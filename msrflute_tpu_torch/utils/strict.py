"""Strict transfer mode — the port's counterpart of
``msrflute_tpu/utils/strict.py``.

``MSRFLUTE_STRICT_TRANSFERS=1`` runs the dispatch half of each chunk of
the server's round loop (the ``latest`` snapshots, the pager's page-in,
staging, the rounds, the stats' copy and the writeback's) under
``torch.cuda.set_sync_debug_mode("error")``: a call there that makes the
host wait for the card (``.item()``, a pageable copy to the host,
``nonzero``) raises at its line.  Only the dispatch half: torch cannot tell
an implicit read from an explicit one, and the drain's packed readback is
the sanctioned crossing, so the JAX package's scope around the whole loop
(``server.py:1197-1205``) would refuse it.  The one read a dispatch half
makes on purpose, secure aggregation's survivors after a screen
(``engine/round.py::_recover_masks``), runs under :func:`allow_sync`.
On the CPU the scope does nothing.

:func:`sync_points` is the same check as a report: the places (file:line)
of the synchronizing calls a function makes, from the mode's warnings
(``chip_smoke.py`` holds the dispatch half to none).
"""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Callable, List

import torch

ENV_FLAG = "MSRFLUTE_STRICT_TRANSFERS"

#: the warning ``set_sync_debug_mode("warn")`` gives at a synchronizing call
SYNC_WARNING = "called a synchronizing CUDA operation"


def strict_transfers_enabled() -> bool:
    return os.environ.get(ENV_FLAG, "") == "1"


@contextlib.contextmanager
def sync_debug_mode(mode: str):
    """``torch.cuda.set_sync_debug_mode(mode)`` inside the block, the
    previous mode after it."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def strict_transfer_scope(device: torch.device):
    """A synchronizing call raises inside the block when the env flag is
    set and ``device`` is a card; otherwise nothing happens."""
    if not strict_transfers_enabled() or device.type != "cuda":
        yield
        return
    with sync_debug_mode("error"):
        yield


@contextlib.contextmanager
def allow_sync():
    """A sanctioned read inside a strict scope (the mode restored after
    it); nothing happens without a card."""
    if not torch.cuda.is_available():
        yield
        return
    with sync_debug_mode("default"):
        yield


def sync_points(fn: Callable[[], object], root: str) -> List[str]:
    """Run ``fn()`` with the sync debug mode at "warn" and return where it
    made a synchronizing call, as paths relative to ``root`` with their
    line."""
    places = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with sync_debug_mode("warn"):
            fn()
    for w in caught:
        if SYNC_WARNING in str(w.message):
            places.append(f"{os.path.relpath(w.filename, root)}:{w.lineno}")
    return places
