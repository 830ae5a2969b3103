"""Size-capped rotation of the run's jsonl streams — the port's copy of
the rotation half of ``msrflute_tpu/telemetry/metrics.py``.

The metrics stream itself is :class:`~..utils.logging.MetricsLog`, an
object the caller creates (the JAX package keeps one module-global
stream); ``telemetry.max_log_mb`` arms its cap through
:meth:`~..utils.logging.MetricsLog.set_max_log_mb`, which every telemetry
scope's construction calls (``telemetry/__init__.py:122-125``).  At a
flush point past the cap the live file rotates to a numbered segment:
hardlink the live inode to ``<path>.N``, then atomically swap an empty
inode into the primary name (tmp + ``os.replace``), so no crash instant
loses lines; the worst case is the link-then-swap window, where a crash
leaves the newest lines under both names.  A ``log_rotated`` event opens
the new segment, and the scope readers (:mod:`.scope_cli`) walk the
segments oldest first.
"""

from __future__ import annotations

import os
from typing import List


def rotate_jsonl(path: str, fh):
    """Rotate one append-mode jsonl stream to its next numbered segment
    and hand back ``(new_fh, segment_index)`` without closing ``fh``:
    the caller exchanges handles under its own lock, then closes the old
    one (a writer still holding it writes the old inode, which is the
    segment file)."""
    fh.flush()
    seg = 1
    while os.path.exists(f"{path}.{seg}"):
        seg += 1
    os.link(path, f"{path}.{seg}")
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8"):
        pass
    os.replace(tmp, path)
    return open(path, "a", encoding="utf-8"), seg


def jsonl_segment_paths(path: str) -> List[str]:
    """Rotated segments of one jsonl stream, oldest first, the primary
    last — the reader-side mirror of :func:`rotate_jsonl`."""
    out = []
    seg = 1
    while os.path.exists(f"{path}.{seg}"):
        out.append(f"{path}.{seg}")
        seg += 1
    if os.path.exists(path):
        out.append(path)
    return out
