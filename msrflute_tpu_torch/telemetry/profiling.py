"""``torch.profiler`` windows: ``telemetry.profile_rounds`` and
``do_profiling`` — the port's counterpart of
``msrflute_tpu/telemetry/profiling.py``.

``server_config.telemetry.profile_rounds`` names the window — an int
(``5``: profile the chunk holding round 5), a ``"lo:hi"`` string, or a
two-element list — and the server calls :meth:`RoundProfiler.observe` at
every chunk boundary.  The capture starts at the first chunk whose round
range reaches ``lo`` and stops at the first boundary at or past ``hi``, so
a chunk spanning the window's edge profiles whole.  The trace lands in
``<telemetry>/xla_profile/rounds_r<lo>.pt.trace.json`` (the directory
keeps the JAX package's name).

:func:`start_window` and :func:`stop_window` are the one profiler code
that both windows run (``do_profiling``'s chunk trace in
``<model_dir>/profile`` too).  On a card each edge of a window waits for
the device, so a window holds exactly the kernels enqueued inside it.
One window at a time, as ``jax.profiler`` allows: a second start raises.
The profile-rounds window takes that as a failed start (a warning, and no
window for the run, as the JAX package's ``profiler_start_trace``
returns), ``do_profiling`` lets it raise, as the JAX server's
``jax.profiler.start_trace`` does.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional, Tuple

import torch

_LOGGER = logging.getLogger("msrflute_tpu_torch")


def parse_profile_rounds(spec: Any) -> Optional[Tuple[int, int]]:
    """``None`` | int | ``"lo:hi"`` | [lo, hi] -> half-open round window
    ``(lo, hi)`` or None.  Raises ValueError on garbage (the config check
    calls this too, so a bad spec fails at config load)."""
    if spec is None:
        return None
    if isinstance(spec, bool):
        raise ValueError("telemetry.profile_rounds: must be an int, "
                         "'lo:hi', or [lo, hi] — got a boolean")
    if isinstance(spec, int):
        return (spec, spec + 1)
    if isinstance(spec, str):
        if ":" not in spec:
            raise ValueError(
                f"telemetry.profile_rounds: {spec!r} is not 'lo:hi'")
        lo_s, hi_s = spec.split(":", 1)
        lo, hi = int(lo_s), int(hi_s)
    elif isinstance(spec, (list, tuple)) and len(spec) == 2:
        lo, hi = int(spec[0]), int(spec[1])
    else:
        raise ValueError(
            f"telemetry.profile_rounds: {spec!r} must be an int, "
            "'lo:hi', or [lo, hi]")
    if lo < 0 or hi <= lo:
        raise ValueError(
            f"telemetry.profile_rounds: window [{lo}, {hi}) is empty or "
            "negative")
    return (lo, hi)


def start_window(device: torch.device):
    """Open a ``torch.profiler`` window (the host's ops and, on a card,
    its kernels) once the device has finished what came before it."""
    from torch.profiler import ProfilerActivity, profile
    if torch._C._autograd._profiler_enabled():
        raise RuntimeError("a torch.profiler window is already open; only "
                           "one profile may run at a time")
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    prof = profile(activities=acts)
    prof.start()
    return prof


def stop_window(prof, device: torch.device, path: str) -> None:
    """Close the window once the device has run what was enqueued in it,
    and write its Chrome trace to ``path``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)


class RoundProfiler:
    """Drives one ``torch.profiler`` window over the configured rounds."""

    def __init__(self, spec: Any, out_dir: str,
                 device: Optional[torch.device] = None):
        self.window = parse_profile_rounds(spec)
        self.out_dir = os.path.join(out_dir, "xla_profile")
        self.device = device if device is not None else torch.device("cpu")
        self.active = False
        self.captured = False
        self.failed = False
        #: the written trace's path, once captured
        self.path: Optional[str] = None
        self._prof = None

    def observe(self, round_no: int, rounds: int = 1) -> None:
        """Chunk-boundary hook: the chunk about to dispatch covers
        ``[round_no, round_no + rounds)``.  The capture starts when that
        range meets the window, so a window inside a chunk of several
        rounds still fires (the chunk profiles whole)."""
        if self.window is None or self.failed or self.captured:
            if self.active:
                self._stop()
            return
        lo, hi = self.window
        if self.active and round_no >= hi:
            self._stop()
        elif not self.active and round_no < hi and round_no + max(
                int(rounds), 1) > lo:
            self._start()

    def finish(self) -> None:
        """Train-exit hook: a window still open (the run ended inside it)
        stops here so the capture is written."""
        if self.active:
            self._stop()

    # ------------------------------------------------------------------
    def _start(self) -> None:
        try:
            self._prof = start_window(self.device)
        except RuntimeError as exc:
            self.failed = True
            _LOGGER.warning("telemetry.profile_rounds: torch.profiler "
                            "unavailable (%s); no window for this run", exc)
            return
        self.active = True
        _LOGGER.info("telemetry: torch.profiler window started (rounds "
                     "%s)", self.window)

    def _stop(self) -> None:
        self.active = False
        self.path = os.path.join(self.out_dir,
                                 f"rounds_r{self.window[0]}.pt.trace.json")
        stop_window(self._prof, self.device, self.path)
        self._prof = None
        self.captured = True
        _LOGGER.info("telemetry: torch.profiler window written to %s",
                     self.path)
