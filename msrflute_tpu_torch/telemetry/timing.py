"""Stopwatch primitives — the port's counterpart of
``msrflute_tpu/telemetry/timing.py``.

:class:`Stopwatch` times one region on the host's ``perf_counter`` clock
(the span tracer's clock) or, given a CUDA device, between two CUDA
events recorded on its current stream: the device time of the work
enqueued in the region.  :func:`scalar_time` is the mean seconds a call of
a function that returns a scalar tensor.  The JAX package's ``grad_wall``
(an attention probe of its tools) is not ported.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import torch


class Stopwatch:
    """``with Stopwatch() as sw: ... ; sw.secs``.  With ``device`` a CUDA
    device, ``secs`` is read between two CUDA events on that device's
    current stream, and reading it waits for the second event."""

    def __init__(self, device: Optional[torch.device] = None):
        self.device = (torch.device(device) if device is not None
                       else None)
        self._secs = 0.0
        self._t0 = 0.0
        self._events = None

    def _cuda(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def __enter__(self) -> "Stopwatch":
        if self._cuda():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(torch.cuda.current_stream(self.device))
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self.device))
        else:
            self._secs = time.perf_counter() - self._t0

    @property
    def secs(self) -> float:
        if self._events is not None:
            self._events[1].synchronize()
            return self._events[0].elapsed_time(self._events[1]) / 1e3
        return self._secs


def scalar_time(fn, *args: Any, iters: int = 20) -> float:
    """Mean seconds a call of ``fn`` (which returns a scalar tensor): the
    first call runs untimed (kernel builds, the caching allocator), then
    ``iters`` calls between two CUDA events on a CUDA result, else on the
    host clock with the value read back each call."""
    first = fn(*args)
    if isinstance(first, torch.Tensor) and first.device.type == "cuda":
        with Stopwatch(first.device) as sw:
            for _ in range(iters):
                fn(*args)
        return sw.secs / iters
    tic = time.perf_counter()
    for _ in range(iters):
        float(fn(*args))
    return (time.perf_counter() - tic) / iters
