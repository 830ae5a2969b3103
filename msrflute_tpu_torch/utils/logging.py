"""Logging and the metrics stream — the port's counterpart of
``msrflute_tpu/utils/logging.py`` and ``telemetry/metrics.py``.

:class:`MetricsLog` writes one JSON line per scalar to
``<log_dir>/metrics.jsonl`` (``{"ts", "name", "value"[, "step"]}``, the JAX
package's record shape) and echoes it to the ``msrflute_tpu_torch``
logger.  Structured events (:meth:`MetricsLog.event`: preemption, chaos
faults, checkpoint recovery, arrival-plane fires) go to the same stream as
``{"ts", "event": kind, **fields}``, with ``thread`` set when the caller is
off the main thread (``telemetry/metrics.py:195-210``).  It is an object the
caller creates and hands to the server, so two runs in one process never
share a stream.  ``telemetry.max_log_mb`` caps its size
(:meth:`MetricsLog.set_max_log_mb`): past the cap, a flush rotates the file
to a numbered segment (:func:`..telemetry.metrics.rotate_jsonl`) and
writes a ``log_rotated`` event into the new one.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ..telemetry.metrics import rotate_jsonl

_LOGGER = logging.getLogger("msrflute_tpu_torch")


def init_logging(log_dir: Optional[str] = None,
                 loglevel: int = logging.INFO) -> None:
    """stdout logging, plus ``<log_dir>/log.out`` when a directory is
    given."""
    handlers: list = [logging.StreamHandler()]
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        handlers.append(logging.FileHandler(os.path.join(log_dir, "log.out")))
    logging.basicConfig(level=loglevel, handlers=handlers, force=True,
                        format="%(asctime)s %(levelname)s %(name)s: "
                               "%(message)s")


def print_rank(msg: str, loglevel: int = logging.INFO) -> None:
    _LOGGER.log(loglevel, msg)


def _to_py(value: Any) -> Any:
    """numpy scalars and arrays as plain JSON values."""
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, (list, tuple)):
        return [_to_py(v) for v in value]
    return value


class MetricsLog:
    """The run's metrics stream; without a directory it only logs.
    :attr:`events` keeps every event record of the run in memory too."""

    def __init__(self, log_dir: Optional[str] = None):
        self._fh = None
        self.path: Optional[str] = None
        # the async checkpoint writer emits from its own thread
        self._lock = threading.Lock()
        #: the run's event records, in emission order
        self.events: List[Dict[str, Any]] = []
        #: size cap in bytes (0: unbounded) and the bytes in the live file
        self.max_log_bytes = 0
        self._bytes = 0
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.path = os.path.join(log_dir, "metrics.jsonl")
            self._fh = open(self.path, "a")
            self._bytes = os.path.getsize(self.path)

    def set_max_log_mb(self, mb: float) -> None:
        """Arm size-capped rotation (``telemetry.max_log_mb``; 0 turns it
        off).  Rotation happens at :meth:`flush`, never mid-line."""
        self.max_log_bytes = int(float(mb) * 2 ** 20) if mb else 0

    def _write_line(self, record: Dict[str, Any]) -> None:
        # caller holds the lock
        if self._fh is not None:
            line = json.dumps(record) + "\n"
            self._fh.write(line)
            self._bytes += len(line)

    def _write(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self._write_line(record)

    def log(self, name: str, value: Any, step: Optional[int] = None) -> None:
        record = {"ts": time.time(), "name": name, "value": value}
        if step is not None:
            record["step"] = step
        self._write(record)
        _LOGGER.info("metric %s=%s%s", name, value,
                     f" @ {step}" if step is not None else "")

    def event(self, kind: str, **fields: Any) -> None:
        """One structured event record (``telemetry/metrics.py::
        log_event``): ``{"ts", "event": kind, **fields}``, plus the
        emitting thread's name off the main thread."""
        record = {"ts": time.time(), "event": kind}
        record.update({k: _to_py(v) for k, v in fields.items()})
        emitter = threading.current_thread()
        if emitter is not threading.main_thread():
            record.setdefault("thread", emitter.name)
        with self._lock:   # the list and the stream in one order
            self.events.append(record)
            self._write_line(record)
        _LOGGER.info("event %s %s", kind,
                     {k: v for k, v in record.items()
                      if k not in ("ts", "event")})

    def flush(self) -> None:
        """Force the buffered lines out, then rotate the file when it is
        past the cap (``telemetry/metrics.py::_maybe_rotate``)."""
        with self._lock:
            if self._fh is None:
                return
            self._fh.flush()
            if not self.max_log_bytes or self._bytes < self.max_log_bytes:
                return
            try:
                new_fh, seg = rotate_jsonl(self.path, self._fh)
            except OSError:
                return   # rotation is best effort; the stream goes on
            old, self._fh = self._fh, new_fh
            rotated, self._bytes = self._bytes, 0
        old.close()
        self.event("log_rotated", file="metrics.jsonl", segment=seg,
                   rotated_bytes=rotated)
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
