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
share a stream.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

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
        # the async checkpoint writer emits from its own thread
        self._lock = threading.Lock()
        #: the run's event records, in emission order
        self.events: List[Dict[str, Any]] = []
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def _write(self, record: Dict[str, Any]) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.write(json.dumps(record) + "\n")

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
            if self._fh is not None:
                self._fh.write(json.dumps(record) + "\n")
        _LOGGER.info("event %s %s", kind,
                     {k: v for k, v in record.items()
                      if k not in ("ts", "event")})

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
