"""Logging and the metrics stream — the port's counterpart of
``msrflute_tpu/utils/logging.py`` and ``telemetry/metrics.py``.

:class:`MetricsLog` writes one JSON line per scalar to
``<log_dir>/metrics.jsonl`` (``{"ts", "name", "value"[, "step"]}``, the JAX
package's record shape) and echoes it to the ``msrflute_tpu_torch``
logger.  It is an object the caller creates and hands to the server, so
two runs in one process never share a stream.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Optional

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


class MetricsLog:
    """The run's metrics stream; without a directory it only logs."""

    def __init__(self, log_dir: Optional[str] = None):
        self._fh = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log(self, name: str, value: Any, step: Optional[int] = None) -> None:
        record = {"ts": time.time(), "name": name, "value": value}
        if step is not None:
            record["step"] = step
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
        _LOGGER.info("metric %s=%s%s", name, value,
                     f" @ {step}" if step is not None else "")

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
