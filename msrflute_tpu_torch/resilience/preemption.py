"""Graceful preemption: SIGTERM / SIGINT -> drain -> checkpoint -> exit —
the port's copy of ``msrflute_tpu/resilience/preemption.py``.

A preemptible card gets a SIGTERM and a short grace window.  The handler
aborts nothing itself: it sets a flag that the server's round loop polls
at chunk boundaries.  On seeing it the loop dispatches nothing more,
drains the chunks already in flight through their normal housekeeping
(which writes each one's ``latest`` checkpoint), waits for the async
writer, writes ``{"preempted": reason}`` into ``status_log.json`` and
returns; the request is a ``preemption`` event record.  ``e2e_trainer``
then exits with ``os.EX_TEMPFAIL`` (75), so a
scheduler can tell "preempted, resume me" from success and from a crash.

Signal handlers install from the main thread only (a CPython rule);
anywhere else the handler degrades to the flag alone, which the
``server_config.chaos.preempt_at_round`` drill and direct :meth:`request`
calls still drive end to end.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
from typing import Callable, List, Optional

from ..utils.logging import print_rank


class PreemptionHandler:
    """SIGTERM and SIGINT handlers around a training run.

    Repeated signals stay graceful until ``escalate_after`` arrivals; then
    the previous dispositions come back, so the next signal kills a drain
    that has wedged."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, escalate_after: int = 2,
                 events: Optional[Callable[..., None]] = None,
                 flush: Optional[Callable[[], None]] = None):
        self.escalate_after = max(int(escalate_after), 1)
        #: the structured-event sink: one ``preemption`` record a request,
        #: written by :meth:`flush_now` (``preemption.py:150-151``), then
        #: ``flush`` (the metrics stream's) makes the records durable
        self.events = events
        self.flush = flush
        self._event = threading.Event()
        self._reason: Optional[str] = None
        self._prev: dict = {}
        self._installed = False
        self._hits = 0
        #: callables run once a request is seen outside signal context
        self._flush_hooks: List[Callable[[], None]] = []
        self._flush_pending = False

    def add_flush_hook(self, fn: Callable[[], None]) -> None:
        """Register a callable run (best effort) by :meth:`flush_now`."""
        self._flush_hooks.append(fn)

    # -- flag side -----------------------------------------------------
    @property
    def requested(self) -> bool:
        return self._event.is_set()

    @property
    def reason(self) -> Optional[str]:
        return self._reason

    @property
    def installed(self) -> bool:
        return self._installed

    def reset(self) -> None:
        """Clear a latched request and the signal count, so a server that
        was preempted once can train again."""
        self._event.clear()
        self._reason = None
        self._hits = 0
        self._flush_pending = False

    def request(self, reason: str, _from_signal: bool = False) -> None:
        """Ask the loop to stop (the drill and tests call this; the signal
        handler wraps it).  From a signal, the log line and the flush hooks
        wait for :meth:`flush_now`: logging takes locks that the
        interrupted thread may hold."""
        if not self._event.is_set():
            self._reason = reason
            self._flush_pending = True
            if not _from_signal:
                self.flush_now()
        self._event.set()

    def flush_now(self) -> None:
        """The deferred log line and flush hooks, once a request; the
        round loop calls it when it sees the request."""
        if not self._flush_pending:
            return
        self._flush_pending = False
        print_rank(f"preemption requested ({self._reason}); draining and "
                   "checkpointing", loglevel=logging.WARNING)
        try:
            if self.events is not None:
                self.events("preemption", reason=self._reason or "requested")
            if self.flush is not None:
                self.flush()
        except Exception:  # a flush may never block the drain
            pass
        for hook in self._flush_hooks:
            try:
                hook()
            except Exception:  # a flush may never block the drain
                pass

    # -- signal side ---------------------------------------------------
    def _on_signal(self, signum, frame):  # noqa: ARG002 - signal API
        self._hits += 1
        self.request(f"signal {signal.Signals(signum).name}",
                     _from_signal=True)
        if self._hits >= self.escalate_after:
            # the next signal behaves as if no handler were here; a raw
            # write is the one async-signal-safe way to say so
            self.uninstall()
            os.write(2, b"repeated preemption signal: handlers "
                        b"restored; the next signal is fatal\n")

    def install(self) -> bool:
        """Install the handlers; True when installed (main thread only —
        elsewhere the flag still works, signals do not)."""
        if self._installed:
            return True
        if threading.current_thread() is not threading.main_thread():
            return False
        for sig in self.SIGNALS:
            self._prev[sig] = signal.signal(sig, self._on_signal)
        self._installed = True
        return True

    def uninstall(self) -> None:
        """Restore the dispositions :meth:`install` replaced."""
        if not self._installed:
            return
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):  # teardown off the main thread
                pass
        self._prev.clear()
        self._installed = False
