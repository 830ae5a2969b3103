"""Thread-aware round tracing — the port's copy of
``msrflute_tpu/telemetry/spans.py``, pure host code.

Every round phase (pack -> dispatch -> device execute ->
packed-stats decode -> housekeeping -> checkpoint submit/drain) becomes a
span, emitted in TWO forms simultaneously:

- ``trace.json`` — Chrome-trace/Perfetto ``traceEvents`` JSON.  Load it
  at https://ui.perfetto.dev to SEE the pipeline overlap: round k's
  host-tail span on the main-thread track running while round k+1's
  device span is open on the "rounds in flight" track, the async
  checkpoint writer on its own thread track, chaos/checkpoint/preemption
  instant events pinned at their timestamps.
- ``events.jsonl`` — one JSON line per completed span/event, appended
  incrementally (crash-safe: a SIGKILL loses at most the buffered tail;
  the preemption drain path flushes it explicitly).

Two span APIs, because the pipelined loop needs both:

- ``with tracer.span("pack", rounds=R):`` — context manager for phases
  that nest normally on the calling thread's track.
- ``token = tracer.begin("round", round0=k)`` / ``tracer.end(token)`` —
  explicit begin/end for spans that OUTLIVE the code block that opened
  them (round k's device window stays open across the host's dispatch of
  k+1).  These land on virtual "in flight" tracks so overlapping spans
  never nest wrongly in a viewer.

Hard constraints (the zero-cost / zero-transfer contract, pinned by
``tests/test_torch_telemetry_contract.py``):

- span args must already be host values; a device tensor goes through
  the device-metric bus (:mod:`.devbus`), never into a span;
- when telemetry is off nothing here is ever constructed; the module's
  only off-path surface is the shared :data:`NULL_SPAN` no-op context.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

#: the telemetry-off fast path: one shared, stateless no-op context
#: manager (contextlib.nullcontext is re-enterable) — call sites pay a
#: None-check and nothing else
NULL_SPAN = contextlib.nullcontext()

#: virtual-track base tid for begin/end spans (real thread tracks use
#: the OS thread ident; anything >= this is an "in flight" slot)
_FLIGHT_TID_BASE = 1_000_000


class SpanToken:
    """Handle for an explicit begin/end span (see :meth:`Tracer.begin`)."""

    __slots__ = ("name", "args", "t0_us", "tid", "done")

    def __init__(self, name: str, args: Dict[str, Any], t0_us: float,
                 tid: int):
        self.name = name
        self.args = args
        self.t0_us = t0_us
        self.tid = tid
        self.done = False


class Tracer:
    """Collects spans/events; writes ``trace.json`` + ``events.jsonl``.

    Thread-aware: spans record the emitting thread's ident as the trace
    ``tid`` and register a ``thread_name`` metadata row on first use, so
    the async checkpoint writer's serialize/write spans appear on their
    own track.  All mutation is under one lock — span emission is a dict
    append, never IO (IO happens at :meth:`flush`/:meth:`close`, plus
    buffered JSONL appends).
    """

    #: in-memory event cap: past this, new TRACE events are dropped
    #: (counted, and flagged in the flushed trace) while the incremental
    #: JSONL stream keeps recording — bounds a 100k-round run's RAM
    MAX_EVENTS = 1_000_000
    #: minimum seconds between flush_throttled() rewrites of trace.json
    #: (each flush rewrites the whole file; the throttle bounds the
    #: O(events) cost while keeping the on-disk trace reasonably fresh)
    FLUSH_INTERVAL_SECS = 30.0

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.trace_path = os.path.join(out_dir, "trace.json")
        self.events_path = os.path.join(out_dir, "events.jsonl")
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._dropped = 0
        self._t0 = time.perf_counter()
        self._epoch0 = time.time()
        self._pid = os.getpid()
        self._named_threads: set = set()
        self._free_slots: List[int] = []
        self._next_slot = 0
        self._jsonl_fh = open(self.events_path, "a", encoding="utf-8")
        try:
            self._jsonl_bytes = os.path.getsize(self.events_path)
        except OSError:
            self._jsonl_bytes = 0
        #: events.jsonl size cap in bytes (0 = unbounded); armed from
        #: the telemetry block's ``max_log_mb`` knob
        self.max_log_bytes = 0
        self._last_flush = 0.0
        self._closed = False

    @property
    def dropped(self) -> int:
        """Trace events dropped past :data:`MAX_EVENTS` so far — the
        counter the rollup stream and the scorecard carry
        (the in-trace flag alone was invisible to gates)."""
        return self._dropped

    # -- clock ----------------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _epoch_of(self, ts_us: float) -> float:
        return self._epoch0 + ts_us / 1e6

    # -- track bookkeeping ----------------------------------------------
    def _thread_tid(self) -> int:
        ident = threading.get_ident()
        if ident not in self._named_threads:
            self._named_threads.add(ident)
            self._events.append({
                "name": "thread_name", "ph": "M", "pid": self._pid,
                "tid": ident,
                "args": {"name": threading.current_thread().name}})
        return ident

    def _alloc_flight_tid(self) -> int:
        if self._free_slots:
            return _FLIGHT_TID_BASE + self._free_slots.pop()
        slot = self._next_slot
        self._next_slot += 1
        tid = _FLIGHT_TID_BASE + slot
        self._events.append({
            "name": "thread_name", "ph": "M", "pid": self._pid,
            "tid": tid, "args": {"name": f"rounds in flight (slot {slot})"}})
        return tid

    # -- emission -------------------------------------------------------
    def _jsonl(self, record: Dict[str, Any]) -> None:
        # caller holds the lock; buffered append (flush() forces it out)
        if not self._jsonl_fh.closed:
            line = json.dumps(record) + "\n"
            self._jsonl_fh.write(line)
            self._jsonl_bytes += len(line)

    def _append_trace(self, event: Dict[str, Any]) -> None:
        # caller holds the lock.  Past the cap, trace events drop
        # (counted — flush() flags it) but the JSONL stream still
        # records, so nothing is silently lost, only un-visualized.
        if len(self._events) >= self.MAX_EVENTS:
            self._dropped += 1
            return
        self._events.append(event)

    def _emit_complete(self, name: str, t0_us: float, dur_us: float,
                       args: Dict[str, Any], tid: int) -> None:
        with self._lock:
            self._append_trace({
                "name": name, "ph": "X", "ts": round(t0_us, 1),
                "dur": round(max(dur_us, 0.0), 1),
                "pid": self._pid, "tid": tid, "args": args})
            self._jsonl({"kind": "span", "name": name,
                         "ts": round(self._epoch_of(t0_us), 6),
                         "dur_s": round(dur_us / 1e6, 6), **args})

    # -- public span API ------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **args: Any):
        """Context-managed span on the calling thread's track."""
        with self._lock:
            tid = self._thread_tid()
        t0 = self._now_us()
        try:
            yield
        finally:
            self._emit_complete(name, t0, self._now_us() - t0, args, tid)

    def begin(self, name: str, **args: Any) -> SpanToken:
        """Open a span that another code path will :meth:`end` — the
        pipelined-overlap case, placed on a virtual in-flight track."""
        with self._lock:
            tid = self._alloc_flight_tid()
        return SpanToken(name, args, self._now_us(), tid)

    def end(self, token: Optional[SpanToken]) -> None:
        if token is None or token.done:
            return
        token.done = True
        self._emit_complete(token.name, token.t0_us,
                            self._now_us() - token.t0_us, token.args,
                            token.tid)
        with self._lock:
            self._free_slots.append(token.tid - _FLIGHT_TID_BASE)

    def instant(self, name: str, **args: Any) -> None:
        """One structured instant event (chaos fault, checkpoint
        fallback, preemption, watchdog finding) in both streams."""
        ts = self._now_us()
        with self._lock:
            tid = self._thread_tid()
            self._append_trace({
                "name": name, "ph": "i", "s": "p", "ts": round(ts, 1),
                "pid": self._pid, "tid": tid, "args": args})
            self._jsonl({"kind": "event", "name": name,
                         "ts": round(self._epoch_of(ts), 6), **args})

    def counter(self, name: str, value: float, **args: Any) -> None:
        """A Perfetto counter-track sample (devbus scalars plot as time
        series)."""
        ts = self._now_us()
        with self._lock:
            self._append_trace({
                "name": name, "ph": "C", "ts": round(ts, 1),
                "pid": self._pid, "tid": 0,
                "args": {"value": float(value)}})
            self._jsonl({"kind": "counter", "name": name,
                         "ts": round(self._epoch_of(ts), 6),
                         "value": float(value), **args})

    # -- persistence ----------------------------------------------------
    def flush(self) -> None:
        """Rewrite ``trace.json`` (complete, valid JSON every time — a
        trace captured mid-run still loads in Perfetto) and force the
        JSONL buffer out.  The server calls :meth:`flush_throttled` at
        round-housekeeping cadence and this directly at train exit and
        from the preemption flush path."""
        with self._lock:
            snapshot = list(self._events)
            dropped = self._dropped
            if not self._jsonl_fh.closed:
                self._jsonl_fh.flush()
        if dropped:
            # no silent caps: a capped trace says so, in the trace
            snapshot.append({
                "name": "tracer_events_capped", "ph": "i", "s": "p",
                "ts": round(self._now_us(), 1), "pid": self._pid,
                "tid": 0, "args": {"dropped": dropped,
                                   "cap": self.MAX_EVENTS}})
        tmp = self.trace_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump({"traceEvents": snapshot,
                       "displayTimeUnit": "ms"}, fh)
        os.replace(tmp, self.trace_path)
        self._last_flush = time.perf_counter()
        self._maybe_rotate_jsonl()

    def _maybe_rotate_jsonl(self) -> None:
        """Size-capped events.jsonl rotation (``telemetry.max_log_mb``),
        run at flush cadence.  Inode-swap ordering so no writer is ever
        blocked and no line is ever lost: (1) hardlink the live inode to
        ``events.jsonl.N``; (2) swap a fresh empty inode into the
        primary name (tmp + ``os.replace``); (3) open the new inode;
        (4) under the lock, exchange the handle and close the old one.
        A concurrent span emitted between (2) and (4) still writes the
        OLD inode — which is exactly the segment file now — so ordering
        is preserved; all file opens happen OUTSIDE the tracer lock
        (the lock-discipline contract)."""
        with self._lock:
            need = (self.max_log_bytes and not self._jsonl_fh.closed and
                    self._jsonl_bytes >= self.max_log_bytes)
            rotated_bytes = self._jsonl_bytes
        if not need:
            return
        seg = 1
        while os.path.exists(f"{self.events_path}.{seg}"):
            seg += 1
        try:
            os.link(self.events_path, f"{self.events_path}.{seg}")
            tmp = self.events_path + ".tmp"
            with open(tmp, "w", encoding="utf-8"):
                pass
            os.replace(tmp, self.events_path)
            new_fh = open(self.events_path, "a", encoding="utf-8")
        except OSError:
            return  # rotation is best-effort; the stream must survive
        with self._lock:
            old = self._jsonl_fh
            self._jsonl_fh = new_fh
            self._jsonl_bytes = 0
        if not old.closed:
            old.flush()
            old.close()
        self.instant("log_rotated", file="events.jsonl", segment=seg,
                     rotated_bytes=rotated_bytes)

    def flush_throttled(self) -> None:
        """Round-cadence flush point: rewrites at most once per
        :data:`FLUSH_INTERVAL_SECS` (a full rewrite is O(events)), so a
        long run keeps a reasonably fresh on-disk trace without paying
        the rewrite every round.  The JSONL stream needs no throttle —
        it is incremental."""
        if time.perf_counter() - self._last_flush >= \
                self.FLUSH_INTERVAL_SECS:
            self.flush()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.flush()
        with self._lock:
            if not self._jsonl_fh.closed:
                self._jsonl_fh.close()
