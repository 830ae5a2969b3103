"""Streaming rollups and the flight recorder — the port's copy of
``msrflute_tpu/telemetry/rollup.py``, pure host code.

The longitudinal half of the telemetry package.  Everything the tracer
and metrics stream record is per-event: fine for a 50-round CPU run,
useless for a 3-day fleet run whose limiting signals are TRENDS —
throughput drift, straggler accumulation, host-memory creep — and whose
forensic record must survive the process dying.  Two pieces:

- :class:`RollupEngine` — incremental windowed rollups over values the
  host tail ALREADY holds (span durations, per-round wall clocks, the
  fetched client counts, live MFU, host RSS, the device-truth layer's
  cumulative counters).  Every ``rollup_window`` rounds one JSON line is
  appended to ``<telemetry>/rollups.jsonl`` (complete-line append +
  flush — the crash-safe jsonl idiom) and the window state resets, so
  host memory stays O(window), never O(run length).  Per-phase p50/p95
  inside a window are EXACT (the window's samples are retained — the
  window bound is the memory bound); run-cumulative quantiles come from
  a :class:`P2Quantile` streaming sketch (O(1) memory per phase).
- :class:`FlightRecorder` — a bounded ring of the last-N structured
  events plus the live (unflushed) rollup window and the scorecard,
  persisted atomically as ``<telemetry>/flight.json`` on watchdog
  abort, preemption, or any BaseException exit from the round loop.
  The record of a dead days-long run is always on disk, written by the
  path that killed it — not dependent on a clean shutdown.

Zero-cost contract (``tests/test_torch_telemetry_contract.py``): nothing here is
constructed when telemetry is off, and nothing here ever touches a
device value — every input is a host float the round loop already
fetched or measured.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "FlightRecorder", "P2Quantile", "RollupEngine", "host_rss_bytes",
]

ROLLUPS_FILENAME = "rollups.jsonl"
FLIGHT_FILENAME = "flight.json"


# ----------------------------------------------------------------------
# host RSS (pure stdlib; the rss_leak watchdog's input)
# ----------------------------------------------------------------------
def host_rss_bytes() -> Optional[int]:
    """This process's CURRENT resident set size in bytes, or None when
    the platform offers no cheap reading.  Linux reads one line of
    ``/proc/self/statm`` (pages); the fallback uses ``getrusage``
    ``ru_maxrss`` — a PEAK, not a current value, so the leak detector's
    slope still rises with a leak but can never fall."""
    try:
        with open("/proc/self/statm", "r", encoding="ascii") as fh:
            rss_pages = int(fh.read().split()[1])
        return rss_pages * (os.sysconf("SC_PAGE_SIZE")
                            if hasattr(os, "sysconf") else 4096)
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource
        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # linux reports KiB, macOS bytes; by this branch we are not on
        # a /proc system, so assume the BSD convention
        return int(ru)
    except Exception:
        return None


# ----------------------------------------------------------------------
# streaming quantiles
# ----------------------------------------------------------------------
class P2Quantile:
    """The P² streaming quantile estimator (Jain & Chlamtac 1985):
    one quantile, five markers, O(1) memory and O(1) per observation.

    EXACT for the first five observations; beyond that the markers
    interpolate parabolically — the classic accuracy is well within a
    few percent on smooth distributions, which is what a trend gate
    needs (the per-window quantiles in the rollup records stay exact;
    this sketch backs only the run-CUMULATIVE columns, where retaining
    every sample would be the O(run length) memory this module exists
    to remove).  Deterministic for a fixed observation order."""

    __slots__ = ("p", "n", "_heights", "_positions", "_desired", "_incr")

    def __init__(self, p: float):
        if not 0.0 < p < 1.0:
            raise ValueError(f"quantile p must be in (0, 1), got {p}")
        self.p = float(p)
        self.n = 0
        self._heights: List[float] = []
        self._positions = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._desired = [1.0, 1.0 + 2.0 * p, 1.0 + 4.0 * p,
                         3.0 + 2.0 * p, 5.0]
        self._incr = [0.0, p / 2.0, p, (1.0 + p) / 2.0, 1.0]

    def observe(self, value: float) -> None:
        value = float(value)
        self.n += 1
        if len(self._heights) < 5:
            self._heights.append(value)
            self._heights.sort()
            return
        q = self._heights
        if value < q[0]:
            q[0] = value
            k = 0
        elif value >= q[4]:
            q[4] = value
            k = 3
        else:
            k = 0
            while k < 3 and value >= q[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            self._positions[i] += 1.0
        for i in range(5):
            self._desired[i] += self._incr[i]
        # adjust the three interior markers toward their desired
        # positions, parabolic when the neighbor gap allows, linear else
        for i in (1, 2, 3):
            d = self._desired[i] - self._positions[i]
            np_, nm = self._positions[i + 1], self._positions[i - 1]
            if (d >= 1.0 and np_ - self._positions[i] > 1.0) or \
                    (d <= -1.0 and nm - self._positions[i] < -1.0):
                d = 1.0 if d >= 1.0 else -1.0
                qi = self._parabolic(i, d)
                if not q[i - 1] < qi < q[i + 1]:
                    qi = q[i] + d * (q[i + int(d)] - q[i]) / (
                        self._positions[i + int(d)] - self._positions[i])
                q[i] = qi
                self._positions[i] += d
        return

    def _parabolic(self, i: int, d: float) -> float:
        q, pos = self._heights, self._positions
        return q[i] + d / (pos[i + 1] - pos[i - 1]) * (
            (pos[i] - pos[i - 1] + d) * (q[i + 1] - q[i]) /
            (pos[i + 1] - pos[i]) +
            (pos[i + 1] - pos[i] - d) * (q[i] - q[i - 1]) /
            (pos[i] - pos[i - 1]))

    @property
    def value(self) -> Optional[float]:
        if not self._heights:
            return None
        if len(self._heights) < 5 or self.n <= 5:
            # exact small-sample quantile (nearest-rank, matching the
            # repo's _p50 convention of sorted[int(n*p)])
            ordered = sorted(self._heights)
            idx = min(int(len(ordered) * self.p), len(ordered) - 1)
            return ordered[idx]
        return self._heights[2]


def _exact_quantile(values: List[float], p: float) -> Optional[float]:
    """Nearest-rank quantile of a retained sample list (the per-window
    EXACT numbers — same convention as scope_cli's ``_p50``)."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[min(int(len(ordered) * p), len(ordered) - 1)]


# ----------------------------------------------------------------------
# the rollup engine
# ----------------------------------------------------------------------
class RollupEngine:
    """Windowed longitudinal rollups appended to ``rollups.jsonl``.

    The server's host tail feeds it per-round observations
    (:meth:`observe_round`), the telemetry scope feeds it per-phase span
    durations (:meth:`observe_phase`) and event kinds
    (:meth:`observe_event`); :meth:`maybe_flush` runs on the round
    housekeeping cadence and appends ONE record per completed window.
    All state is bounded: window samples reset at flush, cumulative
    quantiles are P² sketches, counters are dicts over the (small)
    event-kind vocabulary.

    Thread-aware, like the Tracer: ``observe_phase`` arrives from the
    async-checkpoint writer thread (its ``ckpt_async_write`` span) and
    ``observe_event`` from the stall-monitor thread, while the main
    thread flushes — ONE lock guards all window/cumulative mutation
    and record building snapshots under it; the jsonl append happens
    OUTSIDE the lock (the lock-discipline contract: no file opens in a
    held region).
    """

    #: default rounds per rollup window
    DEFAULT_WINDOW = 16

    def __init__(self, out_dir: str, window: int = DEFAULT_WINDOW,
                 ladder=None):
        self.out_dir = out_dir
        self.path = os.path.join(out_dir, ROLLUPS_FILENAME)
        self.window = max(int(window), 1)
        self.windows_flushed = 0
        #: rollup degradation ledger: a window whose append exhausts its
        #: retries is DROPPED and counted — telemetry loss must never
        #: become a host-tail exception in a training run
        self.windows_dropped = 0
        #: optional resilience.DurableIOLadder governing the jsonl
        #: append (surface "writer": retry, then drop); None appends raw
        #: but still drops-and-counts on failure
        self.ladder = ladder
        #: optional ``on_drop(rec)`` callback the server wires to emit
        #: the ``rollup_windows_dropped`` instant event
        self.on_drop = None
        self._fh = None  # opened lazily at first flush
        self._lock = threading.Lock()
        # ---- window state (reset at every flush) ----
        self._w_round_lo: Optional[int] = None
        self._w_round_hi: Optional[int] = None
        self._w_secs: List[float] = []
        self._w_clients = 0.0
        self._w_mfu: List[float] = []
        self._w_phase: Dict[str, List[float]] = {}
        self._w_events: Dict[str, int] = {}
        self._w_t0 = time.time()
        # ---- cumulative state (bounded: sketches + counters) ----
        self._c_secs_p50 = P2Quantile(0.5)
        self._c_secs_p95 = P2Quantile(0.95)
        self._c_phase: Dict[str, Dict[str, P2Quantile]] = {}
        self._c_events: Dict[str, int] = {}
        self._c_rounds = 0
        self._c_clients = 0.0
        # last-known cumulative gauges (device-truth counters, tracer
        # drops) — handed in by the scope at observe/flush time, never
        # read from a device
        self.gauges: Dict[str, Any] = {}

    # -- feeds ----------------------------------------------------------
    def observe_round(self, round_no: int, secs: float, clients: float,
                      mfu: Optional[float] = None,
                      rss_bytes: Optional[int] = None) -> None:
        with self._lock:
            if self._w_round_lo is None:
                self._w_round_lo = int(round_no)
            self._w_round_hi = int(round_no)
            self._w_secs.append(float(secs))
            self._w_clients += float(clients)
            if mfu is not None:
                self._w_mfu.append(float(mfu))
            if rss_bytes is not None:
                self.gauges["host_rss_bytes"] = int(rss_bytes)
            self._c_secs_p50.observe(secs)
            self._c_secs_p95.observe(secs)
            self._c_rounds += 1
            self._c_clients += float(clients)

    def observe_phase(self, name: str, secs: float) -> None:
        with self._lock:
            self._w_phase.setdefault(name, []).append(float(secs))
            sketches = self._c_phase.get(name)
            if sketches is None:
                sketches = {"p50": P2Quantile(0.5),
                            "p95": P2Quantile(0.95)}
                self._c_phase[name] = sketches
            sketches["p50"].observe(secs)
            sketches["p95"].observe(secs)

    def observe_event(self, kind: str) -> None:
        with self._lock:
            self._w_events[kind] = self._w_events.get(kind, 0) + 1
            self._c_events[kind] = self._c_events.get(kind, 0) + 1

    def update_gauges(self, values: Dict[str, Any]) -> None:
        with self._lock:
            self.gauges.update(values)

    # -- records --------------------------------------------------------
    def _rounds_in_window(self) -> int:
        return len(self._w_secs)

    def window_record(self, partial: bool = False) -> Dict[str, Any]:
        """The CURRENT window as a record (flushed form, or the live
        snapshot the flight recorder embeds)."""
        with self._lock:
            return self._window_record_locked(partial=partial)

    def _window_record_locked(self, partial: bool = False
                              ) -> Dict[str, Any]:
        # caller holds self._lock
        wall = time.time() - self._w_t0
        rec: Dict[str, Any] = {
            "kind": "rollup",
            "window": self.windows_flushed,
            "ts": round(time.time(), 3),
            "round_lo": self._w_round_lo,
            "round_hi": self._w_round_hi,
            "rounds": self._rounds_in_window(),
            "wall_secs": round(wall, 3),
            "secs_per_round_p50": _exact_quantile(self._w_secs, 0.5),
            "secs_per_round_p95": _exact_quantile(self._w_secs, 0.95),
            "clients": round(self._w_clients, 1),
            "clients_per_sec": (round(self._w_clients / wall, 3)
                                if wall > 0 else None),
            "mfu_p50": _exact_quantile(self._w_mfu, 0.5),
            "phase_secs": {
                name: {"count": len(vals),
                       "total": round(sum(vals), 6),
                       "p50": round(_exact_quantile(vals, 0.5), 6),
                       "p95": round(_exact_quantile(vals, 0.95), 6)}
                for name, vals in sorted(self._w_phase.items())},
            "events": dict(sorted(self._w_events.items())),
            # run-cumulative columns (sketch-backed, O(1) memory)
            "cum": {
                "rounds": self._c_rounds,
                "clients": round(self._c_clients, 1),
                "secs_per_round_p50": self._c_secs_p50.value,
                "secs_per_round_p95": self._c_secs_p95.value,
                "events": dict(sorted(self._c_events.items())),
            },
        }
        if partial:
            rec["partial"] = True
        rec.update({k: v for k, v in sorted(self.gauges.items())})
        return rec

    def _reset_window(self) -> None:
        self._w_round_lo = None
        self._w_round_hi = None
        self._w_secs = []
        self._w_clients = 0.0
        self._w_mfu = []
        self._w_phase = {}
        self._w_events = {}
        self._w_t0 = time.time()

    def _append(self, rec: Dict[str, Any]) -> None:
        def _do() -> None:
            if self._fh is None:
                os.makedirs(self.out_dir, exist_ok=True)
                self._fh = open(self.path, "a", encoding="utf-8")
            # one complete line + flush: the crash-safe jsonl idiom — a
            # reader (scope watch / health) never sees a torn record
            # older than the last flush, and a kill loses at most the
            # line being written (readers tolerate a torn tail)
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.ladder is not None:
            ok = self.ladder.run(_do, surface="writer",
                                 what="rollup window append")
        else:
            try:
                _do()
                ok = True
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception:  # noqa: BLE001 - telemetry must not abort
                ok = False
        if not ok:
            self._drop_window(rec)

    def _drop_window(self, rec: Dict[str, Any]) -> None:
        """Writer exhaustion: the window record is lost, the loss is
        counted, the handle resets (a broken fh must not poison every
        later flush), and the server's callback turns it into the
        ``rollup_windows_dropped`` instant event — the degradation table
        in action, never an exception up the host tail."""
        self.windows_dropped += 1
        fh, self._fh = self._fh, None
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass
        cb = self.on_drop
        if cb is not None:
            cb(rec)

    def maybe_flush(self) -> Optional[Dict[str, Any]]:
        """Housekeeping-cadence flush point: append the window record
        when the window is complete; returns the record iff flushed."""
        with self._lock:
            if self._rounds_in_window() < self.window:
                return None
        return self.flush_window()

    def flush_window(self, partial: bool = False
                     ) -> Optional[Dict[str, Any]]:
        """Force-flush the current window (train-exit / close path
        passes ``partial=True`` for an incomplete window).  Record
        building + window reset are atomic under the lock; the file
        append happens outside it."""
        with self._lock:
            if self._rounds_in_window() == 0:
                return None
            rec = self._window_record_locked(partial=partial)
            self.windows_flushed += 1
            self._reset_window()
        self._append(rec)
        return rec

    def close(self) -> None:
        self.flush_window(partial=True)
        if self._fh is not None and not self._fh.closed:
            self._fh.close()


# ----------------------------------------------------------------------
# the flight recorder
# ----------------------------------------------------------------------
class FlightRecorder:
    """Bounded ring of the last-N structured events + the live rollup
    window + the scorecard, persisted atomically as ``flight.json``.

    Fed from the telemetry scope's event path (every structured event
    passes through, whatever its stream destinations); persisted by the
    paths that end a run abnormally — watchdog abort, preemption,
    any BaseException out of the round loop.  ``persist`` is tmp +
    ``os.replace`` (the blessed atomic-write idiom) and re-entrant:
    each call overwrites with the full reason history, so a stall
    abort followed by the exception unwind leaves ONE coherent record
    carrying both."""

    DEFAULT_EVENTS = 256

    def __init__(self, out_dir: str, max_events: int = DEFAULT_EVENTS):
        self.out_dir = out_dir
        self.path = os.path.join(out_dir, FLIGHT_FILENAME)
        self.ring: deque = deque(maxlen=max(int(max_events), 8))
        self.reasons: List[Dict[str, Any]] = []
        #: best-effort scorecard builder (the server wires its
        #: ``build_scorecard``); called at persist time, never earlier
        self.card_fn: Optional[Callable[[], Dict[str, Any]]] = None
        #: the live rollup engine (None when rollups are disabled)
        self.rollup: Optional[RollupEngine] = None

    def record_event(self, kind: str, fields: Dict[str, Any]) -> None:
        self.ring.append({"ts": round(time.time(), 3), "kind": kind,
                          **fields})

    def persist(self, reason: str,
                detail: Optional[str] = None) -> Optional[str]:
        """Write ``flight.json`` atomically; returns the path (None on
        a write failure — the caller is already on an abort path and
        must never die on forensics IO)."""
        self.reasons.append({"ts": round(time.time(), 3),
                             "reason": str(reason),
                             **({"detail": str(detail)[:2000]}
                                if detail else {})})
        record: Dict[str, Any] = {
            "reasons": list(self.reasons),
            "written_ts": round(time.time(), 3),
            "host_rss_bytes": host_rss_bytes(),
            "events": list(self.ring),
        }
        if self.rollup is not None:
            try:
                record["live_window"] = self.rollup.window_record(
                    partial=True)
                record["rollup_windows_flushed"] = \
                    self.rollup.windows_flushed
            except Exception:
                pass
        if self.card_fn is not None:
            try:
                record["scorecard"] = self.card_fn()
            except Exception:
                record["scorecard"] = None
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(record, fh, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
            return self.path
        except OSError:
            return None
