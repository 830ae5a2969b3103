"""Event-driven round firing (``server_config.traffic``) — the port's own
copy of ``msrflute_tpu/traffic/schedule.py``, fire for fire.

Clients become available per a seeded :mod:`trace <.traces>`, train for a
drawn duration and deliver their update; aggregation fires when the buffer
holds ``buffer_size`` updates, and one fire is one round, so the round's
geometry never changes: only who is in the cohort and how stale each update
is come from the timeline.

- ``buffered`` (FedBuff-style): every delivery enters the buffer with its
  true staleness, the fires since the version the client trained from.
- ``sync`` (the barrier baseline): a delivery computed against a superseded
  version is discarded and counted (``sync_discarded``); all staleness is 0.

The timeline is a pure function of ``(traffic.seed, trace config,
buffer_size, mode)``.  Fires are simulated once, in tick order, and cached,
so ``fire(r)`` replays identically however the host loop is arranged
(serial, pipelined with lookahead, or resumed through :meth:`fast_forward`).
Deliveries within a tick are processed in client-id order.  The counters and
:attr:`stale_hist` are the host replay oracle that the round's on-device
staleness histogram is held to.
"""

from __future__ import annotations

import heapq
from typing import Any, Dict, List, Optional

import numpy as np

from .traces import (ArrivalTrace, _ARRIVAL_STREAM, _DURATION_STREAM,
                     make_trace, tick_rng)

#: staleness-histogram bin count shared by the host oracle and the
#: packed-stats operand path (engine/round.py): bins 0..BINS-2 count
#: exact staleness, the last bin is the open ">= BINS-1" overflow
STALE_HIST_BINS = 8

#: traffic modes accepted by :func:`make_traffic` / the schema enum
TRAFFIC_MODES = ("sync", "buffered")


class TrafficSchedule:
    """Seeded arrival/firing timeline.  One instance per run; every
    accessor is deterministic given the construction args (see module
    docstring)."""

    def __init__(self, trace: ArrivalTrace, buffer_size: int,
                 mode: str = "buffered", seed: int = 0,
                 duration_lo: int = 1, duration_hi: int = 4,
                 max_idle_ticks: int = 50_000):
        if str(mode) not in TRAFFIC_MODES:
            raise ValueError(
                f"traffic.mode: {mode!r} not in {TRAFFIC_MODES}")
        if int(buffer_size) < 1:
            raise ValueError("traffic.buffer_size must be >= 1")
        if int(buffer_size) > trace.population:
            raise ValueError(
                f"traffic.buffer_size ({int(buffer_size)}) exceeds the "
                f"population ({trace.population}) — the buffer could "
                "never fill")
        if int(duration_lo) < 1 or int(duration_hi) < int(duration_lo):
            raise ValueError(
                "traffic duration bounds must satisfy "
                "1 <= duration_lo <= duration_hi")
        if int(max_idle_ticks) < 1:
            raise ValueError("traffic.max_idle_ticks must be >= 1")
        self.trace = trace
        self.population = trace.population
        self.buffer_size = int(buffer_size)
        self.mode = str(mode)
        self.seed = int(seed)
        self.duration_lo = int(duration_lo)
        self.duration_hi = int(duration_hi)
        self.max_idle_ticks = int(max_idle_ticks)

        # --- simulation state (advanced lazily, never rewound) --------
        self._tick = 0
        self._version = 0                 # == fires so far
        self._last_fire_tick = 0
        self._in_flight = np.zeros(self.population, bool)
        self._pending: List[tuple] = []   # heap of (deliver_tick, cid, v0)
        self._buffer: List[tuple] = []    # [(cid, staleness)]
        self._fires: List[Dict[str, Any]] = []
        self._dur_scale = trace.duration_scale()

        #: host-replay-oracle rollups (the run's traffic summary reads them)
        self.counters: Dict[str, float] = {
            "arrivals": 0.0, "deliveries": 0.0, "fires": 0.0,
            "sync_discarded": 0.0, "stale_sum": 0.0, "stale_max": 0.0,
            "buffer_occupancy_ticks": 0.0,
        }
        #: staleness histogram over FIRED updates (see STALE_HIST_BINS)
        self.stale_hist = np.zeros(STALE_HIST_BINS, np.int64)

    # ------------------------------------------------------------------
    def _fire(self, tick: int) -> None:
        cohort = np.array([cid for cid, _ in self._buffer], np.int64)
        stale = np.array([s for _, s in self._buffer], np.int32)
        # buffered entries held their clients busy; the fire releases
        # them (guaranteeing each cohort lists a client at most once)
        self._in_flight[cohort] = False
        np.add.at(self.stale_hist,
                  np.minimum(stale, STALE_HIST_BINS - 1), 1)
        self.counters["fires"] += 1
        self.counters["stale_sum"] += float(stale.sum())
        self.counters["stale_max"] = max(self.counters["stale_max"],
                                         float(stale.max(initial=0)))
        self._fires.append({
            "round": len(self._fires),
            "tick": int(tick),
            "wait_ticks": int(tick - self._last_fire_tick),
            "cohort": cohort,
            "staleness": stale,
        })
        self._last_fire_tick = int(tick)
        self._version += 1
        self._buffer = []

    def _step_tick(self) -> None:
        t = self._tick
        # 1) deliveries due this tick, in client-id order (never arrival
        #    order) — a fire mid-tick bumps the version, so later
        #    deliveries in the same tick really are one step staler
        due = []
        while self._pending and self._pending[0][0] <= t:
            due.append(heapq.heappop(self._pending))
        for _, cid, v0 in sorted(due, key=lambda e: e[1]):
            self.counters["deliveries"] += 1
            stale = self._version - v0
            if self.mode == "sync" and stale > 0:
                # the synchronous barrier: work against a superseded
                # broadcast is waste, counted rather than hidden
                self.counters["sync_discarded"] += 1
                self._in_flight[cid] = False
                continue
            # the client stays busy while its update waits in the
            # buffer — released by the fire, never re-drawn before it
            self._buffer.append((int(cid), int(stale)))
            if len(self._buffer) == self.buffer_size:
                self._fire(t)
        # 2) fresh arrivals: full-population slot-keyed draws (in-flight
        #    clients consume theirs inertly, so dedup never shifts the
        #    timeline other clients see)
        u = tick_rng(self.seed, _ARRIVAL_STREAM, t).random(self.population)
        arrive = np.flatnonzero((u < self.trace.probs(t)) &
                                ~self._in_flight)
        if arrive.size:
            ud = tick_rng(self.seed, _DURATION_STREAM,
                          t).random(self.population)
            span = self.duration_hi - self.duration_lo + 1
            base = self.duration_lo + np.floor(ud * span)
            dur = np.maximum(np.ceil(base * self._dur_scale), 1.0)
            self.counters["arrivals"] += float(arrive.size)
            for cid in arrive:
                self._in_flight[cid] = True
                heapq.heappush(self._pending,
                               (t + int(dur[cid]), int(cid),
                                self._version))
        self.counters["buffer_occupancy_ticks"] += len(self._buffer)
        self._tick += 1

    def _advance_to(self, round_no: int) -> None:
        """Simulate until fire ``round_no`` exists (cached thereafter)."""
        while len(self._fires) <= int(round_no):
            if self._tick - self._last_fire_tick > self.max_idle_ticks:
                raise RuntimeError(
                    f"traffic trace starved: no fire for "
                    f"{self.max_idle_ticks} ticks (trace="
                    f"{self.trace.name}, buffer_size={self.buffer_size},"
                    f" arrivals={int(self.counters['arrivals'])}, "
                    f"deliveries={int(self.counters['deliveries'])}) — "
                    "raise the arrival rate, widen the availability "
                    "window, or shrink buffer_size")
            self._step_tick()

    # ------------------------------------------------------------------
    def fire(self, round_no: int) -> Dict[str, Any]:
        """The full fire record for one round (simulating forward as
        needed): round, tick, wait_ticks, cohort, staleness."""
        self._advance_to(round_no)
        return self._fires[int(round_no)]

    def cohort(self, round_no: int) -> np.ndarray:
        """``[buffer_size] int64`` client ids for one fire."""
        return self.fire(round_no)["cohort"]

    def staleness(self, round_no: int) -> np.ndarray:
        """``[buffer_size] int32`` true staleness per cohort member."""
        return self.fire(round_no)["staleness"]

    def staleness_vector(self, round_no: int,
                         client_ids: np.ndarray) -> np.ndarray:
        """Staleness aligned to an arbitrary packed client-id vector
        (the host-packed batch order, padding included): ids outside the
        fire's cohort — padding slots — map to 0, which the engine's
        live-mask gating keeps inert anyway."""
        rec = self.fire(round_no)
        lut = {int(c): int(s) for c, s in zip(rec["cohort"],
                                              rec["staleness"])}
        return np.array([lut.get(int(c), 0) for c in client_ids],
                        np.int32)

    def fast_forward(self, round_no: int) -> None:
        """Resume support: make fires ``[0, round_no)`` available.  The
        timeline is a pure function of the seed, so this is a cache
        warm-up, not a state restore — a resumed process replays the
        identical fire sequence the preempted one saw."""
        if int(round_no) > 0:
            self._advance_to(int(round_no) - 1)

    # ------------------------------------------------------------------
    def arrival_rate(self) -> float:
        """Observed arrivals per tick over the simulated horizon."""
        return (self.counters["arrivals"] / self._tick
                if self._tick else 0.0)

    def mean_buffer_occupancy(self) -> float:
        """Mean end-of-tick buffer fill over the simulated horizon."""
        return (self.counters["buffer_occupancy_ticks"] / self._tick
                if self._tick else 0.0)

    def describe(self) -> Dict[str, Any]:
        """The bench-contract record: enough to make a traffic run
        impossible to confuse with a boundary-sampled baseline."""
        return {
            "enabled": True,
            "mode": self.mode,
            "seed": self.seed,
            "buffer_size": self.buffer_size,
            "duration_lo": self.duration_lo,
            "duration_hi": self.duration_hi,
            **self.trace.describe(),
        }


#: ``server_config.traffic`` keys :func:`make_traffic` consumes itself
#: (everything else in the block parameterizes the trace)
_SCHEDULE_KEYS = ("enable", "mode", "seed", "buffer_size",
                  "duration_lo", "duration_hi", "max_idle_ticks",
                  "target_accuracy")


def make_traffic(server_config, num_clients: int
                 ) -> Optional[TrafficSchedule]:
    """Build the run's :class:`TrafficSchedule` from
    ``server_config.traffic`` (None when absent or ``enable: false``).

    ``buffer_size`` defaults to the run's cohort size — the fused round
    program's ``[K, S, B]`` geometry is compiled for exactly K client
    slots, so the buffer IS the cohort (the FedBuff paper's
    buffer == K mapping); the server refuses a mismatch."""
    raw = (server_config.get("traffic")
           if server_config is not None else None)
    if not raw:
        return None
    raw = dict(raw)
    if not raw.pop("enable", True):
        return None
    cohort = int(server_config.get("num_clients_per_iteration", 1) or 1)
    return TrafficSchedule(
        make_trace(raw, int(num_clients)),
        buffer_size=int(raw.get("buffer_size", cohort)),
        mode=raw.get("mode", "buffered"),
        seed=raw.get("seed", 0),
        duration_lo=raw.get("duration_lo", 1),
        duration_hi=raw.get("duration_hi", 4),
        max_idle_ticks=raw.get("max_idle_ticks", 50_000),
    )
