"""Seeded arrival-process traces (``server_config.traffic.trace``) — the
port's own copy of ``msrflute_tpu/traffic/traces.py``, draw for draw.

A trace is a per-tick arrival probability vector over the whole population:
phones coming online in the evening (``diurnal``), a push notification's
flash crowd (``bursty``), device classes with their own availability windows
and training speeds (``device_classes``), or the memoryless baseline
(``poisson``).  :class:`~.schedule.TrafficSchedule` turns the draws into
round fires.

Every arrival decision is a pure function of ``(traffic.seed, stream tag,
tick)`` through ``np.random.SeedSequence``, with the JAX package's stream
tags, so both packages draw the same arrivals and durations from one seed,
and serial, pipelined and resumed runs replay the same timeline.  Draws are
slot-keyed over the full population each tick, so the timeline one client
sees never shifts because another client's state changed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

#: stream tags keeping the arrival plane independent of the chaos
#: streams (0xC7A0....) and of anything else seeded from small ints
_ARRIVAL_STREAM = 0x7AF1CA11
_DURATION_STREAM = 0x7AF1D07A

#: trace names accepted by :func:`make_trace` / the schema enum
TRACE_NAMES = ("poisson", "diurnal", "bursty", "device_classes")


def _entropy(seed: int, stream: int, tick: int) -> list:
    """SeedSequence entropy for one per-tick vector draw — the 3-word
    ``(seed, stream, tick)`` key mirrors chaos' round-keyed scheme, so
    the trace is a pure function of the tick index (resume-stable)."""
    return [int(seed), int(stream), int(tick)]


def tick_rng(seed: int, stream: int, tick: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        _entropy(seed, stream, tick)))


class ArrivalTrace:
    """One arrival process over a fixed population.

    Subclasses implement :meth:`probs` — the per-tick, per-client
    probability that an idle client becomes available during that tick.
    ``duration_scale`` is a static per-client training-time multiplier
    (device-class mixtures make their slow classes slow here)."""

    name = "base"

    def __init__(self, population: int):
        if int(population) < 1:
            raise ValueError("traffic trace population must be >= 1")
        self.population = int(population)

    def probs(self, tick: int) -> np.ndarray:
        """``[N] float64`` in ``[0, 1]``: arrival probability per client
        for this tick."""
        raise NotImplementedError

    def duration_scale(self) -> np.ndarray:
        """``[N] float64 >= 1``: per-client training-duration multiplier
        (1.0 = the schedule's base duration draw, untouched)."""
        return np.ones(self.population, np.float64)

    # ------------------------------------------------------------------
    def _uniform_probs(self, rate: float) -> np.ndarray:
        """Spread ``rate`` expected arrivals/tick across the population."""
        return np.full(self.population,
                       min(float(rate) / self.population, 1.0), np.float64)

    def describe(self) -> Dict[str, Any]:
        return {"trace": self.name, "population": self.population}


class PoissonTrace(ArrivalTrace):
    """Homogeneous arrivals: ``rate`` expected arrivals per tick, spread
    uniformly over the population — the memoryless baseline every other
    trace perturbs."""

    name = "poisson"

    def __init__(self, population: int, rate: float = 8.0):
        super().__init__(population)
        if float(rate) <= 0.0:
            raise ValueError("traffic.rate must be > 0")
        self.rate = float(rate)

    def probs(self, tick: int) -> np.ndarray:
        return self._uniform_probs(self.rate)

    def describe(self) -> Dict[str, Any]:
        return dict(super().describe(), rate=self.rate)


class DiurnalTrace(ArrivalTrace):
    """Sinusoidal day/night cycle: the instantaneous rate is
    ``rate * max(0, 1 + depth * sin(2*pi*tick / period))`` — ``depth``
    1.0 means the trough goes fully dark (phones asleep), 0.0 collapses
    to :class:`PoissonTrace`."""

    name = "diurnal"

    def __init__(self, population: int, rate: float = 8.0,
                 period: int = 64, depth: float = 0.8):
        super().__init__(population)
        if float(rate) <= 0.0:
            raise ValueError("traffic.rate must be > 0")
        if int(period) < 2:
            raise ValueError("traffic.period must be >= 2 ticks")
        if not 0.0 <= float(depth) <= 1.0:
            raise ValueError("traffic.depth must be in [0, 1]")
        self.rate = float(rate)
        self.period = int(period)
        self.depth = float(depth)

    def probs(self, tick: int) -> np.ndarray:
        mult = max(0.0, 1.0 + self.depth *
                   np.sin(2.0 * np.pi * tick / self.period))
        return self._uniform_probs(self.rate * mult)

    def describe(self) -> Dict[str, Any]:
        return dict(super().describe(), rate=self.rate,
                    period=self.period, depth=self.depth)


class BurstyTrace(ArrivalTrace):
    """Flash crowd: a quiet baseline of ``rate`` arrivals/tick, and
    every ``burst_every`` ticks a burst window of ``burst_len`` ticks at
    ``burst_rate`` — the push-notification stampede that makes the
    synchronous barrier look worst and a staleness-tolerant buffer look
    best."""

    name = "bursty"

    def __init__(self, population: int, rate: float = 2.0,
                 burst_rate: float = 32.0, burst_every: int = 48,
                 burst_len: int = 8):
        super().__init__(population)
        if float(rate) <= 0.0 or float(burst_rate) <= 0.0:
            raise ValueError("traffic rate/burst_rate must be > 0")
        if int(burst_every) < 1 or int(burst_len) < 1:
            raise ValueError("traffic burst_every/burst_len must be >= 1")
        if int(burst_len) > int(burst_every):
            raise ValueError(
                "traffic.burst_len must be <= burst_every (the burst "
                "window repeats inside the cycle)")
        self.rate = float(rate)
        self.burst_rate = float(burst_rate)
        self.burst_every = int(burst_every)
        self.burst_len = int(burst_len)

    def probs(self, tick: int) -> np.ndarray:
        in_burst = (int(tick) % self.burst_every) < self.burst_len
        return self._uniform_probs(self.burst_rate if in_burst
                                   else self.rate)

    def describe(self) -> Dict[str, Any]:
        return dict(super().describe(), rate=self.rate,
                    burst_rate=self.burst_rate,
                    burst_every=self.burst_every,
                    burst_len=self.burst_len)


#: device-class defaults: a phone-ish fast majority, a tablet-ish
#: evening class, and a slow IoT duty-cycle tail
_DEFAULT_CLASSES = (
    {"fraction": 0.6, "rate": 6.0, "window": 1.0, "phase": 0.0,
     "duration_scale": 1.0},
    {"fraction": 0.3, "rate": 6.0, "window": 0.5, "phase": 0.5,
     "duration_scale": 2.0},
    {"fraction": 0.1, "rate": 2.0, "window": 0.25, "phase": 0.25,
     "duration_scale": 4.0},
)

_CLASS_KEYS = {"fraction", "rate", "window", "phase", "duration_scale"}


class DeviceClassTrace(ArrivalTrace):
    """Population mixture with distinct availability windows: each class
    owns a contiguous id range (``fraction`` of the population, assigned
    deterministically so the partition never depends on draw order),
    arrives at ``rate`` expected arrivals/tick while its window is open
    — open means ``(tick/period + phase) mod 1 < window`` — and trains
    ``duration_scale`` x slower than the base duration draw."""

    name = "device_classes"

    def __init__(self, population: int,
                 classes: Optional[List[Dict[str, Any]]] = None,
                 period: int = 64):
        super().__init__(population)
        if int(period) < 2:
            raise ValueError("traffic.period must be >= 2 ticks")
        self.period = int(period)
        raw = [dict(c) for c in (classes or _DEFAULT_CLASSES)]
        if not raw:
            raise ValueError("traffic.classes must be a non-empty list")
        for i, c in enumerate(raw):
            unknown = set(c) - _CLASS_KEYS
            if unknown:
                raise ValueError(
                    f"traffic.classes[{i}] has unknown keys "
                    f"{sorted(unknown)} (known: {sorted(_CLASS_KEYS)})")
            if not 0.0 < float(c.get("fraction", 0.0)) <= 1.0:
                raise ValueError(
                    f"traffic.classes[{i}].fraction must be in (0, 1]")
            if float(c.get("rate", 1.0)) <= 0.0:
                raise ValueError(f"traffic.classes[{i}].rate must be > 0")
            if not 0.0 < float(c.get("window", 1.0)) <= 1.0:
                raise ValueError(
                    f"traffic.classes[{i}].window must be in (0, 1]")
            if not 0.0 <= float(c.get("phase", 0.0)) < 1.0:
                raise ValueError(
                    f"traffic.classes[{i}].phase must be in [0, 1)")
            if float(c.get("duration_scale", 1.0)) < 1.0:
                raise ValueError(
                    f"traffic.classes[{i}].duration_scale must be >= 1")
        total = sum(float(c["fraction"]) for c in raw)
        if total > 1.0 + 1e-9:
            raise ValueError(
                f"traffic.classes fractions sum to {total:.3f} > 1")
        self.classes = raw
        # contiguous deterministic partition; any remainder after the
        # listed fractions joins the LAST class (never unassigned)
        bounds = np.cumsum([float(c["fraction"]) for c in raw])
        edges = np.minimum(np.round(bounds * self.population),
                           self.population).astype(np.int64)
        edges[-1] = self.population
        self._edges = np.concatenate([[0], edges])
        self._class_of = np.zeros(self.population, np.int64)
        for ci in range(len(raw)):
            self._class_of[self._edges[ci]:self._edges[ci + 1]] = ci

    def probs(self, tick: int) -> np.ndarray:
        p = np.zeros(self.population, np.float64)
        for ci, c in enumerate(self.classes):
            lo, hi = int(self._edges[ci]), int(self._edges[ci + 1])
            n_c = hi - lo
            if n_c <= 0:
                continue
            frac = (float(tick) / self.period +
                    float(c.get("phase", 0.0))) % 1.0
            if frac < float(c.get("window", 1.0)):
                p[lo:hi] = min(float(c.get("rate", 1.0)) / n_c, 1.0)
        return p

    def duration_scale(self) -> np.ndarray:
        scale = np.ones(self.population, np.float64)
        for ci, c in enumerate(self.classes):
            lo, hi = int(self._edges[ci]), int(self._edges[ci + 1])
            scale[lo:hi] = float(c.get("duration_scale", 1.0))
        return scale

    def describe(self) -> Dict[str, Any]:
        return dict(super().describe(), period=self.period,
                    classes=[dict(c) for c in self.classes])


def make_trace(raw: Dict[str, Any], population: int) -> ArrivalTrace:
    """Build the configured trace from a ``server_config.traffic`` dict.

    Unknown trace names raise with the full catalogue (the schema enum
    rejects them at config load; this is the defense for programmatic
    construction)."""
    name = str(raw.get("trace", "poisson")).lower()
    if name == "poisson":
        return PoissonTrace(population, rate=raw.get("rate", 8.0))
    if name == "diurnal":
        return DiurnalTrace(population, rate=raw.get("rate", 8.0),
                            period=raw.get("period", 64),
                            depth=raw.get("depth", 0.8))
    if name == "bursty":
        return BurstyTrace(population, rate=raw.get("rate", 2.0),
                           burst_rate=raw.get("burst_rate", 32.0),
                           burst_every=raw.get("burst_every", 48),
                           burst_len=raw.get("burst_len", 8))
    if name == "device_classes":
        return DeviceClassTrace(population,
                                classes=raw.get("classes"),
                                period=raw.get("period", 64))
    raise ValueError(
        f"traffic.trace: {name!r} not in {TRACE_NAMES}")
