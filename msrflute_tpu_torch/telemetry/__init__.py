"""Round-structured telemetry — the port's counterpart of
``msrflute_tpu/telemetry/``, one config block (``server_config.telemetry``,
off by default; off, a run builds none of it).

- :mod:`.spans` — the thread-aware tracer: ``trace.json`` (Perfetto) and
  ``events.jsonl``;
- :mod:`.devbus` — per-round device scalars riding the packed stats'
  one readback;
- :mod:`.profiling` — the ``profile_rounds`` window over
  ``torch.profiler`` (and ``do_profiling``'s, through the same code);
- :mod:`.watchdog` — the NaN-loss, round-time, checkpoint-streak,
  quarantine, recompile-storm, stall, RSS-leak and throughput-drift
  detectors with their ``off``/``log``/``mark``/``abort`` actions;
- :mod:`.rollup` — windowed rollups (``rollups.jsonl``) and the flight
  recorder (``flight.json``);
- :mod:`.xla` — the device-truth layer: the signature sentinel, counted
  FLOPs and bytes, live MFU;
- :mod:`.metrics` — size-capped rotation of the jsonl streams;
- :mod:`.timing` — stopwatch primitives on the host clock or CUDA events;
- :mod:`.scope_cli` — ``python -m msrflute_tpu_torch.telemetry.scope_cli``.

The scope's files land in ``<model_dir>/telemetry/``.  Its events go into
the run's :class:`~..utils.logging.MetricsLog` as well (the metrics
stream is an object the caller creates, where the JAX package keeps a
module-global one).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

from . import rollup
from .devbus import DeviceMetricBus
from .spans import NULL_SPAN, SpanToken, Tracer
from .watchdog import Watchdog, WatchdogAbort

__all__ = [
    "DeviceMetricBus", "NULL_SPAN", "SCORECARD_FILENAME", "SpanToken",
    "TELEMETRY_DIRNAME", "Telemetry", "Tracer", "Watchdog", "WatchdogAbort",
    "devbus_config_enabled", "emit_event", "make_telemetry",
    "telemetry_config_enabled", "xla_config_enabled",
]

#: subdirectory of the model dir holding the scope's files
TELEMETRY_DIRNAME = "telemetry"

#: the compact per-run regression surface (``scope_cli diff`` reads it)
SCORECARD_FILENAME = "scorecard.json"


def telemetry_config_enabled(raw: Optional[Dict[str, Any]]) -> bool:
    """Whether a raw ``server_config.telemetry`` block turns the
    subsystem on (absent or ``enable: false``: off)."""
    return bool(raw) and bool(dict(raw).get("enable", True))


def devbus_config_enabled(raw: Optional[Dict[str, Any]]) -> bool:
    """Whether the device-metric bus is on (the engine reads this at
    build time; off, the round's stats are a telemetry-free run's)."""
    return telemetry_config_enabled(raw) and \
        bool(dict(raw).get("devbus", True))


def xla_config_enabled(raw: Optional[Dict[str, Any]]) -> bool:
    """Whether the device-truth layer (:mod:`.xla`) is on; the engine
    builds an :class:`~.xla.XlaIntrospector` only then."""
    return telemetry_config_enabled(raw) and \
        bool(dict(raw).get("xla", True))


class Telemetry:
    """One run's telemetry scope: tracer, watchdog, rollups, flight
    recorder and profiler.  Built only when ``server_config.telemetry``
    turns the subsystem on; the round loop holds None otherwise and pays
    one is-None check an instrumentation point."""

    def __init__(self, raw: Dict[str, Any], model_dir: str, metrics,
                 device=None):
        self.raw = dict(raw)
        self.metrics = metrics
        self.out_dir = os.path.join(model_dir, TELEMETRY_DIRNAME)
        self.tracer: Optional[Tracer] = (
            Tracer(self.out_dir) if self.raw.get("trace", True) else None)
        self.watchdog = Watchdog(self.raw.get("watchdog"),
                                 on_event=self.event)
        self.rollup: Optional[rollup.RollupEngine] = None
        if self.raw.get("rollup", True):
            self.rollup = rollup.RollupEngine(
                self.out_dir,
                window=int(self.raw.get(
                    "rollup_window", rollup.RollupEngine.DEFAULT_WINDOW)))
        self.flight: Optional[rollup.FlightRecorder] = None
        if self.raw.get("flight", True):
            self.flight = rollup.FlightRecorder(
                self.out_dir,
                max_events=int(self.raw.get(
                    "flight_events", rollup.FlightRecorder.DEFAULT_EVENTS)))
            self.flight.rollup = self.rollup
        # the stall monitor persists the flight record before it
        # interrupts a hung main thread
        self.watchdog.on_flight = self.record_flight
        # bounded log growth: set unconditionally, so a scope without the
        # knob gives its stream the unbounded default back
        max_log_mb = float(self.raw.get("max_log_mb", 0) or 0)
        self.metrics.set_max_log_mb(max_log_mb)
        if self.tracer is not None and max_log_mb > 0:
            self.tracer.max_log_bytes = int(max_log_mb * 2 ** 20)
        from .profiling import RoundProfiler
        self.profiler = RoundProfiler(self.raw.get("profile_rounds"),
                                      self.out_dir, device)

    # -- spans ----------------------------------------------------------
    def span(self, name: str, **args: Any):
        inner = (self.tracer.span(name, **args)
                 if self.tracer is not None else NULL_SPAN)
        if self.rollup is None:
            return inner
        # the rollup's per-phase quantiles come from here, with or
        # without the trace
        return self._rollup_span(name, inner)

    @contextlib.contextmanager
    def _rollup_span(self, name: str, inner):
        t0 = time.perf_counter()
        try:
            with inner:
                yield
        finally:
            self.rollup.observe_phase(name, time.perf_counter() - t0)

    def begin(self, name: str, **args: Any) -> Optional[SpanToken]:
        if self.tracer is not None:
            return self.tracer.begin(name, **args)
        if self.rollup is not None:
            # trace: false still feeds the rollup's per-phase quantiles
            return SpanToken(name, args, time.perf_counter() * 1e6, -1)
        return None

    def end(self, token: Optional[SpanToken]) -> None:
        if token is None or token.done:
            return
        if self.tracer is not None:
            if self.rollup is not None:
                self.rollup.observe_phase(
                    token.name,
                    (self.tracer._now_us() - token.t0_us) / 1e6)
            self.tracer.end(token)
            return
        token.done = True
        if self.rollup is not None:
            self.rollup.observe_phase(
                token.name,
                (time.perf_counter() * 1e6 - token.t0_us) / 1e6)

    # -- events / devbus ------------------------------------------------
    def event(self, kind: str, **fields: Any) -> None:
        """One structured record in the metrics stream and, when tracing,
        the trace's instant track; counted in the rollup window and kept
        in the flight ring."""
        self.metrics.event(kind, **fields)
        if self.tracer is not None:
            self.tracer.instant(kind, **fields)
        if self.rollup is not None:
            self.rollup.observe_event(kind)
        if self.flight is not None:
            self.flight.record_event(kind, fields)

    def devbus_host(self, name: str, value: float,
                    step: Optional[int] = None) -> None:
        """A host value already in hand (the pager's counters, the
        host-round SCAFFOLD norm): a metric line and a counter sample, no
        device access."""
        self.metrics.log(f"devbus/{name}", float(value), step=step)
        if self.tracer is not None:
            self.tracer.counter(f"devbus/{name}", float(value))

    def devbus_nonscalar(self, name: str, shape) -> None:
        """The bus skipped a publish that is not one element (once a
        name)."""
        self.event("devbus_nonscalar_skipped", metric=name,
                   shape=list(shape))

    def consume_devbus(self, stats, round0: int) -> None:
        """The bus entries of one fetched chunk's stats (a dict a round):
        a metric line and a counter sample each, name by name, each
        name's rounds in order (the JAX scope's order)."""
        rounds = [dict(DeviceMetricBus.split_fetched(st)) for st in stats]
        for name in sorted({n for r in rounds for n in r}):
            for j, values in enumerate(rounds):
                if name not in values:
                    continue
                value = float(values[name])
                self.metrics.log(f"devbus/{name}", value, step=round0 + j)
                if self.tracer is not None:
                    self.tracer.counter(f"devbus/{name}", value)

    # -- scorecard ------------------------------------------------------
    def write_scorecard(self, card: Dict[str, Any]) -> Optional[str]:
        """Write ``telemetry/scorecard.json`` atomically; None when the
        block turns it off (``scorecard: false``)."""
        if not self.raw.get("scorecard", True):
            return None
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, SCORECARD_FILENAME)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(card, fh, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    # -- endurance rollups + flight recorder ----------------------------
    def rollup_observe(self, round_no: int, secs: float, clients: float,
                       mfu: Optional[float] = None,
                       rss_bytes: Optional[int] = None,
                       xla_snapshot: Optional[Dict[str, Any]] = None
                       ) -> None:
        """One completed round's longitudinal observations (values the
        host tail already holds)."""
        if self.rollup is None:
            return
        gauges = dict(xla_snapshot or {})
        if self.tracer is not None:
            gauges["trace_events_dropped"] = self.tracer.dropped
        if gauges:
            self.rollup.update_gauges(gauges)
        self.rollup.observe_round(round_no, secs, clients, mfu=mfu,
                                  rss_bytes=rss_bytes)

    def rollup_housekeeping(self) -> None:
        """Append the rollup record when the window completed."""
        if self.rollup is not None:
            self.rollup.maybe_flush()

    def record_flight(self, reason: str,
                      detail: Optional[str] = None) -> Optional[str]:
        """Persist ``flight.json`` (no-op when the recorder is off)."""
        if self.flight is None:
            return None
        return self.flight.persist(reason, detail=detail)

    def set_flight_context(self, card_fn) -> None:
        """The scorecard builder the flight record embeds at persist
        time."""
        if self.flight is not None:
            self.flight.card_fn = card_fn

    # -- lifecycle ------------------------------------------------------
    def flush(self) -> None:
        if self.tracer is not None:
            self.tracer.flush()
        self.metrics.flush()

    def flush_throttled(self) -> None:
        """Round-housekeeping flush point (``Tracer.FLUSH_INTERVAL_SECS``
        throttle)."""
        if self.tracer is not None:
            self.tracer.flush_throttled()

    def close(self) -> None:
        self.profiler.finish()
        self.watchdog.stop_stall_monitor()
        if self.rollup is not None:
            self.rollup.close()
        if self.tracer is not None:
            self.tracer.close()
        self.metrics.flush()


def make_telemetry(raw: Optional[Dict[str, Any]], model_dir: str, metrics,
                   device=None) -> Optional[Telemetry]:
    """The run's :class:`Telemetry` scope, or None when the block is
    absent or off (the default)."""
    if not telemetry_config_enabled(raw):
        return None
    return Telemetry(dict(raw), model_dir, metrics, device)


def emit_event(scope: Optional[Telemetry], metrics, kind: str,
               **fields: Any) -> None:
    """A structured event with or without a scope: always a record in the
    metrics stream, and a trace instant (and flight entry) with one."""
    if scope is not None:
        scope.event(kind, **fields)
    else:
        metrics.event(kind, **fields)
