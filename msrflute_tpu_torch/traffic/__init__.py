"""The event-driven arrival plane (``server_config.traffic``) — the port's
own copy of ``msrflute_tpu/traffic/``: seeded traces (:mod:`.traces`) say
when clients become available, :class:`~.schedule.TrafficSchedule` turns
arrivals into buffer-triggered round fires with their true staleness."""

from .traces import (ArrivalTrace, BurstyTrace, DeviceClassTrace,
                     DiurnalTrace, PoissonTrace, TRACE_NAMES, make_trace,
                     tick_rng)
from .schedule import (STALE_HIST_BINS, TRAFFIC_MODES, TrafficSchedule,
                       make_traffic)

__all__ = [
    "ArrivalTrace", "PoissonTrace", "DiurnalTrace", "BurstyTrace",
    "DeviceClassTrace", "TRACE_NAMES", "make_trace", "tick_rng",
    "TrafficSchedule", "TRAFFIC_MODES", "STALE_HIST_BINS",
    "make_traffic",
]
