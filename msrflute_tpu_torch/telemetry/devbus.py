"""Device-metric bus — per-round device scalars riding the packed stats;
the port's counterpart of ``msrflute_tpu/telemetry/devbus.py``.

A publisher calls ``bus.publish("dp_clip_frac", t)`` with a 0-d tensor on
the round's device while the round is being enqueued; the engine drains
the pending values into the round's stats just before
:class:`~..utils.flatpack.FlatPacker` packs them
(``RoundEngine._finish_round``), so every published scalar leaves the
device through the one packed readback of the drain: the bus adds no
``.item()``, no copy and no sync.  Host values that were already fetched
go through :meth:`~.Telemetry.devbus_host` instead.

A publish that is not one element (a per-client vector) is skipped, and
its name reported once through :attr:`DeviceMetricBus.on_nonscalar` (the
``devbus_nonscalar_skipped`` event); the bus carries per-round scalars.
The shape is tensor metadata, so the check reads nothing from the device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

#: round-stats key prefix of a bus-published scalar; the host strips it
#: after the packed fetch
PREFIX = "devbus_"


class DeviceMetricBus:
    """Enqueue-time registry of per-round device scalars.

    One instance per :class:`~..engine.round.RoundEngine`; ``enabled`` is
    decided once at engine build from ``server_config.telemetry`` (off:
    every publish is a no-op and the round's stats are those of a run
    without telemetry)."""

    def __init__(self, enabled: bool = False):
        self.enabled = bool(enabled)
        self._pending: Dict[str, Any] = {}
        self._nonscalar: set = set()
        #: ``on_nonscalar(name, shape)``, called once a name (the server
        #: wires the scope's ``devbus_nonscalar_skipped`` event)
        self.on_nonscalar: Optional[Callable[[str, List[int]], None]] = None

    def publish(self, name: str, value: Any) -> None:
        """Register one per-round scalar (a device tensor).  A later
        publish under the same name in the same round replaces it."""
        if not self.enabled:
            return
        name = str(name)
        if value.numel() != 1:
            if name not in self._nonscalar:
                self._nonscalar.add(name)
                if self.on_nonscalar is not None:
                    self.on_nonscalar(name, list(value.shape))
            return
        self._pending[name] = value.reshape(())

    def drain(self) -> Dict[str, Any]:
        """The engine's hook, once a round just before the stats are
        packed: the pending values keyed for the stats."""
        if not self._pending:
            return {}
        out = {PREFIX + k: v for k, v in self._pending.items()}
        self._pending.clear()
        return out

    @staticmethod
    def split_fetched(stats: Dict[str, Any]) -> List[Tuple[str, Any]]:
        """Host side: the bus entries of one fetched round's stats, with
        the prefix stripped, ``[(name, value), ...]`` by name."""
        return [(k[len(PREFIX):], v) for k, v in sorted(stats.items())
                if k.startswith(PREFIX)]
