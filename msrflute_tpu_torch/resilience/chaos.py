"""Deterministic client faults, update corruption, checkpoint-IO faults and
the preemption drill and the infrastructure faults
(``server_config.chaos``) — the port's copy of
``msrflute_tpu/resilience/chaos.py`` (``:66-200``, ``:202-402``,
``:402-443``).

A seeded schedule that makes the cohort unreliable: clients that drop out
mid-round, stragglers that reach the round barrier with only part of their
local steps done, and adversarial payloads that come back NaN, scaled up or
sign-flipped.  Every decision is a pure function of ``(chaos.seed, stream,
round)`` through ``np.random.SeedSequence``, with the JAX package's stream
tags, entropy and draw order, so both packages draw the same ``drop``,
``keep_steps`` and corruption vectors, draw for draw.  A zero-rate block
draws nothing that reaches the round: the round is bitwise the one without
a block.

How the vectors land (``engine/round.py``): dropout multiplies into the
client mask, straggling truncates the sample mask's step grid (a
straggler's partial work still aggregates), and a live client's corruption
mode transforms the default payload it would transmit.  The counters come
back with the round's stats.

Checkpoint IO (``ckpt_io_error_rate``): :meth:`ChaosSchedule.io_fault_hook`
runs before every physical checkpoint write attempt (retries included) and
raises ``OSError`` when the call-indexed stream ``[seed, _IO_STREAM,
call]`` says so, which the checkpoint manager's retry loop absorbs or
counts toward escalation.  ``preempt_at_round`` is read by the server's
round loop (:mod:`.preemption`).

Infrastructure faults (``chaos.infra``, :class:`InfraFaults`): the fleet
paged carry's host services (the row store's spill and read, the round
marker, the ``fleet-prefetch`` worker, the writeback fetch, the rollup
writer) fail on their own call-indexed streams, with the JAX package's
stream tags, so both packages fail the same attempts.  The server refuses
them without the paged carry.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

#: stream tags keeping the fault streams independent of each other
_CLIENT_STREAM = 0xC7A05C11
#: the corruption stream has its own tag, so enabling corruption never
#: moves the dropout / straggler schedule a seed produces
_CORRUPT_STREAM = 0xC7A0C0DE
#: the checkpoint-IO stream, indexed by call rather than by round
_IO_STREAM = 0xC7A051F0
#: the infrastructure services' streams, one tag a service, so raising one
#: service's rate never moves another's schedule
_INFRA_STORE_WRITE_STREAM = 0xC7A05701
_INFRA_STORE_READ_STREAM = 0xC7A05702
_INFRA_PREFETCH_STREAM = 0xC7A0F7EC
_INFRA_WRITER_STREAM = 0xC7A03217
_INFRA_WRITEBACK_STREAM = 0xC7A03B0A

#: corruption modes of the per-round ``[K]`` int32 vector; 0 = clean
CORRUPT_NONE = 0
CORRUPT_NAN = 1        # payload becomes NaN (corrupted transfer)
CORRUPT_SCALE = 2      # payload x corrupt_scale_factor (scaling attack)
CORRUPT_SIGN_FLIP = 3  # payload x -corrupt_sign_flip_scale (sign flip)

#: "no straggler bound": far above any step grid
NO_BOUND = 1e9


class InfraFaults:
    """Seeded infrastructure faults (``server_config.chaos.infra``).  Each
    surface draws from its own stream ``[seed, stream, call]``, its index
    advancing on every physical attempt (so a retry draws afresh); the
    prefetch delay draws on the prefetch tag with a fourth word 1.  The
    call indices restart at 0 in a resumed process: the faults exercise the
    retry ladder and never touch model state."""

    _STREAMS = {
        "store_write": _INFRA_STORE_WRITE_STREAM,
        "store_read": _INFRA_STORE_READ_STREAM,
        "prefetch": _INFRA_PREFETCH_STREAM,
        "writer": _INFRA_WRITER_STREAM,
        "writeback": _INFRA_WRITEBACK_STREAM,
    }

    def __init__(self, seed: int = 0,
                 store_write_error_rate: float = 0.0,
                 store_read_error_rate: float = 0.0,
                 prefetch_error_rate: float = 0.0,
                 prefetch_delay_rate: float = 0.0,
                 prefetch_delay_s: float = 0.05,
                 writer_error_rate: float = 0.0,
                 writeback_error_rate: float = 0.0):
        rates = {"store_write_error_rate": store_write_error_rate,
                 "store_read_error_rate": store_read_error_rate,
                 "prefetch_error_rate": prefetch_error_rate,
                 "prefetch_delay_rate": prefetch_delay_rate,
                 "writer_error_rate": writer_error_rate,
                 "writeback_error_rate": writeback_error_rate}
        for key, val in rates.items():
            if not 0.0 <= float(val) <= 1.0:
                raise ValueError(f"chaos.infra.{key} must be in [0, 1]")
        if float(prefetch_delay_s) < 0.0:
            raise ValueError("chaos.infra.prefetch_delay_s must be >= 0")
        self.seed = int(seed)
        self.rates = {k: float(v) for k, v in rates.items()}
        self.prefetch_delay_s = float(prefetch_delay_s)
        self._calls = {name: 0 for name in self._STREAMS}
        self._calls["prefetch_delay"] = 0
        #: injected faults a surface
        self.counters: Dict[str, float] = {
            "store_write_faults": 0.0, "store_read_faults": 0.0,
            "prefetch_faults": 0.0, "prefetch_delays": 0.0,
            "writer_faults": 0.0, "writeback_faults": 0.0,
        }

    @property
    def enabled(self) -> bool:
        return any(v > 0.0 for v in self.rates.values())

    def _draw(self, surface: str, rate: float) -> bool:
        if surface == "prefetch_delay":
            key = [self.seed, _INFRA_PREFETCH_STREAM,
                   self._calls[surface], 1]
        else:
            key = [self.seed, self._STREAMS[surface], self._calls[surface]]
        self._calls[surface] += 1
        rng = np.random.default_rng(np.random.SeedSequence(key))
        return bool(rng.random() < rate)

    def fault(self, surface: str) -> bool:
        """Whether ``surface``'s next physical operation fails."""
        if self._draw(surface, self.rates[f"{surface}_error_rate"]):
            self.counters[f"{surface}_faults"] += 1
            return True
        return False

    def hook(self, surface: str):
        """A probe that raises ``OSError`` on a drawn fault (the ladder's
        ``fault_hooks``), or None when the surface's rate is 0."""
        if self.rates[f"{surface}_error_rate"] <= 0.0:
            return None

        def _probe() -> None:
            if self.fault(surface):
                raise OSError(
                    f"chaos: injected {surface} infra fault "
                    f"#{int(self.counters[f'{surface}_faults'])} "
                    f"({surface}_error_rate="
                    f"{self.rates[f'{surface}_error_rate']})")
        return _probe

    def prefetch_delay(self) -> float:
        """The seconds the prefetch worker stalls before staging a chunk
        (0.0 unless the delay stream draws one)."""
        if self._draw("prefetch_delay", self.rates["prefetch_delay_rate"]):
            self.counters["prefetch_delays"] += 1
            return self.prefetch_delay_s
        return 0.0

    def describe(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"enabled": self.enabled, "seed": self.seed}
        out.update(self.rates)
        out["prefetch_delay_s"] = self.prefetch_delay_s
        return out


class ChaosSchedule:
    """Seeded fault schedule, one a run; every method is deterministic
    given the constructor's arguments."""

    def __init__(self, seed: int = 0, dropout_rate: float = 0.0,
                 straggler_rate: float = 0.0,
                 straggler_inflation: float = 2.0,
                 ckpt_io_error_rate: float = 0.0,
                 preempt_at_round: Optional[int] = None,
                 corrupt_nan_rate: float = 0.0,
                 corrupt_scale_rate: float = 0.0,
                 corrupt_sign_flip_rate: float = 0.0,
                 corrupt_scale_factor: float = 10.0,
                 corrupt_sign_flip_scale: float = 1.0,
                 infra: Optional[InfraFaults] = None):
        if not 0.0 <= float(dropout_rate) <= 1.0:
            raise ValueError("chaos.dropout_rate must be in [0, 1]")
        if not 0.0 <= float(straggler_rate) <= 1.0:
            raise ValueError("chaos.straggler_rate must be in [0, 1]")
        if float(straggler_inflation) < 1.0:
            raise ValueError("chaos.straggler_inflation must be >= 1 "
                             "(it divides the steps a straggler completes "
                             "before the round barrier)")
        if not 0.0 <= float(ckpt_io_error_rate) <= 1.0:
            raise ValueError("chaos.ckpt_io_error_rate must be in [0, 1]")
        for key, val in (("corrupt_nan_rate", corrupt_nan_rate),
                         ("corrupt_scale_rate", corrupt_scale_rate),
                         ("corrupt_sign_flip_rate", corrupt_sign_flip_rate)):
            if not 0.0 <= float(val) <= 1.0:
                raise ValueError(f"chaos.{key} must be in [0, 1]")
        if float(corrupt_nan_rate) + float(corrupt_scale_rate) + \
                float(corrupt_sign_flip_rate) > 1.0:
            raise ValueError(
                "chaos corruption rates must sum to <= 1 (each client "
                "draws at most one corruption mode per round)")
        if float(corrupt_scale_factor) <= 0.0:
            raise ValueError("chaos.corrupt_scale_factor must be > 0")
        if float(corrupt_sign_flip_scale) <= 0.0:
            raise ValueError("chaos.corrupt_sign_flip_scale must be > 0")
        self.seed = int(seed)
        self.dropout_rate = float(dropout_rate)
        self.straggler_rate = float(straggler_rate)
        self.straggler_inflation = float(straggler_inflation)
        self.ckpt_io_error_rate = float(ckpt_io_error_rate)
        self.preempt_at_round = (None if preempt_at_round is None
                                 else int(preempt_at_round))
        self.corrupt_nan_rate = float(corrupt_nan_rate)
        self.corrupt_scale_rate = float(corrupt_scale_rate)
        self.corrupt_sign_flip_rate = float(corrupt_sign_flip_rate)
        self.corrupt_scale_factor = float(corrupt_scale_factor)
        self.corrupt_sign_flip_scale = float(corrupt_sign_flip_scale)
        #: the infrastructure faults (None without ``infra``)
        self.infra = infra
        #: IO-fault decisions drawn so far (the IO stream's index)
        self._io_calls = 0
        #: injected-fault totals, accumulated by the server from the
        #: round stats and by :meth:`io_fault`
        self.counters: Dict[str, float] = {
            "dropped": 0.0, "straggled": 0.0, "steps_lost": 0.0,
            "ckpt_io_faults": 0.0,
            "nan_injected": 0.0, "scaled": 0.0, "sign_flipped": 0.0,
        }

    @property
    def has_client_faults(self) -> bool:
        return self.dropout_rate > 0.0 or self.straggler_rate > 0.0

    @property
    def has_infra_faults(self) -> bool:
        return self.infra is not None and self.infra.enabled

    @property
    def has_corruption(self) -> bool:
        return (self.corrupt_nan_rate > 0.0 or
                self.corrupt_scale_rate > 0.0 or
                self.corrupt_sign_flip_rate > 0.0)

    def _rng(self, stream: int, round_no: int,
             salt: int = 0) -> np.random.Generator:
        """The round's stream; a non-zero ``salt`` (a bucket grid's index
        + 1 under cohort bucketing) keys a sub-stream of its own, and 0
        keeps the three-word key (``chaos.py:280-296``)."""
        key = [self.seed, stream, int(round_no)] + ([int(salt)] if salt
                                                    else [])
        return np.random.default_rng(np.random.SeedSequence(key))

    def client_faults(self, round_no: int, sample_mask: np.ndarray,
                      salt: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """``(drop [K] f32 in {0, 1}, keep_steps [K] f32)`` for the round's
        packed ``[K, S, B]`` sample mask (padding slots included).
        ``keep_steps`` is a straggler's step budget,
        ``max(ceil(real_steps / straggler_inflation), 1)``, and
        :data:`NO_BOUND` for everyone else.  Keyed on (seed, round, bucket
        ``salt``, client slot); the draw order is drop, then straggle."""
        k = int(sample_mask.shape[0])
        rng = self._rng(_CLIENT_STREAM, round_no, salt)
        drop = (rng.random(k) < self.dropout_rate).astype(np.float32)
        straggle = rng.random(k) < self.straggler_rate
        real_steps = (np.asarray(sample_mask).sum(axis=2) > 0).sum(axis=1)
        keep = np.where(
            straggle,
            np.maximum(np.ceil(real_steps / self.straggler_inflation), 1.0),
            NO_BOUND).astype(np.float32)
        return drop, keep

    def corrupt_modes(self, round_no: int, k: int,
                      salt: int = 0) -> np.ndarray:
        """``[K] int32`` corruption modes for the round: one uniform draw a
        client slot, partitioned into NaN, scale and sign-flip (at most one
        mode a client).  Padding and dropped slots draw too; the round
        applies a mode only to a live client."""
        u = self._rng(_CORRUPT_STREAM, round_no, salt).random(int(k))
        mode = np.full(int(k), CORRUPT_NONE, np.int32)
        hi = self.corrupt_nan_rate + self.corrupt_scale_rate + \
            self.corrupt_sign_flip_rate
        mode[u < hi] = CORRUPT_SIGN_FLIP
        mode[u < self.corrupt_nan_rate + self.corrupt_scale_rate] = \
            CORRUPT_SCALE
        mode[u < self.corrupt_nan_rate] = CORRUPT_NAN
        return mode

    def io_fault(self) -> bool:
        """One checkpoint-IO decision: True fails this physical write
        attempt.  The index advances on every call, so a retry of the same
        save draws afresh."""
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed, _IO_STREAM, self._io_calls]))
        self._io_calls += 1
        if rng.random() < self.ckpt_io_error_rate:
            self.counters["ckpt_io_faults"] += 1
            return True
        return False

    def io_fault_hook(self) -> None:
        """The checkpoint manager's write probe: raises a synthetic
        ``OSError`` when the stream says so."""
        if self.io_fault():
            raise OSError(
                f"chaos: injected checkpoint IO fault "
                f"#{int(self.counters['ckpt_io_faults'])} "
                f"(ckpt_io_error_rate={self.ckpt_io_error_rate})")

    def describe(self) -> Dict[str, Any]:
        """The schedule's record, as the JAX package writes it."""
        return {
            "enabled": True,
            "seed": self.seed,
            "dropout_rate": self.dropout_rate,
            "straggler_rate": self.straggler_rate,
            "straggler_inflation": self.straggler_inflation,
            "ckpt_io_error_rate": self.ckpt_io_error_rate,
            "preempt_at_round": self.preempt_at_round,
            "corrupt_nan_rate": self.corrupt_nan_rate,
            "corrupt_scale_rate": self.corrupt_scale_rate,
            "corrupt_sign_flip_rate": self.corrupt_sign_flip_rate,
            "corrupt_scale_factor": self.corrupt_scale_factor,
            "corrupt_sign_flip_scale": self.corrupt_sign_flip_scale,
            "infra": (self.infra.describe()
                      if self.infra is not None else None),
        }


def make_chaos(server_config) -> Optional[ChaosSchedule]:
    """The run's :class:`ChaosSchedule` from ``server_config.chaos`` (None
    when absent or ``enable: false``)."""
    raw = server_config.get("chaos") if server_config is not None else None
    if not raw:
        return None
    raw = dict(raw)
    if not raw.pop("enable", True):
        return None
    infra_raw = raw.get("infra")
    infra = None
    if infra_raw:
        if not isinstance(infra_raw, dict):
            raise ValueError("chaos.infra must be a mapping of "
                             "infrastructure fault rates")
        infra = InfraFaults(
            seed=raw.get("seed", 0),
            store_write_error_rate=infra_raw.get(
                "store_write_error_rate", 0.0),
            store_read_error_rate=infra_raw.get(
                "store_read_error_rate", 0.0),
            prefetch_error_rate=infra_raw.get("prefetch_error_rate", 0.0),
            prefetch_delay_rate=infra_raw.get("prefetch_delay_rate", 0.0),
            prefetch_delay_s=infra_raw.get("prefetch_delay_s", 0.05),
            writer_error_rate=infra_raw.get("writer_error_rate", 0.0),
            writeback_error_rate=infra_raw.get(
                "writeback_error_rate", 0.0))
    return ChaosSchedule(
        seed=raw.get("seed", 0),
        dropout_rate=raw.get("dropout_rate", 0.0),
        straggler_rate=raw.get("straggler_rate", 0.0),
        straggler_inflation=raw.get("straggler_inflation", 2.0),
        ckpt_io_error_rate=raw.get("ckpt_io_error_rate", 0.0),
        preempt_at_round=raw.get("preempt_at_round"),
        corrupt_nan_rate=raw.get("corrupt_nan_rate", 0.0),
        corrupt_scale_rate=raw.get("corrupt_scale_rate", 0.0),
        corrupt_sign_flip_rate=raw.get("corrupt_sign_flip_rate", 0.0),
        corrupt_scale_factor=raw.get("corrupt_scale_factor", 10.0),
        corrupt_sign_flip_scale=raw.get("corrupt_sign_flip_scale", 1.0),
        infra=infra,
    )
