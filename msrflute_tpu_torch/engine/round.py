"""One federated round on one device — the port's counterpart of the monolithic
path of ``msrflute_tpu/engine/round.py::RoundEngine._build_round_step``.

Per round: the K clients train at once (:mod:`.client_update`), the
strategy weighs and transforms each client's payload parts (FedAvg: its
sample count; DGA: softmax weight, local DP, quantization; FedLabels: a
supervised and an unsupervised part), the client mask zeroes padding
clients' weights, loss and sample counts, each part's weighted sums go
through ``strategy.combine_parts`` with the round's global params (with
the staleness split when the strategy defers clients,
``round.py:917-922, 988-1019``), and the server optimizer steps on the
aggregate pseudo-gradient — or, for a strategy that owns its server
update (FedAC, FedBuff), ``strategy.apply_server_update`` replaces that
step (``round.py:1408-1411``).  The clients start from
``strategy.broadcast_params`` (``round.py:1295``; FedAC's ``w_md``).

The defenses (``round.py:884-1016, 1213-1377``) ride the same round, in
the JAX package's order: the chaos faults fold into the masks (a dropped
client leaves the client mask, a straggler's late steps the sample mask),
a live client's corruption mode transforms its default payload, secure
aggregation encodes and masks it (:meth:`~..strategies.secure_agg.
SecureAgg.mask_parts`), fluteshield's screen quarantines with
``torch.where``, the masked part sums in the int32 group and the lost
clients' masks are recovered, and a robust strategy combines the screened
stack.  Without a ``chaos`` block (or with zero rates), ``robust`` block or
secure aggregation, the round is the one it always was, bit for bit.

The host-orchestrated rounds (SCAFFOLD, EF quantization, DGA's RL hook)
use the pair :meth:`RoundEngine.client_payloads` (the clients' weighted
payloads, with a per-client gradient offset) and
:meth:`RoundEngine.apply_custom_weights` (a server step on the payloads
under weights the caller picks), ``round.py:1554-1660``.  The server
optimizers are functional, so two calls of ``apply_custom_weights`` from
one state (the RL hook's candidates) both start from that state.

Chunked clients (``server_config.clients_per_chunk``, ``round.py:
233-240, 1050-1083``): with a chunk C smaller than the round's K clients
(C dividing K), the clients run C at a time: each chunk's slice of the
staged inputs goes through the client step, corruption and secure
aggregation's masks, and its part sums are added into the round's, so
the ``[K, P]`` stacks (payloads, the clients' copies and optimizer state)
exist at ``[C, P]`` only; kernel B1 launches once a chunk a local step.
The per-client ``[K]`` stats come back in client order.  The sums differ
from the unchunked round's in f32 reassociation only (secure
aggregation's int32 sums are exact).  The JAX package's refusals hold:
beside a carry path, fused RL, a ``robust`` block or ``dump_norm_stats``.
``dump_norm_stats`` (``round.py:1094-1115``) adds each client's default
payload norm and its cosine against the weighted sum of the payloads to
the round's stats, as ``[K]`` vectors (``dump_norm``, ``dump_cosine``).

Device-resident carry (``server_config.fused_carry``, ``round.py:786-1410``):
a ``device_carry`` strategy's client step gathers the cohort's rows of its
tables from ``strategy_state`` by the staged client ids and returns the
round's carry rows with their ``keep`` gate (``valid * live``, chaos's
dropped clients out; the shield does not gate them, as in the JAX
round); :meth:`~..strategies.base.BaseStrategy.apply_carry` scatters them
after the combine, before the server step, into new tables: the round
never writes the state in place.  Under the fleet paged carry
(``round.py:259-273``) the tables are the page pool's ``[slots, ...]``
and the staged row ids are the pager's ``carry_slots`` (the clients'
generators keep their true ids, so a client's math is the same whichever
slot holds its row).  Fused RL (``wantRL`` with ``fused_carry``,
``round.py:287-338, 1378-1392``) replaces the combine with the DQN tuner
of :mod:`..rl.fused` on the payload stack.

Dispatch and drain (``round.py:58-87, 340-346, 1713-2029``):
:meth:`RoundEngine.dispatch_rounds` launches a chunk of R rounds back to
back with no host sync and returns the new state with a lazy
:class:`PackedStats`; :meth:`RoundEngine.run_round` is
``dispatch_rounds([batch])`` then ``fetch()``.  With ``input_staging``
(the default) the chunk's host inputs — feature grids, masks, chaos
vectors, staleness coins — are packed into one pinned buffer per dtype
group (:class:`..utils.flatpack.AxisPacker`) and cross in one
``non_blocking`` copy each; the buffers come from PyTorch's caching host
allocator, which reuses a block only once the copy out of it has
finished, so the host packs chunk k+1 while chunk k's copy may still be in
flight.  The learning
rates, round indices and thresholds stay Python numbers: they reach the
kernels as arguments by value and need no copy.  The round stats are
packed on the device into one buffer per dtype group
(:class:`..utils.flatpack.FlatPacker`) and cross once a chunk, through
pinned memory, behind an event.  The server's state is never written in
place (the optimizers are functional, B1 writes only the clients' ``[K,
P]`` copy), so a dispatched chunk's state stays valid while later chunks
run.

Cohort bucketing (``server_config.cohort_bucketing``, ``round.py:
469-519, 2031-2940``): :meth:`RoundEngine.dispatch_bucketed_rounds` takes
each round as a list of bucket grids ``[K_b, S_b, B]``; every grid runs
the client phase on its own (its chaos faults, corruption, and secure
aggregation's masks toward its own clients), its part sums are added in
ascending bucket order, the lost clients' masks are recovered a grid at a
time, and under a ``robust`` block the grids' stacks are concatenated and
screened against the whole cohort.  A grid that carries a megabatch tape
(``server_config.megabatch``) trains through the lane scan
(:func:`.client_update.build_mega_update`), handed to the strategy's
unchanged client step in place of the client update.  A client's streams
are keyed on its id, so its update does not depend on its grid.

The device-resident sample pool (``data_config.train.device_resident``,
``round.py:743-757, 826-840, 1910-1944, 2094-2102``):
:meth:`RoundEngine.attach_pool` uploads the flat pool
(``data.batching.build_sample_pool``) to the engine's device once; a round
then stages each grid's ``[K, S, B]`` int32 pool indices (the ``idx`` leaf
of the pinned int32 group) in place of its feature rows, and the client
step gathers the rows on the device, where it runs: a chunk at a time
under ``clients_per_chunk``, a bucket grid at a time under cohort
bucketing, before the lane scan under megabatching.  The gather zeroes
padding slots with ``torch.where`` by the grid's packed sample mask, so
the rows are the host packer's bit for bit (a masked product would give
-0.0 for a negative feature and NaN for a NaN one).  A batch of the other
kind raises "round engine pool mode mismatch".

Randomness, all from ``np.random.SeedSequence`` entropy, so a resumed run
needs only the round number and the numpy sampling state to replay every
stream:

- ``[seed, r, k]``: client k's dropout masks in round r (the analogue of
  ``fold_in(rng, client_id)`` at ``round.py:851``);
- ``[seed, r, k, 2]``: client k's local-DP noise (``fold_in(rng_c, 2)``);
- ``[seed, r, k, 3]``: client k's staleness coin (``fold_in(rng_c, 3)``);
- ``[seed, r, 2**32 - 1, 4]``: the round's server stream, global DP's
  kernel seed (no dataset index reaches client slot ``2**32 - 1``);
  ``[seed, r, 2**32 - 1, 4, 29]`` fused RL's draws, and ``[seed, 0,
  2**32 - 1, 4, 15]`` its net's init;
- ``[seed, r, k, 104729]``: client k's local pass under personalization's
  carry (``fold_in(rng_c, 104729)``).
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.batching import IndexRoundBatch, RoundBatch
from ..device import chip_bytes_per_sec, chip_peak_flops
from ..models.base import BaseTask, Params
from ..optim import make_optimizer
from ..resilience.chaos import CORRUPT_NAN, CORRUPT_SCALE, CORRUPT_SIGN_FLIP
from ..robust import make_shield
from ..strategies.base import BaseStrategy
from ..strategies.secure_agg import wrap_int32
from ..telemetry import devbus_config_enabled, xla_config_enabled
from ..telemetry.devbus import DeviceMetricBus
from ..telemetry.xla import XlaIntrospector, roofline_secs, structural_key
from ..traffic import STALE_HIST_BINS
from ..utils.flatpack import AxisPacker, FlatPacker
from ..utils.strict import allow_sync
from .client_update import (ClientHParams, build_client_update,
                            build_mega_update)


#: stream tags (the fourth entropy word) and the server's client slot
DP_NOISE_TAG, STALE_COIN_TAG, SERVER_TAG = 2, 3, 4
PAD_CLIENT, SERVER_SLOT = 2**32, 2**32 - 1
#: fused RL's streams, the fifth word after the round's server stream:
#: the round's draws (``fold_in(rng, 29)``) and, at round 0, the net's
#: init (``fold_in(rng, 0xF)``)
RL_DRAW_SALT, RL_INIT_SALT = 29, 0xF


def stream_seed(*entropy: int) -> int:
    """A 63-bit seed from ``SeedSequence(entropy)``."""
    return int(np.random.SeedSequence(list(entropy)).generate_state(
        1, dtype=np.uint64)[0] >> np.uint64(1))


@dataclass
class ServerState:
    """Global model (flat ``[P]``), server optimizer state, round, and the
    strategy's cross-round state (DGA's staleness sums)."""

    params: torch.Tensor
    opt_state: Dict[str, torch.Tensor]
    round: int = 0
    strategy_state: Dict[str, torch.Tensor] = field(default_factory=dict)


#: staged leaves start on the caching allocator's 512-byte boundary, where
#: a leaf copied on its own would start: a library kernel that picks its
#: algorithm by alignment then picks the same one either way
STAGE_ALIGN_BYTES = 512


def to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """One host-to-device copy: ``non_blocking`` from pinned memory (the
    host does not wait), a plain ``.to`` otherwise; on the CPU the tensor
    itself."""
    return host.to(device, non_blocking=host.is_pinned())


@dataclass
class PackedStats:
    """One chunk's round stats, packed on the device into one buffer per
    dtype group and copied into pinned host memory behind ``event``
    (``round.py:58-87``).  Nothing waits until :meth:`fetch`."""

    host: Dict[str, torch.Tensor]   #: ``{dtype: 1-D host buffer}``
    packer: FlatPacker              #: the chunk's slot table
    rounds: int
    event: Optional[Any] = None     #: ``torch.cuda.Event`` after the copy

    def fetch(self) -> List[Dict[str, Any]]:
        """Wait for the copy, then decode: one dict a round, as
        :meth:`RoundEngine.run_round` returns it."""
        if self.event is not None:
            self.event.synchronize()
        rounds = self.packer.unpack_np(
            {dt: t.numpy() for dt, t in self.host.items()})
        return [_decode_stats(r) for r in rounds]


#: the per-client ``[K]`` norm dumps among the round's stats
DUMP_KEYS = ("dump_norm", "dump_cosine")


def _decode_stats(stats: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Scalars to floats; each ``privacy_*`` key's ``[K]`` values and the
    client mask under ``"privacy"``; the norm dumps' ``[K]`` values as
    arrays."""
    out: Dict[str, Any] = {}
    privacy = {k: np.array(v) for k, v in stats.items()
               if k.startswith("privacy_")}
    if privacy:
        privacy["client_mask"] = np.array(stats["client_mask"])
        out["privacy"] = privacy
    out.update((k, np.array(v)) for k, v in stats.items() if k in DUMP_KEYS)
    out.update((k, float(v)) for k, v in stats.items()
               if not k.startswith("privacy_") and k != "client_mask"
               and k not in DUMP_KEYS)
    return out


def _add_part_sums(acc: Dict[str, dict], new: Dict[str, dict],
                   unit_parts) -> Dict[str, dict]:
    """A chunk's part sums added into the round's; a unit-weight part's
    int32 sum wraps in the group."""
    if not acc:
        return {name: dict(d) for name, d in new.items()}
    for name, d in new.items():
        for key, v in d.items():
            if key == "grad_sum" and name in unit_parts:
                acc[name][key] = wrap_int32(acc[name][key].to(torch.int64)
                                            + v.to(torch.int64))
            else:
                acc[name][key] = acc[name][key] + v
    return acc


def _rows(tree: Dict[str, Any], lo: int, hi: int) -> Dict[str, Any]:
    """Clients ``lo:hi`` of a round's staged inputs (views, no copy)."""
    return {k: (_rows(v, lo, hi) if isinstance(v, dict) else v[lo:hi])
            for k, v in tree.items()}


def pallas_apply_flag(server_config) -> bool:
    """``server_config.megakernel.pallas_apply`` as the JAX engine reads it:
    opt-in, and off under ``enable: false``.  (``fused_epochs`` changes
    only how the JAX package traces its loop; the port's loop is the same
    math either way.)"""
    raw = server_config.get("megakernel") or {}
    return bool(raw.get("enable", True)) and bool(raw.get("pallas_apply",
                                                          False))


def precision_policy(server_config) -> Dict[str, str]:
    """``server_config.precision`` -> ``{"params"|"compute"|"stats":
    dtype name}``: empty when absent or ``enable: false``."""
    raw = server_config.get("precision") or {}
    if not raw or not bool(raw.get("enable", True)):
        return {}
    return {k: str(raw[k]) for k in ("params", "compute", "stats")
            if raw.get(k) is not None}


class RoundEngine:
    def __init__(self, task: BaseTask, config, strategy: BaseStrategy,
                 device: torch.device, seed: int = 0):
        self.task = task
        self.strategy = strategy
        strategy.task = task
        self.device = device
        self.seed = int(seed)
        self.layout = task.layout()
        #: the leaves' offsets in the flat vector, then its length
        self.bounds = list(self.layout.offsets) + [self.layout.numel]
        cc, sc = config.client_config, config.server_config
        freeze = cc.get("freeze_layer") or []
        if isinstance(freeze, str):
            freeze = [freeze]
        #: the precision policy as the JAX engine normalizes it
        #: (``round.py:185-197``): off under ``enable: false``, else each
        #: dtype given
        self.precision = precision_policy(sc)
        self.hparams = ClientHParams(
            max_grad_norm=cc.get("max_grad_norm"),
            fedprox_mu=float(cc.get("fedprox_mu", 0.0) or 0.0),
            num_epochs=int(cc.get("num_epochs", 1) or 1),
            pallas_apply=pallas_apply_flag(sc),
            freeze_layers=tuple(freeze),
            param_dtype=self.precision.get("params"),
            compute_dtype=self.precision.get("compute"),
            stats_dtype=self.precision.get("stats"))
        self.client_update = build_client_update(
            task, cc.optimizer_config, self.hparams)
        self.server_opt = make_optimizer(sc.optimizer_config)
        self.server_max_grad_norm = sc.get("max_grad_norm")
        self.random = task.draws_random
        #: local steps run so far (num_epochs x S per round): the number of
        #: optimizer-tail passes, hence of kernel B1 launches with
        #: pallas_apply
        self.local_steps = 0
        # chaos client faults and corruption (``round.py:364-386``): read
        # from the config block, so a zero-rate block runs the round of no
        # block; the server draws the vectors
        chaos = sc.get("chaos") or {}
        chaos_on = bool(chaos) and bool(chaos.get("enable", True))
        self.chaos_client_faults = chaos_on and any(
            float(chaos.get(k, 0.0) or 0.0) > 0.0
            for k in ("dropout_rate", "straggler_rate"))
        self.chaos_corruption = chaos_on and any(
            float(chaos.get(k, 0.0) or 0.0) > 0.0
            for k in ("corrupt_nan_rate", "corrupt_scale_rate",
                      "corrupt_sign_flip_rate"))
        self.corrupt_scale = float(chaos.get("corrupt_scale_factor", 10.0)
                                   or 10.0)
        self.corrupt_flip_scale = float(
            chaos.get("corrupt_sign_flip_scale", 1.0) or 1.0)
        #: fluteshield's screening (``round.py:411-467``); None without a
        #: ``robust`` block
        self.shield = make_shield(sc)
        if self.shield is not None:
            self._check_shield(strategy)
        #: ``server_config.input_staging`` (``round.py:340-346``): one
        #: pinned buffer and one copy per dtype group a chunk; off, one
        #: copy a leaf
        self.input_staging = bool(sc.get("input_staging", True))
        #: host seconds the last dispatch spent packing and enqueueing its
        #: inputs
        self.last_stage_secs = 0.0
        #: fused RL (``wantRL`` with ``fused_carry``, ``round.py:287-338``):
        #: the DQN tuner re-weights the payload stack in the round, its
        #: state in ``strategy_state``; None otherwise
        self.fused_rl = None
        if sc.get("wantRL", False) and sc.get("fused_carry", False):
            from ..config import RLConfig
            from ..rl.fused import FusedRL
            self.fused_rl = FusedRL(
                sc.get("RL") or RLConfig(),
                int(sc.get("num_clients_per_iteration", 10)))
        #: per-client payload norms and cosines in the round's stats
        self.dump_norm_stats = bool(config.get(
            "dump_norm_stats", sc.get("dump_norm_stats", False)))
        #: clients a chunk of the client phase (None: all K at once)
        cpc = sc.get("clients_per_chunk")
        self.clients_per_chunk = int(cpc) if cpc else None
        self._check_chunks(strategy)
        #: the arrival plane's traced staleness (``round.py:395-409``): with
        #: ``traffic.mode: buffered`` and a strategy that takes it, each
        #: round stages a per-client int32 operand beside the chaos
        #: vectors, and its histogram and sum come back with the stats
        tr = sc.get("traffic") or {}
        self.traffic_staleness = bool(
            tr and tr.get("enable", True) and
            str(tr.get("mode", "buffered")) == "buffered" and
            strategy.supports_traced_staleness)
        if self.traffic_staleness and self.clients_per_chunk:
            raise ValueError(
                "server_config.traffic traced staleness cannot compose "
                "with clients_per_chunk: the chunk scan's operand tuple "
                "is fixed per chunk — disable one of them")
        #: cohort bucketing (``round.py:469-519``): the round's clients on
        #: per-bucket grids, :meth:`dispatch_bucketed_rounds`
        cb = sc.get("cohort_bucketing") or {}
        self.cohort_bucketing = bool(cb) and bool(cb.get("enable", True))
        mb = cb.get("max_buckets")
        self.bucket_max = 4 if mb is None else int(mb)
        #: cross-client megabatching (``round.py:520-566``): a bucket grid
        #: with a tape trains through the lane scan
        mgb = sc.get("megabatch") or {}
        self.megabatch = bool(mgb) and bool(mgb.get("enable", True))
        self.mega_update = None
        self._check_throughput(strategy, config)
        if self.megabatch:
            self.mega_update = build_mega_update(
                task, cc.optimizer_config, self.hparams)
        #: the device-resident sample pool (:meth:`attach_pool`): ``{key:
        #: [total_samples, *feat]}`` on the engine's device, or None
        self._pool: Optional[Dict[str, torch.Tensor]] = None
        #: the pool's bytes on the device and the upload's host seconds
        self.pool_bytes = 0
        self.pool_upload_secs = 0.0
        #: the arm each ``(K_b, S_b)`` grid ran ("mega" or "vmap")
        self.mega_gate: Dict[Tuple[int, int], str] = {}
        #: ``megabatch.autotune`` (``round.py:536``): under
        #: ``telemetry.xla`` a tape grid's first geometry runs both arms,
        #: counted, and keeps the one with the smaller roofline time
        self.megabatch_autotune = bool(mgb.get("autotune", True))
        self._autotuned: Dict[Tuple[int, int], str] = {}
        #: buffered ``megabatch_fallback`` records, drained by the server
        self._mega_events: List[Dict[str, Any]] = []
        #: the ``(K_b, S_b)`` geometries of the bucket grids dispatched
        self.bucket_shapes_seen: set = set()
        #: host-to-device copies of the last dispatch, a round
        self.last_dispatch_puts = 0
        tel = sc.get("telemetry")
        #: the device-metric bus (``telemetry.devbus``): the engine's
        #: ``update_ratio`` and the strategies' scalars ride the stats
        self.devbus = DeviceMetricBus(devbus_config_enabled(tel))
        strategy.devbus = self.devbus
        #: the device-truth layer (``telemetry.xla``); None when off
        self.xla = (XlaIntrospector(device) if xla_config_enabled(tel)
                    else None)
        #: entry-point names, one a new operand signature — always on
        #: (the sentinel's events, with their diffs, need ``xla``)
        self.compile_log: List[str] = []
        self._signatures: Dict[str, set] = {}

    def _check_chunks(self, strategy: BaseStrategy) -> None:
        """The JAX engine's refusals of ``clients_per_chunk``
        (``round.py:235-255, 318-322, 442-447``)."""
        if not self.clients_per_chunk:
            return
        if self.dump_norm_stats:
            raise ValueError(
                "clients_per_chunk is incompatible with dump_norm_stats: "
                "per-client cosines need every payload against the final "
                "aggregate, which chunked accumulation never materializes "
                "— disable one of them")
        if strategy.device_carry:
            raise ValueError(
                "fused_carry is incompatible with clients_per_chunk: the "
                "carry scatter needs every client's update row, which "
                "chunked accumulation never materializes — disable one")
        if self.fused_rl is not None:
            raise ValueError(
                "fused RL is incompatible with clients_per_chunk: "
                "re-weighting needs the full payload stack")
        if self.shield is not None:
            raise ValueError(
                "server_config.robust is incompatible with "
                "clients_per_chunk: median-of-norms screening (and "
                "the trimmed-mean/median payload stack) needs every "
                "client's payload against the full cohort, which "
                "chunked accumulation never materializes — disable "
                "one of them")

    def _check_throughput(self, strategy: BaseStrategy, config) -> None:
        """The JAX engine's refusals of ``cohort_bucketing``
        (``round.py:485-519``) and ``megabatch`` (``:538-566``)."""
        if self.cohort_bucketing:
            if self.bucket_max < 1:
                raise ValueError("cohort_bucketing.max_buckets must be >= 1")
            if self.clients_per_chunk:
                raise ValueError(
                    "cohort_bucketing is incompatible with "
                    "clients_per_chunk: the chunk scan assumes one grid "
                    "shape per round — pick one HBM/FLOP bounding scheme")
            if self.dump_norm_stats:
                raise ValueError(
                    "cohort_bucketing is incompatible with "
                    "dump_norm_stats: per-client cosines need every "
                    "payload against the final aggregate inside ONE "
                    "program — disable one of them")
            if self.fused_rl is not None:
                raise ValueError(
                    "cohort_bucketing does not compose with fused RL: "
                    "the DQN re-weighting assumes the single-grid payload "
                    "stack — drop wantRL or cohort_bucketing")
            if not self.input_staging:
                raise ValueError(
                    "cohort_bucketing requires input_staging (the "
                    "legacy per-leaf dispatch path is kept only for the "
                    "staging A/B) — drop `input_staging: false`")
            if self.shield is not None and strategy.stale_prob > 0:
                raise ValueError(
                    "cohort_bucketing + robust screening does not "
                    "support stale_prob > 0")
        if not self.megabatch:
            return
        if not self.cohort_bucketing:
            raise ValueError(
                "megabatch requires cohort_bucketing: the super-"
                "batch tape repacks the per-bucket step grids — add "
                "the cohort_bucketing block or drop megabatch")
        pm = getattr(config, "privacy_metrics_config", None)
        if pm is not None and pm.get("apply_metrics", False):
            raise ValueError(
                "megabatch is incompatible with privacy_metrics_"
                "config.apply_metrics: the attack metrics replay "
                "each client's own batches against its payload, "
                "which the fused lane scan no longer materializes "
                "per client — disable one of them")
        if not strategy.supports_megabatch:
            raise ValueError(
                f"megabatch does not compose with "
                f"{type(strategy).__name__}: its training loop "
                "steps outside the client_update contract the lane "
                "scan reproduces (fedlabels' dual sup/unsup "
                "passes) — drop megabatch")
        if self.hparams.pallas_apply:
            raise ValueError(
                "megabatch is incompatible with megakernel."
                "pallas_apply: the flat fused kernel has no "
                "segment-reset lane — drop one of them")

    def _entry(self, name: str, operands: Any, fn, rounds: int = 1):
        """``fn()`` as a dispatch of entry point ``name``: its first
        call with a new operand signature is a compile (counted by the
        device-truth layer when it is on, ``round.py:629-636``)."""
        key = structural_key(operands)
        seen = self._signatures.setdefault(name, set())
        fresh = key not in seen
        if fresh:
            seen.add(key)
            self.compile_log.append(name)
        if self.xla is None:
            return fn()
        return self.xla.dispatch(name, key, operands, fn, rounds=rounds,
                                 fresh=fresh)

    @property
    def recompile_count(self) -> int:
        """New signatures beyond the first an entry point (the always-on
        counter, ``round.py:681-687``)."""
        return len(self.compile_log) - len(set(self.compile_log))

    @staticmethod
    def _state_operands(state: ServerState) -> Dict[str, Any]:
        return {"params": state.params, "opt_state": state.opt_state,
                "strategy_state": state.strategy_state}

    def push_megabatch_event(self, rec: Dict[str, Any]) -> None:
        """Buffer one ``megabatch_fallback`` record (at most 64 undrained,
        ``round.py:646-653``)."""
        if len(self._mega_events) < 64:
            self._mega_events.append(dict(rec))

    def drain_megabatch_events(self) -> List[Dict[str, Any]]:
        out, self._mega_events = self._mega_events, []
        return out

    def _check_shield(self, strategy: BaseStrategy) -> None:
        """The JAX engine's refusals of a ``robust`` block."""
        from ..strategies.fedavg import FedAvg
        from ..strategies.robust import RobustFedAvg
        from ..strategies.secure_agg import SecureAgg
        if type(strategy) not in (FedAvg, RobustFedAvg, SecureAgg):
            raise ValueError(
                "server_config.robust requires strategy: fedavg/"
                f"fedprox/secure_agg — {type(strategy).__name__} "
                "aggregates through its own payload parts and would "
                "bypass the screening")
        if isinstance(strategy, SecureAgg) and self.shield.wants_stack:
            raise ValueError(
                f"robust.aggregator={self.shield.aggregator!r} sorts "
                "per-client payload coordinates, but secure_agg "
                "submissions are masked int32 group elements — only "
                "the SUM is meaningful.  Use aggregator: mean (norm "
                "screening still applies, on submitted norms)")
        if getattr(strategy, "adaptive_clip", None) is not None:
            raise ValueError(
                "server_config.robust is incompatible with "
                "dp_config.adaptive_clipping: quarantined clients' "
                "below-clip votes would still steer the clip "
                "quantile — use a fixed max_grad or drop the robust "
                "block")
        if self.shield.wants_stack and not strategy.wants_client_stack:
            raise ValueError(
                f"robust.aggregator={self.shield.aggregator!r} needs "
                "the stack-combining RobustFedAvg strategy "
                "(strategies/robust.py); the server wires this — "
                "constructing RoundEngine directly, pass it yourself")

    def init_state(self, params: Params) -> ServerState:
        flat = self.layout.flatten(params).to(self.device, torch.float32)
        strategy_state = self.strategy.init_state(flat)
        if self.fused_rl is not None:
            strategy_state = dict(strategy_state)
            strategy_state.update(self.fused_rl.init_state(
                stream_seed(self.seed, 0, SERVER_SLOT, SERVER_TAG,
                            RL_INIT_SALT), self.device))
        return ServerState(flat, self.server_opt.init(flat), 0,
                           strategy_state)

    def params_dict(self, state: ServerState) -> Params:
        return self.layout.views(state.params)

    def client_generators(self, round_idx: int, client_ids,
                          tag: Optional[int] = None) -> List[torch.Generator]:
        """One generator per client on the engine's device: the dropout
        stream (no tag) or a tagged one."""
        gens = []
        for cid in np.asarray(client_ids).tolist():
            entropy = [self.seed, int(round_idx),
                       cid if cid >= 0 else PAD_CLIENT]
            if tag is not None:
                entropy.append(tag)
            gens.append(torch.Generator(device=self.device).manual_seed(
                stream_seed(*entropy)))
        return gens

    def stale_coins(self, round_idx: int, client_ids) -> np.ndarray:
        """Client k is deferred when its ``[seed, r, k, 3]`` uniform falls
        below ``stale_prob`` (``jax.random.bernoulli``'s rule)."""
        p = self.strategy.stale_prob
        return np.asarray([
            np.random.default_rng(stream_seed(
                self.seed, int(round_idx), cid if cid >= 0 else PAD_CLIENT,
                STALE_COIN_TAG)).random() < p
            for cid in np.asarray(client_ids).tolist()], np.float32)

    def server_seed(self, round_idx: int) -> int:
        return stream_seed(self.seed, int(round_idx), SERVER_SLOT,
                           SERVER_TAG)

    def rl_generator(self, round_idx: int) -> torch.Generator:
        """Fused RL's draws of the round, on the engine's device."""
        return torch.Generator(device=self.device).manual_seed(stream_seed(
            self.seed, int(round_idx), SERVER_SLOT, SERVER_TAG,
            RL_DRAW_SALT))

    def attach_pool(self, pool_arrays: Dict[str, np.ndarray]) -> None:
        """Upload the flat sample pool (``data.batching.build_sample_pool``)
        to the engine's device once and switch the rounds to pool mode:
        their inputs become ``[K, S, B]`` int32 indices, gathered on the
        device (``round.py:743-757``)."""
        tic = time.perf_counter()
        self._pool = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            self.device) for k, v in pool_arrays.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.pool_upload_secs = time.perf_counter() - tic
        self.pool_bytes = sum(t.numel() * t.element_size()
                              for t in self._pool.values())

    @property
    def pool_mode(self) -> bool:
        return self._pool is not None

    def _gather_pool(self, idx: torch.Tensor,
                     sample_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The feature rows of a staged index grid, gathered from the pool
        on the device; padding slots (``sample_mask`` 0, index 0) hold
        +0.0 as host packing writes them."""
        flat = idx.reshape(-1).to(torch.int64)
        live = sample_mask.reshape(-1) > 0
        out = {}
        for k, pool in self._pool.items():
            rows = pool.index_select(0, flat)
            keep = live.reshape((-1,) + (1,) * (pool.dim() - 1))
            rows = torch.where(keep, rows, torch.zeros(
                (), dtype=rows.dtype, device=rows.device))
            out[k] = rows.reshape(tuple(idx.shape) + tuple(pool.shape[1:]))
        return out

    def _host_inputs(self, round_idx: int, batch,
                     chaos: Optional[Dict[str, np.ndarray]]
                     ) -> Dict[str, Any]:
        """A round's host operands: the feature grids (in pool mode the
        index grid ``idx``), the masks, the chaos vectors and the
        staleness coins."""
        is_idx = isinstance(batch, IndexRoundBatch)
        if is_idx != self.pool_mode:
            raise ValueError(
                "round engine pool mode mismatch: "
                f"batch={'indices' if is_idx else 'arrays'} but pool "
                f"{'attached' if self.pool_mode else 'absent'}")
        tree: Dict[str, Any] = ({"idx": batch.indices} if is_idx
                                else {"arrays": dict(batch.arrays)})
        tree.update(sample_mask=batch.sample_mask,
                    client_mask=batch.client_mask)
        for key in ("drop", "keep", "corrupt", "traffic_stale"):
            if chaos is not None and key in chaos:
                tree[key] = chaos[key]
        if self.strategy.stale_prob > 0.0:
            tree["stale"] = self.stale_coins(round_idx, batch.client_ids)
        if self.strategy.device_carry:
            # the carry tables' row ids, and each slot's source for the
            # scatter: itself, or for a padding slot the first real one
            # (see strategies/base.py::scatter_rows).  Under the fleet
            # paged carry the rows are the pager's slots; the generators
            # keep the true client ids
            ids = np.asarray(self._carry_rows_of(batch), np.int64)
            src = np.arange(len(ids), dtype=np.int64)
            real = np.flatnonzero(ids >= 0)
            if real.size:
                src[ids < 0] = real[0]
            tree["carry_ids"], tree["carry_src"] = ids, src
        return tree

    def _carry_rows_of(self, batch) -> np.ndarray:
        """The batch's carry table rows: its page-pool slots under the
        fleet paged carry (a batch the pager did not prepare raises, as
        ``round.py:1900-1910`` does), else its client ids."""
        if not self.strategy.carry_rows:
            return batch.client_ids
        slots = getattr(batch, "carry_slots", None)
        if slots is None:
            raise ValueError(
                "fleet paged carry: batch has no carry_slots — the "
                "CarryPager must prepare every chunk before dispatch")
        return slots

    def stage_inputs(self, round0: int, batches: List[RoundBatch],
                     chaos_vecs: Optional[list] = None
                     ) -> List[Dict[str, Any]]:
        """The chunk's host operands on the device, one dict a round.
        Staged: one pinned buffer per dtype group, filled in place and
        copied once (``round.py:1713-1843``); else one copy a leaf."""
        chaos_vecs = chaos_vecs or [None] * len(batches)
        return self._stage([self._host_inputs(round0 + j, b, c)
                            for j, (b, c) in enumerate(zip(batches,
                                                           chaos_vecs))])

    def _stage(self, host: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Host trees to device trees, staged or a copy a leaf."""
        dev = self.device
        if not self.input_staging:
            self.last_dispatch_puts = sum(
                len(v) if k == "arrays" else 1
                for tree in host for k, v in tree.items())
            return [{k: ({a: to_device(torch.from_numpy(x), dev)
                          for a, x in v.items()} if k == "arrays"
                         else to_device(torch.from_numpy(v), dev))
                     for k, v in tree.items()} for tree in host]
        packer = AxisPacker(host, lead_ndim=0,
                            align_bytes=STAGE_ALIGN_BYTES)
        self.last_dispatch_puts = len(packer.buffer_shapes())
        if dev.type == "cuda":
            # the caching host allocator records each copy's stream on its
            # block: a freed buffer is handed out again only once its copy
            # has finished
            bufs = {dt: torch.empty(shape, dtype=getattr(torch, dt),
                                    pin_memory=True)
                    for dt, shape in packer.buffer_shapes().items()}
            packer.pack_np(host, out={dt: b.numpy()
                                      for dt, b in bufs.items()})
            staged = {dt: to_device(b, dev) for dt, b in bufs.items()}
        else:
            staged = {dt: to_device(torch.from_numpy(b), dev)
                      for dt, b in packer.pack_np(host).items()}
        return packer.unpack(staged)

    def _client_step(self, state: ServerState, batch: RoundBatch,
                     inputs: Dict[str, Any], global_flat: torch.Tensor,
                     client_lr: float, quant_threshold: Optional[float],
                     leakage_threshold: Optional[float],
                     grad_offsets: Optional[torch.Tensor] = None,
                     masks: Optional[Tuple[torch.Tensor,
                                           torch.Tensor]] = None,
                     ids: Optional[np.ndarray] = None,
                     update=None):
        """The strategy's client step on the round's staged ``inputs`` ->
        ``(parts, train_loss, num_samples, stats, client_mask, carry)``,
        ``carry`` the carry rows of a ``device_carry`` strategy (else
        None).  ``masks`` replaces the inputs' ``(sample_mask,
        client_mask)`` (the round's chaos faults folded in); ``ids`` are
        the clients' ids when ``inputs`` hold a chunk of the round's;
        ``update`` replaces the client update (the megabatch lane scan)."""
        r = state.round
        strategy = self.strategy
        if masks is None:
            masks = (inputs["sample_mask"], inputs["client_mask"])
        if ids is None:
            ids = batch.client_ids
        if update is None:
            update = self.client_update
        sample_mask, cm = masks
        arrays = (self._gather_pool(inputs["idx"], inputs["sample_mask"])
                  if "idx" in inputs else inputs["arrays"])
        gens = self.client_generators(r, ids) if self.random else None
        self.local_steps += (self.hparams.num_epochs * sample_mask.shape[1]
                             * strategy.client_passes)
        kw = dict(quant_threshold=quant_threshold,
                  client_rngs=lambda tag: self.client_generators(
                      r, ids, tag), bounds=self.bounds,
                  round_idx=r, leakage_threshold=leakage_threshold)
        if self.traffic_staleness:
            # the live clients' true staleness (padding and dropped: 0)
            kw["staleness"] = torch.where(
                cm > 0, inputs["traffic_stale"].to(torch.int64), 0)
        if strategy.device_carry:
            # the live mask: sampled, less chaos's dropped clients
            # (``round.py:853-866``)
            parts, tl, ns, stats, carry = strategy.client_step_carry(
                update, global_flat, arrays,
                sample_mask, client_lr, gens, client_ids=inputs["carry_ids"],
                live_mask=cm, strategy_state=state.strategy_state, **kw)
            return parts, tl, ns, stats, cm, carry
        parts, tl, ns, stats = strategy.client_step(
            update, global_flat, arrays, sample_mask,
            client_lr, gens, strategy_state=state.strategy_state,
            grad_offset=grad_offsets, **kw)
        return parts, tl, ns, stats, cm, None

    def _server_clip(self, agg: torch.Tensor) -> torch.Tensor:
        if self.server_max_grad_norm is None:
            return agg
        norm = torch.linalg.vector_norm(agg)
        return agg * torch.clamp(float(self.server_max_grad_norm)
                                 / torch.clamp(norm, min=1e-12), max=1.0)

    def client_payloads(self, state: ServerState, batch: RoundBatch,
                        client_lr: float,
                        grad_offsets: Optional[torch.Tensor] = None,
                        leakage_threshold: Optional[float] = None):
        """Per-client ``(pseudo_grad [K, P], weight [K], train_loss [K],
        stats)`` from the server's params, padding clients' weight and
        loss zeroed — the payload program of the host-orchestrated rounds
        (``msrflute_tpu/engine/round.py:1554-1632``).  ``grad_offsets``
        (``[K, P]`` on the engine's device, zero rows for padding clients)
        goes to every local step's gradient (SCAFFOLD's ``c - c_i``)."""
        host = self._host_inputs(state.round, batch, None)

        def payloads():
            inputs = self._stage([host])[0]
            parts, tl, _, stats, cm, _ = self._client_step(
                state, batch, inputs, state.params, client_lr, None,
                leakage_threshold, grad_offsets)
            pg, w = parts["default"]
            return pg, w * cm, tl * cm, stats

        name = "payload_step" if grad_offsets is None else "payload_step_off"
        return self._entry(name, (self._state_operands(state), host,
                                  grad_offsets), payloads)

    def apply_custom_weights(self, state: ServerState, pgs: torch.Tensor,
                             weights, server_lr: float) -> ServerState:
        """The server step on ``sum_k w_k pg_k / sum_k w_k`` (reference
        ``dga.py:317-332``; ``round.py:1634-1660``), round + 1, the
        strategy state passed through.  ``state`` is left as it was."""
        def agg_step():
            w = torch.as_tensor(weights, dtype=torch.float32,
                                device=pgs.device)
            agg = (w @ pgs) / torch.clamp(w.sum(), min=1e-12)
            return self.server_opt.step(
                state.params, self._server_clip(agg), state.opt_state,
                server_lr, self.bounds)

        params, opt_state = self._entry(
            "custom_agg", (self._state_operands(state), pgs,
                           np.asarray(weights) if not isinstance(
                               weights, torch.Tensor) else weights),
            agg_step)
        return ServerState(params, opt_state, state.round + 1,
                           state.strategy_state)

    def _chaos_masks(self, inputs: Dict[str, Any],
                     stats: Dict[str, torch.Tensor]):
        """The round's ``(sample_mask, client_mask)`` on the device with
        the chaos faults folded in (``msrflute_tpu/engine/round.py:
        1213-1243``): a dropped client leaves the client mask, a
        straggler's steps past its budget leave the sample mask (its
        partial work still aggregates).  The fault counts go into
        ``stats``."""
        sample_mask, cm = inputs["sample_mask"], inputs["client_mask"]
        if "drop" not in inputs:
            return sample_mask, cm
        drop, keep = inputs["drop"], inputs["keep"]
        step_live = sample_mask.sum(dim=-1) > 0                   # [K, S]
        real_steps = step_live.sum(dim=-1)                        # [K]
        keep_f = (torch.arange(sample_mask.shape[-2], device=self.device)
                  [None, :] < keep[:, None]).to(torch.float32)    # [K, S]
        live_cm = cm * (1.0 - drop)
        stats["chaos_dropped"] = torch.sum(cm * drop)
        stats["chaos_straggled"] = torch.sum(
            live_cm * (keep < real_steps).to(torch.float32))
        stats["chaos_steps_lost"] = torch.sum(
            step_live.to(torch.float32) * (1.0 - keep_f) * live_cm[:, None])
        sample_mask = sample_mask * keep_f[..., None].to(sample_mask.dtype)
        return sample_mask, live_cm

    def _corrupt(self, pg: torch.Tensor, mode: torch.Tensor) -> torch.Tensor:
        """The default payload as a corrupted client would transmit it
        (``round.py:884-904``): NaN, times ``corrupt_scale_factor``, or
        times ``-corrupt_sign_flip_scale``, by the live clients' modes."""
        mult = torch.where(
            mode == CORRUPT_SCALE, self.corrupt_scale,
            torch.where(mode == CORRUPT_SIGN_FLIP, -self.corrupt_flip_scale,
                        1.0)).to(pg.dtype)
        nan = torch.full_like(pg, float("nan"))
        return torch.where((mode == CORRUPT_NAN)[:, None], nan,
                           pg * mult[:, None])

    def dispatch_rounds(self, state: ServerState,
                        batches: List[RoundBatch], client_lrs: List[float],
                        server_lrs: List[float],
                        leakage_threshold: Optional[float] = None,
                        quant_thresholds: Optional[List[Optional[float]]]
                        = None,
                        chaos_vecs: Optional[list] = None
                        ) -> Tuple[ServerState, PackedStats]:
        """Launch ``len(batches)`` rounds back to back without waiting for
        the device (``round.py:1947-2029``): the inputs staged, each round
        enqueued, the stats packed and their copy to the host enqueued.
        Returns the new state and the lazy stats; ``chaos_vecs`` holds
        each round's fault vectors (see :meth:`run_round`)."""
        R = len(batches)
        tic = time.perf_counter()
        chaos_vecs = chaos_vecs or [None] * R
        host = [self._host_inputs(state.round + j, b, c)
                for j, (b, c) in enumerate(zip(batches, chaos_vecs))]
        thresholds = quant_thresholds or [None] * R

        def rounds():
            nonlocal state
            inputs = self._stage(host)
            self.last_stage_secs = time.perf_counter() - tic
            stats = []
            for j in range(R):
                state, round_stats = self._round(
                    state, batches[j], inputs[j], client_lrs[j],
                    server_lrs[j], thresholds[j], leakage_threshold,
                    chaos_vecs[j])
                stats.append(round_stats)
            return state, self._pack_stats(stats)

        # the JAX engine's entry points (``round.py:1483, 1543, 1814``)
        name = (f"staged_r{R}" if self.input_staging else
                "round_step" if R == 1 else f"multi_round_r{R}")
        return self._entry(name, (self._state_operands(state), host),
                           rounds, rounds=R)

    def _pack_stats(self, stats: List[Dict[str, torch.Tensor]]
                    ) -> PackedStats:
        """The chunk's stats, one buffer per dtype group on the device,
        copied into pinned host memory behind an event (on the CPU the
        packed buffers are the host's)."""
        packer = FlatPacker(stats)
        vecs = packer.pack(stats)
        if self.device.type != "cuda":
            return PackedStats(vecs, packer, len(stats))
        host = {}
        for dt, v in vecs.items():
            host[dt] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[dt].copy_(v, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return PackedStats(host, packer, len(stats), event)

    def run_round(self, state: ServerState, batch: RoundBatch,
                  client_lr: float, server_lr: float,
                  quant_threshold: Optional[float] = None,
                  leakage_threshold: Optional[float] = None,
                  chaos: Optional[Dict[str, np.ndarray]] = None
                  ) -> Tuple[ServerState, Dict[str, float]]:
        """One round -> ``(new state, stats)``: :meth:`dispatch_rounds` of
        one batch, then its stats fetched.  The stats are the round's
        scalar sums, and with the privacy metrics on,
        ``stats["privacy"]``: each ``privacy_*`` key's ``[K]`` values and
        the client mask, on the host (the server logs them and adapts the
        leakage threshold).

        ``chaos`` holds the round's fault vectors
        (``resilience/chaos.py``): ``drop`` and ``keep`` (``[K]`` float32)
        when the engine runs client faults, ``corrupt`` (``[K]`` int32)
        when it runs corruption."""
        state, packed = self.dispatch_rounds(
            state, [batch], [client_lr], [server_lr], leakage_threshold,
            [quant_threshold], [chaos])
        return state, packed.fetch()[0]

    def dispatch_bucketed_rounds(
            self, state: ServerState, rounds_buckets: List[List[RoundBatch]],
            client_lrs: List[float], server_lrs: List[float],
            leakage_threshold: Optional[float] = None,
            quant_thresholds: Optional[List[Optional[float]]] = None,
            chaos_vecs: Optional[list] = None
            ) -> Tuple[ServerState, PackedStats]:
        """:meth:`dispatch_rounds` under cohort bucketing
        (``round.py:2761-2940``): ``rounds_buckets[j]`` is round j's list of
        bucket grids in ascending bucket order, ``chaos_vecs[j][b]`` its
        grids' fault vectors.  Every grid of the chunk (with its megabatch
        tape) is staged in one copy per dtype group, each round enqueued
        with :meth:`_bucketed_round`, and the stats packed as ever: a
        round's per-client vectors are its grids' rows concatenated in
        bucket order."""
        R = len(rounds_buckets)
        tic = time.perf_counter()
        chaos_vecs = [
            (chaos_vecs[j] if chaos_vecs is not None and chaos_vecs[j]
             is not None else [None] * len(buckets))
            for j, buckets in enumerate(rounds_buckets)]
        host, where = [], []
        for j, buckets in enumerate(rounds_buckets):
            for batch, chaos in zip(buckets, chaos_vecs[j]):
                tree = self._host_inputs(state.round + j, batch, chaos)
                if batch.mega is not None and self.megabatch:
                    tree["tape_ptr"] = batch.mega.ptr
                    tree["tape_seg"] = batch.mega.seg
                host.append(tree)
                where.append(j)
        staged = self._stage(host)
        self.last_stage_secs = time.perf_counter() - tic
        self.last_dispatch_puts = -(-self.last_dispatch_puts // R)
        inputs: List[list] = [[] for _ in range(R)]
        for j, tree in zip(where, staged):
            inputs[j].append(tree)
        thresholds = quant_thresholds or [None] * R
        stats = []
        for j, buckets in enumerate(rounds_buckets):
            state, round_stats = self._bucketed_round(
                state, buckets, inputs[j], client_lrs[j], server_lrs[j],
                thresholds[j], leakage_threshold, chaos_vecs[j])
            stats.append(round_stats)
        return state, self._pack_stats(stats)

    def _bucketed_round(self, state: ServerState,
                        buckets: List[RoundBatch], inputs: List[dict],
                        client_lr: float, server_lr: float,
                        quant_threshold: Optional[float],
                        leakage_threshold: Optional[float], chaos: list
                        ) -> Tuple[ServerState, Dict[str, torch.Tensor]]:
        """One bucketed round enqueued (the collects of
        ``round.py:2031-2462`` and the finalize of ``:2513-2759``): each
        grid's faults, client phase (the lane scan where it carries a
        tape), corruption and secure aggregation's masks toward its own
        grid; its part sums added in ascending bucket order, or under a
        ``robust`` block the cohort's stacks concatenated and screened
        together; mask recovery a grid at a time; then the round's tail
        as :meth:`_round`'s."""
        strategy = self.strategy
        bcast = strategy.broadcast_params(state.params,
                                          state.strategy_state)
        extra: Dict[str, torch.Tensor] = {}
        sums: Dict[str, dict] = {}
        cols, carries, groups = [], [], []
        state_ops = self._state_operands(state)
        # the round's counted FLOPs and peak over its collects and its
        # finalize (``round.py:2903-2929``)
        flops, hbm = 0.0, 0
        for batch, tree, vecs in zip(buckets, inputs, chaos):
            found: Dict[str, torch.Tensor] = {}
            masks, mode = self._faults(tree, found)
            for key, v in found.items():
                extra[key] = extra[key] + v if key in extra else v
            K, S = (int(n) for n in batch.sample_mask.shape[:2])
            self.bucket_shapes_seen.add((K, S))

            def collect(update, _batch=batch, _tree=tree, _masks=masks,
                        _mode=mode):
                return self._client_phase(
                    state, _batch, _tree, bcast, client_lr,
                    quant_threshold, leakage_threshold, _masks, _mode,
                    update=update)

            plain = {k: v for k, v in tree.items()
                     if not k.startswith("tape_")}
            mega = None
            if "tape_ptr" in tree:
                mega = functools.partial(
                    self.mega_update, tape=batch.mega,
                    tape_dev=(tree["tape_ptr"], tree["tape_seg"]))
            if (mega is not None and self.megabatch_autotune and
                    self.xla is not None and (K, S) not in self._autotuned):
                arm, out = self._autotune(K, S, batch.mega, collect, mega,
                                          (state_ops, plain),
                                          (state_ops, tree))
            elif mega is not None and \
                    self._autotuned.get((K, S), "mega") == "mega":
                arm = "mega"
                out = self._entry(f"megabatch_collect_s{S}",
                                  (state_ops, tree),
                                  functools.partial(collect, mega))
            else:
                arm = "vmap"
                out = self._entry(f"bucket_collect_s{S}", (state_ops, plain),
                                  functools.partial(collect, None))
            if self.megabatch:
                self.mega_gate[(K, S)] = arm
            if self.xla is not None and self.xla.last_dispatch is not None:
                flops += float(self.xla.last_dispatch.get("flops") or 0.0)
                hbm = max(hbm, int(self.xla.last_dispatch.get("hbm_bytes")
                                   or 0))
            parts, tl, ns, stats, cm, carry, sub_norm = out
            if carry is not None and (batch.client_ids >= 0).any():
                carries.append((tree, carry))
            if self.shield is None:
                sums = _add_part_sums(sums, self._part_sums(parts, cm, tree),
                                      strategy.unit_weight_parts)
                parts = None
            cols.append((parts, tl, ns, stats, cm, sub_norm))
            groups.append((batch, _live_host(batch, vecs)))
        parts = None
        tl, ns, cm = (torch.cat([c[i] for c in cols]) for i in (1, 2, 4))
        stats = {k: torch.cat([c[3][k] for c in cols]) for k in cols[0][3]}
        if self.shield is not None:
            # the cohort's stacks in bucket order, screened against the
            # whole cohort (JAX's defer_screen)
            parts = {name: tuple(torch.cat([c[0][name][i] for c in cols])
                                 for i in (0, 1))
                     for name in cols[0][0]}
            sub_norm = (None if cols[0][5] is None
                        else torch.cat([c[5] for c in cols]))
            parts, tl, ns, stats, cm = self._screen(parts, tl, ns, stats, cm,
                                                    sub_norm, extra)
            sums = self._part_sums(parts, cm, {})
        if strategy.wants_cohort:
            sums["default"]["grad_sum"] = self._recover_masks(
                sums["default"]["grad_sum"], groups,
                cm if self.shield is not None else None, state.round, extra)
        n_live = float(sum(live.sum() for _, live in groups))
        out = self._entry(
            "bucket_finalize", (state_ops, [c[4] for c in cols]),
            lambda: self._finish_round(state, bcast, sums, parts, tl, ns,
                                       stats, cm, carries, extra, n_live,
                                       server_lr))
        if self.xla is not None and self.xla.last_dispatch is not None:
            # the live MFU describes the whole bucketed round
            flops += float(self.xla.last_dispatch.get("flops") or 0.0)
            hbm = max(hbm, int(self.xla.last_dispatch.get("hbm_bytes")
                               or 0))
            self.xla.last_dispatch = {
                "entry": "bucketed_round", "rounds": 1,
                "flops": flops or None, "bytes_accessed": None,
                "hbm_bytes": hbm or None}
        return out

    def _autotune(self, K: int, S: int, tape, collect, mega, plain_ops,
                  mega_ops):
        """``megabatch.autotune`` under ``telemetry.xla``
        (``round.py:2855-2896``): a tape grid's first ``(K, S)`` runs the
        vmap arm and the lane scan, each counted, and keeps the arm with
        the smaller roofline time (``max(flops / peak, bytes /
        bandwidth)``, :func:`~..telemetry.xla.roofline_secs`), a tie to
        the tape; the vmap arm's win is a ``megabatch_fallback`` record
        (``reason: "aot_cost"``).  A card of unknown rates prices both
        arms at infinity, and the tape the server's analytic gate
        attached stays.  The arm not kept trained nothing the run sees:
        its outputs are dropped and its local steps not counted.
        ``(arm, the kept arm's outputs)``."""
        steps0 = self.local_steps
        out_v = self._entry(f"bucket_collect_s{S}", plain_ops,
                            functools.partial(collect, None))
        cost_v = dict(self.xla.last_dispatch or {})
        steps = self.local_steps - steps0
        out_m = self._entry(f"megabatch_collect_s{S}", mega_ops,
                            functools.partial(collect, mega))
        cost_m = dict(self.xla.last_dispatch or {})
        self.local_steps = steps0 + steps
        dtype = self.precision.get("compute", "float32")
        peak = chip_peak_flops(self.device, dtype)[1]
        bw = chip_bytes_per_sec(self.device)[1]
        secs_v = roofline_secs(cost_v, peak, bw)
        secs_m = roofline_secs(cost_m, peak, bw)
        if secs_m <= secs_v:
            arm, out = "mega", out_m
        else:
            arm, out = "vmap", out_v
            self.push_megabatch_event({
                "kind": "megabatch_fallback", "reason": "aot_cost",
                "clients": K, "steps": S, "lanes": int(tape.lanes),
                "depth": int(tape.depth), "mega_secs_est": secs_m,
                "vmap_secs_est": secs_v})
        self._autotuned[(K, S)] = arm
        self.xla.last_dispatch = cost_v if arm == "vmap" else cost_m
        return arm, out

    def _round(self, state: ServerState, batch: RoundBatch,
               inputs: Dict[str, Any], client_lr: float, server_lr: float,
               quant_threshold: Optional[float],
               leakage_threshold: Optional[float],
               chaos: Optional[Dict[str, np.ndarray]]
               ) -> Tuple[ServerState, Dict[str, torch.Tensor]]:
        """One round enqueued -> ``(new state, stats on the device)``.  The
        round keeps the JAX package's order: faults, client step,
        corruption, masking (secure aggregation), screening, the part
        sums, mask recovery, the combine."""
        strategy = self.strategy
        bcast = strategy.broadcast_params(state.params,
                                          state.strategy_state)
        extra: Dict[str, torch.Tensor] = {}
        masks, mode = self._faults(inputs, extra)
        K = masks[1].shape[0]
        cpc = self.clients_per_chunk
        if cpc and cpc < K:
            if K % cpc:
                raise ValueError(
                    f"clients_per_chunk={cpc} must divide the per-shard "
                    f"client grid ({K}); pad num_clients_per_iteration or "
                    "pick a divisor")
            part_sums, tl, ns, stats, cm = self._chunked_clients(
                state, batch, inputs, bcast, client_lr, quant_threshold,
                leakage_threshold, masks, mode, cpc)
            parts = carry = None
        else:
            parts, tl, ns, stats, cm, carry, sub_norm = self._client_phase(
                state, batch, inputs, bcast, client_lr, quant_threshold,
                leakage_threshold, masks, mode)
            part_sums = None
        if parts is not None and self.shield is not None:
            parts, tl, ns, stats, cm = self._screen(parts, tl, ns, stats, cm,
                                                    sub_norm, extra)
        if part_sums is None:
            part_sums = self._part_sums(parts, cm, inputs)
            if self.dump_norm_stats and "default" in parts:
                self._norm_dump(parts["default"][0],
                                part_sums["default"]["grad_sum"], extra)
        live_host = _live_host(batch, chaos)
        if strategy.wants_cohort:
            part_sums["default"]["grad_sum"] = self._recover_masks(
                part_sums["default"]["grad_sum"], [(batch, live_host)],
                cm if self.shield is not None else None, state.round, extra)
        carries = ([(inputs, carry)] if carry is not None and
                   (batch.client_ids >= 0).any() else [])
        return self._finish_round(
            state, bcast, part_sums, parts, tl, ns, stats, cm, carries,
            extra, float(live_host.sum()), server_lr)

    def _faults(self, inputs: Dict[str, Any],
                extra: Dict[str, torch.Tensor]):
        """``((sample_mask, client_mask), corruption mode or None)`` of a
        grid, chaos's faults folded in and counted into ``extra``."""
        masks = self._chaos_masks(inputs, extra)
        if self.traffic_staleness:
            # the staleness histogram over the live clients
            # (``round.py:1270-1290``), its last bin open-ended
            live = (masks[1] > 0).to(torch.float32)
            stale = torch.where(masks[1] > 0, inputs["traffic_stale"], 0)
            binned = torch.clamp(stale, max=STALE_HIST_BINS - 1)
            for b in range(STALE_HIST_BINS):
                extra[f"traffic_stale_{b}"] = torch.sum(
                    (binned == b).to(torch.float32) * live)
            extra["traffic_stale_sum"] = torch.sum(
                stale.to(torch.float32) * live)
        mode = None
        if self.chaos_corruption:
            # gated on the live mask: a dropped client never transmits,
            # and a padding slot's zero row must not become NaN
            mode = inputs["corrupt"]
            mode = torch.where(masks[1] > 0, mode, torch.zeros_like(mode))
            for key, code in (("chaos_nan_injected", CORRUPT_NAN),
                              ("chaos_scaled", CORRUPT_SCALE),
                              ("chaos_sign_flipped", CORRUPT_SIGN_FLIP)):
                extra[key] = torch.sum((mode == code).to(torch.float32))
        return masks, mode

    def _screen(self, parts, tl, ns, stats, cm, sub_norm, extra):
        """fluteshield's screen of the round's default payloads: the
        quarantined clients zeroed with ``torch.where``, which a NaN row
        cannot survive, and the quarantine counts into ``extra``."""
        pg, w = parts["default"]
        if sub_norm is not None:
            keep, q_nonfinite, q_norm = self.shield.screen_masked(
                sub_norm, tl * cm, w, cm)
        else:
            keep, q_nonfinite, q_norm = self.shield.screen(
                pg, tl * cm, w, cm)
        kb = keep > 0
        zero = torch.zeros((), dtype=pg.dtype, device=self.device)
        parts = dict(parts)
        parts["default"] = (torch.where(kb[:, None], pg, zero),
                            torch.where(kb, w, 0.0))
        tl = torch.where(kb, tl * cm, 0.0)
        ns = torch.where(kb, ns * cm, 0.0)
        stats = {k: (v if k.startswith("privacy_")
                     else torch.where(kb, v, 0.0))
                 for k, v in stats.items()}
        extra["shield_nonfinite"] = torch.sum(q_nonfinite)
        extra["shield_norm_outlier"] = torch.sum(q_norm)
        return parts, tl, ns, stats, cm * keep

    def _finish_round(self, state: ServerState, bcast: torch.Tensor,
                      part_sums: Dict[str, dict], parts: Optional[dict],
                      tl, ns, stats, cm, carries: list,
                      extra: Dict[str, torch.Tensor], n_live: float,
                      server_lr: float
                      ) -> Tuple[ServerState, Dict[str, torch.Tensor]]:
        """Everything after the client phase: the combine (or the robust
        stack's, or fused RL's), the carry scatters (``carries``: one
        ``(inputs, carry rows)`` a grid), the server step and the round's
        stats.  ``parts`` are the round's payload stacks where a stack
        combine reads them, ``n_live`` the live clients on the host."""
        r = state.round
        strategy = self.strategy
        deferred = None
        if strategy.stale_prob > 0.0:
            deferred = {"grad_sum": part_sums["default"]["grad_sum_def"],
                        "weight_sum": part_sums["default"]["weight_sum_def"]}
        if strategy.wants_client_stack:
            # the robust combine over the screened stack; the strategy
            # state passes through
            agg = strategy.combine_stack(parts["default"][0], cm)
            strategy_state = state.strategy_state
        elif self.fused_rl is not None:
            # fused RL replaces the combine (``round.py:1378-1392``): the
            # tuner re-weights the payload stack
            pg, w = parts["default"]
            cur_loss = (tl * cm).sum() / torch.clamp(cm.sum(), min=1.0)
            agg, strategy_state, rl_stats = self.fused_rl.combine(
                state.strategy_state,
                {"w": w, "mag": stats["mag"], "mean": stats["mean"],
                 "var": stats["var_corrected"]}, pg, cur_loss,
                gen=self.rl_generator(r))
            extra.update(rl_stats)
        else:
            agg, strategy_state = strategy.combine_parts(
                part_sums, deferred, state.strategy_state,
                self.server_seed(r), n_live, global_params=bcast)
        for inputs, carry in carries:
            # the carry rows scattered after the combine, before the
            # server step (``round.py:1397-1405``); a grid at a time under
            # cohort bucketing, whose grids hold disjoint clients
            strategy_state = strategy.apply_carry(
                strategy_state, inputs["carry_ids"], inputs["carry_src"],
                carry)
        if carries:
            extra.update(strategy.carry_stats(strategy_state))
        agg = self._server_clip(agg)
        if strategy.owns_server_update:
            new_params, strategy_state = strategy.apply_server_update(
                state.params, agg, strategy_state, server_lr)
            opt_state = state.opt_state
        else:
            new_params, opt_state = self.server_opt.step(
                state.params, agg, state.opt_state, server_lr, self.bounds)
        count = cm.sum()
        denom = torch.clamp(count, min=1.0)
        # the JAX package's choice: the "default" part's weight sum, else
        # the first part's (FedLabels' "sup", its client count)
        first = part_sums.get("default", next(iter(part_sums.values())))
        round_stats = {
            "train_loss_sum": (tl * cm).sum(),
            "num_samples_sum": (ns * cm).sum(),
            "client_count": count,
            "weight_sum": first["weight_sum"],
            "weight_sum_raw": first["weight_sum_raw"],
            "grad_mean": (stats["mean"] * cm).sum() / denom,
            "grad_mag": (stats["mag"] * cm).sum() / denom,
            "grad_var": (stats["var_corrected"] * cm).sum() / denom,
            "grad_norm": (stats["norm"] * cm).sum() / denom,
            "agg_grad_norm": torch.linalg.vector_norm(agg),
            **extra,
        }
        if "dp_clip" in strategy_state:
            # the clip the next round applies (adaptive clipping)
            round_stats["dp_clip"] = strategy_state["dp_clip"]
        if self.devbus.enabled:
            # the engine's publisher (``round.py:1448-1464``): the applied
            # update's size against the new params, after the server step
            self.devbus.publish(
                "update_ratio",
                torch.linalg.vector_norm(new_params - state.params)
                / (torch.linalg.vector_norm(new_params) + 1e-12))
            round_stats.update(self.devbus.drain())
        privacy = [k for k in stats if k.startswith("privacy_")]
        if privacy:
            round_stats.update((k, stats[k]) for k in privacy)
            round_stats["client_mask"] = cm
        # float32, as the stats have always crossed to the host
        round_stats = {k: v.to(torch.float32) for k, v in round_stats.items()}
        return (ServerState(new_params, opt_state, r + 1, strategy_state),
                round_stats)

    def _client_phase(self, state: ServerState, batch: RoundBatch,
                      inputs: Dict[str, Any], bcast: torch.Tensor,
                      client_lr: float, quant_threshold: Optional[float],
                      leakage_threshold: Optional[float], masks, mode,
                      lo: int = 0, ids: Optional[np.ndarray] = None,
                      update=None):
        """The client step of the clients in ``inputs`` (the round's, a
        bucket grid, or the chunk at row ``lo``), then the corruption of
        the live clients' default payloads and secure aggregation's masks
        (toward ``batch``'s cohort); each part's weight times the client
        mask.  ``update`` replaces the client update (the lane scan).
        Returns ``(parts, train_loss, num_samples, stats, client_mask,
        carry, sub_norm)``."""
        strategy = self.strategy
        parts, tl, ns, stats, cm, carry = self._client_step(
            state, batch, inputs, bcast, client_lr, quant_threshold,
            leakage_threshold, masks=masks, ids=ids, update=update)
        if mode is not None:
            pg, w = parts["default"]
            parts = dict(parts)
            parts["default"] = (self._corrupt(pg, mode), w)
        sub_norm = None
        if strategy.wants_cohort:
            parts, sub_norm = strategy.mask_parts(
                parts, batch.client_ids, batch.client_mask, cm, state.round,
                row0=lo)
        parts = {name: (pg, w * cm) for name, (pg, w) in parts.items()}
        return parts, tl, ns, stats, cm, carry, sub_norm

    def _part_sums(self, parts: Dict[str, tuple], cm: torch.Tensor,
                   inputs: Dict[str, Any]) -> Dict[str, dict]:
        """Each part's weighted sum and weight sums; with staleness the
        deferred clients' apart (``round.py:988-1019``)."""
        strategy = self.strategy
        stale = None
        if strategy.stale_prob > 0.0:
            stale = inputs["stale"] * cm
        part_sums = {}
        for name, (pg, w) in parts.items():
            if name in strategy.unit_weight_parts:
                # every present row enters with coefficient 1, summed in
                # the int32 group (an int64 sum wrapped back)
                live = (cm > 0).to(torch.int64)[:, None]
                part_sums[name] = {
                    "grad_sum": wrap_int32((pg.to(torch.int64) * live).sum(0)),
                    "weight_sum": w.sum(), "weight_sum_raw": w.sum()}
                continue
            if stale is None:
                part_sums[name] = {"grad_sum": w @ pg, "weight_sum": w.sum(),
                                   "weight_sum_raw": w.sum()}
                continue
            w_now, w_def = w * (1.0 - stale), w * stale
            part_sums[name] = {"grad_sum": w_now @ pg,
                               "weight_sum": w_now.sum(),
                               "grad_sum_def": w_def @ pg,
                               "weight_sum_def": w_def.sum(),
                               "weight_sum_raw": w.sum()}
        return part_sums

    def _chunked_clients(self, state: ServerState, batch: RoundBatch,
                         inputs: Dict[str, Any], bcast: torch.Tensor,
                         client_lr: float, quant_threshold: Optional[float],
                         leakage_threshold: Optional[float], masks, mode,
                         chunk: int):
        """The client phase ``chunk`` clients at a time
        (``round.py:1050-1083``): each chunk's part sums added into the
        round's, its ``[chunk]`` losses, sample counts, stats and client
        mask put back in client order.  No ``[K, P]`` stack is built."""
        sums: Dict[str, dict] = {}
        tls, nss, cms, stats_list = [], [], [], []
        for lo in range(0, masks[1].shape[0], chunk):
            hi = lo + chunk
            rows = _rows(inputs, lo, hi)
            parts, tl, ns, stats, cm, _, _ = self._client_phase(
                state, batch, rows, bcast, client_lr, quant_threshold,
                leakage_threshold, (masks[0][lo:hi], masks[1][lo:hi]),
                None if mode is None else mode[lo:hi], lo=lo,
                ids=batch.client_ids[lo:hi])
            sums = _add_part_sums(sums, self._part_sums(parts, cm, rows),
                                  self.strategy.unit_weight_parts)
            del parts
            tls.append(tl)
            nss.append(ns)
            cms.append(cm)
            stats_list.append(stats)
        stats = {k: torch.cat([st[k] for st in stats_list])
                 for k in stats_list[0]}
        return (sums, torch.cat(tls), torch.cat(nss), stats,
                torch.cat(cms))

    @staticmethod
    def _norm_dump(pg: torch.Tensor, grad_sum: torch.Tensor,
                   stats: Dict[str, torch.Tensor]) -> None:
        """Each client's payload norm and its cosine against the weighted
        payload sum, which has the aggregate's direction
        (``round.py:1094-1115``)."""
        norm = torch.sqrt(torch.sum(pg * pg, dim=1))
        stats["dump_norm"] = norm
        stats["dump_cosine"] = (pg @ grad_sum) / torch.clamp(
            norm * torch.linalg.vector_norm(grad_sum), min=1e-12)

    def _recover_masks(self, grad_sum: torch.Tensor, groups: list,
                       screened: Optional[torch.Tensor], round_idx: int,
                       stats: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Secure aggregation's mask recovery (``round.py:1329-1367``;
        ``cancel_buckets``, ``:2531-2558``): for each mask graph in
        ``groups`` (``(batch, live)``: the round's grid, or each bucket
        grid, whose clients mask toward their own grid), the residual
        masks of every (survivor, lost) edge leave the int32 sum; the
        recovery counts go into ``stats``, and a round with fewer than
        ``min_survivors`` survivors aborts (a zero sum).  The sampled and
        live masks are known on the host; the survivors after a screen
        (``screened``, the client mask after it, the groups' rows in
        order) are read back once, since the edges to re-derive are picked
        on the host."""
        strategy = self.strategy
        with allow_sync():   # the one read a strict dispatch half makes
            screened_host = None if screened is None else \
                screened.cpu().numpy()
        recovered = [0, 0]
        n_survivors, row = 0.0, 0
        for batch, live in groups:
            sampled = batch.client_mask
            k = len(sampled)
            survivors = (live if screened_host is None
                         else screened_host[row:row + k])
            row += k
            grad_sum = strategy.cancel_masks(grad_sum, batch.client_ids,
                                             sampled, survivors, round_idx)
            recovered[0] += int(((sampled > 0) & (live <= 0)).sum())
            recovered[1] += int(((live > 0) & (survivors <= 0)).sum())
            n_survivors += float(np.sum(survivors))

        # host counts filled on the device: no copy
        def count(value) -> torch.Tensor:
            return torch.full((), float(value), dtype=torch.float32,
                              device=self.device)

        stats["secagg_recovered_dropout"] = count(recovered[0])
        stats["secagg_recovered_quarantine"] = count(recovered[1])
        if strategy.min_survivors > 0:
            abort = n_survivors < strategy.min_survivors
            if abort:
                grad_sum = torch.zeros_like(grad_sum)
            stats["secagg_abort"] = count(abort)
        return grad_sum


def _live_host(batch: RoundBatch,
               chaos: Optional[Dict[str, np.ndarray]]) -> np.ndarray:
    """A grid's live clients on the host: sampled, less chaos's dropped."""
    if chaos is not None and "drop" in chaos:
        return batch.client_mask * (1.0 - chaos["drop"])
    return batch.client_mask
