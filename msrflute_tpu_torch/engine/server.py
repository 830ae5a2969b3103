"""The federated round loop — the port's counterpart of
``msrflute_tpu/engine/server.py::OptimizationServer`` on its plain serial
path: ``_sample`` (the numpy cohort draw), the annealed quantization
threshold (``server.py:649-650, 1444-1453``), the round, the
privacy-attack bookkeeping (``server.py:455-462, 2867-2900``: the metrics
logged, the leakage threshold adapted to a quantile of the round's
leakages), and
``_round_housekeeping`` (val/test cadence, best model, client-LR decay,
plateau LR, fall-back-to-best, checkpoint, ``status_log.json``), with
``resume_from_checkpoint``, and server replay (``server.py:629-646,
2366-2411``): after each round, ``server_iterations`` local epochs on the
server's own ``train_data_server`` blob with the replay optimizer and its
``updatable_names``.

The defenses (``server.py:76-86, 172-230, 1858-1960``): a ``robust`` block
selects :class:`~..strategies.robust.RobustFedAvg` for a stack
aggregator; the chaos schedule's vectors are drawn for each round from its
index before the round runs (so a resumed run draws the same); the chaos,
quarantine and secure-aggregation counters and the adaptive clip are
logged under the JAX server's metric names.  Chaos client faults and a
``robust`` block are refused on the host-orchestrated rounds.

The round loop is the twin of ``_train_loop`` (``server.py:1256-1983``).
A chunk of R = ``rounds_per_step`` rounds (never crossing an eval
boundary) samples its R cohorts first, then packs them, so both packages
draw the same cohorts and grids from one seed, and is dispatched with
:meth:`~.round.RoundEngine.dispatch_rounds`, which returns at once with
lazy stats.  With ``pipeline_depth`` N >= 1 (the default 1) up to N
dispatched chunks wait in a ring, and the oldest is drained — its stats
fetched once, the per-round logging, privacy stats, the defense
counters, housekeeping and the ``latest`` save — after the next chunk is
dispatched, so the host tail runs while the device works.  At an eval,
rec or last-round boundary the whole ring drains.  Depth 0 is the serial
loop; with ``rounds_per_step`` > 1 it packs the next chunk right after a
dispatch (``prefetch_ok``).  Every random draw (cohorts, shuffles, chaos
vectors, staleness coins) is a numpy draw in dispatch order and
housekeeping draws nothing, so params, each metric's series, the status
log and checkpoints are the same at every depth (a metric logged at
dispatch, the annealed quantization threshold, may come earlier in
``metrics.jsonl``); with lookahead packing the
resume anchor (the ``np_rng`` state) is taken at dispatch and written by
that chunk's housekeeping.  The status log is written before the chunk's
``latest`` save and keeps an entry for each of the last ``STATUS_RING``
chunks, so a resume takes the anchors of the round its checkpoint holds
even when a crash left the status a chunk or two ahead (the async save
in flight, or ``latest``'s ``.prev`` slot).  Paths whose host tail feeds
the next dispatch run serial (``_pipeline_capable``, ``server.py:327-340, 1682-1690``):
DGA's RL hook, SCAFFOLD and EF's host rounds, server replay, the adaptive
leakage threshold and a hooked ``_sample`` (personalization).
``checkpoint_async`` defaults on when the loop is pipelined.

Resilience (``server.py:204-311, 351-358, 1178-1254, 1378-1397,
1633-1668``): the checkpoint manager retries every write under
``server_config.checkpoint_retry`` and runs the chaos IO probe before
each attempt; a :class:`~..resilience.preemption.PreemptionHandler` is
installed around :meth:`train` (SIGTERM and SIGINT set a flag).  The loop
polls the flag at each chunk boundary, before any dispatch; chaos's
``preempt_at_round`` requests it there when the run crosses that round
from below (a run resumed past it trains on).  A preempted loop drains the
ring's chunks in dispatch order through their housekeeping, so each
writes its ``latest``, waits for the async writer, sets
:attr:`preempted` and writes ``{"preempted": reason}`` into the status
log; a resumed run that completes clears it.  ``dump_norm_stats``
(``server.py:1970-1971, 2411-2427``) appends each round's per-client
payload norms and cosines against the aggregate, the sampled clients'
alone, to ``norm_stats.txt`` and ``cosines.txt`` in the model directory.

``server_config.fused_carry`` (``server.py:75-95, 179-191, 323-335,
439-445``) moves four of them onto the ring: SCAFFOLD's controls, EF's
residuals and personalization's local models ride ``strategy_state`` as
``[N, ...]`` tables that the round gathers and scatters
(``RoundEngine``'s carry), and fused RL's tuner re-weights the payloads
in the round (:mod:`..rl.fused`); no host store or RL aggregator is
built, and durability rides the model checkpoint.

Cohort bucketing and megabatching (``server.py:492-603, 2213-2343``):
the population's step needs give the step buckets (or the explicit
``boundaries``, the top clamped to the largest need) and each bucket's
client capacity once at start; each round's cohort is packed on one grid
a bucket (:meth:`_pack_bucketed_round`, every permutation drawn first in
cohort order, so the numpy stream is the monolithic pack's) and the chunk
goes to :meth:`~.round.RoundEngine.dispatch_bucketed_rounds`.  Under
``megabatch`` a bucket whose tape would save ``min_gain`` of its grid's
slots is packed in the tape's row order with the tape attached; else a
``megabatch_fallback`` record is buffered and logged at the drain.
``paddingEfficiency`` (real samples over padded slots, a megabatch
grid's counted on its tape) is logged on every run.

The data planes (``server.py:483-491, 604-626, 1308-1336, 2175-2210``).
With ``data_config.train.device_resident`` the whole sample pool is
built and uploaded to the engine's device at construction
(``RoundEngine.attach_pool``; refused beside the host-orchestrated
rounds, as in the JAX package), and every round packs ``[K, S, B]``
int32 indices (``pack_round_indices``, the same draws as host packing)
in place of feature rows, monolithic and on bucket grids alike.
``length_bucketing`` (default on) crops a host-packed chunk's token grids
(the task's ``seq_pad_keys``) to the power-of-two bucket of its longest
real sequence, one bucket over all its rounds and grids, before the
padding meter and before staging; the last crop's stats are
:attr:`_length_bucket_stats`.  Pool mode ships full-length index rows
and is never cropped (the JAX package skips the crop on its monolithic
pool path and fails on its bucketed one).  ``hostToDeviceBytesPerRound``
(a chunk's feature or index grids plus its sample masks, over its R
rounds) is recorded once a chunk and once a host round, and logged with
the other ``run_stats``.

Default-run parity and the arrival plane.  Every structured event of the
JAX server's paths that the port runs is a record in ``metrics.jsonl``
(:meth:`..utils.logging.MetricsLog.event`), at the JAX call sites' points
and with their fields: the defense counters' events once a chunk drains
(:meth:`_defense_events`), ``preempted_exit``, ``eval_nonfinite_skipped``,
and through the checkpoint manager and the preemption handler theirs.
``do_profiling`` (server or client) writes a ``torch.profiler`` Chrome
trace of one chunk into ``<model_dir>/profile``.  ``server_config.fleet``
draws the cohort with :func:`..data.fleet.sample_cohort` under
``sampling: floyd`` or ``by_samples`` (``uniform`` keeps the numpy trail).
``server_config.traffic`` (``server.py:236-306, 1127-1190``) serves each
round's cohort from a seeded :class:`~..traffic.TrafficSchedule` fire
(``buffer_fired``), re-anchored at :meth:`train` so a resumed run replays
the same fires; in ``buffered`` mode with FedBuff each grid stages the
fire's per-client staleness beside the chaos vectors, the round returns
its histogram (``traffic_staleness``), and ``traffic.target_accuracy``
records :attr:`rounds_to_target_accuracy` (:meth:`traffic_summary`).

The fleet paged carry (``server.py:96-170, 360-380, 860-1030,
1357-1367, 1464-1472, 1586-1603, 1718-1726, 2553-2578``): ``fleet``
beside a device-carry strategy sizes its tables to a page pool
(``strategy.carry_rows``) behind a :class:`~.paging.CarryPager`, built
after the resume decision: each chunk's cohorts map onto slots before its
dispatch (the misses paged in), its rows start home right after it, and
the drain writes them to the host row store before the host tail; the
ring packs the next chunk ahead so the pager's worker can stage its rows.
Every ``spill_freq`` rounds and at the last, once the checkpoint is on
disk, the store spills its dirty rows and commits the drained round as its
marker; a resume takes the checkpoint slot the marker pairs with
(:meth:`_paired_fleet_anchor`).  One :class:`~..resilience.integrity.
DurableIOLadder` (the ``checkpoint_retry`` policy) runs the store's and the
writeback's IO, with ``chaos.infra``'s probes on its surfaces
(:meth:`fleet_summary`).

Host-orchestrated rounds (``server.py:1410``): with ``wantRL`` (DGA's RL
weight hook), ``strategy: scaffold`` or ``strategy: ef_quant`` each round
runs through :meth:`_host_round_setup` and the engine's
``client_payloads`` / ``apply_custom_weights`` pair — :meth:`_run_rl_round`
(``server.py:2791-2842``: candidates A and B from one state, two
validation evals, a reward), :meth:`_run_scaffold_round`
(``server.py:2626``) and :meth:`_run_ef_round` (``server.py:2704``).  The
SCAFFOLD controls and EF residuals keep the JAX server's discipline
(``server.py:771-858``): their files reload only when the checkpoint
resumed and reset when their round marker disagrees with the checkpoint's
round; the marker is -1 while a round changes the files and takes the
round once its checkpoint is written (a device table flushes its dirty
rows first, every ``scaffold_flush_freq`` / ``ef_flush_freq`` rounds,
``server.py:2505-2552``); a fall-back to the best model resets them
(``server.py:3118-3126``); and a resume replays EF's ``quant_anneal``
(``server.py:760-770``).
"""

from __future__ import annotations

import copy
import functools
import json
import logging
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import (INFRA_NEEDS_PAGING, OptimizerConfig, RLConfig,
                      cohort_upper_bound, parse_clients_per_round)
from ..data.batching import (assign_step_buckets, bucket_boundaries,
                             bucket_capacities, build_sample_pool,
                             grid_slots, megabatch_lanes, pack_eval_batches,
                             pack_round_batches, pack_round_indices,
                             plan_megabatch, pow2_ceil, seq_length_bucket,
                             steps_for, steps_for_array)
from ..data.dataset import ArraysDataset
from ..data.fleet import sample_cohort
from ..device import DeviceLike, chip_peak_flops, resolve_device
from ..models.base import BaseTask, Metric, Params
from ..optim import PlateauTracker, make_lr_schedule
from ..resilience.chaos import make_chaos
from ..resilience.integrity import DurableIOLadder, RetryPolicy
from ..resilience.preemption import PreemptionHandler
from ..strategies import select_strategy
from ..strategies.ef_quant import (DeviceResidualTable, EFQuant,
                                   ResidualStore)
from ..strategies.robust import select_robust_strategy
from ..strategies.scaffold import ControlStore, DeviceControlTable, Scaffold
from ..telemetry import NULL_SPAN, emit_event, make_telemetry
from ..telemetry.profiling import start_window, stop_window
from ..telemetry.rollup import host_rss_bytes
from ..telemetry.xla import mfu
from ..traffic import STALE_HIST_BINS, make_traffic
from ..utils.logging import MetricsLog, print_rank
from ..utils.strict import strict_transfer_scope
from .checkpoint import (LATEST_PREV, CheckpointManager,
                         load_pretrained_params)
from .client_update import ClientHParams, build_client_update
from .evaluation import (evaluate, per_user_accuracy, prediction_rows,
                         stage_eval_batches)
from .paging import CarryPager, read_marker
from .round import SERVER_SLOT, RoundEngine, ServerState

#: the replay's dropout stream: ``[seed, r, SERVER_SLOT, REPLAY_TAG]``
REPLAY_TAG = 5
#: chunks of status entries the status log keeps (``server.py:2493``)
STATUS_RING = 16
#: the chaos counters of the round's stats: ``(stats key, counter, the
#: JAX server's metric name)``
CHAOS_METRICS = (
    ("chaos_dropped", "dropped", "Chaos dropped clients"),
    ("chaos_straggled", "straggled", "Chaos stragglers"),
    ("chaos_steps_lost", "steps_lost", "Chaos steps lost"),
    ("chaos_nan_injected", "nan_injected", "Chaos NaN-injected clients"),
    ("chaos_scaled", "scaled", "Chaos scaled clients"),
    ("chaos_sign_flipped", "sign_flipped", "Chaos sign-flipped clients"))


class OptimizationServer:
    def __init__(self, task: BaseTask, config, train_dataset,
                 val_dataset=None, test_dataset=None,
                 model_dir: str = "./models", device: DeviceLike = None,
                 seed: int = 0, init_params: Optional[Params] = None,
                 metrics: Optional[MetricsLog] = None,
                 server_train_dataset=None):
        self.task = task
        self.config = config
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.test_dataset = test_dataset
        self.device = resolve_device(device)
        self.metrics = metrics if metrics is not None else MetricsLog()
        sc, cc = config.server_config, config.client_config
        #: the telemetry scope (``server_config.telemetry``,
        #: ``server.py:382-419``); None when the block is off, and then
        #: every instrumentation point is one is-None check
        self.scope = make_telemetry(sc.get("telemetry"), model_dir,
                                    self.metrics, self.device)
        #: the structured-event sink (``telemetry/__init__.py::
        #: emit_event``): records in ``metrics.jsonl``, and with a scope
        #: trace instants, rollup counts and the flight ring too
        self.event = functools.partial(emit_event, self.scope, self.metrics)
        #: device-resident carry (``server.py:75-95``): SCAFFOLD's and EF's
        #: tables, personalization's and fused RL's state ride
        #: ``strategy_state`` and the round, so their rounds use the ring
        self._fused_carry = bool(sc.get("fused_carry", False))
        strategy_cls = self._select_strategy(config)
        if sc.get("robust"):
            # a stack aggregator swaps in RobustFedAvg; a strategy the
            # screening cannot see into is refused (server.py:76-86)
            self.strategy = select_robust_strategy(config, strategy_cls)
        else:
            self.strategy = strategy_cls(config)
        if self._fused_carry:
            # the carry tables' rows: the client pool
            self.strategy.carry_clients = len(train_dataset)
        self.engine = RoundEngine(task, config, self.strategy, self.device,
                                  seed=seed)
        #: fluteshield's policy (None without a robust block) and the
        #: chaos schedule (None without a chaos block); the server draws
        #: each round's fault vectors and logs the counters
        self.shield = self.engine.shield
        self.chaos = make_chaos(sc)
        # a subclass whose ``_sample`` hook falls back to the base sampler
        # under fused_carry says so with ``fused_carry_sample``
        # (personalization)
        self._sample_hooked = (
            type(self)._sample is not OptimizationServer._sample and
            not (self._fused_carry and
                 getattr(type(self), "fused_carry_sample", False)))
        self._check_host_rounds(sc)
        self._setup_fleet(sc, len(train_dataset))
        if self.chaos is not None and self.chaos.has_infra_faults and \
                not self._fleet_paged:
            raise ValueError(INFRA_NEEDS_PAGING)

        # the dispatch/drain ring (server.py:314-352): paths whose host
        # tail feeds the next dispatch run serial, decided up front
        # because the async-checkpoint default depends on it
        self.pipeline_depth = max(int(sc.get("pipeline_depth", 1) or 0), 0)
        pm_cfg = getattr(config, "privacy_metrics_config", None)
        wants_adaptive = bool(
            pm_cfg is not None and pm_cfg.get("apply_metrics", False)
            and pm_cfg.get("adaptive_leakage_threshold"))
        self._pipeline_capable = (
            not self._host_rl(sc) and
            not getattr(self.strategy, "host_rounds", False) and
            not (sc.get("server_replay_config") is not None and
                 server_train_dataset is not None) and
            not wants_adaptive and not self._sample_hooked)
        ckpt_async = sc.get("checkpoint_async")
        if ckpt_async is None:
            ckpt_async = self.pipeline_depth > 0 and self._pipeline_capable
        self.ckpt = CheckpointManager(
            model_dir, self.engine.layout, sc.get("model_backup_freq", 100),
            async_latest=bool(ckpt_async),
            retry=RetryPolicy.from_config(sc.get("checkpoint_retry")),
            io_fault=(self.chaos.io_fault_hook if self.chaos is not None
                      else None), events=self.event)
        #: SIGTERM / SIGINT -> drain -> checkpoint -> return; the run's
        #: exit says it was preempted (:attr:`preempted`)
        self.preemption = PreemptionHandler(events=self.event,
                                            flush=self.metrics.flush)
        self.preempted = False
        #: ``(kind, peak FLOP/s)`` of the card, the live MFU's denominator
        #: (``device.py::chip_peak_flops``: None for an unknown card);
        #: None when the device-truth layer is off
        self._chip = None
        if self.engine.xla is not None:
            self._chip = chip_peak_flops(
                self.device, self.engine.precision.get("compute", "float32"))
        if self.scope is not None:
            self.ckpt.span = self.scope.span
            self.scope.watchdog.on_mark = self._watchdog_mark
            # the flight record embeds the run's scorecard, built when it
            # is written
            self.scope.set_flight_context(self.build_scorecard)
            # a preemption request makes the trace, the metrics and the
            # flight record durable before the drain starts
            self.preemption.add_flush_hook(self.scope.flush)
            self.preemption.add_flush_hook(self._flight_on_preempt)
            self.engine.devbus.on_nonscalar = self.scope.devbus_nonscalar
        #: chunks drained while a later chunk was in flight
        self.pipelined_chunks = 0

        # LR machinery: server-side schedule + client plateau decay
        self.initial_lr_client = float(sc.get("initial_lr_client", 0.01))
        self.lr_decay_factor = float(sc.get("lr_decay_factor", 1.0))
        self.lr_weight = 1.0
        server_lr = float(sc.optimizer_config.get("lr", 1.0))
        self.server_lr_schedule = make_lr_schedule(sc.annealing_config,
                                                   server_lr)
        self.plateau: Optional[PlateauTracker] = None
        if sc.annealing_config.get("type") == "val_loss":
            self.plateau = PlateauTracker(sc.annealing_config, server_lr)
        self.best_model_criterion = sc.get("best_model_criterion", "loss")
        self.fall_back_to_best = bool(sc.get("fall_back_to_best_model",
                                             False))
        self.best_val: Dict[str, Metric] = {}
        self._last_val: Dict[str, Metric] = {}

        # privacy-attack bookkeeping (reference core/server.py:319-325)
        pm = getattr(config, "privacy_metrics_config", None)
        self.max_allowed_leakage: Optional[float] = None
        self.adaptive_leakage: Optional[float] = None
        if pm is not None and pm.get("apply_metrics", False):
            self.max_allowed_leakage = pm.get("max_allowed_leakage")
            if pm.get("adaptive_leakage_threshold"):
                self.adaptive_leakage = float(
                    pm.get("adaptive_leakage_threshold"))

        # server replay (reference core/server.py:429-442): on only with
        # both the block and the server's data, as in the JAX package
        self.server_replay: Optional[dict] = None
        replay = sc.get("server_replay_config")
        if replay is not None and server_train_dataset is not None:
            if getattr(self.strategy, "owns_server_update", False):
                raise ValueError(
                    f"{type(self.strategy).__name__} maintains coupled "
                    "parameter sequences; server replay would mutate params "
                    "behind its back — disable server_replay_config")
            names = replay.get("updatable_names")
            self.server_replay = {
                "dataset": server_train_dataset,
                "iterations": int(replay.get("server_iterations", 1)),
                "opt_cfg": OptimizerConfig.from_dict(
                    replay.get("optimizer_config")),
                # None: no allowlist; an empty list freezes every leaf
                "updatable_names": (None if names is None
                                    else tuple(names))}

        # quantization threshold annealing (reference core/server.py:294-298)
        self.quant_thresh = cc.get("quant_thresh") or \
            config.model_config.get("quant_threshold")
        self.quant_anneal = float(cc.get("quant_anneal", 1.0) or 1.0)

        # do_profiling (server.py:652-657): a torch.profiler trace of one
        # chunk into <model_dir>/profile
        self._profile_dir: Optional[str] = None
        self._chunks_run = 0
        if sc.get("do_profiling", False) or cc.get("do_profiling", False):
            self._profile_dir = os.path.join(model_dir, "profile")

        # static round geometry
        self.batch_size = int(cc.data_config.train.get("batch_size", 32))
        self.desired_max_samples = cc.get("desired_max_samples") or \
            cc.data_config.train.get("desired_max_samples")
        self.max_steps = steps_for(int(np.max(train_dataset.num_samples)),
                                   self.batch_size, self.desired_max_samples)
        self.step_bucketing = bool(cc.get("step_bucketing", True))
        #: length bucketing of token grids (``server.py:483-491``): on by
        #: default; the stats of the last chunk it cropped
        self.length_bucketing = bool(
            cc.data_config.train.get("length_bucketing", True))
        self._length_bucket_stats: Optional[dict] = None
        self._setup_throughput(sc, cc, train_dataset)
        self._setup_pool(sc, cc, train_dataset)
        self._setup_traffic(sc, train_dataset)

        self._np_rng = np.random.default_rng(seed)
        self._eval_batches: Dict[str, dict] = {}
        self._eval_users: Dict[str, np.ndarray] = {}
        #: host seconds a round, one entry a round (a chunk's R rounds
        #: share its value; housekeeping: one entry a chunk, in seconds):
        #: ``secsPerRound`` from
        #: the previous fence to this one when pipelined, from prep to
        #: fence when serial (``server.py:1709-1716``); its split into
        #: packing, staging, the dispatch's enqueue, the wait at the
        #: stats fetch, the host tail after it, checkpoint submission and
        #: housekeeping
        self.run_stats: Dict[str, List[float]] = {
            key: [] for key in (
                "secsPerRound", "secsPerRoundPack", "secsPerRoundStage",
                "secsPerRoundDispatch", "secsPerRoundDrainWait",
                "secsPerRoundHostTail", "secsPerRoundCkptSubmit",
                "secsPerRoundHousekeeping",
                # real samples over padded grid slots, a chunk each
                # (``server.py:2298-2343``), on every run
                "paddingEfficiency",
                # host-to-device bytes of the data inputs, a chunk or a
                # host round each (``server.py:2175-2193``)
                "hostToDeviceBytesPerRound",
                # live MFU, a chunk each, with ``telemetry.xla`` on
                # (``server.py:2008-2027``)
                "mfuPerRound")}
        #: run totals of the padding-efficiency meter (slot-weighted) and
        #: of the megabatch tape's real slots over its slots
        self._pad_real = self._pad_slots = 0.0
        self._mega_real = self._mega_slots = 0.0
        #: megabatch buckets that fell back to the vmap arm
        self.megabatch_fallbacks = 0
        #: one record per evaluation: split, round and metric values
        self.history: List[Dict[str, float]] = []

        self.state = self.engine.init_state(
            init_params if init_params is not None
            else task.init_params(seed))
        pretrained = config.model_config.get("pretrained_model_path")
        if pretrained:
            # warm params, a fresh optimizer and strategy state (FedAC's
            # w_ag starts at the warm point) and round 0
            # (server.py:698-716); a resume below wins
            self.state = self.engine.init_state(load_pretrained_params(
                pretrained, self.engine.layout, config.data_path))
            print_rank(f"warm-started from pretrained model {pretrained}")
        #: ``[round, status]`` of the last few chunks, written into the
        #: status log (``server.py:2487-2495``)
        self._status_ring: list = []
        resumed = bool(sc.get("resume_from_checkpoint", False)) and \
            self._resume()
        self._ladder: Optional[DurableIOLadder] = None
        self._setup_pager(sc, model_dir, resumed, len(train_dataset))
        if self.scope is not None and self.scope.rollup is not None:
            # the rollup writer degrades through the durable-IO ladder
            # (``server.py:411-419``): the pager's, where chaos.infra's
            # ``writer`` probe sits, else one of the same policy
            ladder = self._ladder or DurableIOLadder(
                policy=RetryPolicy.from_config(sc.get("checkpoint_retry")))
            ladder.event = self.event
            self.scope.rollup.ladder = ladder
            self.scope.rollup.on_drop = self._rollup_dropped

        # DGA's RL weight hook (server.py:437-451); under fused_carry the
        # engine's FusedRL takes its place and no host aggregator is built
        self.rl = None
        #: per RL round, whether candidate B (the RL weights) was kept
        self.rl_kept: List[bool] = []
        if self._host_rl(sc):
            from ..rl import RLAggregator
            self.rl = RLAggregator(
                sc.get("RL") or RLConfig(),
                int(sc.get("num_clients_per_iteration", 10)), model_dir,
                seed=seed, device=self.device)
        # SCAFFOLD's controls and EF's residuals, built after the resume
        # decision so that they pair with the checkpoint's trajectory
        self.scaffold_store = self.ef_store = None
        self.scaffold_device = self.ef_device = None
        host_rounds = getattr(self.strategy, "host_rounds", False)
        if isinstance(self.strategy, Scaffold) and host_rounds:
            self.scaffold_store = self._paired_store(
                ControlStore, model_dir, "scaffold", "SCAFFOLD controls",
                resumed)
            if sc.get("scaffold_device_controls", False):
                self.scaffold_device = DeviceControlTable(
                    self.scaffold_store, len(train_dataset), self.device)
        if isinstance(self.strategy, EFQuant) and host_rounds:
            self.ef_store = self._paired_store(
                ResidualStore, model_dir, "ef_residuals", "EF residuals",
                resumed)
            if sc.get("ef_device_residuals", False):
                self.ef_device = DeviceResidualTable(
                    self.ef_store, len(train_dataset), self.device)
            if resumed and self.quant_anneal != 1.0:
                # the strategy's running threshold anneals once a round
                self.strategy.quant_thresh *= \
                    self.quant_anneal ** self.state.round
        self._max_iteration = int(sc.get("max_iteration", 100))

    def _setup_fleet(self, sc, population: int) -> None:
        """``server_config.fleet`` (``server.py:96-170``): the cohort draw
        of :func:`..data.fleet.sample_cohort`, and beside a device-carry
        strategy the paged carry: the page pool's slots
        (``strategy.carry_rows``, set before ``init_state`` sizes the
        tables), by default ``pow2_ceil(2 * pad * rounds_per_step *
        (pipeline_depth + 1))`` capped at the population, refused below
        the in-flight floor ``pad * rounds_per_step * (pipeline_depth +
        1)``."""
        fl = sc.get("fleet") or {}
        self._fleet_cfg = fl if (fl and fl.get("enable", True)) else None
        self._fleet_paged = bool(self._fleet_cfg is not None and
                                 self.strategy.device_carry)
        if self._fleet_cfg is None:
            return
        if sc.get("scaffold_device_controls") or \
                sc.get("ef_device_residuals"):
            raise ValueError(
                "server_config.fleet does not compose with "
                "scaffold_device_controls / ef_device_residuals — "
                "those keep a FULL [N, n_params] table in HBM, the "
                "exact residency fleet paging exists to replace; "
                "use fused_carry + fleet instead")
        if not self._fleet_paged:
            return
        # one device: the padded cohort is the cohort
        pad = min(cohort_upper_bound(sc.get("num_clients_per_iteration",
                                            10)), population)
        depth = max(int(sc.get("pipeline_depth", 1) or 0), 0)
        rps = max(int(sc.get("rounds_per_step", 1) or 1), 1)
        auto = pow2_ceil(max(pad * rps * (depth + 1) * 2, pad + 1))
        slots = int(self._fleet_cfg.get("page_pool_slots") or auto)
        slots = min(max(slots, pad), population)
        required = min(pad * rps * (depth + 1), population)
        if slots < required:
            raise ValueError(
                f"server_config.fleet.page_pool_slots={slots} is "
                f"below the in-flight floor {required} "
                f"(= padded cohort {pad} x rounds_per_step {rps} x "
                f"(pipeline_depth {depth} + 1), capped at the "
                "population) — raise page_pool_slots or lower "
                "pipeline_depth")
        self.strategy.carry_rows = slots

    def _setup_pager(self, sc, model_dir: str, resumed: bool,
                     population: int) -> None:
        """The paged carry's :class:`~.paging.CarryPager` and its row store
        under ``<model_dir>/fleet_carry`` (``server.py:860-923``), built
        after the resume decision so that the rows and the restored params
        are one trajectory: a resumed run adopts the marker's round (the
        dead trajectory's newer row generations go) or, with a marker
        behind the checkpoint, resets the rows."""
        self.fleet_pager: Optional[CarryPager] = None
        if not self._fleet_paged:
            return
        # one retry ladder over the store's and the writeback's IO
        # (server.py:360-380), chaos's infra probes on its surfaces (the
        # round marker shares the spill stream)
        infra = self.chaos.infra if self.chaos is not None else None
        hooks = {}
        if infra is not None:
            hooks = {"store_write": infra.hook("store_write"),
                     "store_read": infra.hook("store_read"),
                     "marker": infra.hook("store_write"),
                     "writeback": infra.hook("writeback"),
                     "writer": infra.hook("writer")}
        ladder = self._ladder = DurableIOLadder(
            policy=RetryPolicy.from_config(sc.get("checkpoint_retry")),
            fault_hooks=hooks)
        ladder.event = self.event
        fl = self._fleet_cfg
        self.fleet_pager = pager = CarryPager(
            self.strategy, self.state.strategy_state,
            slots=int(self.strategy.carry_rows),
            store_dir=os.path.join(model_dir, "fleet_carry"),
            host_cache_rows=int(fl.get("host_cache_rows", 8192) or 8192),
            resume=resumed, prefetch=bool(fl.get("prefetch", True)),
            ladder=ladder, faults=infra, events=self.event)
        if self.scope is not None:
            pager.span = self.scope.span
        if resumed:
            marker = pager.round()
            if marker is None or int(marker) < int(self.state.round):
                print_rank(
                    f"fleet carry rows were at round {marker} but "
                    f"the checkpoint resumed at {self.state.round}; "
                    "resetting carry rows (one-trajectory rule)")
                pager.reset()
            else:
                pager.adopt_round(int(self.state.round))
                pager.mark_durable(int(self.state.round) - 1)
        mb = pager.n_slots * pager.row_bytes() / 2**20
        print_rank(f"fleet paged carry: {pager.n_slots} pool slots x "
                   f"{sorted(self.strategy.carry_tables)} ({mb:.1f} MiB on "
                   f"{self.device}) over {population} clients")

    def _paired_fleet_anchor(self, restored: ServerState
                             ) -> Optional[ServerState]:
        """The resume anchor under the paged carry (``server.py:993-1030``):
        the round marker commits after the checkpoint, so a kill inside a
        round's commit window can leave ``latest`` ahead of the durable
        rows.  Params and rows must come from one round: ``latest`` when
        the marker reaches it, else the ``.prev`` slot when it is the
        marker's round, else a cold start (the seeded run replays to the
        same bits)."""
        marker = read_marker(os.path.join(self.ckpt.model_dir,
                                          "fleet_carry"))
        durable = int(marker) if marker is not None else 0
        latest_round = int(restored.round)
        if durable >= latest_round:
            return restored
        prev = self.ckpt.load(self.device, LATEST_PREV)
        if prev is not None and int(prev.round) == durable:
            print_rank(
                f"fleet carry rows are durable through round {durable} "
                f"but latest_model is at {latest_round} (hard stop "
                "inside the commit window); resuming from the previous "
                "slot so params and carry stay on one trajectory")
            return prev
        print_rank(
            f"fleet carry rows are durable through round {durable} with "
            f"no matching checkpoint slot (latest {latest_round}); "
            "cold-starting — the seeded replay reproduces the run "
            "bit-for-bit")
        return None

    def fleet_summary(self) -> Optional[Dict[str, Any]]:
        """The paged carry's record (the JAX scorecard's ``fleet`` and
        ``infra_faults`` blocks, ``server.py:2080-2105``): the pager's
        :meth:`~.paging.CarryPager.describe` and the infra counters; None
        without the paged carry."""
        if self.fleet_pager is None:
            return None
        infra = self.chaos.infra if self.chaos is not None else None
        return {"fleet": self.fleet_pager.describe(),
                "infra_faults": (
                    None if infra is None else
                    {k: float(v) for k, v in sorted(infra.counters.items())})}

    def _setup_traffic(self, sc, train_dataset) -> None:
        """The arrival plane (``server.py:236-306``): the seeded
        :class:`~..traffic.TrafficSchedule` that serves each round's cohort
        (None without an enabled ``traffic`` block), with the JAX server's
        refusals, and ``traffic.target_accuracy``'s crossing."""
        self.traffic = make_traffic(sc, len(train_dataset))
        #: the next fire :meth:`_sample` serves; re-anchored at train()
        self._traffic_round = 0
        #: the first round whose val accuracy reached the target
        self.rounds_to_target_accuracy: Optional[int] = None
        tgt = (sc.get("traffic") or {}).get("target_accuracy")
        self.target_accuracy = float(tgt) if tgt is not None else None
        if self.traffic is None:
            return
        if (self._host_rl(sc) or getattr(self.strategy, "host_rounds", False)
                or self._sample_hooked):
            raise ValueError(
                "server_config.traffic requires the fused round "
                "path — wantRL, strategy: scaffold / ef_quant, and "
                "personalization orchestrate rounds host-side and "
                "would keep boundary sampling, silently ignoring "
                "the arrival plane; drop the traffic block for "
                "this configuration")
        ncpi = sc.get("num_clients_per_iteration", 10)
        if not isinstance(ncpi, int) or \
                self.traffic.buffer_size != int(ncpi):
            raise ValueError(
                f"server_config.traffic.buffer_size "
                f"({self.traffic.buffer_size}) must equal a FIXED "
                f"num_clients_per_iteration (got {ncpi!r}) — the "
                "fused program's [K, S, B] grid is compiled for "
                "exactly K client slots, so the buffer IS the "
                "cohort (the FedBuff buffer == K mapping)")
        if (self._fleet_cfg is not None and
                str(self._fleet_cfg.get("sampling", "uniform"))
                != "uniform"):
            raise ValueError(
                "server_config.traffic and fleet.sampling != "
                "'uniform' are two cohort-selection planes — the "
                "arrival schedule decides WHO trains, so a "
                "weighted/floyd fleet draw would be silently "
                "ignored; use fleet.sampling: uniform or drop the "
                "traffic block")
        sa = sc.get("secure_agg") or {}
        if sa and sa.get("enable", True):
            min_surv = int(sa.get("min_survivors", 0) or 0)
            if min_surv > self.traffic.buffer_size:
                raise ValueError(
                    f"secure_agg.min_survivors ({min_surv}) "
                    f"exceeds traffic.buffer_size "
                    f"({self.traffic.buffer_size}) — a buffered "
                    "fire delivers exactly buffer_size clients, so "
                    "every round would abort below the liveness "
                    "floor; lower min_survivors or raise "
                    "buffer_size")
        if self.engine.traffic_staleness and self.megabatch is not None:
            raise ValueError(
                "server_config.megabatch cannot compose with "
                "traced staleness (traffic.mode: buffered + a "
                "staleness-aware strategy): megabatch_passes "
                "replays the strategy's in-jit staleness draw "
                "per lane and would diverge from the trace's "
                "true per-client staleness; drop megabatch or "
                "run traffic.mode: sync")

    def traffic_summary(self) -> Optional[Dict[str, Any]]:
        """The run's arrival-plane summary (``server.py:2135-2149``): the
        trace's identity, the host replay oracle's rollups and the
        target-accuracy crossing; None without traffic."""
        if self.traffic is None:
            return None
        t = self.traffic
        return {**t.describe(),
                "arrival_rate": round(t.arrival_rate(), 6),
                "mean_buffer_occupancy": round(t.mean_buffer_occupancy(), 6),
                "stale_hist": [int(c) for c in t.stale_hist],
                "counters": {k: float(v) for k, v in t.counters.items()},
                "target_accuracy": self.target_accuracy,
                "rounds_to_target_accuracy": self.rounds_to_target_accuracy}

    def _setup_throughput(self, sc, cc, train_dataset) -> None:
        """Cohort bucketing's step buckets and client capacities, and the
        megabatch lanes, from the population's step needs
        (``server.py:492-603``); None when off."""
        self.cohort_bucketing: Optional[dict] = None
        self.megabatch: Optional[dict] = None
        cb = sc.get("cohort_bucketing") or {}
        if not (cb and cb.get("enable", True)):
            return
        if (self._host_rl(sc) or getattr(self.strategy, "host_rounds", False)
                or self._sample_hooked):
            raise ValueError(
                "server_config.cohort_bucketing requires the fused "
                "round path — wantRL (host), strategy: scaffold / "
                "ef_quant (host rounds), and personalization's "
                "overridden sampling orchestrate rounds host-side "
                "and would silently run unbucketed; drop the block "
                "or lift the strategy with fused_carry")
        needs = steps_for_array(train_dataset.num_samples, self.batch_size,
                                self.desired_max_samples)
        max_need = int(needs.max()) if needs.size else 1
        mb = cb.get("max_buckets")
        max_buckets = 4 if mb is None else int(mb)
        user_bounds = cb.get("boundaries")
        if user_bounds:
            bounds = [int(b) for b in user_bounds]
            if any(b < 1 for b in bounds) or \
                    any(y <= x for x, y in zip(bounds, bounds[1:])):
                raise ValueError(
                    "cohort_bucketing.boundaries must be strictly "
                    f"increasing positive ints, got {bounds}")
            # the top bucket covers the largest need, clamped to max_steps
            covering = [b for b in bounds if b >= max_need]
            top = max(min(covering[0] if covering else max_need,
                          self.max_steps), max_need)
            bounds = [b for b in bounds if b < top] + [top]
        else:
            bounds = bucket_boundaries(needs, max_buckets, self.max_steps)
        if len(bounds) > max_buckets:
            raise ValueError(
                f"cohort_bucketing: {len(bounds)} boundaries exceed "
                f"max_buckets={max_buckets} — raise max_buckets or "
                "shorten the boundaries list")
        cohort_hi = min(cohort_upper_bound(
            sc.get("num_clients_per_iteration", 10)), len(train_dataset))
        caps = bucket_capacities(needs, bounds, cohort_hi,
                                 slack=float(cb.get("slack", 1.5) or 1.5))
        self.cohort_bucketing = {"boundaries": bounds, "capacities": caps,
                                 "max_buckets": max_buckets}
        #: each client's step need
        self._step_needs = needs
        print_rank(f"cohort bucketing on: step buckets {bounds} with client "
                   f"capacities {caps} (population max need {max_need}, "
                   f"monolithic S {self.max_steps})")
        mgb = sc.get("megabatch") or {}
        if not (mgb and mgb.get("enable", True)):
            return
        epochs = max(int(cc.get("num_epochs", 1) or 1), 1)
        lanes = megabatch_lanes(needs, bounds, cohort_hi, epochs,
                                slack=float(mgb.get("slack", 1.25) or 1.25),
                                lanes=mgb.get("lanes"), caps=caps)
        self.megabatch = {"lanes": lanes, "epochs": epochs,
                          "min_gain": float(mgb.get("min_gain", 0.1) or 0.0)}
        print_rank(f"megabatch on: per-bucket lanes {lanes} over step "
                   f"buckets {bounds} (tape depth = {epochs} x S_b, "
                   f"min_gain {self.megabatch['min_gain']})")

    def _setup_pool(self, sc, cc, train_dataset) -> None:
        """The device-resident sample pool (``server.py:604-626``): built
        from every user's samples and uploaded once; :attr:`_pool_offsets`
        is None when off."""
        self._pool_offsets: Optional[np.ndarray] = None
        if not bool(cc.data_config.train.get("device_resident", False)):
            return
        if self._host_rl(sc) or getattr(self.strategy, "host_rounds", False):
            # their rounds pack host rows for the payload program and would
            # never read the pool
            raise ValueError(
                "data_config.train.device_resident does not apply to "
                "host-orchestrated rounds (wantRL / strategy: "
                "scaffold / strategy: ef_quant) — drop the flag for "
                "this configuration")
        pool, self._pool_offsets = build_sample_pool(train_dataset)
        self.engine.attach_pool(pool)
        print_rank(f"device-resident pool: {len(self._pool_offsets) - 1} "
                   f"users, {self.engine.pool_bytes} bytes on "
                   f"{self.device}")

    def _pack_grid(self, ids: list, steps: int, **kw):
        """One grid of ``ids``: pool indices in pool mode, else feature
        rows (``server.py:1321-1330, 2275-2284``)."""
        if self._pool_offsets is not None:
            return pack_round_indices(
                self.train_dataset, self._pool_offsets, ids,
                self.batch_size, steps, rng=self._np_rng,
                desired_max_samples=self.desired_max_samples, **kw)
        return pack_round_batches(
            self.train_dataset, ids, self.batch_size, steps,
            rng=self._np_rng, desired_max_samples=self.desired_max_samples,
            **kw)

    def _maybe_length_bucket(self, batches: list) -> None:
        """Crop a host-packed chunk's token grids to their real-length
        bucket (``server.py:2195-2210``), all of them to one; a no-op off,
        for a task without ``seq_pad_keys`` and in pool mode."""
        keys = getattr(self.task, "seq_pad_keys", ())
        if (not self.length_bucketing or not keys
                or self._pool_offsets is not None):
            return
        stats = seq_length_bucket(batches, keys)
        if stats is not None and stats["cropped"]:
            self._length_bucket_stats = stats
            after, before = (stats["tokens_real"] / max(stats[k], 1) for k in
                             ("tokens_grid_after", "tokens_grid_before"))
            print_rank(f"length bucket L={stats['bucket']}/"
                       f"{stats['full_len']} pad-eff {after:.3f} (was "
                       f"{before:.3f})", loglevel=logging.DEBUG)

    def _record_staged_bytes(self, batches: list, rounds: int) -> None:
        """The bytes a chunk's data inputs move to the device, over its
        rounds (``server.py:2175-2193``): each grid's feature arrays, or in
        pool mode its index grid, plus its sample mask; a bucketed chunk's
        nested grids summed."""
        flat = [b for entry in batches
                for b in (entry if isinstance(entry, list) else [entry])]
        chunk_bytes = sum(
            sum(a.nbytes for a in (getattr(b, "arrays", None)
                                   or {"idx": b.indices}).values())
            + b.sample_mask.nbytes for b in flat)
        self.run_stats["hostToDeviceBytesPerRound"].append(
            chunk_bytes / max(rounds, 1))

    def _pack_bucketed_round(self, sampled: list) -> List:
        """One round's cohort on its bucket grids (``server.py:2213-2297``):
        each client in the smallest step bucket that covers it, one
        ``[K_b, S_b, B]`` grid a bucket at its capacity (empty ones too),
        a top bucket's overflow in more grids of its shape.  Every
        client's permutation is drawn first, in cohort order, as the
        monolithic pack draws them.  Under megabatch a bucket whose tape
        prices below its grids by ``min_gain`` (the analytic slots gate)
        is packed in the tape's row order, with the tape attached; else it
        falls back to the vmap arm with a ``megabatch_fallback`` event."""
        needs = [int(self._step_needs[i]) for i in sampled]
        caps = self.cohort_bucketing["capacities"]
        assignment = assign_step_buckets(
            needs, self.cohort_bucketing["boundaries"], capacities=caps)
        orders = {int(ci): self._np_rng.permutation(
            int(self.train_dataset.num_samples[ci])) for ci in sampled}
        out = []
        for bi, ((s_b, positions), cap) in enumerate(zip(assignment.items(),
                                                         caps)):
            ids = [sampled[p] for p in positions]
            cap = int(cap)
            groups = ([ids] if len(ids) <= cap else
                      [ids[i:i + cap] for i in range(0, len(ids), cap)])
            tapes = None
            if self.megabatch is not None and ids:
                lanes = int(self.megabatch["lanes"][bi])
                plan = plan_megabatch([needs[p] for p in positions],
                                      self.megabatch["epochs"], lanes,
                                      int(s_b), 1, cap)
                # per scan step the tape trains L lanes for E*S steps
                # against the grid's cap rows: the compute ratio is
                # groups*L against groups*cap
                gain = 1.0 + float(self.megabatch["min_gain"])
                if len(plan) * lanes * gain <= len(groups) * cap:
                    groups = [[ids[j] if j >= 0 else -1 for j in rows]
                              for rows, _ in plan]
                    tapes = [t for _, t in plan]
                else:
                    self.engine.push_megabatch_event({
                        "kind": "megabatch_fallback", "reason": "slots",
                        "bucket_steps": int(s_b), "clients": len(ids),
                        "lanes": lanes, "tape_groups": len(plan),
                        "grid_groups": len(groups)})
            for gi, g in enumerate(groups):
                b = self._pack_grid(g, int(s_b), pad_clients_to=cap,
                                    orders=orders)
                if tapes is not None:
                    t = b.mega = tapes[gi]
                    self._mega_slots += float(t.lanes * t.depth
                                              * self.batch_size)
                    self._mega_real += float(t.entries * self.batch_size)
                out.append(b)
        return out

    def _record_padding_efficiency(self, grids: list) -> None:
        """Real samples over padded slots of a chunk's grids; a megabatch
        grid counts its tape's slots (``lanes * depth * B`` per epoch), the
        compute the round pays for (``server.py:2298-2333``)."""
        E = self.megabatch["epochs"] if self.megabatch is not None else 1
        slots = sum(float(grid_slots([b])) if b.mega is None else
                    float(b.mega.lanes * b.mega.depth)
                    * b.sample_mask.shape[2] / E for b in grids)
        real = float(sum(np.sum(b.num_samples) for b in grids))
        self.run_stats["paddingEfficiency"].append(real / max(slots, 1.0))
        self._pad_slots += slots
        self._pad_real += real

    @property
    def padding_efficiency(self) -> Optional[float]:
        """Run-total real samples over padded grid slots (1.0: no padding);
        None before a chunk was packed."""
        return self._pad_real / self._pad_slots if self._pad_slots else None

    @property
    def megabatch_utilization(self) -> Optional[float]:
        """Run-total real tape slots over tape slots; None before any
        bucket carried a tape."""
        return (self._mega_real / self._mega_slots if self._mega_slots
                else None)

    def _check_host_rounds(self, sc) -> None:
        """The host-orchestrated rounds (RL, SCAFFOLD, EF, the
        personalization server's hooked sampling) build their payloads
        outside :meth:`RoundEngine.run_round`: a ``robust`` block or chaos
        client faults there are refused, as in ``server.py:195-222``."""
        host = (self._host_rl(sc) or
                getattr(self.strategy, "host_rounds", False) or
                self._sample_hooked)
        if not host:
            return
        if self.shield is not None:
            raise ValueError(
                "server_config.robust requires the fused round path "
                "— wantRL, strategy: scaffold / ef_quant, and "
                "personalization orchestrate rounds host-side and "
                "would aggregate unscreened payloads; drop the "
                "robust block for this configuration")
        if self.chaos is not None and (self.chaos.has_client_faults or
                                       self.chaos.has_corruption):
            raise ValueError(
                "server_config.chaos dropout_rate/straggler_rate/"
                "corrupt_* rates require the fused round path — "
                "wantRL, strategy: scaffold / ef_quant, and "
                "personalization orchestrate rounds host-side and "
                "would ignore the injected faults; zero those rates "
                "or drop the feature")

    def _host_rl(self, sc) -> bool:
        """Whether DGA's RL hook runs host-side (``wantRL`` without
        ``fused_carry``)."""
        return bool(sc.get("wantRL", False)) and not self._fused_carry

    def _select_strategy(self, config) -> type:
        """The strategy class the server builds; the personalization
        server swaps in its carry strategy under ``fused_carry``
        (``server.py:927-932``)."""
        return select_strategy(config.strategy)

    def chaos_vectors(self, round_no: int, batch):
        """The round's fault vectors from the schedule, keyed on the round
        index (so a resumed run draws the same ones): what
        :meth:`RoundEngine.run_round` takes as ``chaos``, with the arrival
        plane's ``traffic_stale`` vector under traced staleness.  For a
        bucketed round (a list of grids) one dict a grid, each drawn from
        its own sub-stream (``salt`` = bucket index + 1,
        ``server.py:1478-1530``)."""
        engine = self.engine
        if not (engine.chaos_client_faults or engine.chaos_corruption
                or engine.traffic_staleness):
            return None
        if isinstance(batch, list):
            return [self._chaos_vecs(round_no, b, bi + 1)
                    for bi, b in enumerate(batch)]
        return self._chaos_vecs(round_no, batch, 0)

    def _chaos_vecs(self, round_no: int, batch, salt: int) -> dict:
        engine, vecs = self.engine, {}
        if engine.chaos_client_faults:
            vecs["drop"], vecs["keep"] = self.chaos.client_faults(
                round_no, batch.sample_mask, salt=salt)
        if engine.chaos_corruption:
            vecs["corrupt"] = self.chaos.corrupt_modes(
                round_no, batch.sample_mask.shape[0], salt=salt)
        if engine.traffic_staleness:
            # keyed on the client id, so it realigns to whatever grid the
            # packer put the client on (padding slots read 0)
            vecs["traffic_stale"] = self.traffic.staleness_vector(
                round_no, batch.client_ids)
        return vecs

    def _log_defense(self, stats: Dict[str, float], r: int) -> None:
        """The round's chaos, quarantine and secure-aggregation counters,
        under the JAX server's metric names (``server.py:1858-1960``),
        added to the run's totals."""
        log = self.metrics.log
        for key, name, metric in CHAOS_METRICS:
            if key in stats:
                self.chaos.counters[name] += stats[key]
                log(metric, stats[key], step=r)
        if self.shield is not None and "shield_nonfinite" in stats:
            c = self.shield.counters
            c["quarantined_nonfinite"] += stats["shield_nonfinite"]
            c["quarantined_norm_outlier"] += stats["shield_norm_outlier"]
            log("Quarantined clients (non-finite)",
                stats["shield_nonfinite"], step=r)
            log("Quarantined clients (norm outlier)",
                stats["shield_norm_outlier"], step=r)
        if "secagg_recovered_dropout" in stats:
            c = self.strategy.counters
            c["recovered_dropout"] += stats["secagg_recovered_dropout"]
            c["recovered_quarantine"] += stats["secagg_recovered_quarantine"]
            log("SecAgg recovered (dropout)",
                stats["secagg_recovered_dropout"], step=r)
            log("SecAgg recovered (quarantine)",
                stats["secagg_recovered_quarantine"], step=r)
            if stats.get("secagg_abort"):
                c["aborted_rounds"] += stats["secagg_abort"]
                log("SecAgg aborted round", stats["secagg_abort"], step=r)
        if "traffic_stale_sum" in stats:
            log("Traffic staleness sum", stats["traffic_stale_sum"], step=r)

    def _defense_events(self, stats: List[dict], round0: int) -> None:
        """A chunk's event records, kind by kind in the JAX server's order
        (``server.py:1858-1960``), each a round with something to say:
        ``chaos_faults``, ``chaos_corruption``, ``traffic_staleness``
        (every round), ``quarantine``, then ``secagg_recovered`` and
        ``secagg_abort`` a round at a time."""
        rounds = list(enumerate(stats, start=round0))
        for kind, keys in (
                ("chaos_faults", (("dropped", "chaos_dropped"),
                                  ("straggled", "chaos_straggled"),
                                  ("steps_lost", "chaos_steps_lost"))),
                ("chaos_corruption", (
                    ("nan_injected", "chaos_nan_injected"),
                    ("scaled", "chaos_scaled"),
                    ("sign_flipped", "chaos_sign_flipped")))):
            for r, st in rounds:
                if keys[0][1] in st and any(st[k] for _, k in keys):
                    self.event(kind, round=r,
                               **{name: st[k] for name, k in keys})
        for r, st in rounds:
            if "traffic_stale_sum" in st:
                self.event("traffic_staleness", round=r,
                           stale_sum=st["traffic_stale_sum"],
                           hist=[st[f"traffic_stale_{b}"]
                                 for b in range(STALE_HIST_BINS)])
        for r, st in rounds:
            if "shield_nonfinite" in st and (st["shield_nonfinite"] or
                                             st["shield_norm_outlier"]):
                self.event("quarantine", round=r,
                           nonfinite=st["shield_nonfinite"],
                           norm_outlier=st["shield_norm_outlier"])
        for r, st in rounds:
            if "secagg_recovered_dropout" not in st:
                continue
            rec_drop = st["secagg_recovered_dropout"]
            rec_quar = st["secagg_recovered_quarantine"]
            if rec_drop or rec_quar:
                self.event("secagg_recovered", round=r, dropout=rec_drop,
                           quarantine=rec_quar)
            if st.get("secagg_abort"):
                self.event("secagg_abort", round=r,
                           aborted=st["secagg_abort"])

    def _paired_store(self, cls, model_dir: str, subdir: str, what: str,
                      resumed: bool):
        """A per-client row store under ``model_dir/subdir``: reloaded
        only on a resume, reset when its round marker is not the
        checkpoint's round (a crash inside a round's window)."""
        store = cls(self.engine.layout.numel,
                    store_dir=os.path.join(model_dir, subdir),
                    resume=resumed)
        if resumed and store.round() != self.state.round:
            print_rank(f"{what} were at round {store.round()} but the "
                       f"checkpoint resumed at {self.state.round}; "
                       "resetting them")
            store.reset()
        return store

    # ------------------------------------------------------------------
    def _resume(self) -> bool:
        """Reload the latest checkpoint and the status log; False when
        there is no checkpoint to resume from."""
        restored = self.ckpt.load(self.device)
        if restored is not None and self._fleet_paged:
            restored = self._paired_fleet_anchor(restored)
        if restored is None:
            return False
        self.state = restored
        status = self._paired_status(self.ckpt.read_status(), restored.round)
        # entries beyond the resumed round belong to the abandoned run
        self._status_ring = [e for e in status.get("status_ring", [])
                             if int(e[0]) <= restored.round]
        if int(status.get("i", -1)) != restored.round:
            print_rank(f"status_log.json is at round {status.get('i')} but "
                       f"the checkpoint at {restored.round}; the sampling "
                       "trail will not replay exactly", logging.WARNING)
        self.lr_weight = float(status.get("weight", 1.0))
        if self.quant_thresh is not None:
            # the running threshold; a status log without it fast-forwards
            # the geometric schedule, as the JAX package does
            self.quant_thresh = float(status.get(
                "quant_thresh",
                float(self.quant_thresh) * self.quant_anneal ** restored.round))
        if "np_rng_state" in status:
            self._np_rng.bit_generator.state = status["np_rng_state"]
        if self.plateau is not None and "plateau" in status:
            pl = status["plateau"]
            self.plateau.lr = float(pl.get("lr", self.plateau.lr))
            self.plateau.best = pl.get("best")
            self.plateau.bad_rounds = int(pl.get("bad_rounds", 0))
        hib = status.get("best_val_hib", {})
        for key, value in status.items():
            if key.startswith("best_val_") and key != "best_val_hib":
                name = key[len("best_val_"):]
                self.best_val[name] = Metric(float(value),
                                             bool(hib.get(name, name != "loss")))
        print_rank(f"resumed from checkpoint at round {self.state.round}")
        return True

    @staticmethod
    def _paired_status(status: Dict[str, Any],
                       round_no: int) -> Dict[str, Any]:
        """The status entry written for the checkpoint's own round
        (``server.py:1030-1044``).  The status log is written before the
        chunk's ``latest`` save, and an async save lands later still, so
        after a crash the flat fields may be a chunk or two ahead of the
        loadable slot; the ring's entry for that slot's round re-anchors
        the sampling trail, the LR weight and the best values.  A log
        without the entry keeps its flat fields."""
        for entry in reversed(status.get("status_ring", [])):
            if int(entry[0]) == int(round_no):
                merged = dict(status)
                merged.update(entry[1])
                return merged
        return status

    def _sample(self) -> list:
        """The round's cohort (a subclass may hook work onto the draw, as
        the personalization server does: anything it draws from
        ``_np_rng`` comes after the cohort and before the round's own
        packing, as in the JAX package).  Under ``traffic`` it is the next
        fire's buffer, with a ``buffer_fired`` record, and the numpy trail
        is untouched; under ``fleet.sampling`` ``floyd`` or ``by_samples``
        it is :func:`~..data.fleet.sample_cohort`'s draw
        (``server.py:1127-1170``)."""
        if self.traffic is not None:
            r = self._traffic_round
            self._traffic_round = r + 1
            fire = self.traffic.fire(r)
            self.event("buffer_fired", round=r, tick=int(fire["tick"]),
                       wait_ticks=int(fire["wait_ticks"]),
                       stale_max=int(fire["staleness"].max(initial=0)),
                       stale_sum=int(fire["staleness"].sum()))
            return [int(c) for c in fire["cohort"]]
        sc = self.config.server_config
        n = parse_clients_per_round(sc.get("num_clients_per_iteration", 10),
                                    self._np_rng)
        n = min(n, len(self.train_dataset))
        mode = (str(self._fleet_cfg.get("sampling", "uniform"))
                if self._fleet_cfg is not None else "uniform")
        if mode != "uniform":
            return sample_cohort(self._np_rng, len(self.train_dataset), n,
                                 mode=mode,
                                 num_samples=self.train_dataset.num_samples)
        return list(self._np_rng.choice(len(self.train_dataset), size=n,
                                        replace=False))

    def _chunk_steps(self, chunk_samples: list) -> int:
        """The chunk's own step need rounded up to a power of two (or the
        dataset-wide worst case without ``step_bucketing``)."""
        if not self.step_bucketing:
            return self.max_steps
        need = max(steps_for(self.train_dataset.num_samples[i],
                             self.batch_size, self.desired_max_samples)
                   for sampled in chunk_samples for i in sampled)
        return min(self.max_steps, pow2_ceil(need))

    # ------------------------------------------------------------------
    def run(self):
        return self.train()

    def _pipeline_ok(self) -> bool:
        """Whether the ring may run (``server.py:1682-1690``): everything
        the host tail feeds into the next dispatch forces serial."""
        return self._pipeline_capable and self.rl is None and \
            self.scaffold_store is None and self.ef_store is None and \
            self.server_replay is None and self.adaptive_leakage is None

    def _pack_chunk(self, R: int) -> list:
        """The chunk's R cohorts, sampled first, then packed on one step
        count, or under cohort bucketing each round on its bucket grids
        (a list of grids a round)."""
        samples = [self._sample() for _ in range(R)]
        if self.cohort_bucketing is not None:
            batches = [self._pack_bucketed_round(sampled)
                       for sampled in samples]
            flat = [b for row in batches for b in row]
            self._maybe_length_bucket(flat)
            self._record_padding_efficiency(flat)
            return batches
        steps = self._chunk_steps(samples)
        batches = [self._pack_grid(sampled, steps) for sampled in samples]
        self._maybe_length_bucket(batches)
        self._record_padding_efficiency(batches)
        return batches

    def train(self):
        """The round loop inside the preemption window: the handlers are
        installed (main thread only), a request latched by an earlier run
        is cleared, and the previous dispositions come back on the way
        out; an exception first waits for the async save in flight."""
        self.preempted = False
        self.preemption.reset()
        self.preemption.install()
        if self.traffic is not None:
            # the timeline is a pure function of the seed: a resumed run
            # replays the same fires (a cache warm-up, not a restore)
            self._traffic_round = int(self.state.round)
            self.traffic.fast_forward(self._traffic_round)
        if self.scope is not None:
            # the stall monitor, a named thread, only when its action is
            # not "off" (``server.py:1191-1195``)
            self.scope.watchdog.start_stall_monitor()
        try:
            return self._train_loop()
        except BaseException as exc:
            try:
                self.ckpt.wait()
            except Exception:  # never masks the original abort
                pass
            if self.scope is not None:
                # the abnormal exit's record: the last events, the live
                # rollup window and the scorecard (``server.py:1206-1225``)
                try:
                    self.scope.record_flight(
                        f"exception: {type(exc).__name__}", detail=str(exc))
                except Exception:  # never masks the original abort
                    pass
            raise
        finally:
            if self.scope is not None:
                self._close_scope()
            self.preemption.uninstall()

    def _close_scope(self) -> None:
        """Whatever path left the loop (``server.py:1226-1252``): the
        stall monitor stops, the partial rollup window and an open
        profiler window are written, the buffered compile events reach
        the streams, the trace is flushed and then the scorecard (its
        overlap figures read the flushed trace) is written."""
        scope = self.scope
        scope.watchdog.stop_stall_monitor()
        try:
            if scope.rollup is not None:
                scope.rollup.flush_window(partial=True)
            scope.profiler.finish()
            self._drain_xla_events()
            scope.flush()
            scope.write_scorecard(self.build_scorecard())
        except Exception as exc:  # telemetry never ends a run
            print_rank(f"telemetry close failed: {exc!r}", logging.WARNING)

    def _train_loop(self):
        sc = self.config.server_config
        max_iteration = int(sc.get("max_iteration", 100))
        val_freq = int(sc.get("val_freq", 20) or 20)
        rec_freq = int(sc.get("rec_freq", 20) or 20)
        if self.state.round == 0 and sc.get("initial_val", True):
            self._maybe_eval("val", 0)
        if self.state.round == 0 and sc.get("initial_rec", False):
            self._maybe_eval("test", 0)
        rounds_per_step = max(int(sc.get("rounds_per_step", 1) or 1), 1)
        if self.server_replay is not None and rounds_per_step > 1:
            # the reference replays after every round (core/server.py:429)
            print_rank("server replay forces rounds_per_step=1")
            rounds_per_step = 1

        def chunk_R(r0: int) -> int:
            until_val = (val_freq - (r0 % val_freq)
                         if self.val_dataset is not None else max_iteration)
            until_rec = (rec_freq - (r0 % rec_freq)
                         if self.test_dataset is not None else max_iteration)
            return min(rounds_per_step, max_iteration - r0, until_val,
                       until_rec)

        # do_profiling's chunk: the second when there will be more than
        # one (the first builds the kernels), else the only one
        profile_chunk = (0 if max_iteration - self.state.round <=
                         rounds_per_step else 1)

        def pack(R: int):
            tic = time.time()
            with self._tspan("pack", rounds=R):
                batches = self._pack_chunk(R)
            return R, batches, time.time() - tic

        host_round = (self._run_rl_round if self.rl is not None else
                      self._run_scaffold_round
                      if self.scaffold_store is not None else
                      self._run_ef_round if self.ef_store is not None
                      else None)
        pipelined = self.pipeline_depth > 0 and self._pipeline_ok()
        # serial fused chunks pack the next chunk right after a dispatch;
        # the ring already packs while the device runs
        prefetch_ok = (rounds_per_step > 1 and not pipelined and
                       host_round is None and self.server_replay is None
                       and not self._sample_hooked)
        # the paged carry's row prefetch (server.py:1357-1367): the ring
        # packs the next chunk right after a dispatch too, and hands its
        # cohorts to the pager's worker (the draws' order is the same)
        pager = self.fleet_pager
        fleet_prefetch = (pager is not None and pager.prefetch_enabled
                          and self.rl is None and
                          self.server_replay is None and
                          not self._sample_hooked)
        lookahead = prefetch_ok or (pipelined and fleet_prefetch)
        prefetched = None
        # dispatched, undrained chunks, oldest first
        pending: deque = deque()
        self._last_fence = 0.0
        round_no = start_round = self.state.round
        chaos = self.chaos
        while round_no < max_iteration:
            # the preemption poll, at a chunk boundary before any dispatch;
            # the drill fires only when this run crosses its round
            if (chaos is not None and chaos.preempt_at_round is not None
                    and start_round < chaos.preempt_at_round <= round_no
                    and not self.preemption.requested):
                self.preemption.request(
                    f"chaos preempt_at_round={chaos.preempt_at_round}")
            if self.preemption.requested:
                self.preemption.flush_now()   # outside signal context
                if prefetched is not None:
                    # the looked-ahead chunk is dropped: the sampling
                    # state goes back to the last dispatch's anchor, so a
                    # second train() draws that chunk again
                    self._np_rng.bit_generator.state = \
                        copy.deepcopy(anchor)
                break
            tic = time.time()
            R = chunk_R(round_no)
            if self.scope is not None:
                # the profile_rounds window: chunk boundaries are its only
                # edges; the chunk's round range decides
                self.scope.profiler.observe(round_no, rounds=R)
            if host_round is not None:
                with self._tspan("host_round", round=round_no):
                    host_round(round_no)
                if self.server_replay is not None:
                    self._run_server_replay(round_no)
                round_no += 1
                self.run_stats["secsPerRound"].append(time.time() - tic)
                self._round_housekeeping(round_no, val_freq, rec_freq)
                continue
            client_lr = self.initial_lr_client * self.lr_weight
            server_lrs = [(self.plateau.lr if self.plateau is not None
                           else self.server_lr_schedule(r))
                          for r in range(round_no, round_no + R)]
            if prefetched is None or prefetched[0] != R:
                prefetched = pack(R)
            _, batches, pack_secs = prefetched
            prefetched = None
            self._record_staged_bytes(batches, R)
            prof = (start_window(self.device)
                    if self._profile_dir is not None and
                    self._chunks_run == profile_chunk else None)
            thresholds = [None] * R
            if self.quant_thresh is not None:
                # multiplied by quant_anneal BEFORE its first use, each
                # logged at its own round
                for j in range(R):
                    self.quant_thresh = float(self.quant_thresh) * \
                        self.quant_anneal
                    thresholds[j] = self.quant_thresh
                    self.metrics.log("Quantization Thresh.",
                                     self.quant_thresh, step=round_no + j)
            # the dispatch half: under MSRFLUTE_STRICT_TRANSFERS=1 a call
            # here that waits for the card raises (utils/strict.py)
            with strict_transfer_scope(self.device):
                tac = time.time()
                for ch in pending:
                    # the ring's newest chunk is copied for its `latest`
                    # save now, in stream order, before the next dispatch
                    # queues behind it
                    if ch["snapshot"] is None:
                        ch["snapshot"] = self.ckpt.snapshot(ch["state"])
                snap_secs = time.time() - tac
                if pager is not None:
                    # the chunk's cohorts onto pool slots, the misses paged
                    # in on the stream after the snapshots above and before
                    # the dispatch (server.py:1464-1472)
                    with self._tspan("fleet_page", round0=round_no,
                                     rounds=R):
                        pager.prepare_chunk(batches,
                                            self.state.strategy_state)
                chaos_vecs = [self.chaos_vectors(round_no + j, b)
                              for j, b in enumerate(batches)]
                # the device window opens at dispatch and whoever drains
                # the chunk ends it (``server.py:1535-1538``)
                device_span = (self.scope.begin("round_device",
                                                round0=round_no, rounds=R)
                               if self.scope is not None else None)
                tac = time.time()
                dispatch = (self.engine.dispatch_bucketed_rounds
                            if self.cohort_bucketing is not None
                            else self.engine.dispatch_rounds)
                with self._tspan("dispatch", round0=round_no, rounds=R):
                    self.state, packed = dispatch(
                        self.state, batches, [client_lr] * R, server_lrs,
                        leakage_threshold=self.max_allowed_leakage,
                        quant_thresholds=thresholds, chaos_vecs=chaos_vecs)
                dispatch_secs = time.time() - tac
                # the chunk's rows start home now, before a later page-in
                # writes the tables (server.py:1586-1591)
                wb = (pager.queue_writeback(self.state.strategy_state,
                                            round_no=round_no + R)
                      if pager is not None else None)
            chunk = {
                "span": device_span, "fleet_wb": wb,
                # the dispatch's counted FLOPs, for the live MFU
                "xla_dispatch": (dict(self.engine.xla.last_dispatch)
                                 if self.engine.xla is not None and
                                 self.engine.xla.last_dispatch is not None
                                 else None),
                "round0": round_no, "R": R, "state": self.state,
                "masks": [b.client_mask for b in batches
                          if not isinstance(b, list)],
                "stats": packed, "client_lr": client_lr,
                "server_lrs": server_lrs, "tic": tic, "snapshot": None,
                # with lookahead packing the next chunk samples before
                # this chunk's housekeeping: its resume anchor is now
                "rng_snapshot": (
                    copy.deepcopy(self._np_rng.bit_generator.state)
                    if pipelined or prefetch_ok else None),
                "secs": {"pack": pack_secs,
                         "stage": self.engine.last_stage_secs,
                         "dispatch": dispatch_secs
                         - self.engine.last_stage_secs,
                         "ckpt": snap_secs}}
            round_no += R
            anchor = chunk["rng_snapshot"]
            if lookahead and round_no < max_iteration:
                prefetched = pack(chunk_R(round_no))
                if fleet_prefetch:
                    pager.prefetch_chunk(prefetched[1])
            if prof is not None:
                # the chunk's trace (``server.py:1604-1607``)
                path = os.path.join(self._profile_dir,
                                    f"chunk_r{chunk['round0']}.pt.trace.json")
                stop_window(prof, self.device, path)
                print_rank(f"wrote profiler trace to {path}")
            self._chunks_run += 1
            while len(pending) >= self.pipeline_depth and pending:
                # ring full: drain the oldest while the device runs the
                # newer ones
                self._drain_chunk(pending.popleft(), val_freq, rec_freq)
                self.pipelined_chunks += 1
            # the host tail at an eval or rec boundary can change the
            # LRs, the params (fall-back) and the sampling, and the last
            # chunk ends the run: the whole ring drains first
            boundary = (round_no >= max_iteration or
                        round_no % val_freq == 0 or
                        (round_no % rec_freq == 0 and
                         self.test_dataset is not None))
            if pipelined and not boundary:
                pending.append(chunk)
            else:
                while pending:
                    self._drain_chunk(pending.popleft(), val_freq, rec_freq)
                    self.pipelined_chunks += 1
                self._drain_chunk(chunk, val_freq, rec_freq)
        while pending:
            # preempted with chunks in flight: their device work is done,
            # so each drains and writes its `latest`
            ch = pending.popleft()
            with self._tspan("preempt_drain", round0=ch["round0"],
                             rounds=ch["R"]):
                self._drain_chunk(ch, val_freq, rec_freq)
            self.pipelined_chunks += 1
        self.ckpt.wait()   # the async `latest` is on disk on return
        if self.preemption.requested and round_no < max_iteration:
            self.preempted = True
            self.preemption.flush_now()
            reason = self.preemption.reason or "requested"
            self.ckpt.update_status({"preempted": reason})
            self.event("preempted_exit", round=round_no, reason=reason)
            print_rank(f"preempted at round {round_no}/{max_iteration} "
                       f"({reason}); checkpoint durable — resume with "
                       "server_config.resume_from_checkpoint: true",
                       logging.WARNING)
        elif "preempted" in self.ckpt.read_status():
            # a resumed run that completed
            self.ckpt.update_status({"preempted": None})
        self._log_timing()
        self.metrics.flush()
        return self.state

    def _drain_chunk(self, chunk: Dict[str, Any], val_freq: int,
                     rec_freq: int) -> None:
        """Fetch one dispatched chunk's stats (the fence: one copy per
        dtype group), then its host tail (``server.py:1692-1837``)."""
        R = chunk["R"]
        round0 = chunk["round0"]
        tic = time.time()
        with self._tspan("stats_fetch", round0=round0, rounds=R):
            stats = chunk["stats"].fetch()
        if self.scope is not None:
            # the fetch is the chunk's fence: its device window ends here
            self.scope.end(chunk.get("span"))
        toc = time.time()
        if chunk.get("fleet_wb") is not None:
            # the chunk's rows into the host store, its slots unpinned,
            # before the host tail reads them (server.py:1718-1726)
            with self._tspan("fleet_writeback", round0=round0, rounds=R):
                self.fleet_pager.complete_writeback(chunk["fleet_wb"])
        rs = self.run_stats
        # serial: prep to fence; pipelined: fence to fence, since this
        # chunk's prep began before the previous fence
        rs["secsPerRound"] += [
            (toc - max(chunk["tic"], self._last_fence)) / R] * R
        self._last_fence = toc
        rs["secsPerRoundDrainWait"] += [(toc - tic) / R] * R
        for key, name in (("pack", "secsPerRoundPack"),
                          ("stage", "secsPerRoundStage"),
                          ("dispatch", "secsPerRoundDispatch")):
            rs[name] += [chunk["secs"][key] / R] * R
        with self._tspan("host_tail", round0=round0, rounds=R):
            self._drain_host_tail(chunk, stats, val_freq, rec_freq)
        rs["secsPerRoundHostTail"] += [(time.time() - toc) / R] * R
        if self.scope is not None:
            self._observe_chunk(chunk, stats)

    def _observe_chunk(self, chunk: Dict[str, Any], stats: List[dict]
                       ) -> None:
        """The scope's per-chunk tail (``server.py:1733-1857``): the
        compile events and the live MFU, the pager's and the lazy cache's
        counters on the host-side bus, then the watchdog's and the
        rollup's observations of each round — values the tail already
        holds, no device read.  A watchdog ``abort`` raises from here, at
        the drain of the round that tripped it."""
        scope, round0, R = self.scope, chunk["round0"], chunk["R"]
        step = round0 + R - 1
        chunk_mfu = self._drain_device_truth(chunk, round0, R)
        rss = host_rss_bytes()
        xla = self.engine.xla
        xla_snap = (xla.snapshot() if xla is not None else
                    {"recompiles": int(self.engine.recompile_count)})
        gauges: Dict[str, Any] = {}
        if self.fleet_pager is not None:
            pd = self.fleet_pager.describe()
            for key in ("hits", "misses", "evictions", "resident"):
                gauges[f"fleet_page_{key}"] = pd[key]
                scope.devbus_host(f"fleet_page_{key}", pd[key], step=step)
            wb = chunk.get("fleet_wb") or {}
            for key in ("page_in_bytes", "writeback_bytes"):
                scope.devbus_host(f"fleet_{key}", wb.get(key, 0), step=step)
            if pd["prefetch_hit_rate"] is not None:
                scope.devbus_host("fleet_prefetch_hit_rate",
                                  pd["prefetch_hit_rate"], step=step)
            for key in ("page_in_bytes", "page_in_bytes_per_device",
                        "writeback_bytes", "writeback_bytes_per_device",
                        "prefetch_hit_rate", "migrations", "forced_drains"):
                if pd.get(key) is not None:
                    gauges[f"fleet_{key}"] = pd[key]
        cache_stats = getattr(self.train_dataset, "cache_stats", None)
        if cache_stats is not None:
            cs = cache_stats()
            for key in ("hits", "misses", "evictions", "resident"):
                gauges[f"lazy_cache_{key}"] = cs[key]
                scope.devbus_host(f"lazy_cache_{key}", cs[key], step=step)
        util = (self.megabatch_utilization if self.megabatch is not None
                else None)
        if util is not None:
            gauges["megabatch_utilization"] = util
            scope.devbus_host("megabatch_utilization", util, step=step)
        if gauges and scope.rollup is not None:
            scope.rollup.update_gauges(gauges)
        secs = self.run_stats["secsPerRound"][-1]
        for j, st in enumerate(stats):
            n = max(st["client_count"], 1.0)
            quarantine_frac = None
            if "shield_nonfinite" in st:
                # quarantined over the live cohort (client_count is the
                # count after the screen)
                q = st["shield_nonfinite"] + st["shield_norm_outlier"]
                quarantine_frac = q / max(q + st["client_count"], 1.0)
            scope.watchdog.observe_round(
                round0 + j, train_loss=st["train_loss_sum"] / n,
                round_secs=secs,
                ckpt_failures=self.ckpt.escalator.consecutive,
                quarantine_frac=quarantine_frac,
                recompiles=self.engine.recompile_count,
                host_rss_bytes=rss)
            scope.rollup_observe(round0 + j, secs,
                                 clients=st["client_count"], mfu=chunk_mfu,
                                 rss_bytes=rss, xla_snapshot=xla_snap)

    def _drain_host_tail(self, chunk: Dict[str, Any], stats: List[dict],
                         val_freq: int, rec_freq: int) -> None:
        """The per-round logging, privacy stats, defense counters and
        server replay, in the order of the serial loop, then the chunk's
        housekeeping (``server.py:1838-1983``)."""
        round0, R = chunk["round0"], chunk["R"]
        client_lr = chunk["client_lr"]
        for j in range(R):
            r = round0 + j
            st = stats[j]
            if "privacy" in st:
                self._process_privacy_stats(st["privacy"], r)
            n_clients = max(st["client_count"], 1.0)
            self.metrics.log("Training loss",
                             st["train_loss_sum"] / n_clients, step=r)
            self.metrics.log("LR for agg. opt.", chunk["server_lrs"][j],
                             step=r)
            self.metrics.log("Client learning rate", client_lr, step=r)
            self.metrics.log("Agg. grad norm", st["agg_grad_norm"], step=r)
            self._log_defense(st, r)
            self._log_carry(st, r)
            if self.server_replay is not None:
                self._run_server_replay(r)
        if self.scope is not None:
            # the bus's scalars, from the same packed readback
            self.scope.consume_devbus(stats, round0)
        self._defense_events(stats, round0)
        if "dp_clip" in stats[-1]:
            # the clip the next round applies, logged at that round once a
            # chunk (server.py:1962-1968)
            self.metrics.log("DP clip norm", stats[-1]["dp_clip"],
                             step=round0 + R)
        if "dump_norm" in stats[0]:
            self._dump_norm_stats(stats, chunk["masks"])
        for ev in self.engine.drain_megabatch_events():
            # a bucket the gate sent to the vmap arm; the record reaches
            # the streams only through a scope (``server.py:1994-1997``)
            self.megabatch_fallbacks += 1
            print_rank(f"megabatch_fallback: {ev}", logging.WARNING)
            if self.scope is not None:
                fields = dict(ev)
                self.scope.event(fields.pop("kind"), **fields)
        self._round_housekeeping(
            round0 + R, val_freq, rec_freq,
            latest=chunk["snapshot"],
            rng_snapshot=chunk["rng_snapshot"],
            ckpt_secs=chunk["secs"]["ckpt"], rounds=R)

    # ------------------------------------------------------------------
    # telemetry (``server.py:935-960, 1087-1093, 1979-2172``)
    # ------------------------------------------------------------------
    def _tspan(self, name: str, **args):
        """One span of the scope, or the shared no-op context without
        one."""
        return (self.scope.span(name, **args) if self.scope is not None
                else NULL_SPAN)

    def _watchdog_mark(self, kind: str, fields: Dict[str, Any]) -> None:
        """A watchdog's ``mark`` action: the finding in the status log."""
        self.ckpt.update_status({f"watchdog_{kind}": dict(fields)})

    def _rollup_dropped(self, rec: Dict[str, Any]) -> None:
        """The rollup writer exhausted its ladder: the window is lost,
        counted and reported; training goes on."""
        self.event("rollup_windows_dropped",
                   windows_dropped=int(self.scope.rollup.windows_dropped),
                   window=rec.get("window"))

    def _flight_on_preempt(self) -> None:
        """Preemption flush hook: the flight record, before the drain."""
        self.scope.record_flight(
            f"preemption: {self.preemption.reason or 'requested'}")

    def _drain_xla_events(self) -> None:
        """The device-truth layer's buffered ``xla_compile`` and
        ``recompile`` records into the streams."""
        if self.scope is None or self.engine.xla is None:
            return
        for ev in self.engine.xla.drain_events():
            self.scope.event(ev.pop("kind"), **ev)

    def _drain_device_truth(self, chunk: Dict[str, Any], round0: int,
                            R: int) -> Optional[float]:
        """The compile events, then the chunk's live MFU: its counted
        FLOPs a round (taken at dispatch) over its seconds a round and the
        card's peak, with the dispatch's peak allocation, on the host-side
        bus.  Returns the MFU, or None."""
        self._drain_xla_events()
        disp = chunk.get("xla_dispatch")
        if not disp or not disp.get("flops") or self._chip is None:
            return None
        flops = float(disp["flops"]) / max(int(disp.get("rounds") or R), 1)
        value = mfu(flops, self.run_stats["secsPerRound"][-1],
                    peak_flops=self._chip[1])
        if value is not None:
            self.run_stats["mfuPerRound"].append(value)
            self.scope.devbus_host("mfu", value, step=round0 + R - 1)
        hbm = disp.get("hbm_bytes")
        if hbm:
            self.scope.devbus_host("hbm_program_gb", hbm / 2 ** 30,
                                   step=round0 + R - 1)
        return value

    def build_scorecard(self) -> Dict[str, Any]:
        """The run's compact regression surface
        (``telemetry/scorecard.json``, ``server.py:2029-2172``): values the
        run already measured.  Its ``fleet``, ``infra_faults`` and
        ``traffic`` blocks are :meth:`fleet_summary`'s and
        :meth:`traffic_summary`'s."""
        rs = self.run_stats

        def p50(values):
            return (round(float(np.percentile(values, 50)), 6)
                    if values else None)

        eff = self.padding_efficiency
        card: Dict[str, Any] = {
            "rounds": int(self.state.round),
            "pipeline_depth": int(self.pipeline_depth),
            "pipelined_chunks": int(self.pipelined_chunks),
            "round_secs_p50": p50(rs["secsPerRound"]),
            "host_tail_secs_p50": p50(rs["secsPerRoundHostTail"]),
            "staged_bytes_per_round_p50": p50(
                rs["hostToDeviceBytesPerRound"]),
            "padding_efficiency": (round(eff, 6) if eff is not None
                                   else None),
            "mfu_p50": p50(rs["mfuPerRound"]),
            "puts_per_dispatch": int(self.engine.last_dispatch_puts),
            "compiles": len(self.engine.compile_log),
            "recompiles": int(self.engine.recompile_count),
        }
        fires: Dict[str, int] = {}
        if self.scope is not None:
            for finding in self.scope.watchdog.findings:
                kind = str(finding.get("kind", "?"))
                fires[kind] = fires.get(kind, 0) + 1
        card["watchdog_fires"] = fires
        if self.scope is not None and self.scope.tracer is not None:
            card["trace_events_dropped"] = int(self.scope.tracer.dropped)
        if self.scope is not None and self.scope.rollup is not None:
            card["rollup_windows"] = int(self.scope.rollup.windows_flushed)
            card["rollup_windows_dropped"] = int(
                self.scope.rollup.windows_dropped)
        fleet = self.fleet_summary()
        if fleet is not None:
            if fleet["infra_faults"] is not None:
                card["infra_faults"] = fleet["infra_faults"]
            card["fleet"] = fd = fleet["fleet"]
            card["fleet_page_in_bytes_per_device"] = \
                fd["page_in_bytes_per_device"]
            card["fleet_writeback_bytes_per_device"] = \
                fd["writeback_bytes_per_device"]
            if fd["prefetch_hit_rate"] is not None:
                card["fleet_prefetch_hit_rate"] = fd["prefetch_hit_rate"]
        cache_stats = getattr(self.train_dataset, "cache_stats", None)
        if cache_stats is not None:
            card["lazy_cache"] = cache_stats()
        if self.cohort_bucketing is not None:
            card["cohort_bucketing"] = {
                "boundaries": list(self.cohort_bucketing["boundaries"]),
                "max_buckets": int(self.cohort_bucketing["max_buckets"]),
                "bucket_grid_variants": len(self.engine.bucket_shapes_seen),
            }
        if self.megabatch is not None:
            util = self.megabatch_utilization
            card["megabatch"] = {
                "lanes": [int(n) for n in self.megabatch["lanes"]],
                "utilization": (round(util, 6) if util is not None
                                else None),
                "gate_arms": {f"K{k}_S{s}": arm for (k, s), arm in
                              sorted(self.engine.mega_gate.items())},
            }
            card["megabatch_utilization"] = card["megabatch"]["utilization"]
        traffic = self.traffic_summary()
        if traffic is not None:
            card["traffic"] = traffic
        xla = self.engine.xla
        if xla is not None:
            card["entry_points"] = xla.summary()
            card["hbm_peak_bytes"] = xla.hbm_peak_bytes()
            if self._chip is not None:
                card["chip"] = {"kind": self._chip[0],
                                "peak_flops": self._chip[1]}
        # the overlap geometry from the flushed trace, through the one
        # reader (scope_cli.summarize)
        try:
            from ..telemetry.scope_cli import summarize
            overlap = summarize(self.ckpt.model_dir).get("overlap") or {}
            card["overlap_efficiency_pct"] = overlap.get("efficiency_pct")
            if "by_depth" in overlap:
                card["host_tail_by_depth_s"] = overlap["by_depth"]
            if "max_rounds_in_flight" in overlap:
                card["max_rounds_in_flight"] = \
                    overlap["max_rounds_in_flight"]
        except (OSError, ValueError):
            card["overlap_efficiency_pct"] = None
        return card

    def _dump_norm_stats(self, stats: List[dict], masks: list) -> None:
        """Each round's client payload norms and their cosines against the
        aggregate, the sampled clients' alone, one JSON list a line
        (``server.py:2411-2427``)."""
        for key, name in (("dump_norm", "norm_stats.txt"),
                          ("dump_cosine", "cosines.txt")):
            with open(os.path.join(self.ckpt.model_dir, name), "a",
                      encoding="utf-8") as fh:
                for st, mask in zip(stats, masks):
                    fh.write(json.dumps(
                        np.asarray(st[key])[np.asarray(mask) > 0].tolist())
                        + "\n")

    def _log_carry(self, stats: Dict[str, float], r: int) -> None:
        """The carry paths' round scalars, from the packed stats: fused
        SCAFFOLD's ``|c|`` and fused RL's reward, Q loss and epsilon."""
        log = self.metrics.log
        if "scaffold_c_norm" in stats:
            log("Control norm (server c)", stats["scaffold_c_norm"], step=r)
        if "rl_reward" in stats:
            log("RL Rewards", stats["rl_reward"], step=r)
            log("RL Q loss", stats["rl_qloss"], step=r)
            log("RL epsilon", stats["rl_epsilon"], step=r)

    def _run_server_replay(self, round_idx: int) -> None:
        """``server_iterations`` epochs of the replay optimizer over the
        server's data, every user's samples in one client, repacked (and
        reshuffled from ``_np_rng``) each round; the result replaces the
        global params, the server optimizer's state is left as it is
        (``msrflute_tpu/engine/server.py:2366-2411``)."""
        replay = self.server_replay
        if "update" not in replay:
            names = replay["updatable_names"]
            replay["update"] = build_client_update(
                self.task, replay["opt_cfg"],
                ClientHParams(num_epochs=replay["iterations"],
                              updatable_layers=names))
            ds = replay["dataset"]
            merged = {k: np.concatenate([ds.user_arrays(i)[k]
                                         for i in range(len(ds))])
                      for k in ds.user_arrays(0)}
            n = len(next(iter(merged.values())))
            bs = int(self.config.server_config.data_config.train.get(
                "batch_size", self.batch_size))
            replay["pack"] = (ArraysDataset(["server"], [merged]), bs,
                              steps_for(n, bs))
            replay["lr"] = float(replay["opt_cfg"].get("lr", 0.01))
        one, bs, steps = replay["pack"]
        batch = pack_round_batches(one, [0], bs, steps, rng=self._np_rng)
        dev = self.device
        arrays = {k: torch.from_numpy(v).to(dev)
                  for k, v in batch.arrays.items()}
        mask = torch.from_numpy(batch.sample_mask).to(dev)
        gens = (self.engine.client_generators(round_idx, [SERVER_SLOT],
                                              tag=REPLAY_TAG)
                if self.engine.random else None)
        pg, tl, _, _ = replay["update"](self.state.params, arrays, mask,
                                        replay["lr"], gens)
        st = self.state
        self.state = ServerState(st.params - pg[0], st.opt_state, st.round,
                                 st.strategy_state)
        print_rank(f"server replay loss {float(tl[0]):.4f}")

    # ------------------------------------------------------------------
    def _host_round_setup(self, round_no: int):
        """The host rounds' prologue (``server.py:2607``): client and
        server LR, the cohort and its packed batch."""
        client_lr = self.initial_lr_client * self.lr_weight
        server_lr = (self.plateau.lr if self.plateau is not None
                     else self.server_lr_schedule(round_no))
        sampled = self._sample()
        batch = pack_round_batches(
            self.train_dataset, sampled, self.batch_size,
            self._chunk_steps([sampled]), rng=self._np_rng,
            desired_max_samples=self.desired_max_samples)
        self._maybe_length_bucket([batch])
        self._record_staged_bytes([batch], 1)
        self._record_padding_efficiency([batch])
        return client_lr, server_lr, batch

    def _host_round_tail(self, round_no: int, batch, stats, tls, ws_np
                         ) -> None:
        """Privacy bookkeeping, the round's mean loss and weight sum."""
        self._process_payload_privacy(stats, batch, round_no)
        n_real = max(float((batch.client_ids >= 0).sum()), 1.0)
        self.metrics.log("Training loss", float(tls.sum()) / n_real,
                         step=round_no)
        self.metrics.log("Aggregated weights", float(ws_np.sum()),
                         step=round_no)

    def _process_payload_privacy(self, stats, batch, round_no: int) -> None:
        keys = [k for k in stats if k.startswith("privacy_")]
        if keys:
            host = {k: stats[k].float().cpu().numpy() for k in keys}
            host["client_mask"] = batch.client_mask
            self._process_privacy_stats(host, round_no)

    def _run_scaffold_round(self, round_no: int) -> None:
        """One SCAFFOLD round: the ``c - c_i`` offsets into every local
        step, sample-count aggregation, then option II on the controls
        (host store or device table) for the clients that took part."""
        client_lr, server_lr, batch = self._host_round_setup(round_no)
        ids = batch.client_ids
        offsets = (self.scaffold_device.offsets(ids)
                   if self.scaffold_device is not None else
                   torch.from_numpy(self.scaffold_store.offsets(ids)).to(
                       self.device))
        pgs, ws, tls, stats = self.engine.client_payloads(
            self.state, batch, client_lr, grad_offsets=offsets,
            leakage_threshold=self.max_allowed_leakage)
        del offsets
        self.state = self.engine.apply_custom_weights(self.state, pgs, ws,
                                                      server_lr)
        ws_np = ws.cpu().numpy()
        epochs = int(self.config.client_config.get("num_epochs", 1) or 1)
        # real local steps a client: steps with a real sample, per epoch
        steps = (batch.sample_mask.sum(axis=2) > 0).sum(axis=1) * epochs
        self.scaffold_store.set_round(-1)   # the files change from here
        if self.scaffold_device is not None:
            c_norm = float(self.scaffold_device.update(
                ids, steps, pgs, ws, client_lr,
                total_clients=len(self.train_dataset)))
        else:
            self.strategy.update_controls(
                self.scaffold_store, ids, steps, pgs.cpu().numpy(),
                client_lr, total_clients=len(self.train_dataset),
                weights=ws_np)
            c_norm = float(np.linalg.norm(self.scaffold_store.c))
        self._host_round_tail(round_no, batch, stats, tls, ws_np)
        self.metrics.log("Control norm (server c)", c_norm, step=round_no)
        if self.scope is not None:
            self.scope.devbus_host("scaffold_c_norm", c_norm, step=round_no)

    def _run_ef_round(self, round_no: int) -> None:
        """One error-feedback round: the payloads plus the stored
        residuals, quantized a row at a time (one launch of kernel B3),
        the quantized payloads aggregated, ``corrected - q`` kept for the
        clients that took part."""
        client_lr, server_lr, batch = self._host_round_setup(round_no)
        ids = batch.client_ids
        real = ids[ids >= 0]
        if len(np.unique(real)) != len(real):
            raise ValueError(
                "ef_quant round batch contains duplicate client ids "
                f"({sorted(real.tolist())}); per-client EF residuals "
                "require without-replacement sampling")
        pgs, ws, tls, stats = self.engine.client_payloads(
            self.state, batch, client_lr,
            leakage_threshold=self.max_allowed_leakage)
        thresh = self.strategy.next_threshold()
        if self.strategy.quant_anneal != 1.0:
            self.metrics.log("Quantization Thresh.", thresh, step=round_no)
        if self.scope is not None:
            self.scope.devbus_host("ef_quant_thresh", float(thresh),
                                   step=round_no)
        residuals = (self.ef_device.rows(ids) if self.ef_device is not None
                     else torch.from_numpy(self.ef_store.rows(ids)).to(
                         self.device))
        self.ef_store.set_round(-1)   # the files change from here
        q, new_res = self.strategy.ef_step(pgs, residuals, thresh)
        del pgs, residuals
        self.state = self.engine.apply_custom_weights(self.state, q, ws,
                                                      server_lr)
        ws_np = ws.cpu().numpy()
        if self.ef_device is not None:
            self.ef_device.update(ids, new_res, ws)
        else:
            keep = (ids >= 0) & (ws_np > 0)
            self.ef_store.update(ids, new_res.cpu().numpy(), keep)
        self._host_round_tail(round_no, batch, stats, tls, ws_np)

    def _run_rl_round(self, round_no: int) -> None:
        """One RL round (reference ``core/strategies/dga.py:286-406``):
        the payloads once, candidate A under the strategy's weights and B
        under the RL weights (both from the round's state), the one that
        validates better kept, the policy rewarded and trained."""
        client_lr, server_lr, batch = self._host_round_setup(round_no)
        pgs, ws, _, stats = self.engine.client_payloads(
            self.state, batch, client_lr,
            leakage_threshold=self.max_allowed_leakage)
        ws_np = ws.cpu().numpy()
        k = int((batch.client_ids >= 0).sum())
        state_vec = np.concatenate(
            [ws_np[:k]] + [stats[key].float().cpu().numpy()[:k]
                           for key in ("mag", "mean", "var_corrected")])
        baseline_state = self.engine.apply_custom_weights(
            self.state, pgs, ws, server_lr)
        action = self.rl.forward(state_vec)
        rl_w = self.rl.weights_from_action(action)
        rl_w_full = np.zeros_like(ws_np)
        rl_w_full[:k] = rl_w[:k] if len(rl_w) >= k else \
            np.pad(rl_w, (0, k - len(rl_w)))
        rl_state = self.engine.apply_custom_weights(
            self.state, pgs, rl_w_full, server_lr)
        del pgs
        self.state = baseline_state
        baseline_acc = self._val_acc()
        self.state = rl_state
        rl_acc = self._val_acc()
        rl_cfg = self.config.server_config.get("RL") or RLConfig()
        reward, keep_rl = self.rl.compute_reward(
            baseline_acc, rl_acc, bool(rl_cfg.get("marginal_update_RL",
                                                  True)))
        self.state = rl_state if keep_rl else baseline_state
        self.rl_kept.append(bool(keep_rl))
        self.metrics.log("RL Rewards", reward, step=round_no)
        self.metrics.log("Val acc (baseline vs RL)",
                         {"baseline": baseline_acc, "rl": rl_acc},
                         step=round_no)
        self._process_payload_privacy(stats, batch, round_no)
        self.rl.train(state_vec, action, reward)
        self.rl.save()
        self.metrics.log("RL Running Loss", self.rl.running_loss,
                         step=round_no)

    def _val_acc(self) -> float:
        """Validation accuracy (else minus the loss) for the RL reward."""
        metrics = self._evaluate("val", events=None)
        if "acc" in metrics:
            return float(metrics["acc"].value)
        return -float(metrics["loss"].value)

    def _process_privacy_stats(self, stats: Dict[str, np.ndarray],
                               round_no: int) -> None:
        """Log the attack metrics over the round's real clients (the
        largest value of each, and the dropped count), and move the
        leakage threshold to the ``adaptive_leakage_threshold`` quantile of
        the round's sorted leakages (reference ``core/server.py:390-409``)."""
        real = stats["client_mask"] > 0

        def select(key):
            vals = stats[key][real]
            return vals[np.isfinite(vals)]

        self.metrics.log("Dropped clients",
                         float(select("privacy_dropped").sum()),
                         step=round_no)
        for key, name in (
                ("privacy_overlap", "Extracted indices percentage"),
                ("privacy_leakage", "Practical epsilon (Max leakage)"),
                ("privacy_above_rank", "Words percentage above rank")):
            if key in stats:
                finite = select(key)
                if finite.size:
                    self.metrics.log(name, float(finite.max()),
                                     step=round_no)
        if self.adaptive_leakage is not None and "privacy_leakage" in stats:
            values = np.sort(select("privacy_leakage"))
            if values.size:
                idx = min(int(self.adaptive_leakage * values.size),
                          values.size - 1)
                self.max_allowed_leakage = float(values[idx])
                print_rank("updated leakage threshold to "
                           f"{self.max_allowed_leakage}")

    # ------------------------------------------------------------------
    def _round_housekeeping(self, round_no: int, val_freq: int,
                            rec_freq: int, latest=None,
                            rng_snapshot: Optional[dict] = None,
                            ckpt_secs: float = 0.0, rounds: int = 1) -> None:
        """Eval cadence, LR decay, fall-back, status log, checkpoint
        (reference ``core/server.py:448-490``).  ``latest``: the snapshot
        to save as ``latest``, taken when a later chunk was dispatched
        before this one drained; None saves the current state, which any
        fall-back or server replay has already replaced.  ``rng_snapshot``: the resume anchor
        taken at dispatch when packing looked ahead; None takes it now.
        ``ckpt_secs`` and ``rounds``: the chunk's earlier checkpoint time
        and its round count, for ``secsPerRoundCkptSubmit``."""
        with self._tspan("housekeeping", round=round_no):
            self._round_housekeeping_inner(round_no, val_freq, rec_freq,
                                           latest, rng_snapshot, ckpt_secs,
                                           rounds)

    def _round_housekeeping_inner(self, round_no: int, val_freq: int,
                                  rec_freq: int, latest, rng_snapshot,
                                  ckpt_secs: float, rounds: int) -> None:
        tic = time.time()
        if round_no % val_freq == 0:
            improved = self._maybe_eval("val", round_no)
            if not improved and self.lr_decay_factor != 1.0:
                self.lr_weight *= self.lr_decay_factor
                print_rank(f"decayed client lr weight to {self.lr_weight}")
            if self.plateau is not None and "loss" in self._last_val and \
                    np.isfinite(self._last_val["loss"].value):
                self.plateau.step(self._last_val["loss"].value)
            if self.fall_back_to_best and not improved:
                self._fall_back()
        if round_no % rec_freq == 0 and self.test_dataset is not None:
            self._maybe_eval("test", round_no)

        status = {
            "i": round_no,
            "weight": self.lr_weight,
            "np_rng_state": (
                rng_snapshot if rng_snapshot is not None
                else copy.deepcopy(self._np_rng.bit_generator.state)),
            **{f"best_val_{k}": m.value for k, m in self.best_val.items()},
        }
        if self.best_val:
            status["best_val_hib"] = {k: bool(m.higher_is_better)
                                      for k, m in self.best_val.items()}
        if self.quant_thresh is not None:
            status["quant_thresh"] = float(self.quant_thresh)
        if self.plateau is not None:
            status["plateau"] = {"lr": self.plateau.lr,
                                 "best": self.plateau.best,
                                 "bad_rounds": self.plateau.bad_rounds}
        # the status leads the chunk's durable sequence (status, latest,
        # store markers) and the ring keeps an entry a chunk: whichever
        # slot a crash leaves loadable, its round's anchors are on disk
        # (server.py:2487-2495)
        self._status_ring.append([int(round_no), dict(status)])
        del self._status_ring[:-STATUS_RING]
        status["status_ring"] = self._status_ring
        self.ckpt.update_status(status)
        tac = time.time()
        with self._tspan("ckpt_submit", round=round_no):
            self.ckpt.save_latest(self.state if latest is None else latest)
            self.ckpt.backup(round_no, best_names=tuple(self.best_val))
        self.run_stats["secsPerRoundCkptSubmit"] += [
            (ckpt_secs + time.time() - tac) / rounds] * rounds
        sc = self.config.server_config
        for store, table, freq_key in (
                (self.scaffold_store, self.scaffold_device,
                 "scaffold_flush_freq"),
                (self.ef_store, self.ef_device, "ef_flush_freq")):
            # the marker takes the round once its checkpoint is written;
            # a device table writes its dirty rows through first, every
            # flush_freq rounds and at the last
            if store is None:
                continue
            # the marker claims a checkpoint on disk
            self.ckpt.wait()
            freq = int(sc.get(freq_key, 1) or 1)
            if table is None:
                store.set_round(self.state.round)
            elif freq <= 1 or round_no % freq == 0 or \
                    round_no >= self._max_iteration:
                table.flush()
                store.set_round(self.state.round)
        spill_freq = int((self._fleet_cfg or {}).get("spill_freq", 1) or 1)
        if self.fleet_pager is not None and (
                spill_freq <= 1 or round_no % spill_freq == 0 or
                round_no >= self._max_iteration):
            # the rows' durability (server.py:2553-2578): spilled, then
            # the marker commits the drained round once its checkpoint is
            # on disk; generations at or below the round before it may go
            self.ckpt.wait()
            self.fleet_pager.flush()
            self.fleet_pager.set_round(int(round_no))
            self.fleet_pager.mark_durable(int(round_no) - 1)
        self.metrics.flush()
        if self.scope is not None:
            # the trace rewritten at most every FLUSH_INTERVAL_SECS, and at
            # most one rollup record a window (``server.py:2582-2592``)
            self.scope.flush_throttled()
            self.scope.rollup_housekeeping()
        self.run_stats["secsPerRoundHousekeeping"].append(time.time() - tic)

    def _evaluate(self, split: str, events):
        """The split's metrics at the current params, as the engine's
        ``eval_step`` entry point (``server.py:660-666``)."""
        batches = self._staged_eval(split)
        span = self.scope.span if self.scope is not None else None
        return self.engine._entry(
            "eval_step", (self.state.params, batches),
            lambda: evaluate(self.task, self.engine.params_dict(self.state),
                             batches, events=events, span=span))

    def _split_cfg(self, split: str):
        dc = self.config.server_config.data_config
        return dc.val if split == "val" else dc.test

    def _staged_eval(self, split: str):
        if split not in self._eval_batches:
            dataset = (self.val_dataset if split == "val"
                       else self.test_dataset)
            bs = int(self._split_cfg(split).get("batch_size",
                                                self.batch_size))
            packed = pack_eval_batches(dataset, bs)
            #: the grid's user of each row (-1 on padding), for the eval
            #: outputs
            self._eval_users[split] = packed["user_idx"]
            self._eval_batches[split] = stage_eval_batches(packed,
                                                           self.device)
        return self._eval_batches[split]

    def _dump_predictions(self, split: str, round_no: int) -> None:
        """``wantLogits``: one JSON row per real sample into
        ``predictions_<split>_r<N>.jsonl`` in the model directory, written
        to a temporary file renamed into place (``server.py:3040-3100``)."""
        task = self.task
        if getattr(task, "topk_predictions", None) is None and \
                getattr(task, "predict", None) is None:
            print_rank(f"wantLogits set for {split} but task "
                       f"{type(task).__name__} exposes neither "
                       "topk_predictions nor predict — no dump written",
                       loglevel=logging.WARNING)
            return
        path = os.path.join(self.ckpt.model_dir,
                            f"predictions_{split}_r{round_no}.jsonl")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            for row in prediction_rows(
                    task, self.engine.params_dict(self.state),
                    self._staged_eval(split), self._eval_users[split]):
                fh.write(json.dumps(row) + "\n")
        os.replace(tmp, path)
        print_rank(f"wrote {split} predictions to {path}")

    def _log_per_user_stats(self, split: str, round_no: int,
                            dataset) -> None:
        """``per_user_stats``: the worst user's accuracy, its 10th, 50th and
        90th percentiles, its spread and the users evaluated
        (``server.py:2989-3038``); a task that is not a classification
        with labels ``y`` warns and skips."""
        batches = self._staged_eval(split)
        if getattr(self.task, "predict", None) is None or \
                "y" not in batches:
            print_rank(f"per_user_stats set for {split} but task "
                       f"{type(self.task).__name__} is not "
                       "classification-style (needs apply() + y labels); "
                       "skipping", loglevel=logging.WARNING)
            return
        users = torch.from_numpy(self._eval_users[split]).to(self.device)
        accs = per_user_accuracy(self.task,
                                 self.engine.params_dict(self.state),
                                 batches, users, len(dataset))
        accs = accs[~np.isnan(accs)]
        if accs.size == 0:
            return
        cap = split.capitalize()
        self.metrics.log(f"{cap} acc (worst user)", float(accs.min()),
                         step=round_no)
        for pct in (10, 50, 90):
            self.metrics.log(f"{cap} acc (user p{pct})",
                             float(np.percentile(accs, pct)), step=round_no)
        self.metrics.log(f"{cap} acc (user std)", float(accs.std()),
                         step=round_no)
        self.metrics.log(f"{cap} acc (users evaluated)", int(accs.size),
                         step=round_no)

    def _maybe_eval(self, split: str, round_no: int) -> bool:
        dataset = self.val_dataset if split == "val" else self.test_dataset
        if dataset is None or len(dataset) == 0:
            return False
        with self._tspan("eval", split=split, round=round_no):
            metrics = self._evaluate(split, events=self.event)
        for name, metric in metrics.items():
            self.metrics.log(f"{split.capitalize()} {name}", metric.value,
                             step=round_no)
        if self._split_cfg(split).get("wantLogits", False):
            self._dump_predictions(split, round_no)
        if self._split_cfg(split).get("per_user_stats", False):
            self._log_per_user_stats(split, round_no, dataset)
        self.history.append({"split": split, "round": round_no,
                             **{k: m.value for k, m in metrics.items()}})
        improved = False
        if split == "val":
            self._last_val = metrics
            for name, metric in metrics.items():
                if not np.isfinite(metric.value):
                    # a NaN must never become the best value
                    self.event("eval_nonfinite_skipped", split=split,
                               metric=name, round=round_no,
                               value=str(metric.value))
                    continue
                prev = self.best_val.get(name)
                if prev is None or metric.is_better_than(prev):
                    self.best_val[name] = metric
                    self.ckpt.save_best(self.state, name)
                    if name == self.best_model_criterion:
                        improved = True
            # traffic.target_accuracy: the first val eval at or above the
            # target pins the round (server.py:2974-2987)
            acc = metrics.get("acc")
            if self.target_accuracy is not None and \
                    self.rounds_to_target_accuracy is None and \
                    acc is not None and np.isfinite(acc.value) and \
                    float(acc.value) >= self.target_accuracy:
                self.rounds_to_target_accuracy = int(round_no)
                self.event("target_accuracy_reached", round=round_no,
                           acc=float(acc.value), target=self.target_accuracy)
        return improved

    def _fall_back(self) -> None:
        """Reload the best checkpoint, keeping the round and the LR weight
        (reference ``core/server.py:561-578``)."""
        restored = self.ckpt.load(
            self.device, f"best_val_{self.best_model_criterion}_model.pt")
        if restored is not None:
            restored.round = self.state.round
            self.state = restored
            print_rank("fell back to previous best model")
            # rows gathered since that checkpoint belong to the abandoned
            # trajectory (a device table resets its store too)
            for store, table, what in (
                    (self.scaffold_store, self.scaffold_device,
                     "SCAFFOLD controls"),
                    (self.ef_store, self.ef_device, "EF residuals")):
                if store is not None:
                    (table or store).reset()
                    print_rank(f"reset {what} after fallback")

    def _log_timing(self) -> None:
        for key, values in self.run_stats.items():
            if values:
                self.metrics.log(f"{key} (mean)", float(np.mean(values)))
                self.metrics.log(f"{key} (p50)",
                                 float(np.percentile(values, 50)))
                self.metrics.log(f"{key} (p95)",
                                 float(np.percentile(values, 95)))


def select_server(server_type: str) -> type:
    """``personalization`` -> :class:`~.personalization.PersonalizationServer`,
    else :class:`OptimizationServer` (``msrflute_tpu/engine/server.py:3140``)."""
    if str(server_type or "").lower() == "personalization":
        from .personalization import PersonalizationServer
        return PersonalizationServer
    return OptimizationServer
