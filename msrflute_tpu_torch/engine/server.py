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

Rounds run one after another.  ``rounds_per_step`` keeps the JAX
package's host-side order of random draws — a chunk of R rounds (never
crossing an eval boundary) samples its R cohorts first, then packs them
— so both packages draw the same cohorts and grids from one seed; the
rounds themselves are not fused into one program.
"""

from __future__ import annotations

import copy
import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import OptimizerConfig, parse_clients_per_round
from ..data.batching import (pack_eval_batches, pack_round_batches,
                             pow2_ceil, steps_for)
from ..data.dataset import ArraysDataset
from ..device import DeviceLike, resolve_device
from ..models.base import BaseTask, Metric, Params
from ..optim import PlateauTracker, make_lr_schedule
from ..strategies import select_strategy
from ..utils.logging import MetricsLog, print_rank
from .checkpoint import CheckpointManager
from .client_update import ClientHParams, build_client_update
from .evaluation import evaluate, stage_eval_batches
from .round import SERVER_SLOT, RoundEngine, ServerState

#: the replay's dropout stream: ``[seed, r, SERVER_SLOT, REPLAY_TAG]``
REPLAY_TAG = 5


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
        self.strategy = select_strategy(config.strategy)(config)
        self.engine = RoundEngine(task, config, self.strategy, self.device,
                                  seed=seed)
        self.ckpt = CheckpointManager(model_dir, self.engine.layout,
                                      sc.get("model_backup_freq", 100))

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

        # static round geometry
        self.batch_size = int(cc.data_config.train.get("batch_size", 32))
        self.desired_max_samples = cc.get("desired_max_samples") or \
            cc.data_config.train.get("desired_max_samples")
        self.max_steps = steps_for(int(np.max(train_dataset.num_samples)),
                                   self.batch_size, self.desired_max_samples)
        self.step_bucketing = bool(cc.get("step_bucketing", True))

        self._np_rng = np.random.default_rng(seed)
        self._eval_batches: Dict[str, dict] = {}
        self.run_stats: Dict[str, List[float]] = {
            "secsPerRound": [], "secsPerRoundHousekeeping": []}
        #: one record per evaluation: split, round and metric values
        self.history: List[Dict[str, float]] = []

        self.state = self.engine.init_state(
            init_params if init_params is not None
            else task.init_params(seed))
        if sc.get("resume_from_checkpoint", False):
            self._resume()

    # ------------------------------------------------------------------
    def _resume(self) -> bool:
        """Reload the latest checkpoint and the status log; False when
        there is no checkpoint to resume from."""
        restored = self.ckpt.load(self.device)
        if restored is None:
            return False
        self.state = restored
        status = self.ckpt.read_status()
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

    def _sample(self) -> list:
        """The round's cohort (a subclass may hook work onto the draw, as
        the personalization server does: anything it draws from
        ``_np_rng`` comes after the cohort and before the round's own
        packing, as in the JAX package)."""
        sc = self.config.server_config
        n = parse_clients_per_round(sc.get("num_clients_per_iteration", 10),
                                    self._np_rng)
        n = min(n, len(self.train_dataset))
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

    def train(self):
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

        round_no = self.state.round
        while round_no < max_iteration:
            R = chunk_R(round_no)
            client_lr = self.initial_lr_client * self.lr_weight
            samples = [self._sample() for _ in range(R)]
            steps = self._chunk_steps(samples)
            batches = [pack_round_batches(
                self.train_dataset, sampled, self.batch_size, steps,
                rng=self._np_rng,
                desired_max_samples=self.desired_max_samples)
                for sampled in samples]
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
            for j, batch in enumerate(batches):
                r = round_no + j
                server_lr = (self.plateau.lr if self.plateau is not None
                             else self.server_lr_schedule(r))
                tic = time.time()
                # run_round ends in its stats fetch, so this wall time
                # covers the round's device work
                self.state, stats = self.engine.run_round(
                    self.state, batch, client_lr, server_lr,
                    quant_threshold=thresholds[j],
                    leakage_threshold=self.max_allowed_leakage)
                self.run_stats["secsPerRound"].append(time.time() - tic)
                if "privacy" in stats:
                    self._process_privacy_stats(stats["privacy"], r)
                n_clients = max(stats["client_count"], 1.0)
                self.metrics.log("Training loss",
                                 stats["train_loss_sum"] / n_clients, step=r)
                self.metrics.log("LR for agg. opt.", server_lr, step=r)
                self.metrics.log("Client learning rate", client_lr, step=r)
                self.metrics.log("Agg. grad norm", stats["agg_grad_norm"],
                                 step=r)
                if self.server_replay is not None:
                    self._run_server_replay(r)
            round_no += R
            self._round_housekeeping(round_no, val_freq, rec_freq)
        self._log_timing()
        self.metrics.flush()
        return self.state

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
                            rec_freq: int) -> None:
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

        self.ckpt.save_latest(self.state)
        self.ckpt.backup(round_no, best_names=tuple(self.best_val))
        status = {
            "i": round_no,
            "weight": self.lr_weight,
            "np_rng_state": copy.deepcopy(self._np_rng.bit_generator.state),
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
        self.ckpt.update_status(status)
        self.metrics.flush()
        self.run_stats["secsPerRoundHousekeeping"].append(time.time() - tic)

    def _split_cfg(self, split: str):
        dc = self.config.server_config.data_config
        return dc.val if split == "val" else dc.test

    def _maybe_eval(self, split: str, round_no: int) -> bool:
        dataset = self.val_dataset if split == "val" else self.test_dataset
        if dataset is None or len(dataset) == 0:
            return False
        if split not in self._eval_batches:
            bs = int(self._split_cfg(split).get("batch_size",
                                                self.batch_size))
            self._eval_batches[split] = stage_eval_batches(
                pack_eval_batches(dataset, bs), self.device)
        metrics = evaluate(self.task, self.engine.params_dict(self.state),
                           self._eval_batches[split])
        for name, metric in metrics.items():
            self.metrics.log(f"{split.capitalize()} {name}", metric.value,
                             step=round_no)
        self.history.append({"split": split, "round": round_no,
                             **{k: m.value for k, m in metrics.items()}})
        improved = False
        if split == "val":
            self._last_val = metrics
            for name, metric in metrics.items():
                if not np.isfinite(metric.value):
                    continue   # a NaN must never become the best value
                prev = self.best_val.get(name)
                if prev is None or metric.is_better_than(prev):
                    self.best_val[name] = metric
                    self.ckpt.save_best(self.state, name)
                    if name == self.best_model_criterion:
                        improved = True
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
