"""One federated round on one device — the port's counterpart of the monolithic
path of ``msrflute_tpu/engine/round.py::RoundEngine._build_round_step``.

Per round: the K clients train at once (:mod:`.client_update`), the
strategy weighs each client (FedAvg: its sample count), the client mask
zeroes padding clients' weights, loss and sample counts, the weighted sums
go through ``strategy.combine_parts``, and the server optimizer steps on
the aggregate pseudo-gradient as ``p + (-lr * agg)`` (optax's association).

Randomness: client k of round r draws its dropout masks from a
``torch.Generator`` seeded by ``np.random.SeedSequence([seed, r, k])`` —
the analogue of ``fold_in(rng, client_id)`` at ``round.py:851``.  A
resumed run therefore needs only the round number and the numpy sampling
state to replay every stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.batching import RoundBatch
from ..models.base import BaseTask, Params
from ..optim import make_optimizer
from ..strategies.base import BaseStrategy
from .client_update import ClientHParams, build_client_update


@dataclass
class ServerState:
    """Global model (flat ``[P]``), server optimizer state and round."""

    params: torch.Tensor
    opt_state: Dict[str, torch.Tensor]
    round: int = 0


def pallas_apply_flag(server_config) -> bool:
    """``server_config.megakernel.pallas_apply`` as the JAX engine reads it:
    opt-in, and off under ``enable: false``.  (``fused_epochs`` changes
    only how the JAX package traces its loop; the port's loop is the same
    math either way.)"""
    raw = server_config.get("megakernel") or {}
    return bool(raw.get("enable", True)) and bool(raw.get("pallas_apply",
                                                          False))


class RoundEngine:
    def __init__(self, task: BaseTask, config, strategy: BaseStrategy,
                 device: torch.device, seed: int = 0):
        self.task = task
        self.strategy = strategy
        self.device = device
        self.seed = int(seed)
        self.layout = task.layout()
        cc, sc = config.client_config, config.server_config
        self.hparams = ClientHParams(
            max_grad_norm=cc.get("max_grad_norm"),
            fedprox_mu=float(cc.get("fedprox_mu", 0.0) or 0.0),
            num_epochs=int(cc.get("num_epochs", 1) or 1),
            pallas_apply=pallas_apply_flag(sc))
        self.client_update = build_client_update(
            task, cc.optimizer_config, self.hparams)
        self.server_opt = make_optimizer(sc.optimizer_config)
        self.server_max_grad_norm = sc.get("max_grad_norm")
        self.random = any(rate > 0 for rate, _ in task.dropout_sites)
        #: local steps run so far (num_epochs x S per round): the number of
        #: optimizer-tail passes, hence of kernel B1 launches with
        #: pallas_apply
        self.local_steps = 0

    def init_state(self, params: Params) -> ServerState:
        flat = self.layout.flatten(params).to(self.device, torch.float32)
        return ServerState(flat, self.server_opt.init(flat), 0)

    def params_dict(self, state: ServerState) -> Params:
        return self.layout.views(state.params)

    def client_generators(self, round_idx: int, client_ids
                          ) -> Optional[List[torch.Generator]]:
        if not self.random:
            return None
        gens = []
        for cid in np.asarray(client_ids).tolist():
            entropy = [self.seed, int(round_idx), cid if cid >= 0 else 2**32]
            seed = int(np.random.SeedSequence(entropy).generate_state(
                1, dtype=np.uint64)[0] >> np.uint64(1))
            gens.append(torch.Generator(device=self.device).manual_seed(seed))
        return gens

    def run_round(self, state: ServerState, batch: RoundBatch,
                  client_lr: float, server_lr: float
                  ) -> Tuple[ServerState, Dict[str, float]]:
        dev = self.device
        arrays = {k: torch.from_numpy(v).to(dev)
                  for k, v in batch.arrays.items()}
        sample_mask = torch.from_numpy(batch.sample_mask).to(dev)
        cm = torch.from_numpy(batch.client_mask).to(dev)
        gens = self.client_generators(state.round, batch.client_ids)
        self.local_steps += self.hparams.num_epochs * sample_mask.shape[1]
        parts, tl, ns, stats = self.strategy.client_step(
            self.client_update, state.params, arrays, sample_mask,
            client_lr, gens)
        part_sums = {}
        for name, (pg, w) in parts.items():
            w = w * cm
            part_sums[name] = {"grad_sum": w @ pg, "weight_sum": w.sum()}
        agg = self.strategy.combine_parts(part_sums)
        if self.server_max_grad_norm is not None:
            norm = torch.linalg.vector_norm(agg)
            agg = agg * torch.clamp(float(self.server_max_grad_norm)
                                    / torch.clamp(norm, min=1e-12), max=1.0)
        new_params, opt_state = self.server_opt.step(
            state.params, agg, state.opt_state, server_lr)
        count = cm.sum()
        denom = torch.clamp(count, min=1.0)
        round_stats = {
            "train_loss_sum": (tl * cm).sum(),
            "num_samples_sum": (ns * cm).sum(),
            "client_count": count,
            "weight_sum": part_sums["default"]["weight_sum"],
            "grad_mean": (stats["mean"] * cm).sum() / denom,
            "grad_mag": (stats["mag"] * cm).sum() / denom,
            "grad_var": (stats["var_corrected"] * cm).sum() / denom,
            "grad_norm": (stats["norm"] * cm).sum() / denom,
            "agg_grad_norm": torch.linalg.vector_norm(agg),
        }
        # one device->host transfer for the whole stats dict
        host = torch.stack(list(round_stats.values())).cpu().tolist()
        return (ServerState(new_params, opt_state, state.round + 1),
                dict(zip(round_stats, host)))
