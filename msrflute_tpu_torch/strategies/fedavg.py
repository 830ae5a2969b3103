"""FedAvg / FedProx aggregation — the port's counterpart of
``msrflute_tpu/strategies/fedavg.py``: each client weighs its
``num_samples`` (through :func:`filter_weight`), and the aggregate is the
weighted sum of pseudo-gradients over the weight sum.  FedProx shares it;
its proximal term lives in the client update.

Local DP (``dp_config.enable_local_dp``) runs :func:`..privacy.apply_local_dp`
on each client's payload without weight noise (``fedavg.py:126-141``), its
noise from the client's ``[seed, r, k, 2]`` stream.  Adaptive clipping
(``dp_config.adaptive_clipping``, Andrew et al., arXiv:1905.03871;
``fedavg.py:46-150``) tracks the ``target_quantile`` of the clients' update
norms:

- the clip ``dp_clip`` is strategy state (checkpointed with the round, so a
  resumed run goes on bit for bit), starting at ``min(initial_clip,
  max_grad)``, and replaces ``max_grad`` in the clip;
- each client's pre-clip update norm gives a below-clip indicator, summed
  as its own payload part ``clip_frac`` with weight 1 for a client whose
  weight is not 0;
- the combine noises the below-clip count with ``N(0, count_sigma^2)``
  (``count_sigma`` defaults to m / 20 over the m counted clients; 0 turns
  it off) and moves the clip geometrically, ``C <- C exp(-clip_lr (b -
  target))`` with ``b`` the noised fraction, capped at ``max_grad``.

The count noise comes from the round's server stream with a tag of its own
(the JAX package folds 23 into its round key: the streams differ, as
ROADMAP.md §C records).  ``enable_global_dp`` is accepted and ignored, as
in the JAX package, where only DGA's combine calls ``apply_global_dp``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..privacy import apply_local_dp
from .base import BaseStrategy, filter_weight

#: the count noise's stream: the round's server seed and this tag
COUNT_NOISE_TAG = 23


class FedAvg(BaseStrategy):
    supports_adaptive_clipping = True

    def __init__(self, config):
        super().__init__(config)
        dp = self.dp_config
        self.local_dp = bool(dp.get("enable_local_dp", False))
        self.adaptive_clip = None
        if dp.get("adaptive_clipping") and not self.local_dp:
            raise ValueError(
                "dp_config.adaptive_clipping requires enable_local_dp: true "
                "(the clip applies inside the local-DP transform)")
        ac = dp.get("adaptive_clipping") if self.local_dp else None
        if ac:
            max_grad = float(dp.get("max_grad", 1.0))
            self.adaptive_clip = {
                "target": float(ac.get("target_quantile", 0.5)),
                "lr": float(ac.get("clip_lr", 0.2)),
                "init": min(float(ac.get("initial_clip", max_grad)),
                            max_grad),
                "count_sigma": ac.get("count_sigma"),
            }
            if float(dp.get("eps", -1.0)) >= 0:
                from ..utils.logging import print_rank
                print_rank(
                    "adaptive_clipping: the below-clip count query is "
                    "noised centrally (sigma_b) and is NOT composed "
                    "into the RDP accountant — budget accordingly")

    def client_weight(self, *, num_samples, train_loss, stats):
        return filter_weight(num_samples)

    def init_state(self, params):
        if self.adaptive_clip is None:
            return super().init_state(params)
        return {"dp_clip": torch.tensor(self.adaptive_clip["init"],
                                        dtype=torch.float32,
                                        device=params.device)}

    def client_step(self, client_update, global_flat, arrays, sample_mask,
                    client_lr, gens=None, quant_threshold=None,
                    client_rngs=None, bounds=None, round_idx=None,
                    leakage_threshold=None, strategy_state=None,
                    grad_offset=None):
        if not self.local_dp:
            return super().client_step(
                client_update, global_flat, arrays, sample_mask, client_lr,
                gens, quant_threshold=quant_threshold,
                client_rngs=client_rngs, bounds=bounds, round_idx=round_idx,
                leakage_threshold=leakage_threshold,
                strategy_state=strategy_state, grad_offset=grad_offset)
        pg, tl, ns, stats = client_update(global_flat, arrays, sample_mask,
                                          client_lr, gens,
                                          grad_offset=grad_offset)
        w = self.client_weight(num_samples=ns, train_loss=tl, stats=stats)
        w = self._apply_privacy_metrics(pg, w, stats, global_flat, arrays,
                                        sample_mask, leakage_threshold)
        clip = None
        if self.adaptive_clip is not None and strategy_state:
            clip = strategy_state["dp_clip"]
            # the indicator reads the PRE-clip update norm
            below = (torch.sqrt(torch.sum(pg * pg, dim=1)) <= clip).to(
                torch.float32)
        z = None
        if float(self.dp_config.get("eps", -1.0)) >= 0:
            K, P = pg.shape
            z = torch.stack([torch.randn(P + 1, generator=g,
                                         device=pg.device)
                             for g in client_rngs(2)])
        pg, w = apply_local_dp(pg, w, self.dp_config, add_weight_noise=False,
                               z=z, clip=clip)
        parts = {"default": (pg, w)}
        if clip is not None:
            # weight 1 for a client whose payload was not dropped, so the
            # quantile tracks the population being aggregated
            parts["clip_frac"] = (below[:, None], (w > 0).to(torch.float32))
        return parts, tl, ns, stats

    def combine_parts(self, part_sums, deferred, state, seed, num_clients,
                      global_params=None):
        if self.adaptive_clip is None or "clip_frac" not in part_sums:
            return super().combine_parts(part_sums, deferred, state, seed,
                                         num_clients,
                                         global_params=global_params)
        default = part_sums["default"]
        agg, _ = self.combine(default["grad_sum"], default["weight_sum"],
                              deferred, {}, seed, num_clients)
        frac = part_sums["clip_frac"]
        below_count = frac["grad_sum"][0]
        m = torch.clamp(frac["weight_sum"], min=1.0)
        ac = self.adaptive_clip
        sigma_b = ac["count_sigma"]
        sigma_b = m / 20.0 if sigma_b is None else float(sigma_b)
        # one normal from the round's server stream, drawn on the host so
        # that every device reads the same draw
        z = float(np.random.default_rng(
            [int(seed), COUNT_NOISE_TAG]).standard_normal())
        noisy_count = below_count + sigma_b * z
        b = torch.clamp(noisy_count / m, 0.0, 1.0)
        new_clip = state["dp_clip"] * torch.exp(-ac["lr"] * (b - ac["target"]))
        new_clip = torch.clamp(
            new_clip, max=float(self.dp_config.get("max_grad", 1.0)))
        if self.devbus is not None:
            # the noised below-clip fraction and the adapted clip
            # (``strategies/fedavg.py:149-156``)
            self.devbus.publish("dp_clip_frac", b)
            self.devbus.publish("dp_clip", new_clip)
        return agg, {"dp_clip": new_clip}
