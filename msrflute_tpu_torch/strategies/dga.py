"""DGA, Dynamic Gradient Aggregation (arXiv:2106.07578) — the port's
counterpart of ``msrflute_tpu/strategies/dga.py:30-118`` (reference
``core/strategies/dga.py``):

- client softmax weight ``exp(-beta * metric)``, the metric
  ``train_loss / num_samples`` or a pseudo-gradient statistic
  (``mag`` / ``var`` / ``mean``) per ``weight_train_loss``, through
  :func:`filter_weight`; all weights 1 unless ``aggregate_median`` is
  ``softmax``;
- :meth:`DGA.transform_payload`: local DP (noising payload and weight),
  then quantization with the round's (annealed) threshold, which overrides
  the configured one when ``>= 0``;
- the staleness buffer: the engine defers a client with probability
  ``stale_prob``; :meth:`DGA.combine` folds in LAST round's deferred sums
  and banks this round's for the next;
- global DP on the aggregate (kernel B2).

The RL weight re-estimation hook (reference ``dga.py:286-406``) is a host
round of the server (``engine/server.py::_run_rl_round`` with
:class:`..rl.RLAggregator`, under ``server_config.wantRL``): the clients'
payloads come through :meth:`DGA.client_step` as in any round (local DP
and quantization included, kernel B3), then candidate A aggregates them
under these softmax weights and candidate B under the RL weights, both by
``RoundEngine.apply_custom_weights``; :meth:`DGA.combine` (staleness,
global DP) is not on that path, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.quantization import quantize_pytree
from ..privacy import apply_global_dp, apply_local_dp
from .base import BaseStrategy, filter_weight


class DGA(BaseStrategy):
    #: its combine keeps the staleness sums across rounds
    stateful = True

    def __init__(self, config):
        super().__init__(config)
        sc, cc, mc = (config.server_config, config.client_config,
                      config.model_config)
        self.aggregate_median = sc.get("aggregate_median", "softmax")
        self.softmax_beta = float(sc.get("softmax_beta", 1.0))
        self.weight_metric = sc.get("weight_train_loss", "train_loss")
        self.stale_prob = float(sc.get("stale_prob", 0.0) or 0.0)
        self.quant_threshold = cc.get("quant_thresh")
        if self.quant_threshold is None:
            self.quant_threshold = mc.get("quant_threshold")
        bits = cc.get("quant_bits")
        if bits is None:
            bits = mc.get("quant_bits")
        self.quant_bits = int(bits) if bits is not None else 10
        self.quant_approx = bool(cc.get("quant_approx", False))
        self.local_dp = bool(self.dp_config.get("enable_local_dp", False))
        self.global_dp = bool(self.dp_config.get("enable_global_dp", False))
        self._offsets_dev: Dict[tuple, torch.Tensor] = {}

    def client_weight(self, *, num_samples, train_loss, stats):
        if self.aggregate_median != "softmax":
            return filter_weight(torch.ones_like(train_loss))
        if self.weight_metric == "train_loss":
            metric = train_loss / torch.clamp(num_samples, min=1.0)
        elif self.weight_metric == "mag_var_loss":
            metric = stats["var"]
        elif self.weight_metric == "mag_mean_loss":
            metric = stats["mean"]
        else:
            metric = stats["mag"]
        return filter_weight(torch.exp(-self.softmax_beta * metric))

    def _bounds_on(self, bounds, device: torch.device) -> torch.Tensor:
        key = (tuple(bounds), device)
        if key not in self._offsets_dev:
            self._offsets_dev[key] = torch.tensor(bounds, dtype=torch.int64,
                                                  device=device)
        return self._offsets_dev[key]

    def transform_payload(self, pseudo_grad, weight, quant_threshold=None,
                          client_rngs=None, bounds=None):
        if self.local_dp:
            z = None
            if float(self.dp_config.get("eps", -1.0)) >= 0:
                K, P = pseudo_grad.shape
                z = torch.stack([
                    torch.randn(P + 1, generator=g,
                                device=pseudo_grad.device)
                    for g in client_rngs(2)])
            pseudo_grad, weight = apply_local_dp(
                pseudo_grad, weight, self.dp_config,
                add_weight_noise=self.aggregate_median == "softmax", z=z)
        if self.quant_threshold is not None:
            # the round's annealed threshold overrides the configured one
            # when >= 0 (reference core/server.py:294-298)
            thr = (float(quant_threshold) if quant_threshold is not None
                   and float(quant_threshold) >= 0
                   else float(self.quant_threshold))
            if bounds is None:
                raise ValueError("DGA quantization needs the leaf bounds")
            pseudo_grad = quantize_pytree(
                pseudo_grad, bounds, thr, self.quant_bits,
                approx=self.quant_approx,
                offsets_dev=self._bounds_on(bounds, pseudo_grad.device))
        return pseudo_grad, weight

    # ---- staleness buffer (dga.py:260-284) -----------------------------
    def init_state(self, params):
        if self.stale_prob <= 0.0:
            return {}
        return {"stale_grad_sum": torch.zeros_like(params),
                "stale_weight_sum": torch.zeros((), dtype=params.dtype,
                                                device=params.device)}

    def combine(self, weighted_grad_sum, weight_sum,
                deferred: Optional[dict], state, seed, num_clients):
        new_state = state
        if self.stale_prob > 0.0 and deferred is not None:
            # fold in LAST round's deferred contributions; bank this
            # round's for the next
            weighted_grad_sum = weighted_grad_sum + state["stale_grad_sum"]
            weight_sum = weight_sum + state["stale_weight_sum"]
            new_state = {"stale_grad_sum": deferred["grad_sum"],
                         "stale_weight_sum": deferred["weight_sum"]}
        agg = weighted_grad_sum / torch.clamp(weight_sum, min=1e-12)
        if self.global_dp:
            agg = apply_global_dp(agg, self.dp_config, seed, num_clients)
        return agg, new_state
