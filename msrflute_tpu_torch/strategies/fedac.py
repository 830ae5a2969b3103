"""FedAC, federated accelerated SGD (arXiv:2006.08950) — the port's
counterpart of ``msrflute_tpu/strategies/fedac.py:35-89``.

Three coupled sequences; the engine's params are the canonical ``w`` and
``strategy_state["w_ag"]`` the aggregate sequence (checkpointed with the
state).  Per round:

    w_md  = (1/beta) * w + (1 - 1/beta) * w_ag      (broadcast point)
    Delta = weighted-average client pseudo-gradient from w_md
    w_ag' = w_md - eta * lr * Delta
    w'    = (1 - 1/alpha) * w + (1/alpha) * w_md - gamma * lr * Delta

``alpha = beta = gamma = 1`` is FedAvg with a plain SGD server step.  Unset
couplings take FedAC-I's ``alpha = gamma / eta``, ``beta = alpha + 1``.
The server optimizer's state passes through untouched (the engine calls
:meth:`FedAC.apply_server_update` instead of it).  Local DP is FedAvg's
client step (clip, weight, noise at ``eps >= 0``); adaptive clipping is
refused, as in the JAX package.
"""

from __future__ import annotations

import torch

from .fedavg import FedAvg


class FedAC(FedAvg):

    owns_server_update = True
    supports_rl = False
    stateful = True

    def __init__(self, config):
        # refused before FedAvg's own checks, whose advice would mislead
        # (``fedac.py:44-53``)
        dp = getattr(config, "dp_config", None) or {}
        if dp.get("adaptive_clipping"):
            raise ValueError(
                "FedAC and dp_config.adaptive_clipping both need the "
                "strategy-state slot (w_ag vs dp_clip) — not supported "
                "together; use strategy: fedavg for adaptive clipping")
        super().__init__(config)
        sc = config.server_config
        self.eta = float(sc.get("fedac_eta", 1.0))
        self.gamma = float(sc.get("fedac_gamma", max(self.eta, 1.0)))
        alpha, beta = sc.get("fedac_alpha"), sc.get("fedac_beta")
        self.alpha = (float(alpha) if alpha is not None else
                      max(self.gamma / max(self.eta, 1e-12), 1.0))
        self.beta = float(beta) if beta is not None else self.alpha + 1.0

    def init_state(self, params):
        return {"w_ag": params.clone()}

    def _md_point(self, params, state):
        inv_b = 1.0 / self.beta
        return inv_b * params + (1.0 - inv_b) * state["w_ag"]

    def broadcast_params(self, params, state):
        return self._md_point(params, state)

    def apply_server_update(self, params, agg, state, server_lr):
        md = self._md_point(params, state)
        lr = torch.tensor(server_lr, dtype=torch.float32)
        new_ag = md - (self.eta * lr) * agg
        inv_a = 1.0 / self.alpha
        new_w = (1.0 - inv_a) * params + inv_a * md - (self.gamma * lr) * agg
        return new_w, {"w_ag": new_ag}
