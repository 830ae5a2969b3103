"""FedBuff, buffered asynchronous aggregation (arXiv:2106.06639) — the
port's counterpart of ``msrflute_tpu/strategies/fedbuff.py:74-185``, with
drawn staleness, or under ``server_config.traffic`` in ``buffered`` mode
the arrival plane's traced staleness (:attr:`supports_traced_staleness`:
the round hands ``client_step`` each update's true version gap).

- ``strategy_state["history"]`` is ``[S, P]``, the last
  ``S = max_staleness`` broadcast versions, index 0 the current one
  (checkpointed with the state);
- each client draws ``s_i`` uniform over ``0 .. S-1`` from its own stream
  ``[seed, round, client, FEDBUFF_TAG]``, on the host, so that every device
  draws the same ``s`` (the JAX package draws from its
  ``fold_in(rng_client, 23)``, which the port cannot repeat bit for bit:
  the draw matches in law, and given the same ``s`` the round matches),
  trains from ``history[s_i]`` and returns ``history[s_i] - y_T``;
- its weight is FedAvg's times ``(1 + s_i) ** -rho``;
- the server step is owned: plain SGD on the aggregate, then the history
  rolls (the new params in front, the oldest version dropped).

``max_staleness: 1`` is FedAvg exactly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import host_to_device
from .fedavg import FedAvg

#: the staleness draw's stream tag (the JAX package folds in 23)
FEDBUFF_TAG = 23


class FedBuff(FedAvg):

    supports_rl = False
    supports_traced_staleness = True
    stateful = True
    owns_server_update = True
    #: the state is the version history, which FedAvg's ``dp_clip`` cannot
    #: share; local DP runs through FedAvg's client step
    supports_adaptive_clipping = False

    def __init__(self, config):
        super().__init__(config)
        fb = config.server_config.get("fedbuff", True)
        fb = fb if isinstance(fb, dict) else {}
        self.max_staleness = int(fb.get("max_staleness", 4))
        self.rho = float(fb.get("staleness_exponent", 0.5))

    def init_state(self, params):
        return {"history": params.expand(self.max_staleness, -1).clone()}

    def draw_staleness(self, client_rngs) -> torch.Tensor:
        """``[K]`` int64 ``s_i``, one uniform draw a client from numpy's
        generator on the seed of its :data:`FEDBUFF_TAG` stream, so the
        draw is the same on every device (as the engine's staleness
        coins are)."""
        gens = client_rngs(FEDBUFF_TAG)
        draws = [np.random.default_rng(g.initial_seed()).integers(
            0, self.max_staleness) for g in gens]
        return host_to_device(draws, gens[0].device, torch.int64)

    def client_step(self, client_update, global_flat, arrays, sample_mask,
                    client_lr, gens=None, quant_threshold=None,
                    client_rngs=None, bounds=None, round_idx=None,
                    leakage_threshold=None, strategy_state=None,
                    grad_offset=None,
                    staleness: Optional[torch.Tensor] = None):
        """``staleness`` (``[K]`` ints) replaces the draw: each client then
        trains from ``history[min(s, S - 1)]`` and the discount keeps the
        given ``s``, as the JAX package's traced mode does."""
        if staleness is None:
            s_true = self.draw_staleness(client_rngs)
        else:
            s_true = torch.as_tensor(staleness, dtype=torch.int64,
                                     device=global_flat.device)
        s_idx = torch.clamp(s_true, 0, self.max_staleness - 1)
        start = strategy_state["history"][s_idx]
        parts, tl, ns, stats = super().client_step(
            client_update, start, arrays, sample_mask, client_lr, gens,
            quant_threshold=quant_threshold, client_rngs=client_rngs,
            bounds=bounds, round_idx=round_idx,
            leakage_threshold=leakage_threshold,
            strategy_state=strategy_state, grad_offset=grad_offset)
        pg, w = parts["default"]
        discount = (1.0 + s_true.to(torch.float32)) ** (-self.rho)
        parts["default"] = (pg, w * discount)
        return parts, tl, ns, stats

    def apply_server_update(self, params, agg, state, server_lr):
        lr = torch.tensor(server_lr, dtype=torch.float32)
        new_params = params - lr * agg
        history = torch.cat([new_params[None], state["history"][:-1]])
        return new_params, {"history": history}
