"""Personalization as device-resident carry — the port's counterpart of
``msrflute_tpu/strategies/personalized.py`` (``PersonalizedFedAvg``).

Under ``server_config.fused_carry: true`` the personalization server
selects this strategy instead of running its personal pass in
``_sample``: each user's local model ``local [N, P]`` (flat, in the
layout's order), its interpolation weight ``alpha [N]`` and a ``seen [N]``
gate live in ``strategy_state``, and the sampled users' local pass and
alpha step run in the round's own client step, beside the global pass,
so the round rides the dispatch ring like FedAvg.

- A user's first participation starts its local model from the round's
  live global params (``seen == 0`` selects them over the table row):
  ``personalization_init: global``, the only init carry mode takes.
- The local pass is a second ``client_update`` on the same batch, on the
  clients' ``fold_in(rng, 104729)`` sub-streams: here the clients'
  generators under tag 104729.  With ``pallas_apply`` it launches kernel
  B1 once a local step, as the global pass does.
- ``alpha`` takes one SGD step at the client learning rate on the
  interpolation objective over the post-training params (reference
  ``utils/utils.py:607-617``), clipped to ``[1e-4, 0.9999]``; a
  non-finite result resets it to ``alpha0``.
- A live user's rows are written (:func:`.base.scatter_rows`, a new table
  a round) and its ``seen`` set to 1; no host read anywhere.

The personalized eval reads the tables at an eval boundary
(:meth:`..engine.personalization.PersonalizationServer.personalized_eval`).
"""

from __future__ import annotations

import torch

from .base import gather_rows, scatter_rows
from .fedavg import FedAvg

#: the local pass's stream tag (``fold_in(rng, 104729)``)
LOCAL_PASS_SALT = 104729
ALPHA_MIN, ALPHA_MAX, ALPHA_DECAY = 1e-4, 0.9999, 0.02


class PersonalizedFedAvg(FedAvg):
    """FedAvg's aggregation with the users' local models and alphas as
    carry."""

    device_carry = True
    supports_rl = False
    client_passes = 2
    carry_tables = ("local", "alpha", "seen")

    def carry_row_defaults(self):
        # a user never seen starts at alpha0 with seen 0 (the local model
        # is then the live global one, whatever the row holds)
        return {"local": 0.0, "alpha": self.alpha0, "seen": 0.0}

    def __init__(self, config):
        super().__init__(config)
        if self.local_dp:
            raise ValueError(
                "fused_carry personalization does not compose with "
                "dp_config.enable_local_dp — the alpha update reads the raw "
                "global pseudo-gradient; drop fused_carry for DP runs")
        self.alpha0 = float(config.client_config.get("convex_model_interp",
                                                     0.75))
        init = config.server_config.get("personalization_init", "global")
        if init != "global":
            raise ValueError(
                "fused_carry personalization supports only "
                f"personalization_init: global (got {init!r}) — drop "
                "fused_carry for the other modes")

    def init_state(self, params):
        n, P, dev = self._carry_table_rows(), params.shape[-1], params.device
        return {"local": torch.zeros((n, P), dtype=torch.float32,
                                     device=dev),
                "alpha": torch.full((n,), self.alpha0, dtype=torch.float32,
                                    device=dev),
                "seen": torch.zeros(n, dtype=torch.float32, device=dev)}

    def client_step_carry(self, client_update, global_flat, arrays,
                          sample_mask, client_lr, gens=None, *, client_ids,
                          live_mask, strategy_state, **kw):
        parts, tl, ns, stats = self.client_step(
            client_update, global_flat, arrays, sample_mask, client_lr, gens,
            **kw)
        # no transform without DP: the raw global-pass pseudo-gradient
        pg_g = parts["default"][0]
        seen = gather_rows(strategy_state["seen"], client_ids) > 0
        table_local = gather_rows(strategy_state["local"], client_ids)
        local = torch.where(seen[:, None], table_local, global_flat[None, :])
        alpha = torch.where(seen, gather_rows(strategy_state["alpha"],
                                              client_ids), self.alpha0)
        client_rngs = kw.get("client_rngs")
        local_gens = (client_rngs(LOCAL_PASS_SALT)
                      if gens is not None else None)
        pg_p = client_update(local, arrays, sample_mask, client_lr,
                             local_gens)[0]
        new_local = local - pg_p
        a = alpha[:, None]
        grad_alpha = torch.sum(((global_flat[None, :] - pg_g) - new_local) *
                               (a * pg_g + (1.0 - a) * pg_p), dim=-1) \
            + ALPHA_DECAY * alpha
        new_alpha = torch.clamp(alpha - client_lr * grad_alpha, ALPHA_MIN,
                                ALPHA_MAX)
        new_alpha = torch.where(torch.isfinite(new_alpha), new_alpha,
                                self.alpha0)
        keep = (client_ids >= 0).to(torch.float32) * live_mask
        return parts, tl, ns, stats, {"row": new_local, "old": table_local,
                                      "alpha": new_alpha, "keep": keep}

    def apply_carry(self, state, client_ids, src, carry):
        # a row whose gate is 0 (a dropped user) writes its own row back
        keep = carry["keep"] > 0
        old = {k: gather_rows(state[k], client_ids)
               for k in ("alpha", "seen")}
        return {
            "local": scatter_rows(state["local"], client_ids, src,
                                  torch.where(keep[:, None], carry["row"],
                                              carry["old"])),
            "alpha": scatter_rows(state["alpha"], client_ids, src,
                                  torch.where(keep, carry["alpha"],
                                              old["alpha"])),
            "seen": scatter_rows(state["seen"], client_ids, src,
                                 torch.where(keep, 1.0, old["seen"])),
        }
