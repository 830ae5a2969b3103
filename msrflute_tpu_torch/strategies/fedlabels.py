"""FedLabels semi-supervision — the port's counterpart of
``msrflute_tpu/strategies/fedlabels.py`` (reference
``core/strategies/fedlabels.py``, ``Trainer.run_train_epoch_sup``,
``get_label_VAT``).

Each client trains a **supervised** model on its labeled ``x``/``y``
through the round's client update (kernel B1 under ``pallas_apply``), and
from ``burnout_round`` on an **unsupervised** one that starts at the
round's global params and learns from pseudo-labels on its unlabeled
``ux``:

- labels (VAT selection, ``comp: var``): the initial ("local") and the
  supervised ("server") model score ``ux`` at temperature ``temp``; the
  side with the larger variance of its probabilities labels a sample when
  its top probability exceeds ``thre``, with the losing side's variance
  over the winner's as the sample's confidence weight;
- loss ``unsup_lamb * CE(net(ux_in), labels) + vat_consis * KL(server ||
  net)`` (weighted, over samples where both sides agree) ``+ l2_lambda *``
  the per-leaf mean squared distance to the initial params, where ``ux_in``
  is the RandAugment view ``ux_rand`` under ``uda: 1``;
- plain SGD at ``eta`` for ``unsuptrain_ep`` passes over the ``[S, B]``
  grid, a step with no selected sample leaving the params as they were,
  all K clients at once under ``torch.func.vmap``.  It is a plain tensor
  update: the JAX package runs it through optax, outside any Pallas
  kernel, so kernel B1 is not launched for it.

Parts ``sup`` (weight 1 a client) and ``unsup`` (weight ``max(ns, 1)``)
are averaged apart, and the server "loads" ``(sup_avg + unsup_avg) / 2``
as the pseudo-gradient ``w0 - (sup_avg + unsup_avg) / 2``, which the
canonical server SGD at lr 1.0 applies exactly.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.func import grad, vmap

from ..device import cpu16_guard
from ..models.base import softmax_xent
from .base import BaseStrategy, State, filter_weight

#: the unlabeled streams a semisupervision batch carries beside ``x``/``y``
UNLABELED = ("ux", "ux_rand", "uy")


class FedLabels(BaseStrategy):

    #: its two payload parts do not take the RL hook
    supports_rl = False
    #: the unsupervised pass trains outside the client update the
    #: megabatch lane scan stands in for (``fedlabels.py:56``)
    supports_megabatch = False

    def __init__(self, config):
        super().__init__(config)
        # read as the JAX package reads it: the client section's, else the
        # server section's, else a top-level block
        ss = (config.client_config.get("semisupervision")
              or config.server_config.get("semisupervision")
              or config.extra.get("semisupervision") or {})
        self.eta = float(ss.get("eta", 0.01))
        self.burnout_round = int(ss.get("burnout_round", 0))
        self.temp = float(ss.get("temp", 1.0))
        self.thre = float(ss.get("thre", 0.6))
        self.vat_consis = float(ss.get("vat_consis", 1.0))
        self.l2_lambda = float(ss.get("l2_lambda", 0.0))
        self.unsup_lamb = float(ss.get("unsup_lamb", 1.0))
        self.uda = int(ss.get("uda", 0))
        self.unsuptrain_ep = int(ss.get("unsuptrain_ep", 1))

    def client_step(self, client_update, global_flat, arrays, sample_mask,
                    client_lr, gens=None, quant_threshold=None,
                    client_rngs=None, bounds=None, round_idx=None,
                    leakage_threshold=None, strategy_state=None,
                    grad_offset=None):
        labeled = {k: v for k, v in arrays.items() if k not in UNLABELED}
        pg_sup, tl, ns, stats = client_update(global_flat, labeled,
                                              sample_mask, client_lr, gens)
        sup = global_flat - pg_sup
        active = "ux" in arrays and (round_idx is None or
                                     round_idx >= self.burnout_round)
        if active:
            with cpu16_guard(sup.device, self.task.compute_dtype):
                unsup = self.unsup_train(global_flat, sup, arrays,
                                         sample_mask)
        else:
            unsup = global_flat.expand_as(sup)
        w = filter_weight(torch.clamp(ns, min=1.0))
        return ({"sup": (sup, torch.ones_like(w)), "unsup": (unsup, w)},
                tl, ns, stats)

    def _pseudo_labels(self, initial, sup, u_clean, mask):
        """One client's VAT labels on one batch of ``ux``: labels, their
        mask, confidence weights, the agreement mask, and the supervised
        model's log-probabilities."""
        task, temp = self.task, self.temp
        local = F.softmax(task.apply(initial, u_clean) / temp, dim=-1)
        server = F.softmax(task.apply(sup, u_clean) / temp, dim=-1)
        lvar = torch.var(local, dim=-1, correction=0)
        svar = torch.var(server, dim=-1, correction=0)
        use_local = lvar >= svar
        chosen = torch.where(use_local[:, None], local, server)
        est_mask = (chosen.max(-1).values > self.thre).to(mask.dtype) * mask
        est_labels = torch.argmax(chosen, dim=-1)
        est_var = torch.where(use_local, svar / torch.clamp(lvar, min=1e-12),
                              lvar / torch.clamp(svar, min=1e-12))
        agree = (torch.argmax(local, -1) == torch.argmax(server, -1))
        log_srv = torch.log(torch.clamp(server, min=1e-12))
        return (est_labels, est_mask, est_var, agree.to(mask.dtype) * est_mask,
                log_srv)

    def _unsup_loss(self, net, initial, u_in, u_clean, est_labels, est_mask,
                    est_var, agree_mask, log_srv):
        task = self.task
        out = task.apply(net, u_in)
        out_clean = task.apply(net, u_clean)
        ce = softmax_xent(out, est_labels)
        unsup = torch.sum(ce * est_mask) / torch.clamp(est_mask.sum(),
                                                       min=1.0)
        log_net = F.log_softmax(out_clean / self.temp, dim=-1)
        kl = torch.sum(torch.exp(log_srv) * (log_srv - log_net), dim=-1)
        consist = torch.sum(kl * est_var * agree_mask) / torch.clamp(
            agree_mask.sum(), min=1.0)
        reg = sum(torch.mean((net[n] - initial[n]) ** 2) for n in net)
        return (self.unsup_lamb * unsup + self.vat_consis * consist +
                self.l2_lambda * reg)

    def unsup_train(self, initial_flat: torch.Tensor, sup: torch.Tensor,
                    arrays: Dict[str, torch.Tensor],
                    sample_mask: torch.Tensor) -> torch.Tensor:
        """The K clients' unsupervised models ``[K, P]``, each started at
        ``initial_flat`` ``[P]``, from the supervised ones ``sup``."""
        layout = self.task.layout()
        initial = layout.views(initial_flat)
        ux = arrays["ux"]
        ux_in = arrays.get("ux_rand", ux) if self.uda == 1 else ux
        S = sample_mask.shape[1]
        # the labels depend on the initial and supervised models only, so
        # every pass over the grid reads the same ones
        with torch.no_grad():
            labels = [vmap(self._pseudo_labels, in_dims=(None, 0, 0, 0))(
                initial, layout.views(sup), ux[:, s], sample_mask[:, s])
                for s in range(S)]
        grad_fn = vmap(grad(self._unsup_loss),
                       in_dims=(0, None, 0, 0, 0, 0, 0, 0, 0))
        net = initial_flat.expand_as(sup).contiguous()
        for _ in range(max(self.unsuptrain_ep, 1)):
            for s in range(S):
                grads = grad_fn(layout.views(net), initial, ux_in[:, s],
                                ux[:, s], *labels[s])
                step = net - self.eta * layout.flatten(grads, batch_dims=1)
                has_data = labels[s][1].sum(-1) > 0
                net = torch.where(has_data[:, None], step, net)
        return net

    def combine_parts(self, part_sums, deferred: Optional[State],
                      state: State, seed: int, num_clients: float,
                      global_params: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, State]:
        sup, unsup = part_sums["sup"], part_sums["unsup"]
        sup_avg = sup["grad_sum"] / torch.clamp(sup["weight_sum"], min=1e-12)
        unsup_avg = unsup["grad_sum"] / torch.clamp(unsup["weight_sum"],
                                                    min=1e-12)
        return global_params - (sup_avg / 2 + unsup_avg / 2), state
