"""Local training of K clients at once — the port's counterpart of
``msrflute_tpu/engine/client_update.py::build_client_update``.

Semantics kept from the JAX package (and the reference FLUTE trainer):

- every client starts from the server's params with a fresh optimizer;
- masked local SGD over the ``[S, B]`` grid, ``num_epochs`` times, step
  ``t`` reading batch ``t % S`` (the fused-epoch indexing);
- per step: loss -> grad -> ``combine_grad_terms`` (FedProx, clip) ->
  stats -> optimizer step, with an all-padding step (``has_data`` 0) a
  no-op for params and the optimizer state (momentum; Adam's moments and
  step count);
- pseudo-gradient ``w_server - w_trained``; stats on it, including the
  reference's degenerate ``var`` (identically 0) and ``var_corrected``;
- ``mean_sample_loss`` and ``num_samples`` as in the JAX package:
  ``num_samples`` counts the task's unit, ``aux["train_sample_count"]``
  of its loss where it returns one (the GRU LM counts words), else rows.

Layout: the K clients' params are ONE flat ``[K, P]`` float32 buffer with
per-leaf views into it.  Gradients come from ``torch.func.vmap`` of
``grad_and_value`` over ``functional_call`` (the analogue of the JAX
``vmap``) and are flattened into a ``[K, P]`` grad buffer.  The optimizer
tail is then one pass over ``[K, P]``: for momentum SGD with
``pallas_apply`` (the JAX config key
``server_config.megakernel.pallas_apply``) one launch of kernel B1
(:mod:`..ops.fused_sgd`), else the plain ``fused_apply`` ops.  An
Adam-family client optimizer (``adam``, ``adamW``, ``adamax``) runs
``fused_opt_apply``: optax's arithmetic with a fresh state a round, the
client learning rate injected; it has no kernel, and ``pallas_apply``
with it raises ``ValueError``, as in the JAX package
(``client_update.py:182-187``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.func import grad_and_value, vmap

from ..models.base import BaseTask
from ..ops.fused_sgd import fused_sgd_apply
from ..optim import (SGD, combine_grad_terms, fused_apply, fused_opt_apply,
                     make_optimizer)


@dataclass(frozen=True)
class ClientHParams:
    max_grad_norm: Optional[float] = None
    fedprox_mu: float = 0.0
    num_epochs: int = 1
    #: the optimizer tail runs as kernel B1, one launch per local step
    pallas_apply: bool = False


def _suff_stats_of(flat: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row ``sum``, ``sum of squares`` and element count of ``[K, P]``."""
    n = torch.full((flat.shape[0],), float(flat.shape[1]),
                   dtype=flat.dtype, device=flat.device)
    return flat.sum(-1), (flat * flat).sum(-1), n


def _derive_stats(s, s2, n) -> Dict[str, torch.Tensor]:
    n = torch.clamp(n, min=1.0)
    mean = s / n
    mag = torch.sqrt(s2 / n)
    return {"sum": s, "sq_sum": s2, "n": n, "mean": mean, "mag": mag,
            "var": s2 / n - mag ** 2,             # reference formula (== 0)
            "var_corrected": s2 / n - mean ** 2,  # meaningful variance
            "norm": torch.sqrt(s2)}


def build_client_update(task: BaseTask, client_opt_cfg,
                        hparams: ClientHParams) -> Callable:
    """Returns ``client_update(global_flat, arrays, sample_mask, lr, gens)``
    -> ``(pseudo_grad [K, P], train_loss [K], num_samples [K], stats)``.

    ``global_flat`` is the ``[P]`` vector every client starts from, or a
    ``[K, P]`` stack of one start a client (the personalization server's
    local models); the pseudo-gradient is each client's start less its
    trained params.

    ``arrays``: dict of ``[K, S, B, ...]`` tensors; ``sample_mask``:
    ``[K, S, B]``; ``gens``: one ``torch.Generator`` per client for the
    dropout stream (``None`` when the task draws no random numbers)."""
    opt = make_optimizer(client_opt_cfg)
    sgd = isinstance(opt, SGD)
    if hparams.pallas_apply and not sgd:
        raise ValueError(
            "megakernel.pallas_apply requires a plain SGD client "
            "optimizer (momentum ok; no nesterov/weight_decay) — got "
            f"type={client_opt_cfg.get('type', 'sgd')!r}")
    layout = task.layout()
    mu = opt.momentum if sgd else 0.0
    epochs = max(int(hparams.num_epochs), 1)
    grad_fn = vmap(grad_and_value(task.loss_and_aux, has_aux=True))

    def client_update(global_flat: torch.Tensor,
                      arrays: Dict[str, torch.Tensor],
                      sample_mask: torch.Tensor, lr: float,
                      gens: Optional[List[torch.Generator]] = None):
        K, S, B = sample_mask.shape
        # a copy in every case: a [K, P] start is the caller's, and the
        # steps below update params in place
        params = global_flat.expand(K, -1).clone(
            memory_format=torch.contiguous_format)
        trace = (torch.zeros_like(params)
                 if sgd and (hparams.pallas_apply or mu) else None)
        opt_state = None if sgd else opt.init(params)
        views = layout.views(params)
        zero = torch.zeros((K,), dtype=torch.float32,
                           device=sample_mask.device)
        loss_sum = wloss_acc = ns_acc = zero
        for t in range(epochs * S):
            step = t % S
            mask = sample_mask[:, step]
            batch = {k: a[:, step] for k, a in arrays.items()}
            batch["sample_mask"] = mask
            masks = (task.draw_masks(gens, B, mask.device)
                     if gens is not None else ())
            grads, (loss, aux) = grad_fn(views, batch, masks)
            grads = combine_grad_terms(
                layout.flatten(grads, batch_dims=1),
                prox_mu=hparams.fedprox_mu, params=params,
                global_params=global_flat, max_norm=hparams.max_grad_norm)
            rows = mask.sum(-1)
            has_data = (rows > 0).to(torch.float32)
            loss_sum = loss_sum + has_data * loss
            # sample-weighted loss sum (loss is the batch's masked MEAN)
            wloss_acc = wloss_acc + loss * rows
            ns_acc = ns_acc + has_data * aux.get("train_sample_count", rows)
            if not sgd:
                opt_state = fused_opt_apply(opt, params, grads, opt_state,
                                            lr, has_data)
            elif hparams.pallas_apply:
                fused_sgd_apply(params, grads, trace, lr, mu, has_data)
            else:
                fused_apply(params, grads, trace, lr, mu, has_data)
            del grads

        pseudo_grad = global_flat - params
        stats = _derive_stats(*_suff_stats_of(pseudo_grad))
        rows_total = sample_mask.sum(dim=(1, 2))
        stats["mean_sample_loss"] = wloss_acc / torch.clamp(
            rows_total * epochs, min=1.0)
        return pseudo_grad, loss_sum, ns_acc / epochs, stats

    return client_update
