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
(:mod:`..ops.fused_sgd`), else the plain ``fused_apply`` ops.  Every
other client optimizer (the Adam family, ``lamb``, ``lars``, ``yogi``, SGD
with nesterov or weight decay) runs ``fused_opt_apply``: optax's
arithmetic with a fresh state a round, the client learning rate injected;
it has no kernel, and ``pallas_apply`` with it raises ``ValueError``, as
in the JAX package (``client_update.py:182-187``).

Layer controls and precision (``client_update.py:129-216``, ``:312-314``,
``:587-622``), each leaf named by its flax path
(:func:`..models.convert.flax_path`):

- ``freeze_layers``: after training, the pseudo-gradient of a leaf whose
  ``/``-joined path contains a pattern is zero (the local steps still
  move it);
- ``updatable_layers``: only leaves whose ``.``-joined path ``re.match``-es
  a pattern move (the optimizer state of the others still advances);
  ``pallas_apply`` with it raises, as in the JAX package;
- the precision policy: ``param_dtype`` holds the ``[K, P]`` copy and the
  optimizer state in that dtype (a 16-bit ``pallas_apply`` runs B1's
  16-bit arm); ``compute_dtype`` casts the params and the float batch
  features at the loss boundary (grads come back in the params' dtype);
  ``stats_dtype`` is the dtype of the loss and count accumulators.  None
  or ``"float32"`` runs the float32 code path unchanged.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.func import grad_and_value, vmap

from ..device import cpu16_guard
from ..models.base import BaseTask
from ..models.convert import flax_path
from ..ops.fused_sgd import fused_sgd_apply
from ..optim import (SGD, Lamb, Lars, combine_grad_terms, fused_apply,
                     fused_opt_apply, make_optimizer)
from ..utils.logging import print_rank


@dataclass(frozen=True)
class ClientHParams:
    max_grad_norm: Optional[float] = None
    fedprox_mu: float = 0.0
    num_epochs: int = 1
    #: the optimizer tail runs as kernel B1, one launch per local step
    pallas_apply: bool = False
    #: ``client_config.freeze_layer`` patterns (substrings of the
    #: ``/``-joined flax path)
    freeze_layers: Tuple[str, ...] = ()
    #: regex allowlist (``re.match`` on the ``.``-joined flax path): when
    #: set, only matching leaves move
    updatable_layers: Optional[Tuple[str, ...]] = None
    #: the precision policy (``server_config.precision``), dtype names
    param_dtype: Optional[str] = None
    compute_dtype: Optional[str] = None
    stats_dtype: Optional[str] = None


def resolve_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """A precision-policy entry: None for absent or ``"float32"`` (the two
    spellings run the same code), else a floating torch dtype."""
    if name is None or str(name) == "float32":
        return None
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
        raise ValueError(f"precision dtype must be floating, got {name!r}")
    return dt


def _cast_floats(tree: Dict[str, torch.Tensor], dt: torch.dtype
                 ) -> Dict[str, torch.Tensor]:
    """Every floating tensor to ``dt``; ids and masks keep their dtypes."""
    return {k: v.to(dt) if v.is_floating_point() else v
            for k, v in tree.items()}


def updatable_columns(layout, patterns: Tuple[str, ...],
                      device) -> torch.Tensor:
    """``[P]`` bools: the columns of every leaf whose ``.``-joined flax path
    ``re.match``-es one of ``patterns`` (the JAX package's
    ``_updatable_mask``)."""
    keep = torch.zeros(layout.numel, dtype=torch.bool)
    for name, a, n in zip(layout.names, layout.offsets, layout.sizes):
        path = ".".join(flax_path(name))
        moves = any(re.match(pat, path) for pat in patterns)
        print_rank(("updating " if moves else "freezing ") + path,
                   loglevel=logging.DEBUG)
        keep[a:a + n] = moves
    return keep.to(device)


def frozen_ranges(layout, patterns: Tuple[str, ...]
                  ) -> List[Tuple[int, int]]:
    """Column ranges of the leaves whose ``/``-joined flax path contains a
    pattern (the JAX package's ``_freeze_layers``)."""
    return [(a, a + n) for name, a, n in zip(layout.names, layout.offsets,
                                             layout.sizes)
            if any(f in "/".join(flax_path(name)) for f in patterns)]


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
    """Returns ``client_update(global_flat, arrays, sample_mask, lr, gens,
    grad_offset=None)`` -> ``(pseudo_grad [K, P], train_loss [K],
    num_samples [K], stats)``.

    ``global_flat`` is the ``[P]`` vector every client starts from, or a
    ``[K, P]`` stack of one start a client (the personalization server's
    local models); the pseudo-gradient is each client's start less its
    trained params.

    ``arrays``: dict of ``[K, S, B, ...]`` tensors; ``sample_mask``:
    ``[K, S, B]``; ``gens``: one ``torch.Generator`` per client for the
    dropout stream (``None`` when the task draws no random numbers);
    ``grad_offset``: a ``[K, P]`` term added to every local step's gradient
    before the proximal term and the clip (SCAFFOLD's ``c - c_i``,
    ``msrflute_tpu/engine/client_update.py:197-231``), so it enters kernel
    B1 with the gradient."""
    opt = make_optimizer(client_opt_cfg)
    sgd = isinstance(opt, SGD) and opt.plain
    if hparams.pallas_apply and not sgd:
        raise ValueError(
            "megakernel.pallas_apply requires a plain SGD client "
            "optimizer (momentum ok; no nesterov/weight_decay) — got "
            f"type={client_opt_cfg.get('type', 'sgd')!r}")
    if hparams.pallas_apply and hparams.updatable_layers is not None:
        raise ValueError(
            "megakernel.pallas_apply does not compose with "
            "updatable_layers: the flat fused kernel has no per-leaf "
            "freeze mask — drop one of them")
    layout = task.layout()
    mu = opt.momentum if sgd else 0.0
    epochs = max(int(hparams.num_epochs), 1)
    pdt = resolve_dtype(hparams.param_dtype)
    cdt = resolve_dtype(hparams.compute_dtype)
    sdt = resolve_dtype(hparams.stats_dtype)
    #: the leaves' bounds, for the optimizers that scale by leaf
    bounds = (list(layout.offsets) + [layout.numel]
              if isinstance(opt, (Lamb, Lars)) else None)
    frozen = frozen_ranges(layout, tuple(hparams.freeze_layers))
    masks_by_device: Dict[torch.device, torch.Tensor] = {}
    loss_fn = task.loss_and_aux
    if cdt is not None:
        def loss_fn(params, batch, masks):  # noqa: F811 - the cast wrap
            return task.loss_and_aux(
                {k: v.to(cdt) for k, v in params.items()},
                _cast_floats(batch, cdt), masks)
    grad_fn = vmap(grad_and_value(loss_fn, has_aux=True))

    def acc(value: torch.Tensor) -> torch.Tensor:
        return value if sdt is None else value.to(sdt)

    def client_update(global_flat: torch.Tensor,
                      arrays: Dict[str, torch.Tensor],
                      sample_mask: torch.Tensor, lr: float,
                      gens: Optional[List[torch.Generator]] = None,
                      grad_offset: Optional[torch.Tensor] = None):
        K, S, B = sample_mask.shape
        # a copy in every case: a [K, P] start is the caller's, and the
        # steps below update params in place
        start = global_flat if pdt is None else global_flat.to(pdt)
        params = start.expand(K, -1).clone(
            memory_format=torch.contiguous_format)
        trace = (torch.zeros_like(params)
                 if sgd and (hparams.pallas_apply or mu) else None)
        opt_state = None if sgd else opt.init(params)
        views = layout.views(params)
        update_mask = None
        if hparams.updatable_layers is not None:
            dev = params.device
            if dev not in masks_by_device:
                masks_by_device[dev] = updatable_columns(
                    layout, tuple(hparams.updatable_layers), dev)
            update_mask = masks_by_device[dev]
        zero = torch.zeros((K,), dtype=sdt or torch.float32,
                           device=sample_mask.device)
        loss_sum = wloss_acc = ns_acc = zero
        for t in range(epochs * S):
            step = t % S
            mask = sample_mask[:, step]
            batch = {k: a[:, step] for k, a in arrays.items()}
            batch["sample_mask"] = mask
            masks = (task.draw_masks(gens, B, mask.device)
                     if gens is not None else ())
            with cpu16_guard(mask.device, task.compute_dtype, cdt):
                grads, (loss, aux) = grad_fn(views, batch, masks)
            grads = combine_grad_terms(
                layout.flatten(grads, batch_dims=1), offset=grad_offset,
                prox_mu=hparams.fedprox_mu, params=params,
                global_params=global_flat, max_norm=hparams.max_grad_norm)
            rows = mask.sum(-1)
            has_data = (rows > 0).to(torch.float32)
            loss_sum = acc(loss_sum + has_data * loss)
            # sample-weighted loss sum (loss is the batch's masked MEAN)
            wloss_acc = acc(wloss_acc + loss * rows)
            ns_acc = acc(ns_acc + has_data * aux.get("train_sample_count",
                                                     rows))
            if not sgd:
                opt_state = fused_opt_apply(opt, params, grads, opt_state,
                                            lr, has_data, bounds,
                                            update_mask)
            elif hparams.pallas_apply:
                fused_sgd_apply(params, grads, trace, lr, mu, has_data)
            else:
                fused_apply(params, grads, trace, lr, mu, has_data,
                            update_mask)
            del grads

        pseudo_grad = global_flat - params
        for a, b in frozen:
            pseudo_grad[:, a:b] = 0.0
        stats = _derive_stats(*_suff_stats_of(pseudo_grad))
        rows_total = sample_mask.sum(dim=(1, 2))
        stats["mean_sample_loss"] = wloss_acc / torch.clamp(
            rows_total * epochs, min=1.0)
        return pseudo_grad, loss_sum, ns_acc / epochs, stats

    return client_update
