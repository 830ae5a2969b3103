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

:func:`build_mega_update` is the megabatch lane scan over the same step
(:class:`_LocalSGD`): lanes that train one small client after another
from a pointer tape, with each client's outputs in its grid row.

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

import numpy as np
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


class _LocalSGD:
    """The client optimizer's set-up and its local step over a ``[N, P]``
    stack of rows (N clients in the grid's vmap arm, N lanes in the
    megabatch lane scan), shared by :func:`build_client_update` and
    :func:`build_mega_update` so both run the same step, op for op."""

    def __init__(self, task: BaseTask, client_opt_cfg,
                 hparams: ClientHParams):
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
        self.task, self.hparams, self.opt, self.sgd = task, hparams, opt, sgd
        self.layout = task.layout()
        self.mu = opt.momentum if sgd else 0.0
        self.epochs = max(int(hparams.num_epochs), 1)
        self.pdt = resolve_dtype(hparams.param_dtype)
        cdt = resolve_dtype(hparams.compute_dtype)
        self.cdt = cdt
        self.sdt = resolve_dtype(hparams.stats_dtype)
        #: the leaves' bounds, for the optimizers that scale by leaf
        self.bounds = (list(self.layout.offsets) + [self.layout.numel]
                       if isinstance(opt, (Lamb, Lars)) else None)
        self.frozen = frozen_ranges(self.layout,
                                    tuple(hparams.freeze_layers))
        self._masks_by_device: Dict[torch.device, torch.Tensor] = {}
        loss_fn = task.loss_and_aux
        if cdt is not None:
            def loss_fn(params, batch, masks):  # noqa: F811 - the cast wrap
                return task.loss_and_aux(
                    {k: v.to(cdt) for k, v in params.items()},
                    _cast_floats(batch, cdt), masks)
        self.grad_fn = vmap(grad_and_value(loss_fn, has_aux=True))

    def acc(self, value: torch.Tensor) -> torch.Tensor:
        return value if self.sdt is None else value.to(self.sdt)

    def update_mask(self, device) -> Optional[torch.Tensor]:
        if self.hparams.updatable_layers is None:
            return None
        if device not in self._masks_by_device:
            self._masks_by_device[device] = updatable_columns(
                self.layout, tuple(self.hparams.updatable_layers), device)
        return self._masks_by_device[device]

    def init(self, start: torch.Tensor, n: int):
        """``(params [n, P], momentum trace, optimizer state)`` from
        ``start`` (``[P]`` or ``[n, P]``), a copy in every case: the
        steps update params in place."""
        if self.pdt is not None:
            start = start.to(self.pdt)
        params = start.expand(n, -1).clone(
            memory_format=torch.contiguous_format)
        trace = (torch.zeros_like(params)
                 if self.sgd and (self.hparams.pallas_apply or self.mu)
                 else None)
        opt_state = None if self.sgd else self.opt.init(params)
        return params, trace, opt_state

    def zeros(self, n: int, device) -> torch.Tensor:
        return torch.zeros((n,), dtype=self.sdt or torch.float32,
                           device=device)

    def step(self, params, views, trace, opt_state, batch, gens, lr,
             anchor, offset, update_mask, accs):
        """One local step of the ``[N]`` rows on ``batch`` (``[N, B, ...]``
        with its ``sample_mask``): loss -> grad -> ``combine_grad_terms``
        (``offset``, the proximal term against ``anchor``, the clip) ->
        the accumulators ``(loss_sum, wloss, ns)`` -> the optimizer tail,
        params, trace and state in place.  Returns ``(opt_state, accs)``."""
        hp, task = self.hparams, self.task
        mask = batch["sample_mask"]
        B = mask.shape[-1]
        masks = (task.draw_masks(gens, B, mask.device)
                 if gens is not None else ())
        with cpu16_guard(mask.device, task.compute_dtype, self.cdt):
            grads, (loss, aux) = self.grad_fn(views, batch, masks)
        grads = combine_grad_terms(
            self.layout.flatten(grads, batch_dims=1), offset=offset,
            prox_mu=hp.fedprox_mu, params=params, global_params=anchor,
            max_norm=hp.max_grad_norm)
        rows = mask.sum(-1)
        has_data = (rows > 0).to(torch.float32)
        loss_sum, wloss_acc, ns_acc = accs
        loss_sum = self.acc(loss_sum + has_data * loss)
        # sample-weighted loss sum (loss is the batch's masked MEAN)
        wloss_acc = self.acc(wloss_acc + loss * rows)
        ns_acc = self.acc(ns_acc + has_data * aux.get("train_sample_count",
                                                      rows))
        if not self.sgd:
            opt_state = fused_opt_apply(self.opt, params, grads, opt_state,
                                        lr, has_data, self.bounds,
                                        update_mask)
        elif hp.pallas_apply:
            fused_sgd_apply(params, grads, trace, lr, self.mu, has_data)
        else:
            fused_apply(params, grads, trace, lr, self.mu, has_data,
                        update_mask)
        return opt_state, (loss_sum, wloss_acc, ns_acc)

    def finish(self, global_flat, params, sample_mask, accs):
        """``(pseudo_grad, train_loss, num_samples, stats)`` of the trained
        ``[K, P]`` rows against their starts."""
        loss_sum, wloss_acc, ns_acc = accs
        pseudo_grad = global_flat - params
        for a, b in self.frozen:
            pseudo_grad[:, a:b] = 0.0
        stats = _derive_stats(*_suff_stats_of(pseudo_grad))
        rows_total = sample_mask.sum(dim=(1, 2))
        stats["mean_sample_loss"] = wloss_acc / torch.clamp(
            rows_total * self.epochs, min=1.0)
        return pseudo_grad, loss_sum, ns_acc / self.epochs, stats


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
    sgd = _LocalSGD(task, client_opt_cfg, hparams)

    def client_update(global_flat: torch.Tensor,
                      arrays: Dict[str, torch.Tensor],
                      sample_mask: torch.Tensor, lr: float,
                      gens: Optional[List[torch.Generator]] = None,
                      grad_offset: Optional[torch.Tensor] = None):
        K, S, _ = sample_mask.shape
        params, trace, opt_state = sgd.init(global_flat, K)
        views = sgd.layout.views(params)
        update_mask = sgd.update_mask(params.device)
        zero = sgd.zeros(K, sample_mask.device)
        accs = (zero, zero, zero)
        for t in range(sgd.epochs * S):
            step = t % S
            batch = {k: a[:, step] for k, a in arrays.items()}
            batch["sample_mask"] = sample_mask[:, step]
            opt_state, accs = sgd.step(params, views, trace, opt_state,
                                       batch, gens, lr, global_flat,
                                       grad_offset, update_mask, accs)
        return sgd.finish(global_flat, params, sample_mask, accs)

    return client_update


def build_mega_update(task: BaseTask, client_opt_cfg,
                      hparams: ClientHParams) -> Callable:
    """The megabatch lane scan (``server_config.megabatch``,
    ``msrflute_tpu/engine/client_update.py:340-586``).  Returns
    ``mega_update(global_flat, arrays, sample_mask, lr, gens,
    grad_offset=None, *, tape, tape_dev)`` with :func:`build_client_update`'s
    outputs for the grid's ``[K]`` rows.

    ``tape`` is the grid's :class:`~..data.batching.MegaTape` (host) and
    ``tape_dev`` its ``(ptr, seg)`` on the device.  Instead of K rows for
    ``num_epochs * S`` steps, ``L`` lanes run the tape's ``T`` slots, and a
    lane trains one client after another: at a slot that starts a client
    (its segment id changes) the lane takes the client's start row, a
    fresh optimizer state and zero accumulators (JAX
    ``optim/fused.py::segment_select``); each slot gathers its batch from
    the flat ``[K*S, B, ...]`` grid by ``ptr``; at the client's last slot
    the lane's params and accumulators are written into the client's grid
    row.  The step is :class:`_LocalSGD`'s, the vmap arm's, so a client's
    update comes from its own samples only, and the pseudo-gradient and
    stats are then taken over the ``[K, P]`` rows as there.  The start
    (``[P]`` or ``[K, P]``: FedBuff's stale versions, personalization's
    local models), ``grad_offset`` (SCAFFOLD's ``c - c_i``) and ``gens``
    are the strategy's, per grid row, as it hands them to the vmap arm.

    A client's generator draws on its real slots only: at ``num_epochs``
    1 the prefix the vmap arm draws, so dropout matches bitwise; at more
    epochs the vmap arm draws on its padded steps too and the streams
    part, as in the JAX package.  Kernel B1 has no segment reset, so
    ``pallas_apply`` is refused (``client_update.py:393-401``)."""
    if hparams.pallas_apply:
        raise ValueError(
            "server_config.megabatch is incompatible with "
            "megakernel.pallas_apply: the flat fused kernel has no "
            "segment-reset lane — drop one of them")
    sgd = _LocalSGD(task, client_opt_cfg, hparams)
    #: the idle lanes' dropout draws, which touch no client
    idle_gens: Dict[torch.device, torch.Generator] = {}

    def mega_update(global_flat: torch.Tensor,
                    arrays: Dict[str, torch.Tensor],
                    sample_mask: torch.Tensor, lr: float,
                    gens: Optional[List[torch.Generator]] = None,
                    grad_offset: Optional[torch.Tensor] = None, *,
                    tape, tape_dev):
        K, S, B = sample_mask.shape
        dev = sample_mask.device
        seg_h = np.asarray(tape.seg)
        L, T = seg_h.shape
        fence = np.full((L, 1), -2, seg_h.dtype)
        live_h = seg_h >= 0
        start_h = live_h & (seg_h != np.concatenate([fence, seg_h[:, :-1]],
                                                    1))
        end_h = live_h & (seg_h != np.concatenate([seg_h[:, 1:], fence], 1))
        ptr_d, seg_d = tape_dev
        live_d = seg_d >= 0
        row_d = torch.clamp(seg_d, min=0).to(torch.int64)
        fence_d = torch.full((L, 1), -2, dtype=seg_d.dtype, device=dev)
        start_d = live_d & (seg_d != torch.cat([fence_d, seg_d[:, :-1]], 1))
        # idle and non-final slots write into a spare row K
        out_d = torch.where(
            live_d & (seg_d != torch.cat([seg_d[:, 1:], fence_d], 1)),
            row_d, K)
        per_row = global_flat.ndim == 2

        def rows_of(idx):
            """The start rows of the grid rows ``idx`` (``[L]``)."""
            if not per_row:
                return global_flat
            return global_flat.index_select(0, idx)

        params, trace, opt_state = sgd.init(rows_of(row_d[:, 0]), L)
        fresh = None if opt_state is None else sgd.opt.init(params)
        views = sgd.layout.views(params)
        update_mask = sgd.update_mask(dev)
        zero = sgd.zeros(L, dev)
        accs = (zero, zero, zero)
        # the trained rows: padding rows, which no segment writes, keep
        # their start, as in the vmap arm
        starts = sgd.init(global_flat, K)[0]
        out_params = torch.cat([starts, starts[:1]])
        out_accs = [sgd.zeros(K + 1, dev) for _ in range(3)]
        flat = {k: a.reshape((K * S,) + a.shape[2:])
                for k, a in arrays.items()}
        mask_flat = sample_mask.reshape(K * S, B)
        if gens is not None and dev not in idle_gens:
            idle_gens[dev] = torch.Generator(device=dev)
        for t in range(T):
            if not live_h[:, t].any():
                continue
            if start_h[:, t].any():
                st = start_d[:, t]
                row = rows_of(row_d[:, t])
                if sgd.pdt is not None:
                    row = row.to(sgd.pdt)
                params.copy_(torch.where(st[:, None], row, params))
                if trace is not None:
                    trace.copy_(torch.where(st[:, None], 0.0, trace))
                if opt_state is not None:
                    for key, v in opt_state.items():
                        v.copy_(torch.where(
                            st.reshape((-1,) + (1,) * (v.ndim - 1)),
                            fresh[key], v))
                accs = tuple(torch.where(st, 0.0, a) for a in accs)
            ptr = ptr_d[:, t].to(torch.int64)
            batch = {k: a.index_select(0, ptr) for k, a in flat.items()}
            batch["sample_mask"] = torch.where(
                live_d[:, t, None], mask_flat.index_select(0, ptr), 0.0)
            lane_gens = None
            if gens is not None:
                lane_gens = [gens[int(r)] if r >= 0 else idle_gens[dev]
                             for r in seg_h[:, t]]
            row = row_d[:, t]
            offset = (None if grad_offset is None
                      else grad_offset.index_select(0, row))
            anchor = rows_of(row) if per_row else global_flat
            opt_state, accs = sgd.step(params, views, trace, opt_state,
                                       batch, lane_gens, lr, anchor, offset,
                                       update_mask, accs)
            if end_h[:, t].any():
                out = out_d[:, t]
                out_params.index_copy_(0, out, params)
                for o, a in zip(out_accs, accs):
                    o.index_copy_(0, out, a)
        return sgd.finish(global_flat, out_params[:K], sample_mask,
                          tuple(o[:K] for o in out_accs))

    return mega_update
