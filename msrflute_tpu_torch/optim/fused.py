"""The per-step optimizer tail over flat ``[K, P]`` client buffers — the
port's counterpart of ``msrflute_tpu/optim/fused.py``.

Every expression keeps the JAX package's association
(``g + mu * (w - w0)``, ``g * scale``, ``p + (-lr) * t``), so the
port differs from it only in reduction order.  Row ``k`` of each buffer is
client ``k``; scalars that are per client (the clip scale, the
``has_data`` gate) are ``[K]`` vectors broadcast over the row.
:func:`fused_apply` is momentum SGD's tail, :func:`fused_opt_apply` every
other optimizer's.  Both take an ``update_mask``, the ``[P]`` columns of
the leaves that may move (``updatable_layers``,
``msrflute_tpu/optim/fused.py:61-88``): a frozen leaf's update is zero and
the optimizer state still advances.  :func:`segment_norms` and
:func:`trust_ratio` are optax's per-leaf ``scale_by_trust_ratio`` over the
flat layout, for LAMB and LARS.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..device import host_to_device


def segment_norms(x: torch.Tensor, bounds: Sequence[int]) -> torch.Tensor:
    """``[..., P]`` -> ``[..., L]``: the 2-norm of each leaf's columns
    ``bounds[i]:bounds[i + 1]`` (one deterministic reduction a leaf)."""
    return torch.stack([torch.linalg.vector_norm(x[..., a:b], dim=-1)
                        for a, b in zip(bounds[:-1], bounds[1:])], dim=-1)


def trust_ratio(params: torch.Tensor, update: torch.Tensor,
                bounds: Optional[Sequence[int]], coefficient: float = 1.0
                ) -> torch.Tensor:
    """optax's ``scale_by_trust_ratio`` (``min_norm`` 0, ``eps`` 0) as a
    ``[..., P]`` multiplier: ``coefficient * |p| / |u|`` per leaf, 1 where
    either norm is 0.  ``bounds`` are the leaves' boundaries in the columns
    given (``None``: one leaf)."""
    if bounds is None:
        bounds = (0, params.shape[-1])
    pn = segment_norms(params, bounds)
    un = segment_norms(update, bounds)
    ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                        coefficient * pn / un)
    sizes = host_to_device([b - a for a, b in zip(bounds[:-1], bounds[1:])],
                           params.device)
    return torch.repeat_interleave(ratio, sizes, dim=-1,
                                   output_size=params.shape[-1])


def combine_grad_terms(grads: torch.Tensor, *,
                       offset: Optional[torch.Tensor] = None,
                       prox_mu: float = 0.0,
                       params: Optional[torch.Tensor] = None,
                       global_params: Optional[torch.Tensor] = None,
                       max_norm: Optional[float] = None) -> torch.Tensor:
    """``clip((g + offset) + mu * (w - w0))`` per client row: ``offset``
    is SCAFFOLD's ``[K, P]`` drift correction ``c - c_i``, ``prox_mu`` the
    FedProx weight, ``max_norm`` the per-client global-norm clip bound
    (``msrflute_tpu/optim/fused.py:35-58``, the same association)."""
    if offset is not None:
        grads = grads + offset
    if prox_mu > 0.0:
        grads = grads + prox_mu * (params - global_params)
    if max_norm is not None:
        norm = torch.sqrt(torch.sum(grads * grads, dim=-1, keepdim=True))
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        grads = grads * scale
    return grads


def fused_apply(params: torch.Tensor, grads: torch.Tensor,
                trace: Optional[torch.Tensor], lr: float, momentum: float,
                has_data: torch.Tensor,
                update_mask: Optional[torch.Tensor] = None) -> None:
    """``optax.sgd`` step + the all-padding no-op pin, in place.

    ``trace`` is the momentum buffer (``None`` when ``momentum`` is 0, as
    optax keeps none); a client whose ``has_data`` is 0 keeps both its
    params and its trace, exactly like ``fused_apply``'s ``where`` pin.
    Columns outside ``update_mask`` keep their params."""
    live = (has_data > 0)[:, None]
    if trace is not None:
        t = grads + momentum * trace
        trace.copy_(torch.where(live, t, trace))
    else:
        t = grads
    moves = live if update_mask is None else live & update_mask
    params.copy_(torch.where(moves, params + (-lr) * t, params))


#: columns of ``[K, P]`` a chunk of :func:`fused_opt_apply` reads at once:
#: the moments' temporaries stay at a few ``[K, 2^24]`` buffers even at
#: BERT-base's P of 109.5M
OPT_CHUNK = 1 << 24


def column_chunks(P: int, bounds: Optional[Sequence[int]] = None
                  ) -> List[Tuple[int, int]]:
    """``[a, b)`` column ranges of about :data:`OPT_CHUNK` covering ``P``;
    with the leaves' ``bounds`` every cut falls on a leaf boundary (a leaf
    longer than a chunk is a chunk of its own), so no leaf's norm is
    split."""
    if bounds is None:
        return [(a, min(a + OPT_CHUNK, P)) for a in range(0, P, OPT_CHUNK)]
    out, a = [], 0
    for b, c in zip(bounds[1:], bounds[2:] + [None]):
        if c is None or c - a > OPT_CHUNK:
            out.append((a, b))
            a = b
    return out


def fused_opt_apply(opt, params: torch.Tensor, grads: torch.Tensor,
                    state: Dict[str, torch.Tensor], lr: float,
                    has_data: torch.Tensor,
                    bounds: Optional[Sequence[int]] = None,
                    update_mask: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """An optimizer step (``opt.step``) over ``[K, P]`` client rows, in
    place, with the all-padding no-op pin of ``fused_apply``'s ``where``:
    a client whose ``has_data`` is 0 keeps its params and its whole
    optimizer state, step count included.  ``state`` holds ``[K, P]``
    buffers and a ``[K]`` count; the step runs over column chunks
    (:func:`column_chunks`, cut at the leaves' ``bounds`` [0, ..., P] when
    the optimizer scales by leaf) and gives the same bits as one pass.
    Columns outside ``update_mask`` keep their params (their state still
    advances).  Returns the new state (the buffers updated in place)."""
    live = has_data > 0
    rows = live[:, None]
    new_count = None
    for a, b in column_chunks(params.shape[-1], bounds):
        cols = slice(a, b)
        sub = {k: (v[:, cols] if v.ndim == 2 else v)
               for k, v in state.items()}
        local = (None if bounds is None else
                 [o - a for o in bounds if a <= o <= b])
        p_new, s_new = opt.step(params[:, cols], grads[:, cols], sub, lr,
                                local)
        moves = rows if update_mask is None else rows & update_mask[cols]
        params[:, cols] = torch.where(moves, p_new, params[:, cols])
        for k, v in s_new.items():
            if v.ndim == 2:
                state[k][:, cols] = torch.where(rows, v, sub[k])
            else:
                new_count = v
    out = dict(state)
    if new_count is not None:
        out["count"] = torch.where(live, new_count, state["count"])
    return out
