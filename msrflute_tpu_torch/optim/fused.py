"""The per-step optimizer tail over flat ``[K, P]`` client buffers — the
port's counterpart of ``msrflute_tpu/optim/fused.py``.

Every expression keeps the JAX package's association
(``g + mu * (w - w0)``, ``g * scale``, ``p + (-lr) * t``), so the
port differs from it only in reduction order.  Row ``k`` of each buffer is
client ``k``; scalars that are per client (the clip scale, the
``has_data`` gate) are ``[K]`` vectors broadcast over the row.
:func:`fused_apply` is momentum SGD's tail, :func:`fused_opt_apply` the
Adam family's.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def combine_grad_terms(grads: torch.Tensor, *,
                       prox_mu: float = 0.0,
                       params: Optional[torch.Tensor] = None,
                       global_params: Optional[torch.Tensor] = None,
                       max_norm: Optional[float] = None) -> torch.Tensor:
    """``clip(g + mu * (w - w0))`` per client row: ``prox_mu`` is the
    FedProx weight, ``max_norm`` the per-client global-norm clip bound."""
    if prox_mu > 0.0:
        grads = grads + prox_mu * (params - global_params)
    if max_norm is not None:
        norm = torch.sqrt(torch.sum(grads * grads, dim=-1, keepdim=True))
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        grads = grads * scale
    return grads


def fused_apply(params: torch.Tensor, grads: torch.Tensor,
                trace: Optional[torch.Tensor], lr: float, momentum: float,
                has_data: torch.Tensor) -> None:
    """``optax.sgd`` step + the all-padding no-op pin, in place.

    ``trace`` is the momentum buffer (``None`` when ``momentum`` is 0, as
    optax keeps none); a client whose ``has_data`` is 0 keeps both its
    params and its trace, exactly like ``fused_apply``'s ``where`` pin."""
    live = (has_data > 0)[:, None]
    if trace is not None:
        t = grads + momentum * trace
        trace.copy_(torch.where(live, t, trace))
    else:
        t = grads
    params.copy_(torch.where(live, params + (-lr) * t, params))


#: columns of ``[K, P]`` a chunk of :func:`fused_opt_apply` reads at once:
#: the moments' temporaries stay at a few ``[K, 2^24]`` buffers even at
#: BERT-base's P of 109.5M
OPT_CHUNK = 1 << 24


def fused_opt_apply(opt, params: torch.Tensor, grads: torch.Tensor,
                    state: Dict[str, torch.Tensor], lr: float,
                    has_data: torch.Tensor) -> Dict[str, torch.Tensor]:
    """An Adam-family step (``opt.step``) over ``[K, P]`` client rows, in
    place, with the all-padding no-op pin of ``fused_apply``'s ``where``:
    a client whose ``has_data`` is 0 keeps its params and its whole
    optimizer state, step count included.  ``state`` holds ``[K, P]``
    moments and a ``[K]`` count; the step is elementwise in ``P``, so it
    runs over column chunks of :data:`OPT_CHUNK` and gives the same bits
    as one pass.  Returns the new state (the moments updated in place)."""
    live = has_data > 0
    rows = live[:, None]
    new_count = None
    for a in range(0, params.shape[-1], OPT_CHUNK):
        cols = slice(a, a + OPT_CHUNK)
        sub = {k: (v[:, cols] if v.ndim == 2 else v)
               for k, v in state.items()}
        p_new, s_new = opt.step(params[:, cols], grads[:, cols], sub, lr)
        params[:, cols] = torch.where(rows, p_new, params[:, cols])
        for k, v in s_new.items():
            if v.ndim == 2:
                state[k][:, cols] = torch.where(rows, v, sub[k])
            else:
                new_count = v
    out = dict(state)
    out["count"] = torch.where(live, new_count, state["count"])
    return out
