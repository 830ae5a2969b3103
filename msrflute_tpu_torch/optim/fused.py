"""The per-step optimizer tail over flat ``[K, P]`` client buffers — the
port's counterpart of ``msrflute_tpu/optim/fused.py``.

Every expression keeps the JAX package's association
(``g + mu * (w - w0)``, ``g * scale``, ``p + (-lr) * t``), so the
port differs from it only in reduction order.  Row ``k`` of each buffer is
client ``k``; scalars that are per client (the clip scale, the
``has_data`` gate) are ``[K]`` vectors broadcast over the row.
"""

from __future__ import annotations

from typing import Optional

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
