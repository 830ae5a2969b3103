"""Switch top-1 mixture-of-experts feed-forward — the port's counterpart of
``msrflute_tpu/ops/moe.py::MoEFFN`` in its local mode (``ep_mesh=None``,
``:106-165``), the mode the federated engine runs.

Every token is routed over all ``E`` experts: ``logits = t @ router`` taken
in float32, ``eid = argmax`` (the first maximum on a tie, as
``jnp.argmax``), ``gate = softmax(logits)[eid]``; every expert computes
``gelu(t @ w_in[e]) @ w_out[e]`` (the tanh gelu, flax's ``nn.gelu``
default), the expert ``eid`` is selected and scaled by the gate.  The
local mode has no capacity and drops nothing.  Under ``dtype`` (bfloat16,
float16) the router and the experts run in that dtype and the routing
logits stay float32, as in the JAX module.

Parameters keep flax's names and shapes: ``router [D, E]``, ``w_in [E, D,
H]``, ``w_out [E, H, D]``, drawn as flax's ``lecun_normal`` draws them
(:func:`moe_fan_in`).

Not ported (ROADMAP.md §A, multi-GPU): ``moe_apply``, the expert-parallel
all-to-all mode, and the ``moe_ep_axis`` that selects it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class MoEFFN(nn.Module):
    """``[..., D]`` tokens -> ``[..., D]``; the routing ids of the last call
    are not kept (the JAX module keeps none either)."""

    def __init__(self, dim: int, num_experts: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.router = nn.Parameter(torch.zeros(dim, num_experts))
        self.w_in = nn.Parameter(torch.zeros(num_experts, dim, hidden))
        self.w_out = nn.Parameter(torch.zeros(num_experts, hidden, dim))

    def route(self, t: torch.Tensor):
        """``(eid [T], gate [T])`` of ``[T, D]`` tokens in the dtype."""
        logits = (t @ self.router.to(self.dtype)).to(torch.float32)
        eid = torch.argmax(logits, dim=-1)
        gate = torch.gather(torch.softmax(logits, dim=-1), -1,
                            eid[:, None])[:, 0]
        return eid, gate.to(t.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        D = x.shape[-1]
        lead = x.shape[:-1]
        t = x.reshape(-1, D).to(self.dtype)
        eid, gate = self.route(t)
        h = F.gelu(torch.einsum("td,edh->teh", t, self.w_in.to(self.dtype)),
                   approximate="tanh")
        y_all = torch.einsum("teh,ehd->ted", h, self.w_out.to(self.dtype))
        y = torch.gather(y_all, 1, eid[:, None, None].expand(-1, 1, D))[:, 0]
        return (y * gate[:, None]).reshape(*lead, D)


def moe_fan_in(shape) -> int:
    """flax ``lecun_normal``'s fan-in: ``shape[-2]`` times every axis before
    it (the router's is ``D``, ``w_in``'s ``E * D``, ``w_out``'s
    ``E * H``)."""
    return int(math.prod(shape[:-1]))

