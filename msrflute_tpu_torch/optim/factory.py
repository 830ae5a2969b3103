"""Optimizer factory — the port's counterpart of ``msrflute_tpu/optim/factory.py``.

Only ``sgd`` (with optional momentum) is ported; every other type raises.
Optimizers are functional over flat ``[..., P]`` float32 buffers, with a
fresh state for each client each round (the client update calls
:meth:`SGD.init` per round, as ``build_client_update`` calls ``tx.init``).
The arithmetic follows ``optax.sgd`` op for op: the trace is
``t' = g + mu * t`` and the applied update ``p + (-lr) * t'``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..config import NOT_PORTED


@dataclass(frozen=True)
class SGD:
    momentum: float = 0.0

    def init(self, params: torch.Tensor) -> Dict[str, torch.Tensor]:
        """optax keeps no trace when ``momentum`` is 0 (``momentum or
        None``); neither does the port."""
        return {"trace": torch.zeros_like(params)} if self.momentum else {}

    def step(self, params: torch.Tensor, grads: torch.Tensor,
             state: Dict[str, torch.Tensor], lr: float
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if self.momentum:
            t = grads + self.momentum * state["trace"]
            state = {"trace": t}
        else:
            t = grads
        return params + (-lr) * t, state


def make_optimizer(cfg) -> SGD:
    kind = str(cfg.get("type", "sgd")).lower()
    if kind != "sgd" or cfg.get("nesterov") or cfg.get("weight_decay"):
        raise NotImplementedError(f"optimizer {dict(cfg)!r} is {NOT_PORTED}")
    return SGD(momentum=float(cfg.get("momentum", 0.0) or 0.0))
