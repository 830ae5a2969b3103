"""Optimizer factory — the port's counterpart of ``msrflute_tpu/optim/factory.py``.

``sgd`` (with optional momentum), ``adam``, ``adamW`` (decay 0 only) and
``adamax`` are ported; every other type raises.  Optimizers are functional
over flat ``[..., P]`` float32 buffers: the server's ``[P]``, or a client
stack ``[K, P]`` whose step count is a ``[K]`` vector, one a client.  A
client gets a fresh state each round (the client update calls ``init``
per round, as ``build_client_update`` calls ``tx.init``); the server's
state lives in ``ServerState.opt_state`` and is checkpointed.

The arithmetic follows optax op for op.  ``optax.sgd``: the trace is
``t' = g + mu * t`` and the applied update ``p + (-lr) * t'``.
``optax.adam`` (``eps_root`` 0): see :class:`Adam`; ``optax.adamw``:
:class:`AdamW`; ``optax.adamax``: :class:`Adamax`.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, Tuple, Union

import torch

from ..config import NOT_PORTED
from ..utils.logging import print_rank


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


@dataclass(frozen=True)
class Adam:
    """``optax.adam(lr, b1, b2, eps)`` with ``eps_root`` 0::

        mu' = (1 - b1) * g + b1 * mu        nu' = (1 - b2) * (g * g) + b2 * nu
        c' = c + 1
        u = (mu' / (1 - b1 ** c')) / (sqrt(nu' / (1 - b2 ** c')) + eps)
        p' = p + (-lr) * u

    ``eps`` is outside the square root.  The bias corrections are float32
    powers on the device, as optax takes them (its ``b ** count`` may
    differ from torch's ``pow`` in the last place)."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: torch.Tensor) -> Dict[str, torch.Tensor]:
        return _moments_init(params)

    def update(self, params: torch.Tensor, grads: torch.Tensor,
               state: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """optax's ``scale_by_adam``: the update before the learning rate."""
        mu = (1 - self.b1) * grads + self.b1 * state["mu"]
        nu = (1 - self.b2) * (grads * grads) + self.b2 * state["nu"]
        count = state["count"] + 1
        bc1, bc2 = _bias_corrections(count, self.b1, self.b2)
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        return update, {"mu": mu, "nu": nu, "count": count}

    def step(self, params: torch.Tensor, grads: torch.Tensor,
             state: Dict[str, torch.Tensor], lr: float
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        update, state = self.update(params, grads, state)
        return params + (-lr) * update, state


@dataclass(frozen=True)
class AdamW(Adam):
    """``optax.adamw``: :class:`Adam`'s update plus ``weight_decay * p``
    (``add_decayed_weights``), then the learning rate.  The JAX package
    builds it with optax's default betas, whatever the config says."""

    weight_decay: float = 0.0

    def step(self, params, grads, state, lr):
        update, state = self.update(params, grads, state)
        update = update + self.weight_decay * params
        return params + (-lr) * update, state


@dataclass(frozen=True)
class Adamax:
    """``optax.adamax(lr, b1, b2, eps)``::

        mu' = (1 - b1) * g + b1 * mu        nu' = max(|g| + eps, b2 * nu)
        c' = c + 1
        p' = p + (-lr) * ((mu' / (1 - b1 ** c')) / nu')

    (the privacy attack's default attacker)."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: torch.Tensor) -> Dict[str, torch.Tensor]:
        return _moments_init(params)

    def step(self, params: torch.Tensor, grads: torch.Tensor,
             state: Dict[str, torch.Tensor], lr: float
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        mu = (1 - self.b1) * grads + self.b1 * state["mu"]
        nu = torch.maximum(torch.abs(grads) + self.eps,
                           self.b2 * state["nu"])
        count = state["count"] + 1
        bc1, _ = _bias_corrections(count, self.b1, self.b2)
        return (params + (-lr) * ((mu / bc1) / nu),
                {"mu": mu, "nu": nu, "count": count})


def _moments_init(params: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Zero moments and a step count for each row: ``[]`` for a ``[P]``
    vector, ``[K]`` for a ``[K, P]`` client stack."""
    return {"mu": torch.zeros_like(params),
            "nu": torch.zeros_like(params),
            "count": torch.zeros(params.shape[:-1], dtype=torch.int32,
                                 device=params.device)}


def _bias_corrections(count: torch.Tensor, b1: float, b2: float):
    """``1 - b ** count`` in float32, shaped to broadcast over each row."""
    t = count.to(torch.float32).unsqueeze(-1)
    return (1 - torch.pow(torch.full_like(t, b1), t),
            1 - torch.pow(torch.full_like(t, b2), t))


Optimizer = Union[SGD, Adam, AdamW, Adamax]


def make_optimizer(cfg) -> Optimizer:
    kind = str(cfg.get("type", "sgd")).lower()
    eps = float(cfg.get("eps", 1e-8))
    if kind == "adamw":
        if cfg.get("weight_decay"):
            raise NotImplementedError(
                f"adamW weight_decay={cfg.get('weight_decay')!r} is "
                f"{NOT_PORTED}")
        return AdamW(eps=eps)
    if kind == "adamax":
        return Adamax(eps=eps)
    if kind == "adam":
        if cfg.get("amsgrad"):
            # the JAX package builds optax.adam whatever amsgrad says
            # (msrflute_tpu/optim/factory.py); so does the port
            print_rank("optimizer amsgrad: true is accepted and not applied "
                       "(plain adam, as in the JAX package)", logging.WARNING)
        betas = cfg.get("betas") or [0.9, 0.999]
        return Adam(b1=float(betas[0]), b2=float(betas[1]), eps=eps)
    if kind != "sgd" or cfg.get("nesterov") or cfg.get("weight_decay"):
        raise NotImplementedError(f"optimizer {dict(cfg)!r} is {NOT_PORTED}")
    return SGD(momentum=float(cfg.get("momentum", 0.0) or 0.0))
