"""Optimizer factory — the port's counterpart of ``msrflute_tpu/optim/factory.py``.

The reference's seven types and the JAX package's ``yogi``: ``sgd`` (with
momentum, ``nesterov`` and ``weight_decay``), ``adam``, ``adamW``,
``adamax``, ``lamb``, ``lars`` / ``LarsSGD`` and ``yogi``.  Optimizers are
functional over flat ``[..., P]`` buffers: the server's ``[P]``, or a
client stack ``[K, P]`` whose step count is a ``[K]`` vector, one a client.
A client gets a fresh state each round (the client update calls ``init``
per round, as ``build_client_update`` calls ``tx.init``); the server's
state lives in ``ServerState.opt_state`` and is checkpointed.  State
tensors take the params' dtype, as optax's do.

The arithmetic follows optax 0.2.6 op for op, in its association.
``optax.sgd``: the trace is ``t' = g + mu * t``, with nesterov the update
``g + mu * t'``, applied as ``p + (-lr) * u``; ``weight_decay`` is
``add_decayed_weights`` chained in front (``g + wd * p``).  ``optax.adam``
(``eps_root`` 0): see :class:`Adam`; ``optax.adamw``: :class:`AdamW`;
``optax.adamax``: :class:`Adamax`; ``optax.lamb``: :class:`Lamb`;
``optax.lars``: :class:`Lars`; ``optax.yogi``: :class:`Yogi`.  LAMB and
LARS scale each leaf by optax's trust ratio, so their ``step`` takes the
leaves' ``bounds`` in the flat vector (:func:`.fused.segment_norms`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from ..utils.logging import print_rank
from .fused import trust_ratio

Bounds = Optional[Sequence[int]]


@dataclass(frozen=True)
class SGD:
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0

    @property
    def plain(self) -> bool:
        """The shape kernel B1 runs: momentum only (the JAX package's
        ``sgd_pallas_fusable``)."""
        return not self.nesterov and not self.weight_decay

    def init(self, params: torch.Tensor) -> Dict[str, torch.Tensor]:
        """optax keeps no trace when ``momentum`` is 0 (``momentum or
        None``); neither does the port."""
        return {"trace": torch.zeros_like(params)} if self.momentum else {}

    def step(self, params: torch.Tensor, grads: torch.Tensor,
             state: Dict[str, torch.Tensor], lr: float, bounds: Bounds = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        if self.weight_decay:
            grads = grads + self.weight_decay * params
        if self.momentum:
            t = grads + self.momentum * state["trace"]
            state = {"trace": t}
            if self.nesterov:
                t = grads + self.momentum * t
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
        bc1, bc2 = _bias_corrections(count, self.b1, self.b2, mu.dtype)
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        return update, {"mu": mu, "nu": nu, "count": count}

    def step(self, params: torch.Tensor, grads: torch.Tensor,
             state: Dict[str, torch.Tensor], lr: float, bounds: Bounds = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        update, state = self.update(params, grads, state)
        return params + (-lr) * update, state


@dataclass(frozen=True)
class AdamW(Adam):
    """``optax.adamw``: :class:`Adam`'s update plus ``weight_decay * p``
    (``add_decayed_weights``), then the learning rate.  The JAX package
    builds it with optax's default betas, whatever the config says."""

    weight_decay: float = 0.0

    def step(self, params, grads, state, lr, bounds: Bounds = None):
        update, state = self.update(params, grads, state)
        update = update + self.weight_decay * params
        return params + (-lr) * update, state


@dataclass(frozen=True)
class Lamb(Adam):
    """``optax.lamb(lr, weight_decay=wd)``: :class:`Adam`'s update at b1
    0.9, b2 0.999, eps 1e-6, plus ``wd * p``, then each leaf scaled by its
    trust ratio ``|p| / |u|`` (1 where either norm is 0), then the
    learning rate.  The JAX package passes no betas or eps."""

    eps: float = 1e-6
    weight_decay: float = 0.0

    def step(self, params, grads, state, lr, bounds: Bounds = None):
        update, state = self.update(params, grads, state)
        update = update + self.weight_decay * params
        update = update * trust_ratio(params, update, bounds)
        return params + (-lr) * update, state


@dataclass(frozen=True)
class Lars:
    """``optax.lars(lr, weight_decay=wd, momentum=mu)``: ``g + wd * p``,
    each leaf scaled by its trust ratio ``0.001 * |p| / |u|`` (1 where
    either norm is 0; eps 0, every leaf decayed and scaled), the learning
    rate, then the trace ``t' = u + mu * t``, which is the update."""

    momentum: float = 0.9
    weight_decay: float = 0.0
    trust_coefficient: float = 0.001

    def init(self, params: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {"trace": torch.zeros_like(params)}

    def step(self, params, grads, state, lr, bounds: Bounds = None):
        update = grads + self.weight_decay * params
        update = update * trust_ratio(params, update, bounds,
                                      self.trust_coefficient)
        t = update * (-lr) + self.momentum * state["trace"]
        return params + t, {"trace": t}


@dataclass(frozen=True)
class Yogi:
    """``optax.yogi(lr, b1, b2, eps)`` (eps 1e-3 by default), with the
    factory's ``add_decayed_weights`` in front when ``weight_decay`` is
    set::

        mu' = (1 - b1) * g + b1 * mu
        nu' = nu - ((1 - b2) * sign(nu - g * g)) * (g * g)
        u = (mu' / (1 - b1 ** c')) / (sqrt(nu' / (1 - b2 ** c')) + eps)

    Both moments start at 1e-6 (``scale_by_yogi``'s
    ``initial_accumulator_value``), not at 0."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-3
    weight_decay: float = 0.0

    def init(self, params: torch.Tensor) -> Dict[str, torch.Tensor]:
        state = _moments_init(params)
        state["mu"].fill_(1e-6)
        state["nu"].fill_(1e-6)
        return state

    def step(self, params, grads, state, lr, bounds: Bounds = None):
        if self.weight_decay:
            grads = grads + self.weight_decay * params
        g2 = grads * grads
        mu = (1 - self.b1) * grads + self.b1 * state["mu"]
        nu = state["nu"] - ((1 - self.b2) * torch.sign(state["nu"] - g2)) * g2
        count = state["count"] + 1
        bc1, bc2 = _bias_corrections(count, self.b1, self.b2, mu.dtype)
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        return params + (-lr) * update, {"mu": mu, "nu": nu, "count": count}


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
             state: Dict[str, torch.Tensor], lr: float, bounds: Bounds = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        mu = (1 - self.b1) * grads + self.b1 * state["mu"]
        nu = torch.maximum(torch.abs(grads) + self.eps,
                           self.b2 * state["nu"])
        count = state["count"] + 1
        bc1, _ = _bias_corrections(count, self.b1, self.b2, mu.dtype)
        return (params + (-lr) * ((mu / bc1) / nu),
                {"mu": mu, "nu": nu, "count": count})


def _moments_init(params: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Zero moments and a step count for each row: ``[]`` for a ``[P]``
    vector, ``[K]`` for a ``[K, P]`` client stack."""
    return {"mu": torch.zeros_like(params),
            "nu": torch.zeros_like(params),
            "count": torch.zeros(params.shape[:-1], dtype=torch.int32,
                                 device=params.device)}


def _bias_corrections(count: torch.Tensor, b1: float, b2: float,
                      dtype: torch.dtype = torch.float32):
    """``1 - b ** count`` in float32, shaped to broadcast over each row,
    then cast to the moments' dtype (optax's ``bias_correction``)."""
    t = count.to(torch.float32).unsqueeze(-1)
    return ((1 - torch.pow(torch.full_like(t, b1), t)).to(dtype),
            (1 - torch.pow(torch.full_like(t, b2), t)).to(dtype))


Optimizer = Union[SGD, Adam, AdamW, Adamax, Lamb, Lars, Yogi]
#: every type the factory builds (lower case), as the JAX package's
TYPES = ("sgd", "adam", "adamw", "adamax", "lamb", "lars", "larssgd", "yogi")


def make_optimizer(cfg) -> Optimizer:
    kind = str(cfg.get("type", "sgd")).lower()
    wd = float(cfg.get("weight_decay", 0.0) or 0.0)
    if kind == "adamw":
        return AdamW(eps=float(cfg.get("eps", 1e-8)), weight_decay=wd)
    if kind == "adamax":
        return Adamax(eps=float(cfg.get("eps", 1e-8)))
    if kind == "adam":
        if cfg.get("amsgrad"):
            # the JAX package builds optax.adam whatever amsgrad says
            # (msrflute_tpu/optim/factory.py); so does the port
            print_rank("optimizer amsgrad: true is accepted and not applied "
                       "(plain adam, as in the JAX package)", logging.WARNING)
        betas = cfg.get("betas") or [0.9, 0.999]
        return Adam(b1=float(betas[0]), b2=float(betas[1]),
                    eps=float(cfg.get("eps", 1e-8)))
    if kind == "lamb":
        return Lamb(weight_decay=wd)
    if kind in ("lars", "larssgd"):
        return Lars(momentum=float(cfg.get("momentum", 0.9)),
                    weight_decay=wd)
    if kind == "yogi":
        betas = cfg.get("betas") or [0.9, 0.999]
        return Yogi(b1=float(betas[0]), b2=float(betas[1]),
                    eps=float(cfg.get("eps", 1e-3)), weight_decay=wd)
    if kind != "sgd":
        raise ValueError(f"unknown optimizer type {cfg.get('type')!r}; "
                         f"one of {list(TYPES)}")
    return SGD(momentum=float(cfg.get("momentum", 0.0) or 0.0),
               nesterov=bool(cfg.get("nesterov", False)), weight_decay=wd)
