"""Task/model contract — the port's counterpart of ``msrflute_tpu/models/base.py``.

A task bundles an ``nn.Module`` with pure functions over an explicit
parameter dict (``{name: tensor}``; the module's own parameters are never
read), so the client update can take ``torch.func.vmap(grad(...))`` over
K clients at once:

- ``init_params(seed)``                      -> ``{name: tensor}`` on the CPU
- ``loss(params, batch, gen, train)``        -> ``(masked mean, aux)``
- ``loss_masked(params, batch, masks)``      -> masked mean, dropout masks given
- ``loss_and_aux(params, batch, masks)``     -> ``(masked mean, aux)``; a task
  that counts its samples in another unit than rows (the GRU LM counts
  words) returns the count as ``aux["train_sample_count"]``
- ``eval_stats(params, batch)``              -> dict of scalar SUMS
- ``finalize_metrics(sums)``                 -> ``{name: Metric}``

``batch`` is a dict of tensors with a leading batch axis plus
``sample_mask``; every reduction is mask-weighted so padded samples are
invisible.  Dropout masks are drawn outside any ``vmap`` from per-client
``torch.Generator``s (:meth:`BaseTask.draw_masks`) and passed in as
tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..config import model_dtype

Params = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]


@dataclass
class Metric:
    value: float
    higher_is_better: bool = True

    def is_better_than(self, other: "Metric") -> bool:
        if self.higher_is_better:
            return self.value > other.value
        return self.value < other.value


#: ``model_config.dtype`` names (:data:`..config.DTYPE_NAMES`) as torch
#: dtypes
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


def parse_dtype(model_config) -> torch.dtype:
    """``model_config.dtype`` -> the dtype a model computes in (the JAX
    package's ``parse_dtype``, ``msrflute_tpu/models/base.py:78-92``):
    parameters stay float32, each layer casts its inputs and weights, and
    the loss and metrics run on float32 logits."""
    return TORCH_DTYPES[model_dtype(model_config)]


def to_float_image(x: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 pixels normalize to [0, 1] on the device; anything else is
    cast to ``dtype``.  In a 16-bit dtype the factor 1/255 is rounded to
    it first, as the JAX package's weakly typed scalar is."""
    if x.dtype == torch.uint8:
        if dtype == torch.float32:
            return x.to(torch.float32) * (1.0 / 255.0)
        return x.to(dtype) * torch.full((), 1.0 / 255.0, dtype=dtype,
                                        device=x.device)
    return x.to(dtype)


def linear(layer: nn.Linear, x: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)`` with ``layer``'s ``[out, in]`` weight:
    input, weight and bias cast to ``dtype`` (``promote_dtype``), output in
    ``dtype``.  In float32 it is ``layer(x)``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def conv(layer: nn.Conv2d, x: torch.Tensor,
         dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(dtype=...)`` with ``layer``'s weight over NCHW ``x``:
    input, weight and bias cast to ``dtype``, output in ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias,
                    stride=layer.stride, padding=layer.padding)


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over real samples only; padded entries contribute nothing."""
    return torch.sum(values * mask) / torch.clamp(torch.sum(mask), min=1.0)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample cross entropy with integer labels."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout with a given keep mask (flax ``nn.Dropout``
    semantics: kept entries scale by ``1 / (1 - rate)``)."""
    keep_prob = 1.0 - rate
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  gen: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: truncated normal (two standard
    deviations) with variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=gen)


class ParamLayout:
    """A task's parameters as one flat float32 vector (the counterpart of
    ``jax.flatten_util.ravel_pytree``): leaves in the module's parameter
    order, each a contiguous slice of the last axis."""

    def __init__(self, spec: Sequence[Tuple[str, Tuple[int, ...]]]):
        self.names = [n for n, _ in spec]
        self.shapes = [tuple(s) for _, s in spec]
        self.sizes = [int(math.prod(s)) for s in self.shapes]
        self.offsets = [sum(self.sizes[:i]) for i in range(len(self.sizes))]
        self.numel = sum(self.sizes)

    def flatten(self, params: Params, batch_dims: int = 0) -> torch.Tensor:
        """``{name: [*batch, *shape]}`` -> ``[*batch, P]`` (a new tensor)."""
        return torch.cat([params[n].flatten(start_dim=batch_dims)
                          for n in self.names], dim=-1)

    def views(self, flat: torch.Tensor) -> Params:
        """``[..., P]`` -> ``{name: [..., *shape]}`` views that alias
        ``flat``, so an in-place update of the buffer moves every leaf."""
        return {n: flat[..., o:o + s].unflatten(-1, shape)
                for n, o, s, shape in zip(self.names, self.offsets,
                                          self.sizes, self.shapes)}


class BaseTask:
    """Abstract task: a module plus loss and metrics over a param dict."""

    name: str = "base"
    module: nn.Module
    #: ``(rate, per-sample shape)`` of each dropout site, in forward order
    dropout_sites: Sequence[Tuple[float, Tuple[int, ...]]] = ()
    #: 0-padded ``[n, L]`` keys whose common all-padding tail length
    #: bucketing may crop (``data.batching.seq_length_bucket``)
    seq_pad_keys: Tuple[str, ...] = ()

    def param_spec(self) -> List[Tuple[str, Tuple[int, ...]]]:
        return [(n, tuple(p.shape)) for n, p in self.module.named_parameters()]

    @property
    def compute_dtype(self) -> torch.dtype:
        """The type the module computes in (``model_config.dtype``)."""
        return getattr(getattr(self, "module", None), "dtype",
                       torch.float32)

    @property
    def draws_random(self) -> bool:
        """Whether a train step draws random numbers (dropout masks, the
        BERT task's MLM mask), so the client update needs a generator a
        client."""
        return any(rate > 0 for rate, _ in self.dropout_sites)

    def layout(self) -> ParamLayout:
        return ParamLayout(self.param_spec())

    def init_params(self, seed: int) -> Params:
        raise NotImplementedError

    def apply(self, params: Params, x: torch.Tensor,
              masks: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        return functional_call(self.module, params, (x,),
                               {"masks": tuple(masks)}).to(torch.float32)

    def draw_masks(self, gens: Sequence[torch.Generator], batch_size: int,
                   device: torch.device) -> Tuple[torch.Tensor, ...]:
        """One ``[K, B, *shape]`` keep mask per live dropout site, client k
        drawn from ``gens[k]`` (so its stream depends on its own seed
        only, not on the cohort it trains in)."""
        out = []
        for rate, shape in self.dropout_sites:
            if rate <= 0.0:
                continue
            out.append(torch.stack([
                torch.rand((batch_size,) + tuple(shape), generator=g,
                           device=device) < (1.0 - rate) for g in gens]))
        return tuple(out)

    def loss_masked(self, params: Params, batch: Batch,
                    masks: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        raise NotImplementedError

    def loss_and_aux(self, params: Params, batch: Batch,
                     masks: Sequence[torch.Tensor] = ()
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return self.loss_masked(params, batch, masks), {}

    def loss(self, params: Params, batch: Batch,
             gen: Optional[torch.Generator] = None,
             train: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Masked mean loss plus ``aux["sample_count"]``.  Train mode draws
        its dropout masks from ``gen`` (required when a site is live)."""
        masks: Tuple[torch.Tensor, ...] = ()
        if train and self.draws_random:
            if gen is None:
                raise ValueError(f"{self.name}: loss(train=True) needs a "
                                 "generator for the dropout stream")
            B = batch["sample_mask"].shape[0]
            masks = tuple(m[0] for m in self.draw_masks(
                [gen], B, batch["sample_mask"].device))
        loss, aux = self.loss_and_aux(params, batch, masks)
        return loss, {"sample_count": torch.sum(batch["sample_mask"]), **aux}

    def eval_stats(self, params: Params, batch: Batch) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def finalize_metrics(self, sums: Dict[str, float]) -> Dict[str, Metric]:
        n = max(float(sums["sample_count"]), 1.0)
        metrics = {"loss": Metric(float(sums["loss_sum"]) / n,
                                  higher_is_better=False)}
        if "correct_sum" in sums:
            metrics["acc"] = Metric(float(sums["correct_sum"]) / n,
                                    higher_is_better=True)
        return metrics
