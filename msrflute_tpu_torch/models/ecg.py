"""ECG heartbeat classifier — the port's counterpart of
``msrflute_tpu/models/ecg.py`` (``experiments/ecg_cnn``, P = 136,709 at
the published widths in 39 leaves).

Two ConvNormPool stacks (1-D convolutions of width 5 with causal left
pads, GroupNorm of 8 groups at eps 1e-5, swish, a conv1 + conv3 skip,
maxpool 2), then an LSTM that runs over the CHANNEL axis (64 steps of the
pooled length's features, the reference's quirk kept), the attention mix
``tanh(W [h; c]) @ outputs``, a max over its two rows and the dense head.
The LSTM is the flax ``OptimizedLSTMCell`` of :mod:`.nlp`, a Python loop
over the 64 steps.

The activations run channels-first (``[B, C, L]``, as ``conv1d`` and
``group_norm`` take them), which is the JAX module's ``swapaxes`` order
at the LSTM.  Parameters keep flax's names and layouts (``Conv_*.kernel``
``[k, in, out]``, Dense kernels ``[in, out]``) in ``ravel_pytree`` order,
so :mod:`.convert` carries them across unchanged.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .base import Params, lecun_normal_
from .cv import ClassificationTask
from .nlp import _Dense, _LSTMCell

GN_GROUPS, GN_EPS = 8, 1e-5


class _Conv(nn.Module):
    """flax ``nn.Conv`` over one spatial axis, ``padding="VALID"``."""

    def __init__(self, c_in: int, c_out: int, k: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.kernel = nn.Parameter(torch.zeros(k, c_in, c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B, C, L]
        return F.conv1d(x, self.kernel.permute(2, 1, 0), self.bias)


class _GroupNorm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))
        self.scale = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, GN_GROUPS, self.scale, self.bias, GN_EPS)


def _swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class _ConvNormPool(nn.Module):
    def __init__(self, c_in: int, hidden: int, k: int = 5):
        super().__init__()
        self.pad = k - 1
        self.Conv_0 = _Conv(c_in, hidden, k)
        self.Conv_1 = _Conv(hidden, hidden, k)
        self.Conv_2 = _Conv(hidden, hidden, k)
        self.GroupNorm_0 = _GroupNorm(hidden)
        self.GroupNorm_1 = _GroupNorm(hidden)
        self.GroupNorm_2 = _GroupNorm(hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv1 = self.Conv_0(x)
        y = F.pad(_swish(self.GroupNorm_0(conv1)), (self.pad, 0))
        y = F.pad(_swish(self.GroupNorm_1(self.Conv_1(y))), (self.pad, 0))
        conv3 = self.Conv_2(y)
        y = _swish(self.GroupNorm_2(conv1[..., :conv3.shape[-1]] + conv3))
        return F.max_pool1d(F.pad(y, (self.pad, 0)), 2)


class ECGNet(nn.Module):
    """``x [B, L]`` (or ``[B, L, 1]``) -> logits ``[B, num_classes]``;
    the attribute names are flax's module names."""

    def __init__(self, seq_len: int = 187, hidden: int = 64,
                 num_classes: int = 5, k: int = 5):
        super().__init__()
        self._ConvNormPool_0 = _ConvNormPool(1, hidden, k)
        self._ConvNormPool_1 = _ConvNormPool(hidden, hidden, k)
        pooled = (seq_len // 2) // 2
        self.OptimizedLSTMCell_0 = _LSTMCell(pooled, hidden)
        self.Dense_0 = _Dense(hidden, hidden, use_bias=False)
        self.Dense_1 = _Dense(hidden, num_classes)

    def forward(self, x: torch.Tensor,
                masks: Tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
        x = x.reshape(x.shape[0], 1, -1).to(torch.float32)
        x = self._ConvNormPool_1(self._ConvNormPool_0(x))   # [B, H, L']
        outputs, c = self.OptimizedLSTMCell_0(x, return_cell=True)
        hc = torch.stack([outputs[:, -1], c], dim=1)         # [B, 2, H]
        mixed = torch.tanh(self.Dense_0(hc)) @ outputs       # [B, 2, H]
        return self.Dense_1(torch.amax(mixed, dim=1))


class ECGTask(ClassificationTask):
    """:class:`~.cv.ClassificationTask` over :class:`ECGNet` with flax's
    leaf order and initializers."""

    def param_spec(self) -> List[Tuple[str, Tuple[int, ...]]]:
        """Leaves in ``ravel_pytree`` order: keys sorted at every level."""
        return sorted(super().param_spec(), key=lambda s: s[0].split("."))

    def init_params(self, seed: int) -> Params:
        """lecun-normal conv, input and dense kernels, orthogonal LSTM
        hidden kernels, GroupNorm scales 1, biases 0; drawn on the CPU so
        every device starts from the same bits."""
        gen = torch.Generator().manual_seed(int(seed))
        out = {}
        for name, shape in self.param_spec():
            t = torch.zeros(shape, dtype=torch.float32)
            path = name.split(".")
            if path[-1] == "scale":
                t.fill_(1.0)
            elif path[-1] == "kernel" and path[-2] in ("hi", "hf", "hg",
                                                        "ho"):
                nn.init.orthogonal_(t, generator=gen)
            elif path[-1] == "kernel":
                fan_in = shape[0] * shape[1] if len(shape) == 3 else shape[0]
                lecun_normal_(t, fan_in, gen)
            out[name] = t
        return out


def make_ecg_task(model_config) -> ECGTask:
    num_classes = int(model_config.get("num_classes", 5))
    seq_len = int(model_config.get("num_frames", 187))
    module = ECGNet(seq_len=seq_len,
                    hidden=int(model_config.get("hidden_dim", 64)),
                    num_classes=num_classes)
    return ECGTask(module, example_shape=(seq_len,), name="ecg_cnn",
                   num_classes=num_classes)

