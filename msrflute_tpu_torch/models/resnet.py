"""ResNet-18/34 with GroupNorm for Fed-CIFAR-100 — the port's counterpart of
``msrflute_tpu/models/resnet.py`` (reference ``experiments/
cv_resnet_fedcifar100/model.py`` with GroupNorm in place of BatchNorm: no
running statistics, so every client's normalization stays its own).

What is kept from the JAX package:

- groups = ``max(c // channels_per_group, 1)``, epsilon 1e-5, a scale and
  a bias per channel; the scale of each block's final norm starts at zero,
  so every block starts as the identity;
- convolutions without bias, He fan-out normal initialisation
  (``variance_scaling(2, "fan_out", "normal")``);
- a 7x7 stride-2 stem (padding 3), GroupNorm, relu, a 3x3 stride-2 max pool
  (padding 1, padded with -inf as flax pads it), four stages of basic
  blocks (stride 2 at the first block of stages 2-4), a 1x1 projection
  with GroupNorm on the shortcut where the shape changes, a global average
  pool and a dense layer;
- NHWC images at the task's boundary (uint8 pixels scaled to [0, 1]), and
  ``in_channels``.

Parameter names are flax's module paths (``_BasicBlock_3.GroupNorm_1.scale``)
with ``Conv_*.weight`` OIHW and ``Dense_0.weight`` ``[out, in]``, as
:mod:`.convert` carries them across.  ``F.group_norm`` computes the
variance as the mean of squared deviations where flax takes
``E[x^2] - E[x]^2``: the two agree to float32 rounding at these widths
(``tests/test_torch_resnet.py`` states the tolerance).

Under ``model_config.dtype`` (bfloat16, float16) the convolutions and the
dense layer run in that dtype; GroupNorm takes its statistics and its
affine in float32 and returns the dtype, as flax's does
(``msrflute_tpu/models/resnet.py:30-42``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import RESNET_DEPTHS
from .base import (Params, conv, lecun_normal_, linear, parse_dtype,
                   to_float_image)
from .cv import ClassificationTask

GN_EPS = 1e-5


class _GroupNorm(nn.Module):
    """flax ``nn.GroupNorm``: ``scale`` and ``bias`` per channel."""

    def __init__(self, channels: int, channels_per_group: int,
                 zero_scale: bool = False):
        super().__init__()
        self.groups = max(channels // max(channels_per_group, 1), 1)
        self.zero_scale = zero_scale
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32:
            return F.group_norm(x, self.groups, self.scale.float(),
                                self.bias.float(), GN_EPS)
        return F.group_norm(x.float(), self.groups, self.scale.float(),
                            self.bias.float(), GN_EPS).to(x.dtype)


def _conv(c_in: int, c_out: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, k, stride=stride, padding=k // 2,
                     bias=False)


class _BasicBlock(nn.Module):
    def __init__(self, c_in: int, planes: int, stride: int,
                 channels_per_group: int):
        super().__init__()
        self.Conv_0 = _conv(c_in, planes, 3, stride)
        self.GroupNorm_0 = _GroupNorm(planes, channels_per_group)
        self.Conv_1 = _conv(planes, planes, 3)
        self.GroupNorm_1 = _GroupNorm(planes, channels_per_group,
                                      zero_scale=True)
        self.project = c_in != planes or stride != 1
        if self.project:
            self.Conv_2 = _conv(c_in, planes, 1, stride)
            self.GroupNorm_2 = _GroupNorm(planes, channels_per_group)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.GroupNorm_0(conv(self.Conv_0, x, x.dtype)))
        y = self.GroupNorm_1(conv(self.Conv_1, y, y.dtype))
        residual = (self.GroupNorm_2(conv(self.Conv_2, x, x.dtype))
                    if self.project else x)
        return F.relu(y + residual)


class ResNetGNModule(nn.Module):
    """NHWC ``[N, H, W, in_channels]`` images -> ``[N, num_classes]``
    logits."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 100, channels_per_group: int = 32,
                 in_channels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = _conv(in_channels, 64, 7, 2)
        self.GroupNorm_0 = _GroupNorm(64, channels_per_group)
        blocks, c_in, planes = [], 64, 64
        for stage, count in enumerate(stage_sizes):
            for block in range(count):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(_BasicBlock(c_in, planes, stride,
                                          channels_per_group))
                c_in = planes
            planes *= 2
        for i, block in enumerate(blocks):
            setattr(self, f"_BasicBlock_{i}", block)
        self.num_blocks = len(blocks)
        self.Dense_0 = nn.Linear(c_in, num_classes)

    def forward(self, x: torch.Tensor,
                masks: Tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
        x = to_float_image(x, self.dtype).permute(0, 3, 1, 2)  # NCHW
        x = F.relu(self.GroupNorm_0(conv(self.Conv_0, x, x.dtype)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(self.num_blocks):
            x = getattr(self, f"_BasicBlock_{i}")(x)
        return linear(self.Dense_0, x.mean(dim=(2, 3)),  # global avg pool
                      self.dtype)


class ResNetTask(ClassificationTask):
    def init_params(self, seed: int) -> Params:
        """The JAX package's initializers: convolutions He fan-out normal,
        GroupNorm scales one (zero on each block's final norm) and biases
        zero, the dense kernel lecun-normal with a zero bias; drawn on the
        CPU so every device starts from the same bits."""
        gen = torch.Generator().manual_seed(int(seed))
        modules = dict(self.module.named_modules())
        out = {}
        for name, shape in self.param_spec():
            owner, leaf = name.rsplit(".", 1)
            module = modules[owner]
            t = torch.zeros(shape, dtype=torch.float32)
            if isinstance(module, nn.Conv2d):
                fan_out = shape[0] * shape[2] * shape[3]
                t.normal_(0.0, math.sqrt(2.0 / fan_out), generator=gen)
            elif isinstance(module, _GroupNorm) and leaf == "scale":
                t.fill_(0.0 if module.zero_scale else 1.0)
            elif isinstance(module, nn.Linear) and leaf == "weight":
                lecun_normal_(t, shape[1], gen)
            out[name] = t
        return out


def make_resnet_task(model_config) -> ResNetTask:
    side = int(model_config.get("image_size", 32))
    chans = int(model_config.get("in_channels", 3))
    num_classes = int(model_config.get("num_classes", 100))
    module = ResNetGNModule(
        RESNET_DEPTHS[int(model_config.get("depth", 18))], num_classes,
        int(model_config.get("channels_per_group", 32)), chans,
        parse_dtype(model_config))
    return ResNetTask(module, example_shape=(side, side, chans),
                      name="cv_resnet_fedcifar100", num_classes=num_classes)
