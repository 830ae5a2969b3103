"""16-bit convolutions on the CPU run outside oneDNN.

oneDNN's bfloat16 convolution weight gradient on the CPU returns garbage,
NaN at times, at the taps that see only padding: at ResNet-18-GN's last
stage on 16x16 images (``x [4, 256, 1, 1]``, ``w [512, 256, 3, 3]``,
stride 2, padding 1) 8 of the 9 taps see only padding and their gradient
is exactly 0.  The client step wraps its ``vmap(grad(...))`` in
:func:`msrflute_tpu_torch.device.cpu16_guard`, which turns oneDNN off for
a 16-bit step on the CPU; this test repeats that gradient under the same
wrapper and holds every call to exact zeros there and to one another,
bit for bit.  Without the wrapper most calls differ.
"""

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, grad, vmap

from msrflute_tpu_torch.device import cpu16_guard
from msrflute_tpu_torch.models.base import conv

#: calls of the gradient: without the guard most of them draw garbage
CALLS = 200
K = 2


class _Conv(nn.Module):
    def __init__(self):
        super().__init__()
        self.c = nn.Conv2d(256, 512, 3, stride=2, padding=1, bias=False)

    def forward(self, x):
        return conv(self.c, x, torch.bfloat16)


def test_bf16_conv_weight_gradient_is_exact_at_padding_taps():
    module = _Conv()
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(0, 0.02, (K, 512, 256, 3, 3))
                         .astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(K, 4, 256, 1, 1))
                         .astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(K, 4, 512, 1, 1))
                           .astype(np.float32))

    def loss(weight, xs, c):
        out = functional_call(module, {"c.weight": weight}, (xs,))
        return (out.float() * c).sum()

    grad_fn = vmap(grad(loss))
    first, nonzero, differ = None, 0, 0
    for _ in range(CALLS):
        with cpu16_guard(torch.device("cpu"), torch.bfloat16):
            g = grad_fn(w, x, cot)
        pad = g.clone()
        pad[..., 1, 1] = 0.0        # the one tap that sees the pixel
        nonzero += int(bool((pad != 0).any()))
        if first is None:
            first = g
        else:
            differ += int(not torch.equal(g, first))
    assert nonzero == 0 and differ == 0, (
        f"{nonzero} of {CALLS} calls gave non-zero padding taps, "
        f"{differ} differ from the first")
    assert bool(torch.isfinite(first).all())
    assert bool((first[..., 1, 1] != 0).any())


def test_guard_leaves_float32_and_cuda_steps_alone():
    on = torch.backends.mkldnn.enabled
    with cpu16_guard(torch.device("cpu"), torch.float32, None):
        assert torch.backends.mkldnn.enabled == on
    with cpu16_guard(torch.device("cuda"), torch.bfloat16):
        assert torch.backends.mkldnn.enabled == on
    for dt in (torch.bfloat16, torch.float16):
        with cpu16_guard("cpu", torch.float32, dt):
            assert not torch.backends.mkldnn.enabled
        assert torch.backends.mkldnn.enabled == on
