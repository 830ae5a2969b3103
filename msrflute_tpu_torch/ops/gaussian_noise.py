"""Kernel B2: ``x * scale + sigma * N(0, 1)`` with the noise made in the kernel.

Port of ``msrflute_tpu/ops/pallas_kernels.py::fused_gaussian_noise``
(``_noise_kernel``, ``pallas_call`` at ``pallas_kernels.py:127``), the
server-side global-DP step (``privacy.apply_global_dp``).  The TPU kernel
draws its bits from the TPU's own generator; the port draws them from
Philox-4x32-10 (Salmon et al., SC'11), keyed by a 64-bit ``seed``, with
the element index as the counter: one call on counter ``(j mod 2^32,
j >> 32, 0, 0)`` gives four words, ``(w0, w1)`` for element ``2j`` and
``(w2, w3)`` for element ``2j + 1``.  Each pair becomes a normal through
the JAX package's Box-Muller transform (:func:`bits_to_normal`, the
DP-critical arithmetic of ``pallas_kernels.py:77-95``).

- :func:`philox4x32_10` — Philox in PyTorch int64 arithmetic (the 32 x 32
  bit products split in 16-bit halves so nothing overflows), so the CPU and
  the card draw the same bits from the same seed.
- :func:`gaussian_noise_plain` — the plain version on those bits.  The CPU
  tests use it, and the chip smoke test holds the kernel to it.
- :data:`fused_gaussian_noise` — the wrapper: the plain version for CPU
  tensors, the hand-written CUDA kernel (``csrc/gaussian_noise.cu``) for
  CUDA tensors, anything else raises.  ``fused_gaussian_noise.launches``
  counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from ..telemetry.xla import hand_kernel
from . import _build

PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_M32 = 0xFFFFFFFF


def _mulhilo(m: int, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` words of the 64-bit product of the 32-bit constant ``m``
    and the int64 tensor ``c`` of 32-bit values, without int64 overflow."""
    a = m * (c & 0xFFFF)                      # < 2^48
    b = m * (c >> 16)                         # < 2^48
    s = a + ((b & 0xFFFF) << 16)              # < 2^49
    return (s >> 32) + (b >> 16), s & _M32


def philox4x32_10(ctr: Tuple[torch.Tensor, ...], key
                  ) -> Tuple[torch.Tensor, ...]:
    """Philox-4x32-10 on four int64 counter words (each in ``[0, 2^32)``)
    and two key words (ints, or int64 tensors of one key per counter);
    returns the four output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key[0] & _M32, key[1] & _M32
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W0) & _M32, (k1 + PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def seed_key(seed: int) -> Tuple[int, int]:
    """A 64-bit seed as Philox's two key words (low, high)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _M32, seed >> 32


def philox_pair_bits(seed: int, n: int, device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``(b1, b2)`` words of elements ``0 .. n-1`` (int64 tensors)."""
    pairs = (n + 1) // 2
    j = torch.arange(pairs, dtype=torch.int64, device=device)
    zero = torch.zeros_like(j)
    w0, w1, w2, w3 = philox4x32_10((j & _M32, j >> 32, zero, zero),
                                   seed_key(seed))
    b1 = torch.stack((w0, w2), dim=1).reshape(-1)[:n]
    b2 = torch.stack((w1, w3), dim=1).reshape(-1)[:n]
    return b1, b2


def bits_to_normal(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Box-Muller on two 32-bit words, as the JAX package writes it: the top
    24 bits become uniforms with 2^-24 resolution (exact in float32), the
    ``+1e-12`` floor guards ``log(0)`` and caps ``|z|`` at about 7.43."""
    u1 = (b1 >> 8).to(torch.float32) * (1.0 / (1 << 24)) + 1e-12
    u2 = (b2 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


def noise_apply(x: torch.Tensor, scale: float, sigma: float,
                z: torch.Tensor) -> torch.Tensor:
    """``x * scale + sigma * z``, each product rounded on its own."""
    return x * scale + sigma * z


def gaussian_noise_plain(x: torch.Tensor, scale: float, sigma: float,
                         seed: int) -> torch.Tensor:
    b1, b2 = philox_pair_bits(seed, x.numel(), x.device)
    return noise_apply(x, scale, sigma, bits_to_normal(b1, b2))


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"fused_gaussian_noise: x must be float32, got "
                        f"{x.dtype}")
    if x.ndim != 1:
        raise ValueError(f"fused_gaussian_noise: x must be flat [n], got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("fused_gaussian_noise: x must be contiguous")


class FusedGaussianNoise:
    """Callable wrapper with a plain-integer launch counter."""

    def __init__(self) -> None:
        self.launches = 0
        self._lib = None

    def library(self) -> ctypes.CDLL:
        """The built kernel library, its argument types declared."""
        if self._lib is None:
            lib = _build.load("gaussian_noise")
            lib.gaussian_noise_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_float, ctypes.c_float, ctypes.c_uint32,
                ctypes.c_uint32, ctypes.c_void_p]
            lib.gaussian_noise_launch.restype = ctypes.c_int
            lib.gaussian_noise_error_string.argtypes = [ctypes.c_int]
            lib.gaussian_noise_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def _raise(self, code: int) -> None:
        if code != 0:
            msg = self.library().gaussian_noise_error_string(code).decode()
            raise RuntimeError(f"gaussian_noise kernel launch failed: {msg} "
                               f"({code})")

    def __call__(self, x: torch.Tensor, scale: float, sigma: float,
                 seed: int) -> torch.Tensor:
        _check(x)
        # the bound's bytes: x read, the result written
        with hand_kernel("fused_gaussian_noise", lambda: (
                0.0, 2.0 * x.numel() * x.element_size())):
            return self._apply(x, scale, sigma, seed)

    def _apply(self, x, scale, sigma, seed):
        if x.device.type == "cpu":
            return gaussian_noise_plain(x, scale, sigma, seed)
        if x.device.type != "cuda":
            raise ValueError(
                f"fused_gaussian_noise: unsupported device {x.device}")
        out = torch.empty_like(x)
        k0, k1 = seed_key(seed)
        lib = self.library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code = lib.gaussian_noise_launch(
                x.data_ptr(), out.data_ptr(), x.numel(), float(scale),
                float(sigma), k0, k1, stream)
        self._raise(code)
        self.launches += 1
        return out


fused_gaussian_noise = FusedGaussianNoise()
