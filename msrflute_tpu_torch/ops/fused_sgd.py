"""Kernel B1: the fused momentum-SGD apply over ``[K, P]`` client rows.

Port of ``msrflute_tpu/ops/pallas_kernels.py::fused_sgd_apply``
(``_sgd_kernel``, ``pallas_call`` at ``pallas_kernels.py:212``).  Per element
of client row ``k``::

    m' = g + (mu * m)        p' = p - (lr * m')

with ``gate[k] <= 0`` pinning row ``k`` of both ``p`` and ``m`` (the
all-padding-step no-op of the client update).  Where the JAX client update
launches its kernel once per client per step (under ``vmap``), the port
launches once per step over all K rows.

Both versions update ``p`` and ``m`` IN PLACE and return them:

- :func:`fused_sgd_plain` — separate elementwise PyTorch ops in the same
  association (no ``add(alpha=)``/``addcmul``, which may contract).  The CPU
  tests use it, and the chip smoke test holds the kernel to it.
- :data:`fused_sgd_apply` — the wrapper: the plain version for CPU tensors,
  the hand-written CUDA kernel (``csrc/fused_sgd.cu``) for CUDA tensors,
  anything else raises.  ``fused_sgd_apply.launches`` counts kernel
  launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build


def fused_sgd_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    lr: float, mu: float, gate: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    m_new = g + mu * m
    p_new = p - lr * m_new
    live = (gate > 0)[:, None]
    m.copy_(torch.where(live, m_new, m))
    p.copy_(torch.where(live, p_new, p))
    return p, m


def _check(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
           gate: torch.Tensor) -> None:
    for name, t in (("p", p), ("g", g), ("m", m), ("gate", gate)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_sgd_apply: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_sgd_apply: {name} must be contiguous")
        if t.device != p.device:
            raise ValueError(f"fused_sgd_apply: {name} is on {t.device}, "
                             f"p on {p.device}")
    if p.ndim != 2 or g.shape != p.shape or m.shape != p.shape:
        raise ValueError("fused_sgd_apply: p, g, m must share one [K, P] "
                         f"shape, got {tuple(p.shape)}, {tuple(g.shape)}, "
                         f"{tuple(m.shape)}")
    if gate.shape != (p.shape[0],):
        raise ValueError(f"fused_sgd_apply: gate must be [{p.shape[0]}], "
                         f"got {tuple(gate.shape)}")


class FusedSGDApply:
    """Callable wrapper with a plain-integer launch counter."""

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            lib = _build.load("fused_sgd")
            fn = lib.fused_sgd_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = lib.fused_sgd_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn = (fn, err)
        return self._fn

    def __call__(self, p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                 lr: float, mu: float, gate: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        _check(p, g, m, gate)
        if p.device.type == "cpu":
            return fused_sgd_plain(p, g, m, lr, mu, gate)
        if p.device.type != "cuda":
            raise ValueError(f"fused_sgd_apply: unsupported device {p.device}")
        fn, err = self._kernel()
        with torch.cuda.device(p.device):
            stream = torch.cuda.current_stream(p.device).cuda_stream
            code = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                      gate.data_ptr(), p.shape[0], p.shape[1], float(lr),
                      float(mu), stream)
        if code != 0:
            raise RuntimeError("fused_sgd kernel launch failed: "
                               f"{err(code).decode()} ({code})")
        self.launches += 1
        return p, m


fused_sgd_apply = FusedSGDApply()
