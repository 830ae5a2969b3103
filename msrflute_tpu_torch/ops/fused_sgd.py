"""Kernel B1: the fused momentum-SGD apply over ``[K, P]`` client rows.

Port of ``msrflute_tpu/ops/pallas_kernels.py::fused_sgd_apply``
(``_sgd_kernel``, ``pallas_call`` at ``pallas_kernels.py:212``).  Per element
of client row ``k``::

    m' = g + (mu * m)        p' = p - (lr * m')

with ``gate[k] <= 0`` pinning row ``k`` of both ``p`` and ``m`` (the
all-padding-step no-op of the client update).  Where the JAX client update
launches its kernel once per client per step (under ``vmap``), the port
launches once per step over all K rows.  ``p``, ``g`` and ``m`` are
float32, bfloat16 or float16 (one type for the three, as the precision
policy's ``params`` gives them); the arithmetic is float32 in every case
and the results are rounded to the storage type, as the JAX kernel's
upcast and ``astype`` do (``pallas_kernels.py:204-227``).

Both versions update ``p`` and ``m`` IN PLACE and return them:

- :func:`fused_sgd_plain` — separate elementwise PyTorch ops in the same
  association (no ``add(alpha=)``/``addcmul``, which may contract), on
  float32 copies of 16-bit inputs.  The CPU tests use it, and the chip
  smoke test holds the kernel to it.
- :data:`fused_sgd_apply` — the wrapper: the plain version for CPU tensors,
  the hand-written CUDA kernel (``csrc/fused_sgd.cu``) for CUDA tensors,
  anything else raises.  ``fused_sgd_apply.launches`` counts kernel
  launches, ``launches_by_dtype`` each storage arm's.  Inside a counted
  dispatch of the device-truth layer each call reports its bound's bytes,
  5 values a parameter (:func:`..telemetry.xla.hand_kernel`).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..telemetry.xla import hand_kernel
from . import _build


#: the storage types and their code in ``fused_sgd_launch``
STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def fused_sgd_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                    lr: float, mu: float, gate: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    pf, gf, mf = p.float(), g.float(), m.float()
    m_new = gf + mu * mf
    p_new = pf - lr * m_new
    live = (gate > 0)[:, None]
    m.copy_(torch.where(live, m_new, mf))
    p.copy_(torch.where(live, p_new, pf))
    return p, m


def _check(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
           gate: torch.Tensor) -> None:
    if p.dtype not in STORAGE:
        raise TypeError("fused_sgd_apply: p must be float32, bfloat16 or "
                        f"float16, got {p.dtype}")
    for name, t, want in (("g", g, p.dtype), ("m", m, p.dtype),
                          ("gate", gate, torch.float32)):
        if t.dtype != want:
            raise TypeError(f"fused_sgd_apply: {name} must be {want}, "
                            f"got {t.dtype}")
    for name, t in (("p", p), ("g", g), ("m", m), ("gate", gate)):
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
        self.launches_by_dtype = {str(dt)[6:]: 0 for dt in STORAGE}
        self._fn = None

    def _kernel(self):
        if self._fn is None:
            lib = _build.load("fused_sgd")
            fn = lib.fused_sgd_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                           ctypes.c_int, ctypes.c_void_p]
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
        with hand_kernel("fused_sgd_apply", lambda: (
                0.0, 5.0 * p.numel() * p.element_size())):
            return self._apply(p, g, m, lr, mu, gate)

    def _apply(self, p, g, m, lr, mu, gate):
        if p.device.type == "cpu":
            return fused_sgd_plain(p, g, m, lr, mu, gate)
        if p.device.type != "cuda":
            raise ValueError(f"fused_sgd_apply: unsupported device {p.device}")
        fn, err = self._kernel()
        with torch.cuda.device(p.device):
            stream = torch.cuda.current_stream(p.device).cuda_stream
            code = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                      gate.data_ptr(), p.shape[0], p.shape[1], float(lr),
                      float(mu), STORAGE[p.dtype], stream)
        if code != 0:
            raise RuntimeError("fused_sgd kernel launch failed: "
                               f"{err(code).decode()} ({code})")
        self.launches += 1
        self.launches_by_dtype[str(p.dtype)[6:]] += 1
        return p, m


fused_sgd_apply = FusedSGDApply()
