"""Kernel B3: histogram binning plus sub-threshold zeroing over ``[K, P]``.

Port of ``msrflute_tpu/ops/pallas_kernels.py::quant_bin_sparsify``
(``_quant_kernel``, ``pallas_call`` at ``pallas_kernels.py:164``), with the
arithmetic of the JAX package's jnp path (``ops/quantization.py:72-76``).
For element ``x`` of client row ``k`` in leaf ``l``, with ``lo``, ``hi``,
``thresh`` the ``[K, L]`` tables and ``n = n_bins``::

    width = (hi - lo) / (n - 1)                      once per (k, l)
    idx   = clip(round((x - lo) / max(width, 1e-30)), 0, n - 1)
    out   = lo + idx * width   if |x| > thresh   else 0

``round`` is half to even.  The JAX package launches its kernel once per
leaf per client (under the round's ``vmap``); the port launches once per
round over the whole ``[K, P]`` payload, with the leaf boundaries in an
``offsets [L + 1]`` table.  Each block of the kernel covers one tile of a
(client, leaf) segment and finds it in a tile table (:func:`schedule`),
which the wrapper builds from ``offsets`` on its device once a layout.

- :func:`quant_bin_plain` — the same arithmetic in separate PyTorch ops.
  The CPU tests use it, and the chip smoke test holds the kernel to it
  bitwise.
- :data:`quant_bin_sparsify` — the wrapper: the plain version for CPU
  tensors, the hand-written CUDA kernel (``csrc/quant_bin.cu``) for CUDA
  tensors, anything else raises.  ``quant_bin_sparsify.launches`` counts
  kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..telemetry.xla import hand_kernel
from . import _build

#: elements one block of the kernel covers (``kTile`` in the source)
TILE = 4096


def grid_size(P: int, L: int, tile: int = TILE) -> int:
    """Blocks a row of the kernel's grid has: at least the tiles of any
    layout of ``L`` leaves over ``P`` elements, from the shapes alone.  A
    leaf of ``n`` elements takes ``ceil((n + 3) / tile) < (n + 3) / tile +
    1`` tiles."""
    return -(-(P + 3 * L) // tile) + L


def schedule(offsets: torch.Tensor, P: int,
             tile: int = TILE) -> torch.Tensor:
    """The kernel's tile table for the leaves ``offsets [L + 1]`` over rows
    of ``P`` elements: ``[grid_size(P, L), 2]`` int32, entry ``t`` the leaf
    of tile ``t`` and the tile's number inside that leaf; ``L`` past the
    layout's last tile.  A leaf of ``n > 0`` elements takes ``ceil((n + 3)
    / tile)`` tiles, enough for a segment that starts up to 3 elements past
    a 16-byte address (the kernel cuts tiles at 16-byte addresses), an
    empty one none.  Built with tensor ops on ``offsets``' device: nothing
    is read on the host."""
    L = offsets.shape[0] - 1
    lens = offsets[1:] - offsets[:-1]
    counts = torch.where(lens > 0, (lens + tile + 2) // tile, 0)
    ends = torch.cumsum(counts, 0)
    t = torch.arange(grid_size(P, L, tile), device=offsets.device)
    leaf = torch.searchsorted(ends, t, right=True)
    first = (ends - counts)[torch.clamp(leaf, max=L - 1)]
    return torch.stack((leaf, t - first), dim=1).to(torch.int32)


def _widths(lo: torch.Tensor, hi: torch.Tensor, n_bins: int):
    # divided by a tensor, not a Python number: PyTorch's CUDA division by
    # a host scalar multiplies by its reciprocal, which is not IEEE division
    top = torch.full_like(hi, float(max(n_bins - 1, 1)))
    width = (hi - lo) / top
    return width, torch.clamp(width, min=1e-30)


def quant_bin_plain(x: torch.Tensor, offsets: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor, thresh: torch.Tensor,
                    n_bins: int) -> torch.Tensor:
    width, wdiv = _widths(lo, hi, n_bins)
    out = torch.empty_like(x)
    bounds = offsets.tolist()
    for l, (a, b) in enumerate(zip(bounds[:-1], bounds[1:])):
        g = x[:, a:b]
        lo_l, w_l = lo[:, l:l + 1], width[:, l:l + 1]
        idx = torch.clamp(torch.round((g - lo_l) / wdiv[:, l:l + 1]),
                          0, n_bins - 1)
        out[:, a:b] = torch.where(torch.abs(g) > thresh[:, l:l + 1],
                                  lo_l + idx * w_l, torch.zeros_like(g))
    return out


def _check(x, offsets, lo, hi, thresh, n_bins) -> None:
    if x.ndim != 2:
        raise ValueError(f"quant_bin_sparsify: x must be [K, P], got "
                         f"{tuple(x.shape)}")
    for name, t in (("x", x), ("lo", lo), ("hi", hi), ("thresh", thresh)):
        if t.dtype != torch.float32:
            raise TypeError(f"quant_bin_sparsify: {name} must be float32, "
                            f"got {t.dtype}")
    if offsets.dtype != torch.int64:
        raise TypeError("quant_bin_sparsify: offsets must be int64, got "
                        f"{offsets.dtype}")
    for name, t in (("x", x), ("offsets", offsets), ("lo", lo), ("hi", hi),
                    ("thresh", thresh)):
        if not t.is_contiguous():
            raise ValueError(f"quant_bin_sparsify: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"quant_bin_sparsify: {name} is on {t.device}, "
                             f"x on {x.device}")
    L = offsets.shape[0] - 1
    if offsets.ndim != 1 or L < 1:
        raise ValueError("quant_bin_sparsify: offsets must be [L + 1], "
                         f"got {tuple(offsets.shape)}")
    for name, t in (("lo", lo), ("hi", hi), ("thresh", thresh)):
        if t.shape != (x.shape[0], L):
            raise ValueError(f"quant_bin_sparsify: {name} must be "
                             f"[{x.shape[0]}, {L}], got {tuple(t.shape)}")
    # offsets itself (0 = o_0 <= ... <= o_L = P) is read on the device
    # only, so a CUDA call never waits for a copy to the host
    if int(n_bins) < 1:
        raise ValueError(f"quant_bin_sparsify: n_bins must be >= 1, got "
                         f"{n_bins}")


class QuantBinSparsify:
    """Callable wrapper with a plain-integer launch counter."""

    def __init__(self) -> None:
        self.launches = 0
        self._fn = None
        # offsets tensor -> ((its version, P), tile table): built once a
        # layout, and dropped with the offsets tensor
        self._tables = WeakIdKeyDictionary()

    def _kernel(self):
        if self._fn is None:
            lib = _build.load("quant_bin")
            tile = lib.quant_bin_tile
            tile.argtypes = []
            tile.restype = ctypes.c_int
            if tile() != TILE:
                raise RuntimeError(f"quant_bin kernel tiles {tile()} "
                                   f"elements, the wrapper {TILE}")
            fn = lib.quant_bin_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_longlong,
                           ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = lib.quant_bin_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn = (fn, err)
        return self._fn

    def table(self, offsets: torch.Tensor, P: int) -> torch.Tensor:
        """:func:`schedule` of ``offsets``, made once for each offsets
        tensor (again if it is written in place)."""
        key = (offsets._version, P)
        cached = self._tables.get(offsets)
        if cached is None or cached[0] != key:
            cached = (key, schedule(offsets, P))
            self._tables[offsets] = cached
        return cached[1]

    def __call__(self, x: torch.Tensor, offsets: torch.Tensor,
                 lo: torch.Tensor, hi: torch.Tensor, thresh: torch.Tensor,
                 n_bins: int) -> torch.Tensor:
        _check(x, offsets, lo, hi, thresh, n_bins)
        # the bound's bytes: x read, the result written
        with hand_kernel("quant_bin_sparsify", lambda: (
                0.0, 2.0 * x.numel() * x.element_size())):
            return self._apply(x, offsets, lo, hi, thresh, n_bins)

    def _apply(self, x, offsets, lo, hi, thresh, n_bins):
        if x.device.type == "cpu":
            return quant_bin_plain(x, offsets, lo, hi, thresh, n_bins)
        if x.device.type != "cuda":
            raise ValueError(
                f"quant_bin_sparsify: unsupported device {x.device}")
        K, P = x.shape
        L = offsets.shape[0] - 1
        fn, err = self._kernel()
        with torch.cuda.device(x.device):
            tiles = self.table(offsets, P)
            out = _aligned_like(x)
            stream = torch.cuda.current_stream(x.device).cuda_stream
            code = fn(x.data_ptr(), out.data_ptr(), offsets.data_ptr(),
                      tiles.data_ptr(), lo.data_ptr(), hi.data_ptr(),
                      thresh.data_ptr(), K, P, L, tiles.shape[0],
                      int(n_bins), stream)
        if code != 0:
            raise RuntimeError("quant_bin kernel launch failed: "
                               f"{err(code).decode()} ({code})")
        self.launches += 1
        return out


def _aligned_like(x: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor like ``x`` whose address agrees with ``x``'s
    mod 16, so that the kernel's 16-byte accesses line up in both."""
    shift = (x.data_ptr() // 4) % 4
    if shift == 0:
        return torch.empty_like(x)
    buf = torch.empty(x.numel() + 3, dtype=x.dtype, device=x.device)
    return buf[shift:shift + x.numel()].view(x.shape)


quant_bin_sparsify = QuantBinSparsify()
