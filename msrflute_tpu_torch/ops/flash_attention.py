"""Kernels B4, B5 and B6: flash attention, forward and backward.

Port of ``msrflute_tpu/ops/pallas_attention.py``: B4 replaces ``_fwd``
(``pallas_call`` at ``pallas_attention.py:336``, body ``_fwd_kernel``), B5
the dq pass of ``_bwd`` (``:385``, ``_dq_kernel``), B6 its dk/dv pass
(``:411``, ``_dkv_kernel``).  All three are hand-written CUDA C++ in
``csrc/flash_attention.cu``.  In float32 all three run on CUDA cores,
bound by operations on the H100, and are register-tiled: a thread owns a
4 x 4 block of each 64 x 64 score product and rows x 4 columns of each
accumulated output and feeds them with 16-byte shared loads (about one
load for 6-8 FMAs, not one for one), tiles that the mask cannot touch
skip the per-element test, and the streamed tiles arrive by
double-buffered ``cp.async`` copies; B4's online softmax runs in the log2
domain with ``ex2``.  In 16-bit storage all three are other kernels of
the same library, on the tensor cores (``mma.sync`` fed by ``ldmatrix``).
The source's header has the bank layout, the shared memory a block and
what bounds the kernels.

Public functions keep the JAX layout and signature: ``q [B, Lq, H, D]``,
``k``/``v`` ``[B, Lk, H, D]``, scale ``1/sqrt(D)``, the causal mask at
global positions ``q_offset``/``k_offset``; :func:`flash_attention_lse`
also returns the per-row logsumexp ``[B, H, Lq]`` and its gradient honours
the lse cotangent.  A row whose keys are all masked gives zeros with
``lse = -1e30``.  ``q``, ``k``, ``v`` (and ``dO``) are float32, bfloat16 or
float16, one type for all, and ``out``, ``dq``, ``dk`` and ``dv`` come
back rounded to that type (``lse``, ``delta`` and the lse cotangent stay
float32), as the TPU kernels' upcasts and ``astype`` do
(``pallas_attention.py:109-111``, ``:150``, ``:172-175``, ``:209``,
``:224-227``, ``:268-269``); any other type raises ``TypeError``.  In
float32 the kernels compute in float32 on CUDA cores; in bfloat16 /
float16 all three run their products on the tensor cores (16-bit
operands, float32 accumulators), the softmax and the masks in float32,
with P and dS rounded once to the storage type for the products that take
them.

The gradient is two ``torch.autograd.Function``s, forward and backward,
each with a ``vmap`` rule that folds the vmapped axis into ``B``: under
the client update's ``vmap(grad_and_value(loss))`` over K clients one
launch of each kernel covers all K.  ``delta = rowsum(dO * O)`` is a torch
reduction outside the kernels, as in JAX (``pallas_attention.py:374``).

Each kernel's wrapper (:data:`flash_fwd`, :data:`flash_dq`,
:data:`flash_dkv`) runs its plain PyTorch version on CPU tensors and
launches the kernel on CUDA tensors (anything else raises); ``launches``
counts kernel launches, ``launches_by_dtype`` each storage arm's.  The
plain versions (float32 math on upcast inputs, the result cast back):
:func:`attention_lse_plain` (the JAX package's ``_dense_lse``),
:func:`attention_dq_plain` and :func:`attention_dkv_plain` (the backward
in the kernels' math), and :func:`attention_bwd_plain`, which runs both.
:func:`kernel_info` reports what the compiler and the card give a kernel
(registers, spills, blocks an SM, shared memory a block).

Not ported (ROADMAP.md): the JAX package's dispatch gate
(``plan_attention``, ``attention_fallback_dense``) and its tile knobs.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from ..telemetry.xla import flash_work, hand_kernel
from . import _build

#: "minus infinity" that survives exp/max without NaNs (the TPU kernels')
NEG = -1e30


# ----------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------
def _scale(D: int) -> float:
    return 1.0 / math.sqrt(D)


def _mask(Lq: int, Lk: int, causal: bool, q_offset: int, k_offset: int,
          device) -> torch.Tensor:
    """``[Lq, Lk]`` visibility at global positions."""
    if not causal:
        return torch.ones((Lq, Lk), dtype=torch.bool, device=device)
    q_pos = q_offset + torch.arange(Lq, device=device)
    k_pos = k_offset + torch.arange(Lk, device=device)
    return q_pos[:, None] >= k_pos[None, :]


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.einsum("blhd,bmhd->bhlm", q.to(torch.float32),
                        k.to(torch.float32)) * _scale(q.shape[3])


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, q_offset: int = 0,
                        k_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``_dense_lse``: ``(out [B, Lq, H, D], lse
    [B, H, Lq])`` with the kernels' masking and lse semantics."""
    Lq, Lk = q.shape[1], k.shape[1]
    mask = _mask(Lq, Lk, causal, q_offset, k_offset, q.device)
    s = torch.where(mask, _scores(q, k), NEG)
    m = s.amax(dim=3)
    e = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = e.sum(dim=3)
    lc = torch.clamp(l, min=1e-30)
    lse = torch.where(l > 0, m + torch.log(lc), NEG)
    out = torch.einsum("bhlm,bmhd->blhd", e / lc[..., None],
                       v.to(torch.float32))
    return out.to(q.dtype), lse


def _probs_and_ds(q, k, v, g, lse, delta, g_lse, causal, q_offset,
                  k_offset):
    """The kernels' backward math: ``p`` recomputed from the saved lse,
    ``ds = p * (dp - delta + glse) * scale``.  The plain version has no
    padding, so every query row is real (the kernels' ``q_loc < Lq``)."""
    Lq, Lk = q.shape[1], k.shape[1]
    mask = _mask(Lq, Lk, causal, q_offset, k_offset, q.device)
    p = torch.where(mask, torch.exp(_scores(q, k) - lse[..., None]), 0.0)
    dp = torch.einsum("blhd,bmhd->bhlm", g.to(torch.float32),
                      v.to(torch.float32))
    ds = p * (dp - delta[..., None] + g_lse[..., None]) * _scale(q.shape[3])
    return p, ds


def attention_dq_plain(q, k, v, g, lse, delta, g_lse, causal=False,
                       q_offset=0, k_offset=0) -> torch.Tensor:
    """B5's plain version: ``dq [B, Lq, H, D]``."""
    _, ds = _probs_and_ds(q, k, v, g, lse, delta, g_lse, causal, q_offset,
                          k_offset)
    return torch.einsum("bhlm,bmhd->blhd", ds,
                        k.to(torch.float32)).to(q.dtype)


def attention_dkv_plain(q, k, v, g, lse, delta, g_lse, causal=False,
                        q_offset=0, k_offset=0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6's plain version: ``(dk, dv)``, each ``[B, Lk, H, D]``."""
    p, ds = _probs_and_ds(q, k, v, g, lse, delta, g_lse, causal, q_offset,
                          k_offset)
    dv = torch.einsum("bhlm,blhd->bmhd", p, g.to(torch.float32))
    dk = torch.einsum("bhlm,blhd->bmhd", ds, q.to(torch.float32))
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` as ``[B, H, Lq]``."""
    return torch.sum(g.to(torch.float32) * out.to(torch.float32),
                     dim=3).transpose(1, 2).contiguous()


def attention_bwd_plain(q, k, v, out, lse, g, g_lse, causal=False,
                        q_offset=0, k_offset=0):
    """The whole backward in the kernels' math: ``(dq, dk, dv)``."""
    delta = attention_delta(out, g)
    dq = attention_dq_plain(q, k, v, g, lse, delta, g_lse, causal, q_offset,
                            k_offset)
    dk, dv = attention_dkv_plain(q, k, v, g, lse, delta, g_lse, causal,
                                 q_offset, k_offset)
    return dq, dk, dv


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------
#: the storage types and the suffix of their launchers
SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16", torch.float16: "_f16"}


def _check(name: str, tensors, n_storage: int, Lq: int, Lk: int, B: int,
           H: int, D: int) -> None:
    """What the kernels take: contiguous tensors on one device, the first
    ``n_storage`` (``[B, Lq or Lk, H, D]``) of one storage type of
    :data:`SUFFIX`, the rest (``[B, H, Lq]`` row statistics) float32;
    ``D <= 128``."""
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if not 1 <= D <= 128:
        raise ValueError(f"{name}: head_dim {D} outside 1..128")
    storage = tensors[0].dtype
    if storage not in SUFFIX:
        raise TypeError(f"{name}: q, k, v must be float32, bfloat16 or "
                        f"float16, got {storage}")
    for i, t in enumerate(tensors):
        want = storage if i < n_storage else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: tensor {i} must be {want}, got "
                            f"{t.dtype}")
        if not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name}: inputs must be contiguous and on one "
                             "device")
        shape = tuple(t.shape)
        if shape not in ((B, Lq, H, D), (B, Lk, H, D), (B, H, Lq)):
            raise ValueError(f"{name}: unexpected shape {shape} for B={B} "
                             f"Lq={Lq} Lk={Lk} H={H} D={D}")


_INT_P = ctypes.POINTER(ctypes.c_int)
#: the entry points of ``csrc/flash_attention.cu`` beside the launchers:
#: ``(restype, argtypes)``
ENTRY_POINTS = {
    "flash_smem_bytes": (ctypes.c_longlong, [ctypes.c_int, ctypes.c_int]),
    "flash_kernel_info": (ctypes.c_int, [ctypes.c_int, ctypes.c_int, _INT_P,
                                         _INT_P, _INT_P]),
    "flash_attention_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}
#: the launchers (pointers, then ``B, Lq, Lk, H, D, causal, q_offset,
#: k_offset, scale, stream``), the 16-bit ones beside the float32 ones
_LAUNCH_TAIL = [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
for _kind, _n_ptr in (("fwd", 5), ("dq", 8), ("dkv", 9)):
    for _suffix in SUFFIX.values():
        if _suffix:
            ENTRY_POINTS[f"flash_{_kind}_launch{_suffix}"] = (
                ctypes.c_int, [ctypes.c_void_p] * _n_ptr + _LAUNCH_TAIL)


def _entry_point(name: str):
    fn = getattr(_build.load("flash_attention"), name)
    fn.restype, fn.argtypes = ENTRY_POINTS[name]
    return fn


def kernel_info(which: int, D: int,
                storage: torch.dtype = torch.float32) -> dict:
    """What the compiler and the card give pass ``which`` (0 B4, 1 B5, 2 B6)
    at head width ``D`` in the ``storage`` type: registers a thread, local
    memory a thread in bytes (stack and spills; 0 means no spill), the
    blocks an SM holds and the shared memory a block.  Builds the library,
    so it needs the card."""
    regs, local, blocks = (ctypes.c_int() for _ in range(3))
    arm = which + 3 * list(SUFFIX).index(storage)
    code = _entry_point("flash_kernel_info")(
        arm, D, ctypes.byref(regs), ctypes.byref(local),
        ctypes.byref(blocks))
    if code != 0:
        err = _entry_point("flash_attention_error_string")(code).decode()
        raise RuntimeError(f"flash_kernel_info failed: {err} ({code})")
    return {"registers": regs.value, "local_bytes": local.value,
            "blocks_per_sm": blocks.value,
            "smem_bytes": int(_entry_point("flash_smem_bytes")(arm, D))}


class _FlashKernel:
    """A kernel of ``csrc/flash_attention.cu`` with plain-integer launch
    counters.  Every launcher takes its tensors' pointers, then
    ``B, Lq, Lk, H, D, causal, q_offset, k_offset, scale, stream``; the
    float32 one is ``symbol``, the 16-bit ones add ``_bf16`` / ``_f16``."""

    #: what follows the ``n_ptr`` pointers of a launcher
    TAIL = _LAUNCH_TAIL

    def __init__(self, symbol: str, n_ptr: int) -> None:
        self.symbol = symbol
        self.n_ptr = n_ptr
        self.launches = 0
        self.launches_by_dtype = {str(dt)[6:]: 0 for dt in SUFFIX}
        self._fns = {}

    def _kernel(self, storage: torch.dtype = torch.float32):
        if storage not in self._fns:
            if storage == torch.float32:
                fn = getattr(_build.load("flash_attention"), self.symbol)
                fn.argtypes = [ctypes.c_void_p] * self.n_ptr + self.TAIL
                fn.restype = ctypes.c_int
            else:
                fn = _entry_point(self.symbol + SUFFIX[storage])
            self._fns[storage] = (
                fn, _entry_point("flash_attention_error_string"))
        return self._fns[storage]

    def _counted(self, which: str, q, k, causal, q_offset, k_offset):
        """The launch's analytic ``(flops, bytes)`` for a counted dispatch
        of the device-truth layer (:func:`..telemetry.xla.flash_work`)."""
        B, Lq, H, D = q.shape
        return hand_kernel(self.symbol, lambda: flash_work(
            which, B, Lq, k.shape[1], H, D, bool(causal), int(q_offset),
            int(k_offset), q.element_size()))

    def _launch(self, tensors, q, k, causal, q_offset, k_offset) -> None:
        B, Lq, H, D = q.shape
        fn, err = self._kernel(q.dtype)
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            code = fn(*[t.data_ptr() for t in tensors], B, Lq, k.shape[1], H,
                      D, int(bool(causal)), int(q_offset), int(k_offset),
                      _scale(D), stream)
        if code != 0:
            raise RuntimeError(f"{self.symbol}{SUFFIX[q.dtype]} failed: "
                               f"{err(code).decode()} ({code})")
        self.launches += 1
        self.launches_by_dtype[str(q.dtype)[6:]] += 1


class FlashFwd(_FlashKernel):
    """B4: ``(out, lse)`` of ``q, k, v``."""

    def __call__(self, q, k, v, causal=False, q_offset=0, k_offset=0):
        B, Lq, H, D = q.shape
        _check("flash_fwd", (q, k, v), 3, Lq, k.shape[1], B, H, D)
        with self._counted("fwd", q, k, causal, q_offset, k_offset):
            return self._apply(q, k, v, causal, q_offset, k_offset)

    def _apply(self, q, k, v, causal, q_offset, k_offset):
        B, Lq, H, D = q.shape
        if q.device.type == "cpu":
            return attention_lse_plain(q, k, v, causal, q_offset, k_offset)
        out = torch.empty_like(q)
        lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
        self._launch((q, k, v, out, lse), q, k, causal, q_offset, k_offset)
        return out, lse


class FlashDq(_FlashKernel):
    """B5: ``dq`` of ``q, k, v, dO, lse, delta, glse``."""

    def __call__(self, q, k, v, g, lse, delta, g_lse, causal=False,
                 q_offset=0, k_offset=0):
        B, Lq, H, D = q.shape
        _check("flash_dq", (q, k, v, g, lse, delta, g_lse), 4, Lq,
               k.shape[1], B, H, D)
        with self._counted("dq", q, k, causal, q_offset, k_offset):
            return self._apply(q, k, v, g, lse, delta, g_lse, causal,
                               q_offset, k_offset)

    def _apply(self, q, k, v, g, lse, delta, g_lse, causal, q_offset,
               k_offset):
        if q.device.type == "cpu":
            return attention_dq_plain(q, k, v, g, lse, delta, g_lse, causal,
                                      q_offset, k_offset)
        dq = torch.empty_like(q)
        self._launch((q, k, v, g, lse, delta, g_lse, dq), q, k, causal,
                     q_offset, k_offset)
        return dq


class FlashDkv(_FlashKernel):
    """B6: ``(dk, dv)`` of ``q, k, v, dO, lse, delta, glse``."""

    def __call__(self, q, k, v, g, lse, delta, g_lse, causal=False,
                 q_offset=0, k_offset=0):
        B, Lq, H, D = q.shape
        _check("flash_dkv", (q, k, v, g, lse, delta, g_lse), 4, Lq,
               k.shape[1], B, H, D)
        with self._counted("dkv", q, k, causal, q_offset, k_offset):
            return self._apply(q, k, v, g, lse, delta, g_lse, causal,
                               q_offset, k_offset)

    def _apply(self, q, k, v, g, lse, delta, g_lse, causal, q_offset,
               k_offset):
        if q.device.type == "cpu":
            return attention_dkv_plain(q, k, v, g, lse, delta, g_lse, causal,
                                       q_offset, k_offset)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        self._launch((q, k, v, g, lse, delta, g_lse, dk, dv), q, k, causal,
                     q_offset, k_offset)
        return dk, dv


flash_fwd = FlashFwd("flash_fwd_launch", 5)
flash_dq = FlashDq("flash_dq_launch", 8)
flash_dkv = FlashDkv("flash_dkv_launch", 9)


# ----------------------------------------------------------------------
# autograd, with vmap rules
# ----------------------------------------------------------------------
def _fold(info, in_dims, args):
    """Move each vmapped axis to the front and fold it into ``B``; an
    unbatched tensor is expanded to the batch first."""
    out = []
    for a, d in zip(args, in_dims):
        if isinstance(a, torch.Tensor):
            a = (a.movedim(d, 0) if d is not None
                 else a.expand(info.batch_size, *a.shape))
            a = a.reshape(a.shape[0] * a.shape[1], *a.shape[2:])
        out.append(a)
    return out


def _unfold(info, tensors):
    return tuple(t.unflatten(0, (info.batch_size, -1)) for t in tensors)


class _FlashAttention(torch.autograd.Function):
    """``(q, k, v) -> (out, lse)`` through B4; backward through
    :class:`_FlashAttentionBwd`."""

    @staticmethod
    def forward(q, k, v, causal, q_offset, k_offset):
        return flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal, q_offset, k_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, q_offset, k_offset = inputs
        ctx.save_for_backward(q, k, v, *output)
        ctx.args = (causal, q_offset, k_offset)

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        g = torch.zeros_like(out) if g is None else g
        g_lse = torch.zeros_like(lse) if g_lse is None else g_lse
        dq, dk, dv = _FlashAttentionBwd.apply(q, k, v, out, lse, g, g_lse,
                                              *ctx.args)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, q_offset, k_offset):
        args = _fold(info, in_dims, (q, k, v))
        out = _FlashAttention.apply(*args, causal, q_offset, k_offset)
        return _unfold(info, out), (0, 0)


class _FlashAttentionBwd(torch.autograd.Function):
    """``(q, k, v, out, lse, dO, glse) -> (dq, dk, dv)`` through B5 and B6.
    First-order only: the federated update needs no second derivative."""

    @staticmethod
    def forward(q, k, v, out, lse, g, g_lse, causal, q_offset, k_offset):
        q, k, v, g = (t.contiguous() for t in (q, k, v, g))
        lse, g_lse = lse.contiguous(), g_lse.contiguous()
        delta = attention_delta(out, g)
        dq = flash_dq(q, k, v, g, lse, delta, g_lse, causal, q_offset,
                      k_offset)
        dk, dv = flash_dkv(q, k, v, g, lse, delta, g_lse, causal, q_offset,
                           k_offset)
        return dq, dk, dv

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash attention has no second "
                                  "derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, out, lse, g, g_lse, causal, q_offset,
             k_offset):
        args = _fold(info, in_dims[:7], (q, k, v, out, lse, g, g_lse))
        grads = _FlashAttentionBwd.apply(*args, causal, q_offset, k_offset)
        return _unfold(info, grads), (0, 0, 0)


def _validate(q, k, v) -> None:
    if q.ndim != 4:
        raise ValueError(f"expected [B, L, H, D], got {tuple(q.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k/v shapes differ: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    if (k.shape[0], k.shape[2], k.shape[3]) != (q.shape[0], q.shape[2],
                                                q.shape[3]):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "outside the length axis")


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, *, q_offset: int = 0,
                        k_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, Lq, H, D], lse [B, H, Lq])``; differentiable in ``q``,
    ``k``, ``v`` through both outputs."""
    _validate(q, k, v)
    return _FlashAttention.apply(q, k, v, bool(causal), int(q_offset),
                                 int(k_offset))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, *, q_offset: int = 0,
                    k_offset: int = 0) -> torch.Tensor:
    """Exact attention over ``[B, L, H, D]``, softmax scale ``1/sqrt(D)``."""
    return flash_attention_lse(q, k, v, causal, q_offset=q_offset,
                               k_offset=k_offset)[0]
