"""RingLM — the port's counterpart of ``msrflute_tpu/models/ringlm.py`` in its
local mode, the mode that rides the federated engine.

A pre-LN causal transformer LM over chars: ``Embed_0`` plus a learned
``pos`` table (allocated at ``max_len = seq_len - 1`` and sliced to the
input length), ``num_layers`` blocks of ``LayerNorm -> _MHA -> residual ->
LayerNorm -> Dense -> gelu (tanh) -> Dense -> residual``, a final
``LayerNorm`` and a ``Dense`` to the vocabulary.  The attention projections
have no bias, the MLP ``Dense`` layers do; the qkv projection is split as
``reshape(B, L, 3H, D)`` cut in three along the ``3H`` axis.  With
``flash_attention: true`` the attention runs through kernels B4-B6
(:mod:`..ops.flash_attention`); otherwise it is the JAX package's einsum
path with ``finfo.min`` masking.  Under ``model_config.dtype`` (bfloat16,
float16) the embedding, the dense layers, the attention and the residual
stream run in that dtype, LayerNorm takes its statistics and affine in
float32 and returns the dtype, and the flash arm feeds 16-bit q/k/v to
B4-B6 (``msrflute_tpu/models/ringlm.py:41-183``).

Parameters keep flax's names and ``[in, out]`` kernel layouts, and
:meth:`RingLMTask.param_spec` lists them in ``ravel_pytree`` order (keys
sorted as strings at every level, so ``block_10`` sorts before
``block_2``), so :mod:`.convert` carries weights across unchanged.

``moe_experts > 0`` replaces each block's MLP (``Dense_0``, gelu,
``Dense_1``) with the switch MoE FFN ``moe_ffn`` of :mod:`..ops.moe` in its
local mode.  ``remat: true`` recomputes each block in the backward
(:class:`_RematBlock`) instead of keeping its activations; the parameter
tree and the result are those without it.  ``flash_attention: "auto"``
takes flash where the sequence (``seq_len - 1``) reaches
:data:`FLASH_AUTO_MIN_LEN`, the JAX package's rule (:func:`_resolve_flash`).

Not ported (ROADMAP.md §A, multi-GPU): the sequence-parallel mode
(``sp_module``, ``build_sp_train_step``, ring attention) and the
expert-parallel MoE dispatch (``moe_ep_axis``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call, vjp

from ..config import check_ringlm_model
from ..ops.flash_attention import flash_attention
from ..ops.moe import MoEFFN, moe_fan_in
from .base import Params, lecun_normal_, parse_dtype
from .nlp import SequenceLMTask, _Dense, _Embed, embed_lookup

#: flax ``nn.LayerNorm``'s default epsilon (torch's is 1e-5)
LN_EPS = 1e-6


class _LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: the fast variance ``E[x^2] - E[x]^2`` (clipped
    at 0), then ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, in
    float32, returned in the dtype of ``x``."""

    def __init__(self, dim: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(dim))
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, x = x.dtype, x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        return ((x - mean) * (torch.rsqrt(var + LN_EPS) * self.scale.float())
                + self.bias.float()).to(dt)


class _MHA(nn.Module):
    def __init__(self, embed_dim: int, heads: int, head_dim: int,
                 use_flash: bool):
        super().__init__()
        self.heads, self.head_dim, self.use_flash = heads, head_dim, use_flash
        self.Dense_0 = _Dense(embed_dim, 3 * heads * head_dim, use_bias=False)
        self.Dense_1 = _Dense(heads * head_dim, embed_dim, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape
        H, D = self.heads, self.head_dim
        q, k, v = self.Dense_0(x, x.dtype).reshape(B, L, 3 * H, D).split(
            H, dim=2)
        if self.use_flash:
            attn = flash_attention(q, k, v, causal=True)
        else:
            scale = 1.0 / torch.sqrt(torch.tensor(float(D), dtype=q.dtype))
            scores = torch.einsum("blhd,bmhd->bhlm", q, k) * scale
            mask = torch.ones((L, L), dtype=torch.bool,
                              device=x.device).tril()
            scores = torch.where(mask, scores,
                                 torch.finfo(scores.dtype).min)
            attn = torch.einsum("bhlm,bmhd->blhd",
                                torch.softmax(scores, dim=-1), v)
        return self.Dense_1(attn.reshape(B, L, H * D), x.dtype)


class _Block(nn.Module):
    def __init__(self, embed_dim: int, heads: int, head_dim: int,
                 mlp_dim: int, use_flash: bool, moe_experts: int = 0,
                 remat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat = remat
        self.LayerNorm_0 = _LayerNorm(embed_dim)
        self._MHA_0 = _MHA(embed_dim, heads, head_dim, use_flash)
        self.LayerNorm_1 = _LayerNorm(embed_dim)
        if moe_experts > 0:
            self.moe_ffn = MoEFFN(embed_dim, moe_experts, mlp_dim, dtype)
        else:
            self.Dense_0 = _Dense(embed_dim, mlp_dim)
            self.Dense_1 = _Dense(mlp_dim, embed_dim)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """``plain``: run the block itself, never through remat (the
        recompute's own call)."""
        if self.remat and not plain:
            names, tensors = zip(*self.named_parameters())
            return _RematBlock.apply(self, names, x, *tensors)
        x = x + self._MHA_0(self.LayerNorm_0(x))
        h = self.LayerNorm_1(x)
        if hasattr(self, "moe_ffn"):
            return x + self.moe_ffn(h)
        h = F.gelu(self.Dense_0(h, x.dtype), approximate="tanh")
        return x + self.Dense_1(h, x.dtype)


def _run_block(block: _Block, names, x, params) -> torch.Tensor:
    """``block`` on ``x`` with ``params`` in place of its own, without
    remat."""
    return functional_call(block, dict(zip(names, params)), (x,),
                           {"plain": True})


class _RematBlock(torch.autograd.Function):
    """One block whose backward recomputes it (``nn.remat``, i.e.
    ``jax.checkpoint``, in the JAX package).  The forward keeps no
    activation: only the block's input and its parameter tensors are saved,
    taken as explicit inputs because under ``functional_call`` they are
    swapped-in tensors.  The backward is :class:`_RematBlockBwd`.
    ``torch.utils.checkpoint`` cannot serve here: neither of its modes runs
    under the client update's ``vmap(grad_and_value)``.  The vmap rules are
    generated, so under the client update the forward, the recompute and
    the flash kernels inside them cover all K clients at once (B4 runs
    twice a layer a step, B5 and B6 once)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(block, names, x, *params):
        return _run_block(block, names, x, params)

    @staticmethod
    def setup_context(ctx, inputs, output):
        block, names, x, *params = inputs
        ctx.block, ctx.names = block, names
        ctx.save_for_backward(x, *params)

    @staticmethod
    def backward(ctx, g):
        return (None, None, *_RematBlockBwd.apply(ctx.block, ctx.names, g,
                                                  *ctx.saved_tensors))


class _RematBlockBwd(torch.autograd.Function):
    """``(dx, *dparams)`` of one block: the block run again under
    :func:`torch.func.vjp` and the cotangent pulled through it.  A
    Function of its own because ``torch.func.grad`` differentiates with
    ``create_graph``: a backward written inline would be recorded for a
    second derivative, and the recompute's activations would stay alive
    until the whole backward ends, as the plain block's do.  First order
    only: the federated update takes no second derivative."""

    generate_vmap_rule = True

    @staticmethod
    def forward(block, names, g, x, *params):
        _, pull = vjp(lambda x, *p: _run_block(block, names, x, p), x,
                      *params)
        return pull(g)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("remat has no second derivative")


class RingLMModule(nn.Module):
    """``x [B, L]`` char ids -> logits ``[B, L, vocab]``."""

    def __init__(self, vocab_size: int = 256, embed_dim: int = 64,
                 heads: int = 4, head_dim: int = 16, mlp_dim: int = 256,
                 num_layers: int = 2, max_len: int = 127,
                 use_flash: bool = False,
                 dtype: torch.dtype = torch.float32, moe_experts: int = 0,
                 remat: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.dtype = dtype
        self.Embed_0 = _Embed(vocab_size, embed_dim)
        self.pos = nn.Parameter(torch.zeros(max_len, embed_dim))
        for i in range(num_layers):
            # "block_{i}" is the JAX package's checkpoint key contract
            setattr(self, f"block_{i}",
                    _Block(embed_dim, heads, head_dim, mlp_dim, use_flash,
                           moe_experts, remat, dtype))
        self.LayerNorm_0 = _LayerNorm(embed_dim)
        self.Dense_0 = _Dense(embed_dim, vocab_size)

    def forward(self, x: torch.Tensor,
                masks: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        h = embed_lookup(x, self.Embed_0.embedding.to(self.dtype))
        h = h + self.pos[:x.shape[1]].to(self.dtype)[None]
        for i in range(self.num_layers):
            h = getattr(self, f"block_{i}")(h)
        return self.Dense_0(self.LayerNorm_0(h), self.dtype)


class RingLMTask(SequenceLMTask):
    """Causal char LM with the plain shift alignment: inputs ``x[:, :-1]``,
    targets ``x[:, 1:]``; samples are counted as rows; no OOV rejection."""

    tokenizer = "chars"

    def init_params(self, seed: int) -> Params:
        """flax's initializers: ``nn.Embed`` normal with variance
        ``1 / embed_dim``, ``pos`` normal(0.02), Dense kernels and the MoE
        FFN's ``router``, ``w_in`` and ``w_out`` lecun-normal, biases 0,
        LayerNorm scales 1; drawn on the CPU so every device starts from
        the same bits."""
        gen = torch.Generator().manual_seed(int(seed))
        out = {}
        for name, shape in self.param_spec():
            t = torch.zeros(shape, dtype=torch.float32)
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "embedding":
                t.normal_(0.0, math.sqrt(1.0 / shape[1]), generator=gen)
            elif name == "pos":
                t.normal_(0.0, 0.02, generator=gen)
            elif leaf == "kernel":
                lecun_normal_(t, shape[0], gen)
            elif leaf in ("router", "w_in", "w_out"):
                lecun_normal_(t, moe_fan_in(shape), gen)
            elif leaf == "scale":
                t.fill_(1.0)
            out[name] = t
        return out


#: the dense/flash crossover of ``flash_attention: "auto"``: flash where
#: the sequence reaches this length.  It is the JAX package's rule
#: (``msrflute_tpu/models/ringlm.py:220-244``), copied so that both
#: packages take the same arm for one config; it is not a measurement of
#: this card (``chip_smoke.py``'s ``ringlm_flash_vs_dense`` times the two
#: arms on the card).
FLASH_AUTO_MIN_LEN = 4096


def _resolve_flash(flag, seq_len: int) -> bool:
    """``flash_attention``: a bool, or ``"auto"`` (any case): flash iff
    ``seq_len`` reaches :data:`FLASH_AUTO_MIN_LEN`."""
    if isinstance(flag, str):
        if flag.lower() != "auto":
            raise ValueError(
                f"model_config.flash_attention must be bool or 'auto', "
                f"got {flag!r}")
        return seq_len >= FLASH_AUTO_MIN_LEN
    return bool(flag)


def make_ringlm_task(model_config) -> RingLMTask:
    check_ringlm_model(model_config)
    seq_len = int(model_config.get("seq_len", 128))
    module = RingLMModule(
        vocab_size=int(model_config.get("vocab_size", 256)),
        embed_dim=int(model_config.get("embed_dim", 64)),
        heads=int(model_config.get("num_heads", 4)),
        head_dim=int(model_config.get("head_dim", 16)),
        mlp_dim=int(model_config.get("mlp_dim", 256)),
        num_layers=int(model_config.get("num_layers", 2)),
        max_len=seq_len - 1,
        use_flash=_resolve_flash(model_config.get("flash_attention", False),
                                 seq_len - 1),
        dtype=parse_dtype(model_config),
        moe_experts=int(model_config.get("moe_experts", 0) or 0),
        remat=bool(model_config.get("remat", False)))
    return RingLMTask(module, seq_len=seq_len, name="ringlm")
