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

Not ported (ROADMAP.md): the sequence-parallel mode (``sp_module``,
``build_sp_train_step``, ring attention) with multi-GPU, ``remat``, the MoE
FFN (``moe_experts``) and the ``flash_attention: "auto"`` gate.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config import check_ringlm_model
from ..ops.flash_attention import flash_attention
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
                 mlp_dim: int, use_flash: bool):
        super().__init__()
        self.LayerNorm_0 = _LayerNorm(embed_dim)
        self._MHA_0 = _MHA(embed_dim, heads, head_dim, use_flash)
        self.LayerNorm_1 = _LayerNorm(embed_dim)
        self.Dense_0 = _Dense(embed_dim, mlp_dim)
        self.Dense_1 = _Dense(mlp_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self._MHA_0(self.LayerNorm_0(x))
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x), x.dtype),
                   approximate="tanh")
        return x + self.Dense_1(h, x.dtype)


class RingLMModule(nn.Module):
    """``x [B, L]`` char ids -> logits ``[B, L, vocab]``."""

    def __init__(self, vocab_size: int = 256, embed_dim: int = 64,
                 heads: int = 4, head_dim: int = 16, mlp_dim: int = 256,
                 num_layers: int = 2, max_len: int = 127,
                 use_flash: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        self.dtype = dtype
        self.Embed_0 = _Embed(vocab_size, embed_dim)
        self.pos = nn.Parameter(torch.zeros(max_len, embed_dim))
        for i in range(num_layers):
            # "block_{i}" is the JAX package's checkpoint key contract
            setattr(self, f"block_{i}",
                    _Block(embed_dim, heads, head_dim, mlp_dim, use_flash))
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
        ``1 / embed_dim``, ``pos`` normal(0.02), Dense kernels
        lecun-normal, biases 0, LayerNorm scales 1; drawn on the CPU so
        every device starts from the same bits."""
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
            elif leaf == "scale":
                t.fill_(1.0)
            out[name] = t
        return out


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
        use_flash=bool(model_config.get("flash_attention", False)),
        dtype=parse_dtype(model_config))
    return RingLMTask(module, seq_len=seq_len, name="ringlm")
