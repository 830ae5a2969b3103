"""NLP tasks — the port's counterpart of ``msrflute_tpu/models/nlp.py``:
the masked sequence-LM task base (:class:`SequenceLMTask`, which the RingLM
task of :mod:`.ringlm` shares), the Shakespeare char LSTM of
``experiments/nlp_rnn_fedshakespeare`` and the Reddit GRU word LM of
``experiments/nlg_gru``.

The LSTM (reference ``experiments/nlp_rnn_fedshakespeare/model.py:12-40``,
the JAX package's ``_ShakespeareLSTM``): an embedding of the 90 chars into
8, two stacked flax ``OptimizedLSTMCell``s of 256 run from a zero carry,
and a dense layer back to the vocabulary at every position.  The cell's
parameters keep flax's names: input kernels ``ii``, ``if``, ``ig``, ``io``
``[in, H]`` without bias, hidden kernels ``hi``, ``hf``, ``hg``, ``ho``
``[H, H]`` with the bias; ``c' = f c + i g``, ``h' = o tanh(c')``.  Under
``model_config.dtype`` (bfloat16, float16) the embedding, the gate
products and activations and the head run in that dtype, while the
carry stays float32 (flax initialises it in the parameters' dtype, and
``f * c`` promotes), as ``msrflute_tpu/models/nlp.py:32-44`` does; the
logits are upcast for the cross entropy.  The GRU runs in float32 whatever
``dtype`` says, as the JAX package's does.

The GRU (reference ``experiments/nlg_gru/model.py:11-133``): a tied
embedding table, a convex-combination GRU cell (``hy = n + i * (h - n)``,
gates split in r, i, n order), the zero initial state's prediction
concatenated in front, a bias-free ``squeeze`` projection back to the
embedding width, and ``logits = squeezed @ table.T + bias``.

Parameters keep flax's names and layouts (Dense kernels ``[in, out]``),
and :meth:`SequenceLMTask.param_spec` lists them in the JAX package's
``ravel_pytree`` order (keys sorted at every level), so the port's flat
``[P]`` vector is element for element the JAX package's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data import featurize
from ..data.dataset import ArraysDataset
from ..data.user_blob import UserBlob
from .base import (BaseTask, Batch, Params, lecun_normal_, parse_dtype,
                   softmax_xent)


class _Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias`` with ``kernel [in, out]``."""

    def __init__(self, d_in: int, d_out: int, use_bias: bool = True):
        super().__init__()
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(d_out))
        else:
            self.bias = None
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out))

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """In ``dtype``: the input, kernel and bias cast to it (flax's
        ``promote_dtype``); in float32 the casts are the identity."""
        y = x.to(dtype) @ self.kernel.to(dtype)
        return y if self.bias is None else y + self.bias.to(dtype)


def embed_lookup(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[x]`` as a one-hot product: exact (one term of each sum is
    nonzero), and its backward is a GEMM, where PyTorch's CUDA embedding
    backward sums with atomics past 3,072 indices, so that two runs differ.
    At the char vocabulary (90) it costs about 1 GFLOP a local step."""
    onehot = x[..., None] == torch.arange(table.shape[0], device=x.device)
    return onehot.to(table.dtype) @ table


class _Embed(nn.Module):
    def __init__(self, vocab_size: int, dim: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(vocab_size, dim))


class _LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``'s parameters, run over a whole sequence."""

    GATES = "ifgo"

    def __init__(self, d_in: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden = hidden
        self.dtype = dtype
        for g in self.GATES:
            self.add_module(f"i{g}", _Dense(d_in, hidden, use_bias=False))
            self.add_module(f"h{g}", _Dense(hidden, hidden))

    def forward(self, x: torch.Tensor, return_cell: bool = False):
        """``x [B, T, d_in]`` -> the hidden states ``[B, T, H]`` from a zero
        carry (and the last cell state ``c [B, H]`` with ``return_cell``).
        The input projection of every step is one product up front; the
        ``T`` steps are a Python loop of one ``[B, H] x [H, 4H]`` product
        and the gate arithmetic each."""
        dt = self.dtype
        w_i = torch.cat([getattr(self, f"i{g}").kernel for g in self.GATES],
                        dim=1).to(dt)
        w_h = torch.cat([getattr(self, f"h{g}").kernel for g in self.GATES],
                        dim=1).to(dt)
        b_h = torch.cat([getattr(self, f"h{g}").bias
                         for g in self.GATES]).to(dt)
        xi = x.to(dt) @ w_i                                # [B, T, 4H]
        # the carry in the parameters' dtype, float32
        h = torch.zeros((x.shape[0], self.hidden), dtype=torch.float32,
                        device=xi.device)
        c, out = h, []
        for t in range(x.shape[1]):
            i, f, g, o = ((h.to(dt) @ w_h + b_h) + xi[:, t]).split(
                self.hidden, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        out = torch.stack(out, dim=1)
        return (out, c) if return_cell else out


class ShakespeareLSTMModule(nn.Module):
    """``x [B, T]`` char ids -> logits ``[B, T, V]``; the attribute names
    are flax's module names."""

    def __init__(self, vocab_size: int = 90, embed_dim: int = 8,
                 hidden: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Embed_0 = _Embed(vocab_size, embed_dim)
        self.OptimizedLSTMCell_0 = _LSTMCell(embed_dim, hidden, dtype)
        self.OptimizedLSTMCell_1 = _LSTMCell(hidden, hidden, dtype)
        self.Dense_0 = _Dense(hidden, vocab_size)

    def forward(self, x: torch.Tensor,
                masks: Tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
        h = embed_lookup(x, self.Embed_0.embedding.to(self.dtype))
        h = self.OptimizedLSTMCell_1(self.OptimizedLSTMCell_0(h))
        return self.Dense_0(h, self.dtype)


class _ConvexGRUCell(nn.Module):
    """The reference's GRU2 cell (``nlg_gru/model.py:11-28``)."""

    def __init__(self, embed_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.w_hh = _Dense(hidden, 3 * hidden)
        self.w_ih = _Dense(embed_dim, 3 * hidden)

    def step(self, gi: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """One time step, ``gi = w_ih(x_t)`` precomputed for all steps."""
        gh = self.w_hh(h)
        i_r, i_i, i_n = gi.split(self.hidden, dim=-1)
        h_r, h_i, h_n = gh.split(self.hidden, dim=-1)
        reset = torch.sigmoid(i_r + h_r)
        inp = torch.sigmoid(i_i + h_i)
        new = torch.tanh(i_n + reset * h_n)
        return new + inp * (h - new)


class GRUWordLMModule(nn.Module):
    """Tied-embedding GRU LM (``nlg_gru/model.py:39-83``); the attribute
    names are flax's module names."""

    def __init__(self, vocab_size: int = 10000, embed_dim: int = 160,
                 hidden_dim: int = 512):
        super().__init__()
        self.Scan_ConvexGRUCell_0 = _ConvexGRUCell(embed_dim, hidden_dim)
        self.embedding = nn.Parameter(torch.zeros(vocab_size, embed_dim))
        self.squeeze = _Dense(hidden_dim, embed_dim, use_bias=False)
        self.unembedding_bias = nn.Parameter(torch.zeros(vocab_size))

    def forward(self, x: torch.Tensor,
                masks: Tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
        """``x [B, T]`` ids (non-negative) -> logits ``[B, T + 1, V]``.

        The ``T`` time steps are a Python loop; the input projection of
        every step is one product up front."""
        cell = self.Scan_ConvexGRUCell_0
        table = self.embedding
        gi = cell.w_ih(F.embedding(x, table))            # [B, T, 3H]
        h = torch.zeros((x.shape[0], cell.hidden), dtype=gi.dtype,
                        device=gi.device)
        # the zero INITIAL state's prediction is part of the output and of
        # the loss (``nlg_gru/model.py:31-36, 92-100``)
        hiddens = [h]
        for t in range(x.shape[1]):
            h = cell.step(gi[:, t], h)
            hiddens.append(h)
        squeezed = self.squeeze(torch.stack(hiddens, dim=1))
        return squeezed @ table.T + self.unembedding_bias


class SequenceLMTask(BaseTask):
    """The masked sequence LM task (the JAX package's ``SequenceLMTask``
    with ``_TokenDatasetMixin``).

    ``batch['x']``: ``[B, L]`` ids, ``batch['tok_mask']``: ``[B, L]`` real
    positions (an unk id 0 is real), ``sample_mask``: ``[B]``; explicit
    per-position targets ride as ``y``.  Two alignments:

    - ``ref_initial_prediction`` (the reference GRU): the module reads
      ``x[:, :-1]`` and emits ``L`` positions, and the targets are the full
      ``x`` (position 0 is predicted from the zero initial state);
    - otherwise the plain shift: inputs ``x[:, :-1]``, targets ``x[:, 1:]``
      with ``tok_mask[:, 1:]``.

    With ``count_frames`` the trainer counts real INPUT positions
    (``train_sample_count``, reference ``total_frames``), else rows.
    ``tokenizer`` says how raw strings are encoded: ``"words"`` through the
    vocab, ``"chars"`` through the Shakespeare char table.
    """

    #: x, y and tok_mask are 0-padded rows that length bucketing crops
    #: together (``msrflute_tpu/models/nlp.py:118-123``); tok_mask marks
    #: real positions where x holds the unk id 0, so the bucket counts them
    seq_pad_keys = ("x", "y", "tok_mask")
    ref_initial_prediction: bool = False
    count_frames: bool = False
    tokenizer: str = "words"

    def __init__(self, module: nn.Module, seq_len: int, name: str,
                 vocab_path: Optional[str] = None, oov_reject: bool = False):
        self.module = module
        self.seq_len = int(seq_len)
        self.name = name
        self.vocab_path = vocab_path
        self.oov_reject = oov_reject

    def param_spec(self) -> List[Tuple[str, Tuple[int, ...]]]:
        """Leaves in ``ravel_pytree`` order: keys sorted at every level."""
        return sorted(super().param_spec(), key=lambda s: s[0].split("."))

    def _logits_targets(self, params: Params, batch: Batch):
        x = batch["x"].long()
        tok_mask = batch.get("tok_mask")
        if "y" in batch and batch["y"].ndim == x.ndim:
            inputs = x[:, :-1] if self.ref_initial_prediction else x
            targets = batch["y"].long()
        elif self.ref_initial_prediction:
            inputs, targets = x[:, :-1], x
        else:
            inputs, targets = x[:, :-1], x[:, 1:]
            if tok_mask is not None:
                # a target is real iff its position was real (keeps the
                # unk id 0 in the denominator)
                tok_mask = tok_mask[:, 1:]
        tok_mask = (tok_mask.to(torch.float32) if tok_mask is not None
                    else (targets != 0).to(torch.float32))
        logits = self.apply(params, inputs)
        return logits, targets, tok_mask * batch["sample_mask"][:, None]

    def loss_and_aux(self, params: Params, batch: Batch,
                     masks: Sequence[torch.Tensor] = ()
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, targets, tok_mask = self._logits_targets(params, batch)
        per_tok = softmax_xent(logits, targets)
        total = torch.sum(per_tok * tok_mask)
        count = torch.clamp(torch.sum(tok_mask), min=1.0)
        if not self.count_frames:
            return total / count, {}
        # reference total_frames: the real INPUT positions of the live rows
        inp = batch.get("tok_mask")
        inp = (inp.to(torch.float32) if inp is not None
               else (batch["x"] != 0).to(torch.float32))
        frames = torch.sum(inp * batch["sample_mask"][:, None])
        return total / count, {"train_sample_count": frames}

    def loss_masked(self, params: Params, batch: Batch,
                    masks: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        return self.loss_and_aux(params, batch, masks)[0]

    def topk_predictions(self, params: Params, batch: Batch, k: int = 1):
        """The ``wantLogits`` payload (``msrflute_tpu/models/nlp.py:207``):
        ``(probabilities [..., k], ids [..., k], labels [...])`` of each
        target position, padded positions labelled -1."""
        logits, targets, tok_mask = self._logits_targets(params, batch)
        top_p, top_ids = torch.topk(torch.softmax(logits, dim=-1), k,
                                    dim=-1)
        labels = torch.where(tok_mask > 0, targets,
                             torch.full_like(targets, -1))
        return top_p, top_ids, labels

    def token_logprobs(self, params: Params, batch: Batch
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each target's log-probability and the validity mask (the
        leakage attack's scorer, reference
        ``extensions/privacy/metrics.py:25-30``)."""
        logits, targets, tok_mask = self._logits_targets(params, batch)
        logp = F.log_softmax(logits, dim=-1)
        return (torch.gather(logp, -1, targets[..., None])[..., 0],
                tok_mask)

    def eval_stats(self, params: Params, batch: Batch
                   ) -> Dict[str, torch.Tensor]:
        logits, targets, tok_mask = self._logits_targets(params, batch)
        per_tok = softmax_xent(logits, targets)
        pred = torch.argmax(logits, dim=-1)
        correct = (pred == targets).to(torch.float32)
        if self.oov_reject:
            # a prediction of the unk id counts as wrong
            # (``nlg_gru/model.py:118-121``)
            correct = correct * (pred != 0)
        return {"loss_sum": torch.sum(per_tok * tok_mask),
                "correct_sum": torch.sum(correct * tok_mask),
                "sample_count": torch.sum(tok_mask),
                "seq_count": torch.sum(batch["sample_mask"])}

    def make_dataset(self, blob: UserBlob, data_config=None,
                     split: str = "train") -> ArraysDataset:
        """Raw strings are encoded by ``tokenizer`` (words through the vocab
        of ``model_config.vocab_dict``, else the split's ``vocab_dict``);
        token lists through the vocab; int sequences pass through.  Rows
        are 0-padded to ``seq_len`` with a ``tok_mask``; explicit label
        sequences become ``y``."""
        vocab = None
        if self.tokenizer == "words":
            vocab_path = self.vocab_path or (
                data_config.get("vocab_dict") if data_config else None)
            vocab = featurize.load_vocab(vocab_path) if vocab_path else None
        L = self.seq_len

        def words(s):
            if vocab is None:
                raise ValueError(f"{self.name}: raw words need a vocab_dict")
            return featurize.encode_words(s, vocab, L)

        def encode_rows(samples):
            rows = []
            for s in samples:
                if isinstance(s, str):
                    rows.append(featurize.encode_chars(s, L)
                                if self.tokenizer == "chars" else words(s))
                elif isinstance(s, (list, tuple)) and s and \
                        isinstance(s[0], str):
                    rows.append(words(s))
                else:
                    rows.append(np.asarray(s))
            return featurize.pad_token_matrix(rows, L)

        per_user = []
        for i in range(len(blob)):
            x, tok_mask = encode_rows(blob.user_data[i])
            entry = {"x": x, "tok_mask": tok_mask}
            if blob.user_labels is not None and \
                    blob.user_labels[i] is not None:
                entry["y"], entry["tok_mask"] = encode_rows(
                    blob.user_labels[i])
            per_user.append(entry)
        return ArraysDataset(blob.user_list, per_user,
                             [len(u["x"]) for u in per_user])


class GRUWordTask(SequenceLMTask):
    """:class:`SequenceLMTask` over :class:`GRUWordLMModule` with the
    reference GRU's alignment (``ref_initial_prediction``), word counting
    (``count_frames``) and OOV-rejecting accuracy."""

    ref_initial_prediction = True
    count_frames = True

    def init_params(self, seed: int) -> Params:
        """flax's initializers: the embedding uniform in
        ``+-sqrt(3 / embed_dim)``, Dense kernels lecun-normal, biases 0;
        drawn on the CPU so every device starts from the same bits."""
        gen = torch.Generator().manual_seed(int(seed))
        out = {}
        for name, shape in self.param_spec():
            t = torch.zeros(shape, dtype=torch.float32)
            if name == "embedding":
                bound = math.sqrt(3.0 / shape[1])
                t.uniform_(-bound, bound, generator=gen)
            elif name.endswith(".kernel"):
                lecun_normal_(t, shape[0], gen)
            out[name] = t
        return out


class ShakespeareTask(SequenceLMTask):
    """:class:`SequenceLMTask` over :class:`ShakespeareLSTMModule`: chars,
    the plain shift alignment (or explicit targets ``y``), rows counted."""

    tokenizer = "chars"

    def init_params(self, seed: int) -> Params:
        """flax's initializers: ``nn.Embed`` normal with variance
        ``1 / embed_dim``, input and output kernels lecun-normal, hidden
        kernels orthogonal, biases 0; drawn on the CPU so every device
        starts from the same bits."""
        gen = torch.Generator().manual_seed(int(seed))
        out = {}
        for name, shape in self.param_spec():
            t = torch.zeros(shape, dtype=torch.float32)
            path = name.split(".")
            if path[-1] == "embedding":
                t.normal_(0.0, math.sqrt(1.0 / shape[1]), generator=gen)
            elif path[-1] == "kernel" and path[-2] in ("hi", "hf", "hg",
                                                        "ho"):
                nn.init.orthogonal_(t, generator=gen)
            elif path[-1] == "kernel":
                lecun_normal_(t, shape[0], gen)
            out[name] = t
        return out


def make_shakespeare_lstm_task(model_config) -> ShakespeareTask:
    vocab = int(model_config.get("vocab_size", 90))
    module = ShakespeareLSTMModule(
        vocab_size=vocab, embed_dim=int(model_config.get("embed_dim", 8)),
        hidden=int(model_config.get("hidden_dim", 256)),
        dtype=parse_dtype(model_config))
    return ShakespeareTask(module, seq_len=int(model_config.get("seq_len",
                                                                80)),
                           name="nlp_rnn_fedshakespeare")


def make_gru_lm_task(model_config) -> GRUWordTask:
    module = GRUWordLMModule(
        vocab_size=int(model_config.get("vocab_size", 10000)),
        embed_dim=int(model_config.get("embed_dim", 160)),
        hidden_dim=int(model_config.get("hidden_dim", 512)))
    return GRUWordTask(module, seq_len=int(model_config.get("max_num_words",
                                                            25)),
                       name="nlg_gru",
                       vocab_path=model_config.get("vocab_dict"),
                       oov_reject=True)
