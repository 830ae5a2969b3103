"""BERT masked LM (``experiments/mlm_bert``) — the port's counterpart of
``msrflute_tpu/models/bert.py``, written in the repo: the port imports no
``transformers``.  At the shipped widths (BERT-base: 12 layers of 768, 12
heads, intermediate 3,072, vocabulary 30,522, 512 positions) P =
109,514,298 in 202 leaves.

The module follows HF Flax ``FlaxBertForMaskedLM``'s semantics:

- embeddings: word + token type 0 + position, LayerNorm (eps 1e-12),
  dropout;
- each layer: query/key/value dense, scores ``(q / sqrt(d)) k^T`` plus an
  additive mask (0 or float32's lowest), softmax, attention dropout drawn
  once for the whole ``[L, L]`` map and shared by the batch and the heads
  (flax's ``broadcast_dropout``), then output dense, dropout and a
  residual LayerNorm; an erf-GELU feed-forward with the same tail;
- the MLM head: dense, GELU, LayerNorm, then the decoder TIED to the word
  embeddings (``h @ word^T``) plus a bias;
- hidden and attention dropout 0.1 in training, their masks drawn outside
  ``vmap`` from each client's ``torch.Generator``.

Dense attention is ``torch.matmul`` and a softmax: the JAX package
computes it outside any Pallas kernel.  The word lookup is
:func:`.embed.embed_gather` (a deterministic backward on the card).

``dtype`` (``BERT.model.dtype``, else ``model_config.dtype``, as
``msrflute_tpu/models/bert.py:78-106`` reads it): parameters stay float32
and every layer computes in the dtype at HF Flax's cast points
(``transformers``' ``modeling_flax_bert.py`` with flax's layers): the
three tables are cast before the lookups and summed in the dtype; every
``Dense`` casts its input, kernel and bias; LayerNorm takes its statistics
in float32 (``E[x^2] - E[x]^2``, clipped at 0) and its affine in float32,
and returns the dtype; the attention bias is 0 or the dtype's lowest, the
query is divided by ``sqrt(d)`` in the dtype, and the softmax runs in the
dtype as ``jax.nn.softmax`` does (``exp(x - max)`` over its sum); the MLM
head's decoder and bias run in the dtype and the logits are cast to
float32 for the loss.  In float32 every cast is the identity.

``mlm_head: gathered`` (``msrflute_tpu/models/bert.py:55-77, 146-220``)
projects only the masked positions into the vocabulary: each sequence's
positions with a label are packed, in order, into ``gathered_slots``
slots (a stable argsort; default ``min(max(ceil8(2 L p), 8), L)``, 40 at
``L = 128``, ``p = 0.15``), the slots left over take label -100, and
masked positions beyond the slots are dropped from the loss, the JAX
package's documented deviation.  The head follows ``_mlm_head_logits``:
dense and GELU in the dtype, LayerNorm's normalization in float32 (the
two-pass variance) with its affine in the dtype, the tied decoder in the
dtype and the bias added in float32.  So the ``[B, L, V]`` logits shrink
to ``[B, gathered_slots, V]``.

The task ports the JAX task's logic: ``_mlm_mask`` (the HF collator's
80/10/10 rule, drawn from the client's generator, so the streams differ
from JAX's), ``premasked`` mode, ``_masked_xent`` in logsumexp form with
label smoothing, ``train_sample_count`` equal to the attention positions,
and ``eval_stats`` with ``pos_count``.  Eval masks draw from a generator
seeded 1234 for every batch, as the JAX package uses ``PRNGKey(1234)``;
the bits differ.  Parameters keep the HF Flax names and layouts in
``ravel_pytree`` order (``layer.10`` sorts before ``layer.2``), so the
first 2-D leaf whose path holds ``embed`` is ``position_embeddings``, as
the JAX package's ``_find_embedding_leaf`` finds it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..data.dataset import ArraysDataset
from ..data.user_blob import UserBlob
from .base import BaseTask, Batch, Metric, Params, dropout, parse_dtype
from .embed import embed_gather
from .nlp import _Dense, _Embed

LN_EPS = 1e-12
#: HF ``BertConfig`` defaults the JAX task keeps
HIDDEN_DROPOUT = ATTENTION_DROPOUT = 0.1
INIT_STD = 0.02
EVAL_MASK_SEED = 1234
IGNORE = -100


class _LayerNorm(nn.Module):
    """In float32 ``F.layer_norm``; in a 16-bit ``x`` flax's
    ``nn.LayerNorm(dtype=...)``: the fast variance in float32, the affine
    in float32, the result in the dtype of ``x``."""

    def __init__(self, dim: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(dim))
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.float32:
            return F.layer_norm(x, x.shape[-1:], self.scale, self.bias,
                                LN_EPS)
        dt, x = x.dtype, x.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        return ((x - mean) * (torch.rsqrt(var + LN_EPS) * self.scale)
                + self.bias).to(dt)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """Over the last axis: ``torch.softmax`` in float32; in a 16-bit dtype
    ``jax.nn.softmax``'s steps, each rounded to the dtype."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=-1)
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


class _Embeddings(nn.Module):
    def __init__(self, vocab: int, hidden: int, positions: int):
        super().__init__()
        self.LayerNorm = _LayerNorm(hidden)
        self.position_embeddings = _Embed(positions, hidden)
        self.token_type_embeddings = _Embed(2, hidden)
        self.word_embeddings = _Embed(vocab, hidden)


class _SelfAttention(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.key = _Dense(hidden, hidden)
        self.query = _Dense(hidden, hidden)
        self.value = _Dense(hidden, hidden)


class _Output(nn.Module):
    """``dense -> dropout -> LayerNorm(h + residual)``."""

    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        self.LayerNorm = _LayerNorm(hidden)
        self.dense = _Dense(d_in, hidden)

    def forward(self, h, residual, keep: Optional[torch.Tensor],
                rate: float):
        h = self.dense(h, h.dtype)
        if keep is not None:
            h = dropout(h, keep, rate)
        return self.LayerNorm(h + residual)


class _Attention(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.output = _Output(hidden, hidden)
        self.add_module("self", _SelfAttention(hidden))


class _Intermediate(nn.Module):
    def __init__(self, hidden: int, inter: int):
        super().__init__()
        self.dense = _Dense(hidden, inter)


class _Layer(nn.Module):
    def __init__(self, hidden: int, inter: int):
        super().__init__()
        self.attention = _Attention(hidden)
        self.intermediate = _Intermediate(hidden, inter)
        self.output = _Output(inter, hidden)


class _Encoder(nn.Module):
    def __init__(self, layers: int, hidden: int, inter: int):
        super().__init__()
        self.layer = nn.ModuleList(_Layer(hidden, inter)
                                   for _ in range(layers))


class _Bert(nn.Module):
    def __init__(self, vocab, hidden, layers, inter, positions):
        super().__init__()
        self.embeddings = _Embeddings(vocab, hidden, positions)
        self.encoder = _Encoder(layers, hidden, inter)


class _Transform(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.LayerNorm = _LayerNorm(hidden)
        self.dense = _Dense(hidden, hidden)


class _Predictions(nn.Module):
    def __init__(self, vocab: int, hidden: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(vocab))
        self.transform = _Transform(hidden)


class _Cls(nn.Module):
    def __init__(self, vocab: int, hidden: int):
        super().__init__()
        self.predictions = _Predictions(vocab, hidden)


class BertMLMModule(nn.Module):
    """``(input_ids [B, L], attention_mask [B, L])`` -> MLM logits
    ``[B, L, V]`` in float32, or ``[B, m, V]`` at the ``m`` positions of
    each row that ``gather_idx [B, m]`` names (the gathered head).
    ``masks`` are the dropout keep masks in forward order (the
    embeddings' ``[B, L, H]``, then per layer the attention map's ``[L,
    L]`` and the two ``[B, L, H]`` of its outputs), or ``()`` for no
    dropout.  The attribute names are HF Flax's."""

    def __init__(self, vocab: int = 30522, hidden: int = 768,
                 layers: int = 12, heads: int = 12, inter: int = 3072,
                 positions: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.hidden_dropout = HIDDEN_DROPOUT
        self.attention_dropout = ATTENTION_DROPOUT
        self.bert = _Bert(vocab, hidden, layers, inter, positions)
        self.cls = _Cls(vocab, hidden)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                masks: Tuple[torch.Tensor, ...] = (),
                gather_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        live = iter(masks)

        def keep(rate):
            return next(live) if masks and rate > 0 else None

        dt = self.dtype
        emb = self.bert.embeddings
        L = input_ids.shape[-1]
        word = emb.word_embeddings.embedding.to(dt)
        h = (embed_gather(word, input_ids)
             + emb.token_type_embeddings.embedding[0].to(dt)) \
            + emb.position_embeddings.embedding[:L].to(dt)
        h = emb.LayerNorm(h)
        k = keep(self.hidden_dropout)
        if k is not None:
            h = dropout(h, k, self.hidden_dropout)
        bias = torch.where(attention_mask[:, None, None, :] > 0,
                           torch.zeros((), dtype=dt, device=h.device),
                           torch.full((), torch.finfo(dt).min, dtype=dt,
                                      device=h.device))
        for layer in self.bert.encoder.layer:
            h = self._layer(layer, h, bias, keep)
        if gather_idx is None:
            return self._full_head(h, word)
        h = torch.gather(h, 1, gather_idx[..., None].expand(
            -1, -1, h.shape[-1]))
        return self._gathered_head(h, word)

    def _full_head(self, h, word):
        """HF's ``FlaxBertLMPredictionHead``: the decoder's product and the
        bias in the dtype, then float32."""
        head, dt = self.cls.predictions, self.dtype
        t = head.transform.LayerNorm(F.gelu(head.transform.dense(h, dt)))
        return (t @ word.T + head.bias.to(dt)).to(torch.float32)

    def _gathered_head(self, h, word):
        """The JAX task's ``_mlm_head_logits``: LayerNorm's normalization in
        float32 (``jnp.var``'s two-pass variance), its affine and the
        decoder in the dtype, the bias added to the float32 logits."""
        head, dt = self.cls.predictions, self.dtype
        ln = head.transform.LayerNorm
        t = F.gelu(head.transform.dense(h, dt)).float()
        mean = t.mean(dim=-1, keepdim=True)
        var = ((t - mean) ** 2).mean(dim=-1, keepdim=True)
        t = ((t - mean) * torch.rsqrt(var + LN_EPS)).to(dt) \
            * ln.scale.to(dt) + ln.bias.to(dt)
        return (t @ word.T).to(torch.float32) + head.bias

    def _layer(self, layer: _Layer, h, bias, keep):
        sa = getattr(layer.attention, "self")
        B, L, H = h.shape
        d = H // self.heads
        dt = h.dtype

        def heads(x):
            return x.unflatten(-1, (self.heads, d)).transpose(1, 2)

        q = heads(sa.query(h, dt)) / torch.tensor(math.sqrt(d), dtype=dt)
        w = _softmax(q @ heads(sa.key(h, dt)).transpose(-1, -2) + bias)
        k = keep(self.attention_dropout)
        if k is not None:
            w = w * (k.to(w.dtype) / (1.0 - self.attention_dropout))
        a = (w @ heads(sa.value(h, dt))).transpose(1, 2).flatten(-2)
        a = layer.attention.output(a, h, keep(self.hidden_dropout),
                                   self.hidden_dropout)
        f = F.gelu(layer.intermediate.dense(a, dt))
        return layer.output(f, a, keep(self.hidden_dropout),
                            self.hidden_dropout)


class BertMLMTask(BaseTask):
    name = "mlm_bert"

    def __init__(self, model_config):
        bert = dict((model_config.get("BERT") or {}).get("model") or {})
        train = dict((model_config.get("BERT") or {}).get("training") or {})
        hidden = int(bert.get("hidden_size", 128))
        self.seq_len = int(bert.get("max_seq_length",
                                    model_config.get("max_seq_length", 128)))
        self.vocab_size = int(bert.get("vocab_size", 30522))
        self.mlm_probability = float(bert.get("mlm_probability", 0.15))
        self.label_smoothing = float(train.get("label_smoothing_factor",
                                               0.0))
        self.mask_token_id = int(bert.get("mask_token_id", 103))
        self.premasked = bool(bert.get("premasked", False))
        self.mlm_head = str(bert.get("mlm_head", "full")).lower()
        if self.mlm_head not in ("full", "gathered"):
            raise ValueError("BERT.model.mlm_head must be 'full' or "
                             f"'gathered', got {self.mlm_head!r}")
        # twice the expected masked count, rounded up to a multiple of 8
        default_slots = int(
            -(-(self.seq_len * self.mlm_probability * 2.0) // 8) * 8)
        self.gathered_slots = int(bert.get(
            "gathered_slots", min(max(default_slots, 8), self.seq_len)))
        if not 1 <= self.gathered_slots <= self.seq_len:
            raise ValueError(
                f"BERT.model.gathered_slots must be in [1, {self.seq_len}] "
                f"(seq_len), got {self.gathered_slots} — 0 slots would "
                "silently train on an empty loss")
        self.module = BertMLMModule(
            vocab=self.vocab_size, hidden=hidden,
            layers=int(bert.get("num_hidden_layers", 2)),
            heads=int(bert.get("num_attention_heads", 2)),
            inter=int(bert.get("intermediate_size", 4 * hidden)),
            positions=max(self.seq_len, 512),
            dtype=parse_dtype(bert if "dtype" in bert else model_config))

    # -- parameters ------------------------------------------------------
    def param_spec(self) -> List[Tuple[str, Tuple[int, ...]]]:
        """Leaves in ``ravel_pytree`` order: keys sorted at every level."""
        return sorted(super().param_spec(), key=lambda s: s[0].split("."))

    def init_params(self, seed: int) -> Params:
        """HF's initializers: kernels and embeddings normal with std 0.02,
        biases 0, LayerNorm scales 1; drawn on the CPU so every device
        starts from the same bits."""
        gen = torch.Generator().manual_seed(int(seed))
        out = {}
        for name, shape in self.param_spec():
            t = torch.zeros(shape, dtype=torch.float32)
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                t.fill_(1.0)
            elif leaf in ("kernel", "embedding"):
                t.normal_(0.0, INIT_STD, generator=gen)
            out[name] = t
        return out

    # -- randomness ------------------------------------------------------
    @property
    def dropout_sites(self):
        m = self.module
        H = m.bert.embeddings.LayerNorm.scale.shape[0]
        hid = (m.hidden_dropout, (self.seq_len, H))
        sites = [hid]
        for _ in m.bert.encoder.layer:
            sites += [(m.attention_dropout, None), hid, hid]
        return tuple(sites)

    @property
    def draws_random(self) -> bool:
        return not self.premasked or super().draws_random

    def _mlm_draws(self, gen: torch.Generator, shape, device):
        """The collator's three draws: selection and roll uniforms, and
        the random replacement ids."""
        return (torch.rand(shape, generator=gen, device=device),
                torch.rand(shape, generator=gen, device=device),
                torch.randint(0, self.vocab_size, shape, generator=gen,
                              device=device))

    def draw_masks(self, gens: Sequence[torch.Generator], batch_size: int,
                   device: torch.device) -> Tuple[torch.Tensor, ...]:
        """Per client, in order: the MLM draws (unless ``premasked``), then
        one keep mask per live dropout site; the attention map's mask is
        ``[L, L]``, one for the batch and the heads."""
        L = self.seq_len
        per_client = []
        for g in gens:
            draws = [] if self.premasked else list(
                self._mlm_draws(g, (batch_size, L), device))
            for rate, shape in self.dropout_sites:
                if rate <= 0.0:
                    continue
                full = (L, L) if shape is None else (batch_size,) + shape
                draws.append(torch.rand(full, generator=g, device=device)
                             < (1.0 - rate))
            per_client.append(draws)
        return tuple(torch.stack(site) for site in zip(*per_client))

    # -- the JAX task's logic -------------------------------------------
    def _mlm_mask(self, draws, input_ids, attention_mask):
        """HF DataCollatorForLanguageModeling: select ``mlm_probability`` of
        the real tokens; of those 80 % -> [MASK], 10 % -> a random id,
        10 % unchanged; labels are the original ids there, -100
        elsewhere."""
        u, roll, random_ids = draws
        select = (u < self.mlm_probability) & (attention_mask > 0)
        labels = torch.where(select, input_ids,
                             torch.full_like(input_ids, IGNORE))
        masked = torch.where(select & (roll < 0.8),
                             torch.full_like(input_ids, self.mask_token_id),
                             input_ids)
        masked = torch.where(select & (roll >= 0.8) & (roll < 0.9),
                             random_ids, masked)
        return masked, labels

    def _masked_xent(self, logits, labels):
        """Label-smoothed CE over positions whose label is not -100, in
        logsumexp form: ``lse - logits[y]``, smoothed toward
        ``lse - mean(logits)``."""
        valid = labels != IGNORE
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        lse = torch.logsumexp(logits, dim=-1)
        at = torch.gather(logits, -1, safe[..., None])[..., 0]
        nll = lse - at
        if self.label_smoothing > 0:
            smooth = lse - torch.mean(logits, dim=-1)
            nll = (1 - self.label_smoothing) * nll \
                + self.label_smoothing * smooth
        return nll, valid.to(torch.float32)

    def _attention_mask(self, batch: Batch, input_ids):
        am = batch.get("attention_mask")
        am = (input_ids != 0).long() if am is None else am.long()
        return am * batch["sample_mask"][:, None].long()

    def _inputs(self, batch: Batch, mlm_draws):
        """``(masked ids, attention mask, labels)``: the blob's own in
        ``premasked`` mode, else masked by ``mlm_draws``."""
        input_ids = batch["x"].long()
        attention_mask = self._attention_mask(batch, input_ids)
        if self.premasked:
            labels = torch.where(batch["sample_mask"][:, None] > 0,
                                 batch["y"].long(),
                                 torch.full_like(input_ids, IGNORE))
            return input_ids, attention_mask, labels
        masked, labels = self._mlm_mask(mlm_draws, input_ids,
                                        attention_mask)
        return masked, attention_mask, labels

    def logits(self, params: Params, input_ids, attention_mask,
               masks: Sequence[torch.Tensor] = (),
               gather_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        return functional_call(self.module, params,
                               (input_ids, attention_mask),
                               {"masks": tuple(masks),
                                "gather_idx": gather_idx})

    def gather_masked(self, labels: torch.Tensor):
        """``(idx [B, m], labels [B, m])`` of the gathered head: each row's
        labelled positions first, in order (a stable argsort of the
        unlabelled flag), cut to ``m = gathered_slots``; a slot past the
        row's labels takes -100."""
        sel = labels != IGNORE
        idx = torch.argsort((~sel).to(torch.int8), dim=-1,
                            stable=True)[:, :self.gathered_slots]
        g_labels = torch.where(torch.gather(sel, 1, idx),
                               torch.gather(labels, 1, idx),
                               torch.full_like(idx, IGNORE))
        return idx, g_labels

    def _head_logits(self, params: Params, ids, am, labels,
                     masks: Sequence[torch.Tensor] = ()):
        """``(logits, labels)`` of the configured head."""
        if self.mlm_head == "gathered":
            idx, labels = self.gather_masked(labels)
            return self.logits(params, ids, am, masks, idx), labels
        return self.logits(params, ids, am, masks), labels

    def loss_and_aux(self, params: Params, batch: Batch,
                     masks: Sequence[torch.Tensor] = ()
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        masks = tuple(masks)
        n_mlm = 0 if self.premasked else 3
        if len(masks) < n_mlm:
            raise ValueError("mlm_bert: the dynamic MLM mask needs the "
                             "client's draws (a generator)")
        ids, am, labels = self._inputs(batch, masks[:n_mlm])
        logits, labels = self._head_logits(params, ids, am, labels,
                                           masks[n_mlm:])
        nll, valid = self._masked_xent(logits, labels)
        loss = torch.sum(nll * valid) / torch.clamp(torch.sum(valid),
                                                    min=1.0)
        # the reference trainer counts MLM samples as attention positions
        return loss, {"train_sample_count": torch.sum(am.to(torch.float32))}

    def loss_masked(self, params: Params, batch: Batch,
                    masks: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        return self.loss_and_aux(params, batch, masks)[0]

    def eval_stats(self, params: Params, batch: Batch
                   ) -> Dict[str, torch.Tensor]:
        draws = None
        if not self.premasked:
            gen = torch.Generator(device=batch["x"].device).manual_seed(
                EVAL_MASK_SEED)
            draws = self._mlm_draws(gen, tuple(batch["x"].shape),
                                    batch["x"].device)
        ids, am, labels = self._inputs(batch, draws)
        logits, labels = self._head_logits(params, ids, am, labels)
        nll, valid = self._masked_xent(logits, labels)
        pred = torch.argmax(logits, dim=-1)
        correct = (pred == torch.where(labels == IGNORE,
                                       torch.full_like(labels, -1),
                                       labels)).to(torch.float32)
        stats = {"loss_sum": torch.sum(nll * valid),
                 "correct_sum": torch.sum(correct * valid),
                 "sample_count": torch.sum(valid),
                 "seq_count": torch.sum(batch["sample_mask"])}
        if self.premasked:
            # the reference divides correct predictions by every position
            stats["pos_count"] = (torch.sum(batch["sample_mask"])
                                  * batch["x"].shape[-1])
        return stats

    def finalize_metrics(self, sums: Dict[str, float]) -> Dict[str, Metric]:
        metrics = super().finalize_metrics(sums)
        if "pos_count" in sums and float(sums["pos_count"]) > 0:
            metrics["acc"] = Metric(float(sums["correct_sum"])
                                    / float(sums["pos_count"]))
        return metrics

    def make_dataset(self, blob: UserBlob, data_config=None,
                     split: str = "train") -> ArraysDataset:
        """Token rows: ``x`` ids 0-padded (or cut) to ``max_seq_length``;
        with labels (``premasked`` blobs), ``y`` -100-padded alike."""
        L = self.seq_len

        def rows(samples, fill):
            out = np.full((len(samples), L), fill, np.int32)
            for j, r in enumerate(samples):
                r = np.asarray(r, np.int64).reshape(-1)[:L]
                out[j, :len(r)] = r
            return out

        per_user = []
        for i in range(len(blob)):
            user = {"x": rows(blob.user_data[i], 0)}
            if blob.user_labels is not None and \
                    blob.user_labels[i] is not None:
                user["y"] = rows(blob.user_labels[i], IGNORE)
            per_user.append(user)
        return ArraysDataset(blob.user_list, per_user,
                             [len(u["x"]) for u in per_user])


def make_bert_task(model_config) -> BertMLMTask:
    return BertMLMTask(model_config)
