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
from .base import BaseTask, Batch, Metric, Params, dropout
from .embed import embed_gather
from .nlp import _Dense, _Embed

LN_EPS = 1e-12
#: HF ``BertConfig`` defaults the JAX task keeps
HIDDEN_DROPOUT = ATTENTION_DROPOUT = 0.1
INIT_STD = 0.02
EVAL_MASK_SEED = 1234
IGNORE = -100


class _LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(dim))
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.scale, self.bias, LN_EPS)


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
        h = self.dense(h)
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
    ``[B, L, V]``.  ``masks`` are the dropout keep masks in forward order
    (the embeddings' ``[B, L, H]``, then per layer the attention map's
    ``[L, L]`` and the two ``[B, L, H]`` of its outputs), or ``()`` for no
    dropout.  The attribute names are HF Flax's."""

    def __init__(self, vocab: int = 30522, hidden: int = 768,
                 layers: int = 12, heads: int = 12, inter: int = 3072,
                 positions: int = 512):
        super().__init__()
        self.heads = heads
        self.hidden_dropout = HIDDEN_DROPOUT
        self.attention_dropout = ATTENTION_DROPOUT
        self.bert = _Bert(vocab, hidden, layers, inter, positions)
        self.cls = _Cls(vocab, hidden)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                masks: Tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
        live = iter(masks)

        def keep(rate):
            return next(live) if masks and rate > 0 else None

        emb = self.bert.embeddings
        L = input_ids.shape[-1]
        word = emb.word_embeddings.embedding
        h = (embed_gather(word, input_ids)
             + emb.token_type_embeddings.embedding[0]) \
            + emb.position_embeddings.embedding[:L]
        h = emb.LayerNorm(h)
        k = keep(self.hidden_dropout)
        if k is not None:
            h = dropout(h, k, self.hidden_dropout)
        bias = torch.where(attention_mask[:, None, None, :] > 0,
                           torch.zeros((), device=h.device),
                           torch.full((), torch.finfo(h.dtype).min,
                                      device=h.device))
        for layer in self.bert.encoder.layer:
            h = self._layer(layer, h, bias, keep)
        head = self.cls.predictions
        t = F.gelu(head.transform.dense(h))
        t = head.transform.LayerNorm(t)
        return t @ word.T + head.bias

    def _layer(self, layer: _Layer, h, bias, keep):
        sa = getattr(layer.attention, "self")
        B, L, H = h.shape
        d = H // self.heads

        def heads(x):
            return x.unflatten(-1, (self.heads, d)).transpose(1, 2)

        q = heads(sa.query(h)) / math.sqrt(d)
        w = torch.softmax(q @ heads(sa.key(h)).transpose(-1, -2) + bias,
                          dim=-1)
        k = keep(self.attention_dropout)
        if k is not None:
            w = w * (k.to(w.dtype) / (1.0 - self.attention_dropout))
        a = (w @ heads(sa.value(h))).transpose(1, 2).flatten(-2)
        a = layer.attention.output(a, h, keep(self.hidden_dropout),
                                   self.hidden_dropout)
        f = F.gelu(layer.intermediate.dense(a))
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
        self.module = BertMLMModule(
            vocab=self.vocab_size, hidden=hidden,
            layers=int(bert.get("num_hidden_layers", 2)),
            heads=int(bert.get("num_attention_heads", 2)),
            inter=int(bert.get("intermediate_size", 4 * hidden)),
            positions=max(self.seq_len, 512))

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
               masks: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        return functional_call(self.module, params,
                               (input_ids, attention_mask),
                               {"masks": tuple(masks)})

    def loss_and_aux(self, params: Params, batch: Batch,
                     masks: Sequence[torch.Tensor] = ()
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        masks = tuple(masks)
        n_mlm = 0 if self.premasked else 3
        if len(masks) < n_mlm:
            raise ValueError("mlm_bert: the dynamic MLM mask needs the "
                             "client's draws (a generator)")
        ids, am, labels = self._inputs(batch, masks[:n_mlm])
        logits = self.logits(params, ids, am, masks[n_mlm:])
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
        logits = self.logits(params, ids, am)
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
