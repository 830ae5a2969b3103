"""FedNewsRec's NRMS news recommender — the port's counterpart of
``msrflute_tpu/models/fednewsrec.py`` with ``arch: nrms``, the shipped
default (``experiments/fednewsrec``; P = 13,320,802 in 17 leaves at the
published widths, the word table ``[40,000, 300]``).

- News encoder: word embedding -> flax ``SelfAttention`` (20 heads of 20,
  no biases, the query scaled by ``1 / sqrt(head_dim)``, an output
  projection) -> attentive pooling (``tanh(Dense 200) -> Dense 1 ->
  softmax`` over the title's words).  Clicked and candidate titles share
  it and run in one pass.
- User encoder: the same attention and pooling over the clicked-news
  vectors.
- Score: the dot product of each candidate's vector with the user's.

Training is ``npratio``-negative softmax training (one positive among
``npratio`` sampled negatives); eval ranks each impression's padded slate
and sums AUC, MRR and nDCG@5 / @10 per impression (``eval_stats``).
``make_dataset`` is the JAX package's MIND featurizer, draw for draw from
its ``np.random.default_rng``, so both packages pack the same slates.

Parameters keep flax's names and layouts (``SelfAttention_0.query.kernel``
``[in, heads, head_dim]``, ``out.kernel`` ``[heads, head_dim, out]``, Dense
kernels ``[in, out]``) in ``ravel_pytree`` order.  The word lookup is
:func:`.embed.embed_gather` (a deterministic backward on the card).

``arch: fednewsrec`` (:class:`FedNewsRecRefTask`) is the reference's own
net (``msrflute_tpu/models/fednewsrec.py:101-270``): a frozen word table
(``np.random.default_rng(0).normal(scale=0.1)`` of ``[vocab, embed_dim]``
in float32, or the config's ``embedding_matrix``) looked up outside the
module and never trained; a document encoder of a valid width-3
convolution (``conv``, ``embed_dim -> conv_filters``), relu, the
projection-less multi-head attention (``WQ``, ``WK``, ``WV``), relu and
attentive pooling, with dropout 0.2 on its input, after each relu and on
the pooling's input (the pooled sum runs over the dropped vectors, the
reference's quirk); a user encoder whose attention path (attention,
dropout, pooling) sits beside a flax ``GRUCell`` run over the last
``gru_tail`` clicks from a zero carry, the two vectors stacked and pooled
once more.  Dropout streams are the port's own (drawn per client, as
everywhere), so a trained run matches the JAX package in law; with no
dropout it matches pass for pass.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from ..data.dataset import ArraysDataset
from ..data.user_blob import UserBlob
from ..utils.logging import print_rank
from .base import BaseTask, Batch, Metric, Params, dropout, lecun_normal_
from .embed import embed_gather
from .nlp import _Dense, _Embed

#: the attentive pooling's hidden width (the reference's 200)
POOL_HIDDEN = 200


class _Kernel(nn.Module):
    def __init__(self, *shape: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(*shape))


class _SelfAttention(nn.Module):
    """flax ``nn.SelfAttention(use_bias=False)`` with ``heads x head_dim``
    features and an output projection to ``heads * head_dim``."""

    def __init__(self, d_in: int, heads: int, head_dim: int):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        self.key = _Kernel(d_in, heads, head_dim)
        self.out = _Kernel(heads, head_dim, heads * head_dim)
        self.query = _Kernel(d_in, heads, head_dim)
        self.value = _Kernel(d_in, heads, head_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [N, T, d_in]
        hd = self.heads * self.head_dim

        def proj(m):
            y = x @ m.kernel.reshape(x.shape[-1], hd)
            return y.unflatten(-1, (self.heads, self.head_dim)).transpose(
                -3, -2)                                   # [N, h, T, d]

        q = proj(self.query) / math.sqrt(self.head_dim)
        w = torch.softmax(q @ proj(self.key).transpose(-1, -2), dim=-1)
        o = (w @ proj(self.value)).transpose(-3, -2).flatten(-2)
        return o @ self.out.kernel.reshape(hd, hd)


class _AttentivePooling(nn.Module):
    def __init__(self, d_in: int):
        super().__init__()
        self.Dense_0 = _Dense(d_in, POOL_HIDDEN)
        self.Dense_1 = _Dense(POOL_HIDDEN, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [..., T, D]
        att = self.Dense_1(torch.tanh(self.Dense_0(x)))[..., 0]
        att = torch.softmax(att, dim=-1)
        return (x * att[..., None]).sum(-2)


class _NewsEncoder(nn.Module):
    def __init__(self, vocab_size: int, embed_dim: int, heads: int,
                 head_dim: int):
        super().__init__()
        self.Embed_0 = _Embed(vocab_size, embed_dim)
        self.SelfAttention_0 = _SelfAttention(embed_dim, heads, head_dim)
        self._AttentivePooling_0 = _AttentivePooling(heads * head_dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:  # [..., L]
        emb = embed_gather(self.Embed_0.embedding, tokens)
        lead = emb.shape[:-2]
        h = self.SelfAttention_0(emb.reshape(-1, *emb.shape[-2:]))
        return self._AttentivePooling_0(h).reshape(*lead, -1)


class _UserEncoder(nn.Module):
    def __init__(self, d_in: int, heads: int, head_dim: int):
        super().__init__()
        self.SelfAttention_0 = _SelfAttention(d_in, heads, head_dim)
        self._AttentivePooling_0 = _AttentivePooling(heads * head_dim)

    def forward(self, news_vecs: torch.Tensor) -> torch.Tensor:
        return self._AttentivePooling_0(self.SelfAttention_0(news_vecs))


class NRMSModule(nn.Module):
    """``(clicked [B, H, L], cands [B, C, L])`` -> scores ``[B, C]``; the
    attribute names are flax's module names."""

    def __init__(self, vocab_size: int, embed_dim: int = 300,
                 heads: int = 20, head_dim: int = 20):
        super().__init__()
        self._NewsEncoder_0 = _NewsEncoder(vocab_size, embed_dim, heads,
                                           head_dim)
        self._UserEncoder_0 = _UserEncoder(heads * head_dim, heads,
                                           head_dim)

    def forward(self, clicked: torch.Tensor, cands: torch.Tensor,
                masks: Tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
        H = clicked.shape[1]
        vecs = self._NewsEncoder_0(torch.cat([clicked, cands], dim=1))
        user = self._UserEncoder_0(vecs[:, :H])
        return (vecs[:, H:] * user[:, None, :]).sum(-1)


class NRMSTask(BaseTask):
    name = "fednewsrec"

    def __init__(self, model_config):
        self.vocab_size = int(model_config.get("vocab_size", 40000))
        self.seq_len = int(model_config.get("max_title_length", 30))
        self.history = int(model_config.get("max_history", 50))
        self.npratio = int(model_config.get("npratio", 4))
        self.max_candidates = int(model_config.get("max_candidates", 20))
        self.module = self.build_module(model_config)

    def build_module(self, model_config) -> nn.Module:
        return NRMSModule(
            self.vocab_size, int(model_config.get("embed_dim", 300)),
            int(model_config.get("num_heads", 20)),
            int(model_config.get("head_dim", 20)))

    def param_spec(self) -> List[Tuple[str, Tuple[int, ...]]]:
        """Leaves in ``ravel_pytree`` order: keys sorted at every level."""
        return sorted(super().param_spec(), key=lambda s: s[0].split("."))

    def init_params(self, seed: int) -> Params:
        """flax's initializers: the embedding normal with variance
        ``1 / embed_dim``, kernels lecun-normal over their input axes,
        biases 0; drawn on the CPU so every device starts from the same
        bits."""
        gen = torch.Generator().manual_seed(int(seed))
        out = {}
        for name, shape in self.param_spec():
            t = torch.zeros(shape, dtype=torch.float32)
            path = name.split(".")
            if path[-1] == "embedding":
                t.normal_(0.0, math.sqrt(1.0 / shape[1]), generator=gen)
            elif path[-1] == "kernel":
                fan_in = (shape[0] * shape[1] if path[-2] == "out"
                          else shape[0])
                lecun_normal_(t, fan_in, gen)
            out[name] = t
        return out

    def _scores(self, params: Params, batch: Batch) -> torch.Tensor:
        return functional_call(self.module, params,
                               (batch["clicked"].long(),
                                batch["cands"].long()))

    def loss_masked(self, params: Params, batch: Batch,
                    masks: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        logp = F.log_softmax(self._scores(params, batch), dim=-1)
        nll = -torch.gather(logp, -1, batch["y"].long()[:, None])[:, 0]
        mask = batch["sample_mask"]
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)

    def eval_stats(self, params: Params, batch: Batch
                   ) -> Dict[str, torch.Tensor]:
        """Per-impression AUC, MRR and nDCG@5 / @10 over the real
        candidates, as the JAX task computes them (ranks by a stable
        descending sort), summed over the impressions with a positive and
        a negative; the slate's loss over its positives."""
        scores = self._scores(params, batch)
        labels = batch.get("labels")
        if labels is None:
            labels = F.one_hot(batch["y"].long(), scores.shape[-1])
        labels = labels.to(torch.float32)
        cm = batch.get("cand_mask")
        cm = (torch.ones_like(labels) if cm is None
              else cm.to(torch.float32))
        mask = batch["sample_mask"]
        s = torch.where(cm > 0, scores,
                        torch.full_like(scores,
                                        torch.finfo(scores.dtype).min))
        C = s.shape[-1]
        order = torch.argsort(-s, dim=-1, stable=True)
        steps = torch.arange(1, C + 1, device=s.device).expand_as(order)
        ranks = torch.empty_like(order).scatter_(-1, order, steps).to(
            torch.float32)
        pos = labels * cm
        negm = (1 - labels) * cm
        n_pos, n_neg = pos.sum(-1), negm.sum(-1)
        pairs = torch.sum(pos[:, :, None] * negm[:, None, :]
                          * (s[:, :, None] > s[:, None, :]), dim=(1, 2))
        auc = pairs / torch.clamp(n_pos * n_neg, min=1.0)
        mrr = torch.sum(pos / ranks, -1) / torch.clamp(n_pos, min=1.0)
        ideal_ranks = torch.arange(1, C + 1, device=s.device,
                                   dtype=torch.float32)

        def ndcg(k):
            gains = pos / torch.log2(ranks + 1.0) * (ranks <= k)
            ideal = torch.sum(
                (ideal_ranks <= torch.clamp(n_pos, max=k)[:, None])
                / torch.log2(ideal_ranks + 1.0), -1)
            return torch.sum(gains, -1) / torch.clamp(ideal, min=1e-12)

        has_pos = n_pos > 0
        zero = torch.zeros_like(auc)
        valid = (has_pos & (n_neg > 0)).to(torch.float32) * mask
        logp = F.log_softmax(s, dim=-1)
        nll = -torch.sum(labels * cm * logp, -1) / torch.clamp(
            torch.sum(labels * cm, -1), min=1.0)
        return {
            "loss_sum": torch.sum(nll * mask),
            "auc_sum": torch.sum(auc * valid),
            "mrr_sum": torch.sum(torch.where(has_pos, mrr, zero) * valid),
            "ndcg5_sum": torch.sum(torch.where(has_pos, ndcg(5), zero)
                                   * valid),
            "ndcg10_sum": torch.sum(torch.where(has_pos, ndcg(10), zero)
                                    * valid),
            "sample_count": torch.sum(valid),
        }

    def finalize_metrics(self, sums: Dict[str, float]) -> Dict[str, Metric]:
        n = max(float(sums["sample_count"]), 1.0)
        return {
            "loss": Metric(float(sums["loss_sum"]) / n,
                           higher_is_better=False),
            "auc": Metric(float(sums["auc_sum"]) / n),
            "mrr": Metric(float(sums["mrr_sum"]) / n),
            "ndcg@5": Metric(float(sums["ndcg5_sum"]) / n),
            "ndcg@10": Metric(float(sums["ndcg10_sum"]) / n),
        }

    # -- MIND-style featurizer (msrflute_tpu/models/fednewsrec.py:369-463)
    def _pad_title(self, title) -> np.ndarray:
        ids = np.zeros((self.seq_len,), np.int32)
        toks = np.asarray(title, np.int64).reshape(-1)[:self.seq_len]
        ids[:len(toks)] = np.clip(toks, 0, self.vocab_size - 1)
        return ids

    def _pad_history(self, clicked) -> np.ndarray:
        """The most recent ``max_history`` clicks, front-padded so the
        newest sits in the last row."""
        hist = np.zeros((self.history, self.seq_len), np.int32)
        titles = list(clicked)[-self.history:]
        for j, title in enumerate(titles):
            hist[self.history - len(titles) + j] = self._pad_title(title)
        return hist

    def make_dataset(self, blob: UserBlob, data_config=None,
                     split: str = "train") -> ArraysDataset:
        """Per user ``{"clicked": [[tok, ...], ...], "impressions":
        [{"cands": [[tok, ...], ...], "labels": [0/1, ...]}, ...]}``.
        Train: one slate a positive, ``npratio`` negatives drawn from the
        impression (with replacement when it has fewer) and the positive
        at a random slot, both from one ``default_rng(seed)``.  Eval: the
        impression padded to ``max_candidates``, negatives cut (positives
        kept) when longer."""
        dc = data_config or {}
        max_cands = int(dc.get("max_candidates", self.max_candidates))
        rng = np.random.default_rng(int(dc.get("seed", 0)))
        users, per_user, counts = [], [], []
        truncated = 0
        for i in range(len(blob)):
            entry = blob.user_data[i]
            if not isinstance(entry, dict) or "impressions" not in entry:
                raise ValueError(
                    "fednewsrec expects MIND-style user dicts with "
                    "'clicked' and 'impressions'")
            hist = self._pad_history(entry.get("clicked", []))
            clicked_rows, cand_rows, y_rows = [], [], []
            label_rows, mask_rows = [], []
            for imp in entry["impressions"]:
                titles = [self._pad_title(t) for t in imp["cands"]]
                labels = np.asarray(imp["labels"], np.int32).reshape(-1)
                if split == "train":
                    pos = np.flatnonzero(labels > 0)
                    neg = np.flatnonzero(labels == 0)
                    for p in pos:
                        if neg.size:
                            take = rng.choice(
                                neg, self.npratio,
                                replace=neg.size < self.npratio)
                            slate = [titles[j] for j in take]
                        else:
                            slate = [np.zeros_like(titles[0])] * self.npratio
                        slot = int(rng.integers(self.npratio + 1))
                        slate.insert(slot, titles[p])
                        clicked_rows.append(hist)
                        cand_rows.append(np.stack(slate))
                        y_rows.append(slot)
                else:
                    keep = np.arange(len(titles))
                    if len(titles) > max_cands:
                        pos_i = np.flatnonzero(labels > 0)[:max_cands]
                        neg_i = np.flatnonzero(labels == 0)
                        neg_i = neg_i[:max_cands - len(pos_i)]
                        keep = np.sort(np.concatenate([pos_i, neg_i]))
                        truncated += 1
                    cands = np.zeros((max_cands, self.seq_len), np.int32)
                    lab = np.zeros((max_cands,), np.float32)
                    msk = np.zeros((max_cands,), np.float32)
                    c = len(keep)
                    cands[:c] = np.stack([titles[j] for j in keep])
                    lab[:c] = labels[keep]
                    msk[:c] = 1.0
                    clicked_rows.append(hist)
                    cand_rows.append(cands)
                    label_rows.append(lab)
                    mask_rows.append(msk)
            if not clicked_rows:
                continue
            user = {"clicked": np.stack(clicked_rows),
                    "cands": np.stack(cand_rows)}
            if split == "train":
                user["y"] = np.asarray(y_rows, np.int32)
            else:
                user["labels"] = np.stack(label_rows)
                user["cand_mask"] = np.stack(mask_rows)
            users.append(blob.user_list[i])
            per_user.append(user)
            counts.append(len(clicked_rows))
        if truncated:
            print_rank(f"fednewsrec {split}: {truncated} impressions longer "
                       f"than max_candidates={max_cands}; negatives "
                       "subsampled (positives kept)")
        return ArraysDataset(users, per_user, counts)


# ----------------------------------------------------------------------
# arch: fednewsrec, the reference's net on a frozen word table
# ----------------------------------------------------------------------
#: the reference net's dropout rate (every site)
REF_DROPOUT = 0.2


class _RefAttention(nn.Module):
    """The reference's projection-less multi-head self-attention: per-head
    ``WQ``, ``WK``, ``WV`` (no bias), heads concatenated, no output
    projection."""

    def __init__(self, d_in: int, heads: int, head_dim: int):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        od = heads * head_dim
        self.WK = _Dense(d_in, od, use_bias=False)
        self.WQ = _Dense(d_in, od, use_bias=False)
        self.WV = _Dense(d_in, od, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [N, T, d_in]
        def split(m):
            return m(x).unflatten(-1, (self.heads, self.head_dim)) \
                .transpose(-3, -2)                       # [N, h, T, d]

        q, k, v = split(self.WQ), split(self.WK), split(self.WV)
        a = torch.softmax((q @ k.transpose(-1, -2))
                          / math.sqrt(self.head_dim), dim=-1)
        return (a @ v).transpose(-3, -2).flatten(-2)


def _drop(x: torch.Tensor, keep) -> torch.Tensor:
    return x if keep is None else dropout(x, keep, REF_DROPOUT)


class _RefPooling(_AttentivePooling):
    """Attentive pooling with the reference's input dropout: the weights
    and the weighted sum both read the dropped vectors."""

    def forward(self, x: torch.Tensor, keep=None) -> torch.Tensor:
        return super().forward(_drop(x, keep))


class _Conv1d(nn.Module):
    """flax ``nn.Conv(features, (k,), padding="VALID")`` over ``[N, T,
    in]``: ``kernel [k, in, out]`` and ``bias``; the sum over the window
    is ``k`` products of the sliding slices."""

    def __init__(self, d_in: int, d_out: int, width: int = 3):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(d_out))
        self.kernel = nn.Parameter(torch.zeros(width, d_in, d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel.shape[0]
        T = x.shape[-2] - k + 1
        out = x[..., 0:T, :] @ self.kernel[0]
        for i in range(1, k):
            out = out + x[..., i:i + T, :] @ self.kernel[i]
        return out + self.bias


class _RefDocEncoder(nn.Module):
    def __init__(self, embed_dim: int, heads: int, head_dim: int,
                 conv_filters: int):
        super().__init__()
        self._AttentivePooling_0 = _RefPooling(heads * head_dim)
        self._RefAttention_0 = _RefAttention(conv_filters, heads, head_dim)
        self.conv = _Conv1d(embed_dim, conv_filters)

    def forward(self, wv: torch.Tensor, keeps) -> torch.Tensor:
        k1, k2, k3, k4 = keeps
        h = F.relu(self.conv(_drop(wv, k1)))
        h = F.relu(self._RefAttention_0(_drop(h, k2)))
        return self._AttentivePooling_0(_drop(h, k3), k4)


class _GRUCell(nn.Module):
    """flax ``nn.GRUCell``: ``r = sigmoid(ir x + hr h)``, ``z = sigmoid(iz x
    + hz h)``, ``n = tanh(in x + r * hn h)``, ``h' = (1 - z) n + z h``; the
    input kernels and ``hn`` carry the biases."""

    def __init__(self, dim: int):
        super().__init__()
        for name in ("hn", "hr", "hz"):
            self.add_module(name, _Dense(dim, dim, use_bias=name == "hn"))
        for name in ("in", "ir", "iz"):
            self.add_module(name, _Dense(dim, dim))

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        """``xs [B, T, D]`` from a zero carry -> the last state ``[B, D]``."""
        g = dict(self.named_children())
        h = torch.zeros_like(xs[:, 0])
        for t in range(xs.shape[1]):
            x = xs[:, t]
            r = torch.sigmoid(g["ir"](x) + g["hr"](h))
            z = torch.sigmoid(g["iz"](x) + g["hz"](h))
            n = torch.tanh(g["in"](x) + r * g["hn"](h))
            h = (1.0 - z) * n + z * h
        return h


class _RefUserEncoder(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, gru_tail: int):
        super().__init__()
        self.gru_tail = gru_tail
        self.GRUCell_0 = _GRUCell(dim)
        self._AttentivePooling_0 = _RefPooling(heads * head_dim)
        self._AttentivePooling_1 = _RefPooling(heads * head_dim)
        self._RefAttention_0 = _RefAttention(dim, heads, head_dim)

    def forward(self, news_vecs: torch.Tensor, keeps) -> torch.Tensor:
        k5, k6, k7 = keeps
        u2 = _drop(self._RefAttention_0(news_vecs), k5)
        u2 = self._AttentivePooling_0(u2, k6)
        # the GRU reads the raw tail (the reference leaves its dropout out)
        u1 = self.GRUCell_0(news_vecs[:, -self.gru_tail:])
        return self._AttentivePooling_1(torch.stack([u1, u2], dim=1), k7)


class FedNewsRecRefModule(nn.Module):
    """``(clicked_wv [B, H, L, E], cand_wv [B, C, L, E])`` word vectors ->
    scores ``[B, C]``.  Clicked and candidate titles run through the
    document encoder in one pass.  ``masks`` are the seven keep masks of
    :attr:`FedNewsRecRefTask.dropout_sites`, or ``()``."""

    def __init__(self, embed_dim: int, heads: int = 20, head_dim: int = 20,
                 gru_tail: int = 20, conv_filters: int = 400):
        super().__init__()
        self._RefDocEncoder_0 = _RefDocEncoder(embed_dim, heads, head_dim,
                                               conv_filters)
        self._RefUserEncoder_0 = _RefUserEncoder(heads * head_dim, heads,
                                                 head_dim, gru_tail)

    def forward(self, clicked: torch.Tensor, cands: torch.Tensor,
                masks: Tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
        B, H, L, E = clicked.shape
        docs = torch.cat([clicked, cands], dim=1)
        N = docs.shape[1]
        keeps = ([m.flatten(0, 1) for m in masks[:4]] if masks
                 else [None] * 4)
        vecs = self._RefDocEncoder_0(docs.reshape(B * N, L, E),
                                     keeps).reshape(B, N, -1)
        user = self._RefUserEncoder_0(vecs[:, :H],
                                      masks[4:] if masks else [None] * 3)
        return (vecs[:, H:] * user[:, None, :]).sum(-1)


def frozen_word_table(model_config) -> np.ndarray:
    """The reference net's frozen ``[vocab, embed_dim]`` float32 table: the
    config's ``embedding_matrix``, else the JAX package's fixed-seed
    stand-in for GloVe, ``default_rng(0).normal(scale=0.1)``."""
    emb = model_config.get("embedding_matrix")
    if emb is None:
        emb = np.random.default_rng(0).normal(
            scale=0.1, size=(int(model_config.get("vocab_size", 40000)),
                             int(model_config.get("embed_dim", 300))))
    return np.asarray(emb, np.float32)


class FedNewsRecRefTask(NRMSTask):
    """``arch: fednewsrec``: :class:`FedNewsRecRefModule` over the frozen
    table, which is no parameter: it stays out of the ``[K, P]`` vector and
    is copied once to each device it is used on.  The featurizer, the
    ranking metrics and the npratio loss are :class:`NRMSTask`'s."""

    def build_module(self, model_config) -> nn.Module:
        self.table = torch.from_numpy(frozen_word_table(model_config))
        self._tables: Dict[torch.device, torch.Tensor] = {}
        heads = int(model_config.get("num_heads", 20))
        head_dim = int(model_config.get("head_dim", 20))
        conv = int(model_config.get("conv_filters", 400))
        docs = self.history + self.npratio + 1
        L, od, E = self.seq_len, heads * head_dim, self.table.shape[1]
        self.dropout_sites = (
            (REF_DROPOUT, (docs, L, E)),
            (REF_DROPOUT, (docs, L - 2, conv)),
            (REF_DROPOUT, (docs, L - 2, od)),
            (REF_DROPOUT, (docs, L - 2, od)),
            (REF_DROPOUT, (self.history, od)),
            (REF_DROPOUT, (self.history, od)),
            (REF_DROPOUT, (2, od)))
        return FedNewsRecRefModule(E, heads, head_dim,
                                   int(model_config.get("gru_tail", 20)),
                                   conv)

    def init_params(self, seed: int) -> Params:
        """flax's initializers: Dense kernels and the GRU's input kernels
        lecun-normal over their input axis, the convolution's over its
        window times its input, the GRU's recurrent kernels orthogonal,
        biases 0; drawn on the CPU so every device starts from the same
        bits."""
        gen = torch.Generator().manual_seed(int(seed))
        out = {}
        for name, shape in self.param_spec():
            t = torch.zeros(shape, dtype=torch.float32)
            path = name.split(".")
            if path[-1] == "kernel" and path[-2] in ("hn", "hr", "hz"):
                nn.init.orthogonal_(t, generator=gen)
            elif path[-1] == "kernel":
                lecun_normal_(t, int(np.prod(shape[:-1])), gen)
            out[name] = t
        return out

    def word_table(self, device: torch.device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = self.table.to(device)
        return self._tables[device]

    def _scores(self, params: Params, batch: Batch,
                masks: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        table = self.word_table(batch["clicked"].device)
        return functional_call(self.module, params,
                               (table[batch["clicked"].long()],
                                table[batch["cands"].long()]),
                               {"masks": tuple(masks)})

    def loss_masked(self, params: Params, batch: Batch,
                    masks: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        logp = F.log_softmax(self._scores(params, batch, masks), dim=-1)
        nll = -torch.gather(logp, -1, batch["y"].long()[:, None])[:, 0]
        mask = batch["sample_mask"]
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def make_nrms_task(model_config) -> NRMSTask:
    """``arch: nrms`` (the default) or ``fednewsrec``."""
    arch = str(model_config.get("arch", "nrms"))
    if arch == "fednewsrec":
        return FedNewsRecRefTask(model_config)
    if arch != "nrms":
        raise ValueError("model_config.arch must be 'nrms' or 'fednewsrec', "
                         f"got {arch!r}")
    return NRMSTask(model_config)
