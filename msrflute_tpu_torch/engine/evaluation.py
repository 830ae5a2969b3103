"""Evaluation in sum form — the port's counterpart of
``msrflute_tpu/engine/evaluation.py::build_eval_fn``/``evaluate``, and the
personalization server's per-user interpolated eval
(:func:`personalized_eval_sums`).

All eval samples are packed into one ``[T, B, ...]`` grid
(:func:`..data.batching.pack_eval_batches`); each step's task stats are
summed on the device and fetched once, then finalized host-side — the
reference's sample-weighted metric merge.  A step whose stats are not all
finite is excluded whole (its ``sample_count`` too), as in the JAX
package; if every step is excluded the metrics are NaN.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import cpu16_guard
from ..models.base import BaseTask, Metric, ParamLayout, Params, softmax_xent
from ..telemetry import NULL_SPAN


def stage_eval_batches(batches, device: torch.device) -> Dict[str, torch.Tensor]:
    """Eval data is static across rounds: move it to the device once."""
    return {k: torch.from_numpy(v).to(device) for k, v in batches.items()
            if k != "user_idx"}


@torch.no_grad()
def evaluate(task: BaseTask, params: Params,
             batches: Dict[str, torch.Tensor],
             events: Optional[Callable[..., None]] = None,
             span: Optional[Callable[..., Any]] = None
             ) -> Dict[str, Metric]:
    """The split's metrics over its staged batch steps.  A step with a
    non-finite stat is left out of the sums and counted; ``events``
    receives an ``eval_nonfinite_skipped`` record with that count
    (``evaluation.py:172-185``).  ``span`` (the telemetry scope's) times
    the device steps and the sums' readback as ``eval_device``."""
    with (span("eval_device") if span is not None else NULL_SPAN):
        flat, sums = _eval_sums(task, params, batches)
    host, at = {}, 0
    for name, v in sums.items():
        host[name] = flat[at] if v.ndim == 0 else flat[at:at + v.numel()]
        at += v.numel()
    if flat[-1] and events is not None:
        events("eval_nonfinite_skipped", steps=int(flat[-1]))
    metrics = task.finalize_metrics(host)
    if host["sample_count"] <= 0.0:
        metrics = {name: Metric(float("nan"), m.higher_is_better)
                   for name, m in metrics.items()}
    return metrics


def _eval_sums(task: BaseTask, params: Params,
               batches: Dict[str, torch.Tensor]):
    """The steps' summed stats read back in one transfer: ``(flat host
    values, the last one the skipped steps; the device sums)``."""
    T = batches["sample_mask"].shape[0]
    sums = None
    skipped = None
    for t in range(T):
        with cpu16_guard(batches["sample_mask"].device, task.compute_dtype):
            step = task.eval_stats(params,
                                   {k: v[t] for k, v in batches.items()})
        finite = torch.stack([torch.isfinite(v).all()
                              for v in step.values()]).all()
        step = {k: torch.where(finite, v, torch.zeros_like(v))
                for k, v in step.items()}
        sums = step if sums is None else {k: sums[k] + step[k] for k in sums}
        bad = (~finite).to(torch.float32)
        skipped = bad if skipped is None else skipped + bad
    # one device->host transfer; a per-class stat (CIFAR_CNN's tp, fp, fn)
    # comes back as a list
    flat = torch.cat([v.reshape(-1).to(torch.float32)
                      for v in sums.values()]
                     + [skipped.reshape(1)]).cpu().tolist()
    return flat, sums


@torch.no_grad()
def personalized_eval_sums(task: BaseTask, layout: ParamLayout,
                           global_flat: torch.Tensor,
                           local_flat: torch.Tensor, alpha: torch.Tensor,
                           arrays: Dict[str, torch.Tensor],
                           sample_mask: torch.Tensor, logspace: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """``(correct, samples, loss)`` sums over K users, each with its local
    model (a row of ``local_flat`` ``[K, P]``) and its ``alpha``: the
    prediction is the argmax of ``alpha * squash(local) + (1 - alpha) *
    squash(global)`` (``squash`` the log-softmax under ``logspace``, else
    the softmax), and a user's loss the mean of the two models' masked
    mean cross entropies, weighted by its sample count (the JAX package's
    ``personalization.py:326-371``; ``arrays`` ``[K, S, B, ...]``)."""
    x = arrays["x"].flatten(1, 2)
    y = arrays["y"].flatten(1, 2).long()
    mask = sample_mask.flatten(1, 2)
    K = x.shape[0]
    with cpu16_guard(x.device, task.compute_dtype):
        logits_g = task.apply(layout.views(global_flat),
                              x.flatten(0, 1)).unflatten(0, (K, -1))
        # one forward a user: the ResNet's GroupNorm has no vmap rule
        # outside a grad transform (it asks the batched input for
        # channels-last)
        logits_l = torch.stack([task.apply(layout.views(local_flat[k]),
                                           x[k]) for k in range(K)])
    squash = F.log_softmax if logspace else F.softmax
    a = alpha[:, None, None]
    mixed = a * squash(logits_l, dim=-1) + (1.0 - a) * squash(logits_g,
                                                              dim=-1)
    correct = ((torch.argmax(mixed, dim=-1) == y).to(mask.dtype) * mask).sum()
    n = mask.sum(-1)
    denom = torch.clamp(n, min=1.0)
    ce_g = (softmax_xent(logits_g, y) * mask).sum(-1) / denom
    ce_l = (softmax_xent(logits_l, y) * mask).sum(-1) / denom
    return correct, n.sum(), (0.5 * (ce_g + ce_l) * n).sum()


@torch.no_grad()
def per_user_accuracy(task: BaseTask, params: Params,
                      batches: Dict[str, torch.Tensor],
                      user_idx: torch.Tensor, n_users: int) -> np.ndarray:
    """Each eval user's accuracy (NaN for a user without samples), from
    ``argmax(apply(x)) == y`` over the packed grid; ``user_idx [T, B]`` on
    the grid's device, -1 on padding rows.  The per-user sums are counts,
    so their order of addition cannot change them."""
    device = batches["sample_mask"].device
    correct = torch.zeros(n_users + 1, device=device)
    count = torch.zeros(n_users + 1, device=device)
    for t in range(batches["sample_mask"].shape[0]):
        mask = batches["sample_mask"][t]
        with cpu16_guard(device, task.compute_dtype):
            pred = torch.argmax(task.apply(params, batches["x"][t]), dim=-1)
        uid = torch.where(user_idx[t] >= 0, user_idx[t].long(),
                          torch.full_like(user_idx[t].long(), n_users))
        correct.index_add_(0, uid, (pred == batches["y"][t].long()).to(
            mask.dtype) * mask)
        count.index_add_(0, uid, mask)
    c = correct[:n_users].double().cpu().numpy()
    n = count[:n_users].double().cpu().numpy()
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(n > 0, c / np.maximum(n, 1.0), np.nan)


@torch.no_grad()
def prediction_rows(task: BaseTask, params: Params,
                    batches: Dict[str, torch.Tensor], user_idx: np.ndarray,
                    topk: int = 3) -> Iterator[dict]:
    """The ``wantLogits`` dump's rows, one per real sample, with the JAX
    server's keys and 6-digit rounding: ``user``, ``topk_ids``,
    ``topk_probs``, ``labels`` for a task with ``topk_predictions``, else
    ``user``, ``pred``, ``label``, ``logits`` (``predict``).  The sample
    mask is read back once; a step without a real sample is skipped."""
    seq_fn = getattr(task, "topk_predictions", None)
    mask = batches["sample_mask"].cpu().numpy() > 0
    for t in range(mask.shape[0]):
        if not mask[t].any():
            continue
        batch = {k: v[t] for k, v in batches.items()}
        with cpu16_guard(batch["sample_mask"].device, task.compute_dtype):
            out = (seq_fn(params, batch, topk) if seq_fn is not None
                   else task.predict(params, batch))
        out = [o.cpu().numpy() for o in out]
        for i in np.flatnonzero(mask[t]):
            if seq_fn is not None:
                top_p, top_ids, labels = out
                yield {"user": int(user_idx[t, i]),
                       "topk_ids": top_ids[i].tolist(),
                       "topk_probs": np.round(top_p[i], 6).tolist(),
                       "labels": labels[i].tolist()}
            else:
                logits, pred, labels = out
                yield {"user": int(user_idx[t, i]), "pred": int(pred[i]),
                       "label": int(labels[i]),
                       "logits": np.round(logits[i], 6).tolist()}
