"""Evaluation in sum form — the port's counterpart of
``msrflute_tpu/engine/evaluation.py::build_eval_fn``/``evaluate``.

All eval samples are packed into one ``[T, B, ...]`` grid
(:func:`..data.batching.pack_eval_batches`); each step's task stats are
summed on the device and fetched once, then finalized host-side — the
reference's sample-weighted metric merge.  A step whose stats are not all
finite is excluded whole (its ``sample_count`` too), as in the JAX
package; if every step is excluded the metrics are NaN.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..models.base import BaseTask, Metric, Params


def stage_eval_batches(batches, device: torch.device) -> Dict[str, torch.Tensor]:
    """Eval data is static across rounds: move it to the device once."""
    return {k: torch.from_numpy(v).to(device) for k, v in batches.items()
            if k != "user_idx"}


@torch.no_grad()
def evaluate(task: BaseTask, params: Params,
             batches: Dict[str, torch.Tensor]) -> Dict[str, Metric]:
    T = batches["sample_mask"].shape[0]
    sums = None
    for t in range(T):
        step = task.eval_stats(params, {k: v[t] for k, v in batches.items()})
        finite = torch.stack([torch.isfinite(v).all()
                              for v in step.values()]).all()
        step = {k: torch.where(finite, v, torch.zeros_like(v))
                for k, v in step.items()}
        sums = step if sums is None else {k: sums[k] + step[k] for k in sums}
    # one device->host transfer; a per-class stat (CIFAR_CNN's tp, fp, fn)
    # comes back as a list
    flat = torch.cat([v.reshape(-1).to(torch.float32)
                      for v in sums.values()]).cpu().tolist()
    host, at = {}, 0
    for name, v in sums.items():
        host[name] = flat[at] if v.ndim == 0 else flat[at:at + v.numel()]
        at += v.numel()
    metrics = task.finalize_metrics(host)
    if host["sample_count"] <= 0.0:
        metrics = {name: Metric(float("nan"), m.higher_is_better)
                   for name, m in metrics.items()}
    return metrics
