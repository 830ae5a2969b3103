"""hello_mlp — the port's twin of ``experiments/hello_mlp/task.py``, the
scenario-authoring example: a two-layer MLP classifier plus one custom
metric.

The module keeps flax's names and layouts as :mod:`..models.convert`
carries them (``Dense_0.weight`` ``[hidden, input_dim]``, ``Dense_1``), and
the folder's ``config.py`` supplies ``input_dim``, ``num_classes`` and
``hidden`` where the YAML leaves them out.  ``top2_acc`` is a sum-form
device stat (``top2_sum``) finalized host-side, as the JAX task does
(``task.py:40-55``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.base import Batch, Metric, Params
from ..models.cv import ClassificationTask


class MLP(nn.Module):
    """Dense(hidden) -> relu -> Dense(num_classes) over flattened inputs."""

    def __init__(self, input_dim: int, hidden: int, num_classes: int):
        super().__init__()
        self.Dense_0 = nn.Linear(input_dim, hidden)
        self.Dense_1 = nn.Linear(hidden, num_classes)

    def forward(self, x, masks: Tuple[torch.Tensor, ...] = ()):
        x = x.to(torch.float32).reshape(x.shape[0], -1)
        return self.Dense_1(F.relu(self.Dense_0(x)))


class HelloMLPTask(ClassificationTask):
    def eval_stats(self, params: Params, batch: Batch) -> Dict[str, torch.Tensor]:
        stats = super().eval_stats(params, batch)
        logits = self.apply(params, batch["x"])
        top2 = torch.topk(logits, 2, dim=-1).indices
        hit = (top2 == batch["y"].long()[:, None]).any(-1).to(torch.float32)
        stats["top2_sum"] = torch.sum(hit * batch["sample_mask"])
        return stats

    def finalize_metrics(self, sums: Dict[str, float]) -> Dict[str, Metric]:
        metrics = super().finalize_metrics(sums)
        if "top2_sum" in sums:
            metrics["top2_acc"] = Metric(
                float(sums["top2_sum"]) / max(float(sums["sample_count"]),
                                              1.0))
        return metrics


def make_task(model_config) -> HelloMLPTask:
    input_dim = int(model_config.get("input_dim", 16))
    num_classes = int(model_config.get("num_classes", 3))
    return HelloMLPTask(
        MLP(input_dim, int(model_config.get("hidden", 64)), num_classes),
        example_shape=(input_dim,), name="hello_mlp",
        num_classes=num_classes)
