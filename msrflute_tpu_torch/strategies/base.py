"""Strategy contract — the port's counterpart of ``msrflute_tpu/strategies/base.py``,
trimmed to the single ``"default"`` payload part.

A strategy contributes functions over the round's ``[K, ...]`` client
stacks: :meth:`client_step` (local work -> weighted payload parts),
:meth:`client_weight`, :meth:`transform_payload` and :meth:`combine`
(weighted sums -> aggregate pseudo-gradient).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import NOT_PORTED

MAX_WEIGHT = 100.0  # reference core/strategies/utils.py:11-19


def filter_weight(weight: torch.Tensor) -> torch.Tensor:
    """NaN/Inf -> 0, cap at ``MAX_WEIGHT``."""
    weight = torch.nan_to_num(weight, nan=0.0, posinf=0.0, neginf=0.0)
    return torch.clamp(weight, 0.0, MAX_WEIGHT)


class BaseStrategy:
    def __init__(self, config):
        self.config = config

    def client_step(self, client_update, global_flat, arrays, sample_mask,
                    client_lr, gens=None):
        """Run the K clients' local work; returns ``(parts, train_loss,
        num_samples, stats)`` with ``parts = {"default": (pg [K, P],
        w [K])}``."""
        pg, tl, ns, stats = client_update(global_flat, arrays, sample_mask,
                                          client_lr, gens)
        w = self.client_weight(num_samples=ns, train_loss=tl, stats=stats)
        pg, w = self.transform_payload(pg, w)
        return {"default": (pg, w)}, tl, ns, stats

    def client_weight(self, *, num_samples: torch.Tensor,
                      train_loss: torch.Tensor,
                      stats: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def transform_payload(self, pseudo_grad: torch.Tensor,
                          weight: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        return pseudo_grad, weight

    def combine(self, weighted_grad_sum: torch.Tensor,
                weight_sum: torch.Tensor) -> torch.Tensor:
        return weighted_grad_sum / torch.clamp(weight_sum, min=1e-12)

    def combine_parts(self, part_sums: Dict[str, Dict[str, torch.Tensor]],
                      deferred: Optional[dict] = None) -> torch.Tensor:
        if set(part_sums) != {"default"} or deferred is not None:
            raise NotImplementedError(
                f"payload parts {sorted(part_sums)} are {NOT_PORTED}")
        return self.combine(part_sums["default"]["grad_sum"],
                            part_sums["default"]["weight_sum"])
