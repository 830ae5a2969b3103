"""Strategy contract — the port's counterpart of ``msrflute_tpu/strategies/base.py``.

A strategy contributes functions over the round's ``[K, ...]`` client
stacks (``msrflute_tpu/strategies/base.py:153-181, 300-330``):

- :meth:`client_step` — local work -> named, weighted payload parts
  (``"default"`` for a single-part strategy; FedLabels sends ``"sup"`` and
  ``"unsup"``); it gets the round's index and hands
  :meth:`transform_payload` the round's quantization threshold, the
  clients' random streams and the leaf bounds of the flat parameter
  vector;
- :meth:`client_weight`, :meth:`transform_payload` (local DP,
  quantization);
- :meth:`init_state` / :meth:`combine` — weighted sums -> aggregate
  pseudo-gradient, with cross-round state (DGA's staleness buffer) passed
  in and returned: ``combine(weighted_grad_sum, weight_sum, deferred,
  state, seed, num_clients) -> (agg, new_state)``;
  :meth:`combine_parts` takes every part's sums and the round's global
  params, and a multi-part strategy overrides it.

The round engine sets :attr:`BaseStrategy.task` (a strategy that runs the
model itself, as FedLabels' unsupervised pass does, reads it there).

Random streams: ``client_rngs(tag)`` gives one ``torch.Generator`` per
client (``SeedSequence([seed, round, client, tag])``, the analogue of the
JAX package's ``fold_in`` tags), and ``seed`` is the round's server-side
stream (global DP's kernel seed).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

MAX_WEIGHT = 100.0  # reference core/strategies/utils.py:11-19

ClientRngs = Callable[[int], List[torch.Generator]]
State = Dict[str, torch.Tensor]


def filter_weight(weight: torch.Tensor) -> torch.Tensor:
    """NaN/Inf -> 0, cap at ``MAX_WEIGHT``."""
    weight = torch.nan_to_num(weight, nan=0.0, posinf=0.0, neginf=0.0)
    return torch.clamp(weight, 0.0, MAX_WEIGHT)


class BaseStrategy:
    #: probability that a client's payload is deferred one round (DGA
    #: staleness); the engine draws the per-client coin and hands
    #: :meth:`combine` separate now and deferred sums
    stale_prob: float = 0.0
    #: the round engine's task
    task = None

    def __init__(self, config):
        self.config = config
        self.dp_config = getattr(config, "dp_config", None) or {}

    def client_step(self, client_update, global_flat, arrays, sample_mask,
                    client_lr, gens=None, quant_threshold=None,
                    client_rngs: Optional[ClientRngs] = None,
                    bounds: Optional[List[int]] = None,
                    round_idx: Optional[int] = None):
        """Run the K clients' local work; returns ``(parts, train_loss,
        num_samples, stats)`` with ``parts = {"default": (pg [K, P],
        w [K])}``.  ``bounds`` are the parameter leaves' offsets in the
        flat vector followed by its length (per-leaf work such as
        quantization reads them); ``round_idx`` is the round's index."""
        pg, tl, ns, stats = client_update(global_flat, arrays, sample_mask,
                                          client_lr, gens)
        w = self.client_weight(num_samples=ns, train_loss=tl, stats=stats)
        pg, w = self.transform_payload(pg, w, quant_threshold=quant_threshold,
                                       client_rngs=client_rngs, bounds=bounds)
        return {"default": (pg, w)}, tl, ns, stats

    def client_weight(self, *, num_samples: torch.Tensor,
                      train_loss: torch.Tensor,
                      stats: Dict[str, torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def transform_payload(self, pseudo_grad: torch.Tensor,
                          weight: torch.Tensor, quant_threshold=None,
                          client_rngs: Optional[ClientRngs] = None,
                          bounds: Optional[List[int]] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        return pseudo_grad, weight

    def init_state(self, params: torch.Tensor) -> State:
        return {}

    def combine(self, weighted_grad_sum: torch.Tensor,
                weight_sum: torch.Tensor, deferred: Optional[State],
                state: State, seed: int, num_clients: float
                ) -> Tuple[torch.Tensor, State]:
        """``(aggregate pseudo-gradient, new state)``.  ``deferred`` holds
        ``{"grad_sum", "weight_sum"}`` of the clients deferred to the next
        round when the engine runs with ``stale_prob > 0``."""
        return weighted_grad_sum / torch.clamp(weight_sum, min=1e-12), state

    def combine_parts(self, part_sums: Dict[str, Dict[str, torch.Tensor]],
                      deferred: Optional[State], state: State, seed: int,
                      num_clients: float,
                      global_params: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, State]:
        """Every part's ``{"grad_sum", "weight_sum"}`` -> ``(agg, new
        state)``; single-part strategies fall through to :meth:`combine`,
        a multi-part one overrides this."""
        if set(part_sums) != {"default"}:
            raise NotImplementedError(
                f"{type(self).__name__} must override combine_parts for "
                f"parts {sorted(part_sums)}")
        return self.combine(part_sums["default"]["grad_sum"],
                            part_sums["default"]["weight_sum"], deferred,
                            state, seed, num_clients)
