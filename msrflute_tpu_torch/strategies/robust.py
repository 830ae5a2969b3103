"""Byzantine-robust aggregation (fluteshield's aggregator half) — the port's
counterpart of ``msrflute_tpu/strategies/robust.py``.

The coordinate-wise trimmed mean and the coordinate-wise median (Yin et
al., arXiv:1803.01498) over the screened ``[K, P]`` payload stack, chosen
by ``server_config.robust.aggregator``.  Neither reduces to the weighted
sums, so :class:`RobustFedAvg` sets ``wants_client_stack`` and the round
hands it the stack.  Both are unweighted over the kept clients (sample
weighting would let an adversary buy influence by claiming samples).

Masked clients and non-finite coordinates are excluded by rank against
``+inf`` sentinels put in place before the sort: ``torch.sort`` ranks NaN
above ``+inf`` (as ``jnp.sort`` does), so a kept NaN could not be excluded
after it.
"""

from __future__ import annotations

import torch

from .base import BaseStrategy
from .fedavg import FedAvg


def _sorted_kept(stack: torch.Tensor, keep: torch.Tensor):
    """``(part, sorted, ranks)``: which entries vote, the stack sorted
    along the client axis with the rest as ``+inf``, and each row's
    rank."""
    part = (keep[:, None] > 0) & torch.isfinite(stack)
    inf = torch.full_like(stack, float("inf"))
    srt = torch.sort(torch.where(part, stack, inf), dim=0).values
    ranks = torch.arange(stack.shape[0], device=stack.device)[:, None]
    return part, srt, ranks


def _client_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the client axis, row after row from 0: the order XLA's
    reduce takes on the JAX side (``torch.sum`` sums in another order,
    1 ulp off at times)."""
    acc = torch.zeros_like(x[0])
    for row in x:
        acc = acc + row
    return acc


def coordinate_trimmed_mean(stack: torch.Tensor, keep: torch.Tensor,
                            trim_fraction: float) -> torch.Tensor:
    """Per coordinate, the mean of the finite kept entries of ranks
    ``[t, n - t)``, ``t = floor(trim_fraction * n)`` computed in float32;
    a coordinate with no finite kept entry gives 0."""
    part, srt, ranks = _sorted_kept(stack, keep)
    n = part.sum(dim=0, keepdim=True).to(stack.dtype)
    t = torch.floor(torch.tensor(trim_fraction, dtype=stack.dtype,
                                 device=stack.device) * n)
    denom = torch.clamp(n - 2.0 * t, min=1.0)
    ind = (ranks >= t) & (ranks < n - t)
    return _client_sum(torch.where(ind, srt, torch.zeros_like(srt))) \
        / denom[0]


def coordinate_median(stack: torch.Tensor, keep: torch.Tensor
                      ) -> torch.Tensor:
    """Per coordinate, the median of the finite kept entries (an even
    count averages the two middle ranks); an empty vote gives 0."""
    part, srt, ranks = _sorted_kept(stack, keep)
    n = part.to(torch.int64).sum(dim=0, keepdim=True)
    i_lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    i_hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), min=0)
    ind = 0.5 * ((ranks == i_lo).to(stack.dtype)
                 + (ranks == i_hi).to(stack.dtype))
    med = _client_sum(torch.where(ind > 0, srt, torch.zeros_like(srt)) * ind)
    return torch.where(n[0] > 0, med, torch.zeros_like(med))


class RobustFedAvg(FedAvg):
    """FedAvg's client side with a robust combine: the round calls
    :meth:`combine_stack` on the screened stack instead of
    :meth:`combine_parts` on the weighted sums."""

    wants_client_stack = True
    # deferring or re-weighting a slice of the stack would give a single
    # client back the leverage the estimator removes
    supports_rl = False

    def __init__(self, config):
        super().__init__(config)
        raw = dict(config.server_config.get("robust") or {})
        self.aggregator = str(raw.get("aggregator", "mean"))
        self.trim_fraction = float(raw.get("trim_fraction", 0.1))
        if self.aggregator not in ("trimmed_mean", "median"):
            raise ValueError(
                "RobustFedAvg is the stack-combining strategy — "
                f"aggregator {self.aggregator!r} does not need it "
                "(screened mean rides the plain FedAvg sum path)")
        if self.adaptive_clip is not None:
            raise ValueError(
                "dp_config.adaptive_clipping tracks its quantile through "
                "the weighted-sum combine, which a robust aggregator "
                "bypasses — disable one of them")

    def combine_stack(self, stack: torch.Tensor,
                      keep: torch.Tensor) -> torch.Tensor:
        """The aggregate pseudo-gradient ``[P]`` from the screened stack
        ``[K, P]`` and the live-and-unscreened mask ``keep [K]``."""
        if self.aggregator == "median":
            return coordinate_median(stack, keep)
        return coordinate_trimmed_mean(stack, keep, self.trim_fraction)


def select_robust_strategy(config, base_cls: type) -> BaseStrategy:
    """``base_cls(config)``, or :class:`RobustFedAvg` when
    ``server_config.robust`` asks for a stack aggregator.  A strategy that
    aggregates through its own parts is refused: it would aggregate
    unscreened payloads under a ``robust`` block."""
    raw = dict(config.server_config.get("robust") or {})
    if not raw or not raw.get("enable", True):
        return base_cls(config)
    from .secure_agg import SecureAgg
    aggregator = str(raw.get("aggregator", "mean"))
    if base_cls is SecureAgg:
        if aggregator in ("trimmed_mean", "median"):
            raise ValueError(
                f"robust.aggregator={aggregator!r} sorts per-client "
                "payload coordinates, but secure_agg submissions are "
                "masked int32 group elements — use aggregator: mean "
                "(submitted-norm screening still applies)")
        return base_cls(config)
    if base_cls is not FedAvg:
        raise ValueError(
            "server_config.robust requires strategy: fedavg/fedprox/"
            f"secure_agg — {base_cls.__name__} aggregates through its "
            "own parts and would ignore the screening; drop the robust "
            "block or the strategy")
    if aggregator in ("trimmed_mean", "median"):
        return RobustFedAvg(config)
    return base_cls(config)
