"""The screening half of fluteshield — the port's counterpart of
``msrflute_tpu/robust/shield.py``, over the round's flat ``[K, P]`` payload
stack in place of a pytree.

Numerical contract (``shield.py:8-22``):

- a quarantined client contributes exactly zero to every aggregate: the
  round zeroes its payload row, weight, loss, sample count and stats with
  ``torch.where`` on the keep mask, never a ``0 *`` multiply (the round's
  ``w @ pg`` sums would let a NaN row poison the aggregate even at weight
  0);
- only live, finite clients vote for the median of the payload norms;
- a median of 0 (an all-zero cohort) turns the norm screen off for that
  round instead of quarantining everyone.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

#: the robust aggregators (``server_config.robust.aggregator``)
AGGREGATORS = ("mean", "trimmed_mean", "median")


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``values[mask > 0]`` over the finite entries, with static
    shapes: masked and non-finite entries sort to the top as ``+inf`` and
    are excluded by rank; an even count averages the two middle ranks; an
    empty vote gives 0."""
    finite = torch.isfinite(values) & (mask > 0)
    inf = torch.full_like(values, float("inf"))
    srt = torch.sort(torch.where(finite, values, inf)).values
    n = finite.to(torch.int64).sum()
    i_lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    i_hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), min=0)
    ranks = torch.arange(srt.shape[0], device=srt.device)
    ind = 0.5 * ((ranks == i_lo).to(srt.dtype) + (ranks == i_hi).to(srt.dtype))
    med = torch.sum(torch.where(torch.isfinite(srt), srt,
                                torch.zeros_like(srt)) * ind)
    return torch.where(n > 0, med, torch.zeros_like(med))


def _flags(finite: torch.Tensor, norm_ok: torch.Tensor,
           client_mask: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(keep, q_nonfinite, q_norm_outlier)``, the counts gated on the
    live mask (a padding slot never counts)."""
    keep = finite & norm_ok
    finite_f = finite.to(client_mask.dtype)
    q_nonfinite = client_mask * (1.0 - finite_f)
    q_norm = client_mask * finite_f * (1.0 - norm_ok.to(client_mask.dtype))
    return keep.to(client_mask.dtype), q_nonfinite, q_norm


class Shield:
    """One run's screening policy and quarantine counters."""

    def __init__(self, screen_nonfinite: bool = True,
                 norm_multiplier: Optional[float] = 5.0,
                 aggregator: str = "mean", trim_fraction: float = 0.1):
        if aggregator not in AGGREGATORS:
            raise ValueError(
                f"robust.aggregator must be one of {AGGREGATORS}, "
                f"got {aggregator!r}")
        if norm_multiplier is not None and float(norm_multiplier) < 1.0 \
                and float(norm_multiplier) != 0.0:
            raise ValueError(
                "robust.norm_multiplier must be >= 1 (it scales the "
                "median payload norm) or 0/absent to disable")
        if not 0.0 <= float(trim_fraction) < 0.5:
            raise ValueError(
                "robust.trim_fraction must be in [0, 0.5) — trimming "
                "half or more from each side leaves nothing to average")
        self.screen_nonfinite = bool(screen_nonfinite)
        self.norm_multiplier = (float(norm_multiplier)
                                if norm_multiplier else 0.0)
        self.aggregator = str(aggregator)
        self.trim_fraction = float(trim_fraction)
        #: quarantine totals, accumulated by the server from the round
        #: stats
        self.counters: Dict[str, float] = {
            "quarantined_nonfinite": 0.0,
            "quarantined_norm_outlier": 0.0,
        }

    @property
    def wants_stack(self) -> bool:
        """Whether the aggregator reduces the per-client stack (trimmed
        mean, median) rather than the weighted sums."""
        return self.aggregator in ("trimmed_mean", "median")

    def _norm_ok(self, norms: torch.Tensor, finite: torch.Tensor,
                 client_mask: torch.Tensor) -> torch.Tensor:
        if self.norm_multiplier <= 0.0:
            return torch.ones_like(finite)
        vote = client_mask * finite.to(client_mask.dtype)
        med = masked_median(norms, vote)
        return torch.where(med > 0.0, norms <= self.norm_multiplier * med,
                           torch.ones_like(finite))

    def screen(self, payload: torch.Tensor, train_loss: torch.Tensor,
               weight: torch.Tensor, client_mask: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The round's quarantine decision from the payloads that would
        aggregate: ``payload [K, P]`` (after the strategy's transform and
        any corruption), ``train_loss`` / ``weight`` / ``client_mask``
        ``[K]`` (the live mask, padding and dropout folded in).  Returns
        ``(keep [K] in {0, 1}, q_nonfinite [K], q_norm_outlier [K])``,
        the two counts disjoint."""
        finite = torch.ones(client_mask.shape, dtype=torch.bool,
                            device=client_mask.device)
        if self.screen_nonfinite:
            finite = (torch.isfinite(payload).all(dim=1)
                      & torch.isfinite(train_loss) & torch.isfinite(weight))
        norms = None
        if self.norm_multiplier > 0.0:
            norms = torch.sqrt(torch.sum(payload * payload, dim=1))
        norm_ok = self._norm_ok(norms, finite, client_mask)
        return _flags(finite, norm_ok, client_mask)

    def screen_masked(self, norms: torch.Tensor, train_loss: torch.Tensor,
                      weight: torch.Tensor, client_mask: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """:meth:`screen` for secure aggregation, on the norms the clients
        submit in the clear (a masked int32 submission carries no norm or
        finiteness signal): a NaN or inf payload has a non-finite norm, so
        the norm carries the finite check too."""
        finite = torch.ones(client_mask.shape, dtype=torch.bool,
                            device=client_mask.device)
        if self.screen_nonfinite:
            finite = (torch.isfinite(norms) & torch.isfinite(train_loss)
                      & torch.isfinite(weight))
        norm_ok = self._norm_ok(norms, finite, client_mask)
        return _flags(finite, norm_ok, client_mask)

    def describe(self) -> Dict[str, Any]:
        """The policy, so a shielded run is never compared against an
        undefended one unawares."""
        return {"enabled": True, "screen_nonfinite": self.screen_nonfinite,
                "norm_multiplier": self.norm_multiplier,
                "aggregator": self.aggregator,
                "trim_fraction": self.trim_fraction}


def make_shield(server_config) -> Optional[Shield]:
    """The run's :class:`Shield` from ``server_config.robust`` (None when
    absent or ``enable: false``: the round is then exactly the one without
    a block)."""
    raw = server_config.get("robust") if server_config is not None else None
    if not raw:
        return None
    raw = dict(raw)
    if not raw.pop("enable", True):
        return None
    return Shield(
        screen_nonfinite=raw.get("screen_nonfinite", True),
        norm_multiplier=raw.get("norm_multiplier", 5.0),
        aggregator=raw.get("aggregator", "mean"),
        trim_fraction=raw.get("trim_fraction", 0.1),
    )
