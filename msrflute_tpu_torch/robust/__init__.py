"""fluteshield — screened aggregation for poisoned or broken cohorts, the
port's counterpart of ``msrflute_tpu/robust/``.

- per-client screening (:meth:`Shield.screen`): a client whose payload,
  train loss or weight is not finite, or whose payload norm exceeds
  ``norm_multiplier`` times the cohort's median norm, is quarantined for
  the round; the quarantine folds into the client mask, so the weights
  renormalize over the rest;
- robust aggregators (``strategies/robust.py``): the coordinate-wise
  trimmed mean and median over the screened stack;
- the attack streams (``resilience/chaos.py``): seeded NaN, scale and
  sign-flip corruption.

Config (``server_config.robust``)::

    robust:
      screen_nonfinite: true     # quarantine any-NaN/Inf payloads
      norm_multiplier: 5.0       # quarantine norm > mult x median (0: off)
      aggregator: mean           # mean | trimmed_mean | median
      trim_fraction: 0.1         # per-side trim for trimmed_mean

No block, or ``enable: false``, leaves the round exactly as it was.
"""

from __future__ import annotations

from .shield import Shield, make_shield, masked_median  # noqa: F401

__all__ = ["Shield", "make_shield", "masked_median"]
