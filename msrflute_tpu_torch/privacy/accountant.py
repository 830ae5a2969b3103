"""Renyi-DP accountant for the sampled Gaussian mechanism — the port's copy
of ``msrflute_tpu/privacy/accountant.py`` (numpy and scipy, no JAX).

Role parity: reference ``extensions/privacy/analysis.py`` (vendored
TF-Privacy/Opacus math).  This is an independent implementation from the
published formulas (Mironov 2017, "Renyi Differential Privacy"; Mironov,
Talwar & Zhang 2019, "Renyi Differential Privacy of the Sampled Gaussian
Mechanism", eq. 7):

For integer order ``alpha >= 2`` and sampling rate ``q``::

    RDP(alpha) = 1/(alpha-1) * log( sum_{k=0}^{alpha}
                 C(alpha,k) (1-q)^(alpha-k) q^k exp(k(k-1)/(2 sigma^2)) )

computed in log space.  Composition over T steps multiplies RDP by T.
Conversion to (eps, delta)-DP uses the standard bound
``eps = rdp + log(1/delta)/(alpha-1)`` minimized over orders.

We restrict to integer orders (fractional orders need the continuous-series
bound and buy little accuracy); callers pass the same order grid either way.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
from scipy.special import gammaln, logsumexp


# shared order grid for RDP accounting (integer-order mechanism family;
# fractional entries below 2 are rounded up by compute_rdp anyway, so the
# grid is integers with a coarse high-order tail)
DEFAULT_ORDERS: Tuple[int, ...] = tuple(range(2, 64)) + (128, 256, 512)


def _log_comb(n: int, k: int) -> float:
    return gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)


def _rdp_integer_order(q: float, sigma: float, alpha: int) -> float:
    """RDP of one sampled-Gaussian step at integer order alpha."""
    if q == 0:
        return 0.0
    if q == 1.0:
        return alpha / (2.0 * sigma ** 2)
    log_terms = []
    for k in range(alpha + 1):
        log_b = _log_comb(alpha, k)
        log_q = k * math.log(q) if k > 0 else 0.0
        log_1mq = (alpha - k) * math.log1p(-q) if alpha - k > 0 else 0.0
        log_e = k * (k - 1) / (2.0 * sigma ** 2)
        log_terms.append(log_b + log_q + log_1mq + log_e)
    log_sum = logsumexp(log_terms)
    return float(log_sum / (alpha - 1))


def compute_rdp(q: float, noise_multiplier: float, steps: int,
                orders: Sequence[float]) -> np.ndarray:
    """RDP at each order after ``steps`` compositions of subsampled Gaussian
    with sampling rate ``q`` and noise multiplier ``noise_multiplier``.

    Non-integer orders are rounded up to the next integer (a valid upper
    bound since RDP is monotone in the order for this mechanism family).
    """
    if noise_multiplier <= 0:
        return np.full(len(orders), np.inf)
    out = []
    for order in orders:
        alpha = int(math.ceil(order))
        alpha = max(alpha, 2)
        out.append(_rdp_integer_order(q, noise_multiplier, alpha) * steps)
    return np.asarray(out)


def get_privacy_spent(orders: Sequence[float], rdp: Sequence[float],
                      target_delta: float) -> Tuple[float, float]:
    """(epsilon, optimal order) for a target delta:
    ``eps(alpha) = rdp(alpha) + log(1/delta)/(alpha-1)`` minimized over
    orders (Mironov 2017, Prop. 3)."""
    orders = np.asarray(orders, dtype=float)
    rdp = np.asarray(rdp, dtype=float)
    with np.errstate(over="ignore", invalid="ignore"):
        eps = rdp + math.log(1.0 / target_delta) / (orders - 1.0)
    eps = np.where(np.isnan(eps), np.inf, eps)
    idx = int(np.argmin(eps))
    return float(eps[idx]), float(orders[idx])
