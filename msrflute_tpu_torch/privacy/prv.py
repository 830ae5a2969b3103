"""PRV accountant — numerical composition of differential privacy.

The port's copy of ``msrflute_tpu/privacy/prv.py``, numpy and scipy
only, equal to it on the same inputs; like the JAX package, the port does
not re-export it from :mod:`msrflute_tpu_torch.privacy`.

Role parity: the reference vendors microsoft/prv_accountant as the
``utils/dp-accountant`` git submodule for *offline* accounting
(reference ``.gitmodules:1-3``, ``README.md:162-171``: "A better
accounting method is in the dp-accountant submodule", exposing
``compute-dp-epsilon -p SAMPLING_PROBABILITY -s NOISE_MULTIPLIER
-i ITERATIONS -d DELTA``).  This module is an independent clean-room
implementation of the same technique from the published algorithm
(Gopi, Lee & Wutschitz 2021, "Numerical Composition of Differential
Privacy", NeurIPS): discretize the privacy-loss random variable (PRV) of
one mechanism invocation, self-compose ``T`` times by raising its FFT to
the ``T``-th power, and read ``delta(eps)`` — and its inverse — off the
composed distribution.  Unlike the Renyi bound in
:mod:`.accountant`, the result is a near-exact
two-sided *bracket* ``(eps_lower, eps_estimate, eps_upper)``.

Mechanism: Poisson-subsampled Gaussian (the mechanism FLUTE's DP actually
runs — per-round client sampling + Gaussian noise).  Its dominating pair
is ``P = (1-q) N(0, s^2) + q N(1, s^2)`` vs ``Q = N(0, s^2)`` (noise
multiplier ``s``, sampling rate ``q``); both adjacency directions
(remove: ``log dP/dQ`` under ``P``; add: ``log dQ/dP`` under ``Q``) are
composed and the worse epsilon reported.

Everything is host-side numpy/scipy — accounting is offline by design
(reference ``README.md:160``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Tuple

import numpy as np
from scipy.stats import norm


# ----------------------------------------------------------------------
# single-step PRV CDFs (analytic)
# ----------------------------------------------------------------------
def _remove_direction_cdf(q: float, sigma: float) -> Callable:
    """CDF of ``L = log dP/dQ (x)`` with ``x ~ P``.

    ``dP/dQ(x) = (1-q) + q exp((2x-1)/(2 sigma^2))`` is increasing in
    ``x``, so ``P(L <= t) = P(x <= x(t))`` with
    ``x(t) = sigma^2 log((e^t - (1-q))/q) + 1/2`` for ``t > log(1-q)``.
    """
    def cdf(t: np.ndarray) -> np.ndarray:
        t = np.asarray(t, dtype=np.float64)
        out = np.zeros_like(t)
        # threshold: below log(1-q) the loss is unattainable (CDF = 0)
        lo = math.log1p(-q) if q < 1.0 else -np.inf
        ok = t > lo
        with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
            u = np.where(ok, np.expm1(t) + q, q)  # e^t - (1-q)
            x = sigma * sigma * (np.log(u) - math.log(q)) + 0.5
        mass = (1.0 - q) * norm.cdf(x / sigma) + q * norm.cdf((x - 1) / sigma)
        return np.where(ok, mass, 0.0)
    return cdf


def _add_direction_cdf(q: float, sigma: float) -> Callable:
    """CDF of ``L' = log dQ/dP (x)`` with ``x ~ Q = N(0, sigma^2)``.

    ``L' = -log((1-q) + q exp((2x-1)/(2 sigma^2)))`` is decreasing in
    ``x``, so ``P(L' <= t) = P(x >= x(-t))`` with the same ``x(.)``.
    """
    def cdf(t: np.ndarray) -> np.ndarray:
        t = np.asarray(t, dtype=np.float64)
        # L' ranges in (-inf, -log(1-q)); at/above that bound CDF = 1
        hi = -math.log1p(-q) if q < 1.0 else np.inf
        ok = t < hi
        with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
            u = np.where(ok, np.expm1(-t) + q, q)
            x = sigma * sigma * (np.log(u) - math.log(q)) + 0.5
        mass = norm.sf(x / sigma)
        return np.where(ok, mass, 1.0)
    return cdf


# ----------------------------------------------------------------------
# discretization + FFT self-composition
# ----------------------------------------------------------------------
@dataclass
class _ComposedPRV:
    """Discretized distribution of the T-fold composed PRV.

    ``delta(eps)`` splits as ``sum_{y>eps} p_y - e^eps sum_{y>eps} p_y e^-y``;
    both suffix sums are precomputed once so each evaluation is a binary
    search, which makes the bisection in :meth:`epsilon` cheap.
    """
    grid: np.ndarray   # bin centers (absolute, after un-centering)
    pmf: np.ndarray    # probability mass per bin
    tail_low: float    # mass truncated below the grid (maps to delta=0 side)
    tail_high: float   # mass truncated above the grid (counts fully in delta)

    def __post_init__(self):
        # suffix sums from the high-y end; e^-y clipped at y=-50 (those
        # entries are only reachable for eps < -50, never queried)
        w = np.exp(-np.clip(self.grid, -50.0, None)) * self.pmf
        self._suffix_p = np.cumsum(self.pmf[::-1])[::-1]
        self._suffix_pe = np.cumsum(w[::-1])[::-1]

    def delta(self, eps: float, pessimistic: bool = True) -> float:
        """``delta(eps) = E[(1 - e^(eps - Y))_+]`` over the composed PRV.

        ``pessimistic`` adds the truncated upper-tail mass in full (each
        such sample contributes at most 1); the optimistic variant drops
        it.  The lower tail contributes nothing either way.
        """
        i = int(np.searchsorted(self.grid, eps, side="right"))
        if i >= self.grid.size:
            d = 0.0
        else:
            d = float(self._suffix_p[i] - math.exp(eps) * self._suffix_pe[i])
        if pessimistic:
            d += self.tail_high
        return min(max(d, 0.0), 1.0)

    def epsilon(self, target_delta: float, pessimistic: bool) -> float:
        """Invert ``delta(eps)`` by bisection (delta is non-increasing)."""
        lo, hi = 0.0, 1.0
        while self.delta(hi, pessimistic) > target_delta:
            hi *= 2.0
            if hi > 1e6:
                return math.inf
        if self.delta(lo, pessimistic) <= target_delta:
            return 0.0
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            if self.delta(mid, pessimistic) > target_delta:
                lo = mid
            else:
                hi = mid
        return hi


def _discretize(cdf: Callable, lo: float, hi: float, n_bins: int
                ) -> Tuple[np.ndarray, np.ndarray, float, float]:
    """Exact bin masses from CDF differences on ``n_bins`` uniform bins."""
    edges = np.linspace(lo, hi, n_bins + 1)
    c = np.clip(cdf(edges), 0.0, 1.0)
    c = np.maximum.accumulate(c)  # guard tiny numeric non-monotonicity
    pmf = np.diff(c)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, pmf, float(c[0]), float(1.0 - c[-1])


def _compose(cdf: Callable, steps: int, eps_max: float, eps_error: float
             ) -> _ComposedPRV:
    """T-fold self-composition of the discretized PRV via FFT powering.

    The single-step PRV is discretized on a wide bracket, re-centered on
    its (grid-aligned) mean so the composed deviation stays small, and
    convolved by raising its DFT to the ``steps``-th power on a grid large
    enough that the concentrated composed mass cannot wrap around.
    """
    # --- moment probe on a coarse wide grid to size the final domain ---
    probe_g, probe_p, _, _ = _discretize(cdf, -80.0, 80.0, 1 << 14)
    tot = probe_p.sum()
    if tot <= 0:
        raise ValueError("degenerate PRV (no mass in probe window)")
    mu = float((probe_g * probe_p).sum() / tot)
    var = float((((probe_g - mu) ** 2) * probe_p).sum() / tot)
    std = math.sqrt(max(var, 1e-30))

    # mesh: fine enough for the eps budget after sqrt(T) random-walk
    # accumulation AND fine enough to resolve the single-step bulk — for
    # small sampling rates the PRV's std is tiny and a mesh sized only to
    # eps_error quantizes the whole distribution into a handful of bins,
    # biasing the composed mean by O(T * h)
    h = max(min(eps_error / math.sqrt(steps), std / 16.0), 1e-6)

    # composed deviation from T*mu concentrates in O(sqrt(T))*std; cover
    # 12 sigma, the single-step support, the queried eps range, and the
    # worst-case accumulated grid-alignment offset (h/2 per step)
    half = 12.0 * std * math.sqrt(steps) + 4.0 * std + eps_max + 4.0 \
        + 0.5 * steps * h
    n = int(2 ** math.ceil(math.log2(max(2.0 * half / h, 1024.0))))
    # n bins whose CENTERS are shift + (k - n//2) * h exactly: offsets from
    # the grid-aligned mean are integer multiples of h, so T-fold index
    # sums are exact
    shift = round(mu / h) * h  # grid-aligned single-step mean
    lo = shift - (n // 2) * h - 0.5 * h
    hi = shift + (n - n // 2) * h - 0.5 * h
    _, pmf, t_lo, t_hi = _discretize(cdf, lo, hi, n)

    # circular convolution is in OFFSET space: roll so offset 0 (the bin at
    # the single-step mean) sits at index 0, power the DFT, then roll back.
    # Without this, the T-fold center lands at (T*(n//2)) mod n, not n//2.
    rolled = np.roll(pmf, -(n // 2))
    f = np.fft.rfft(rolled)
    composed = np.fft.irfft(f ** steps, n=n)
    composed = np.maximum(np.roll(composed, n // 2), 0.0)
    # index j holds composed offset (j - n//2); each step contributed shift
    grid = (np.arange(n) - n // 2) * h + steps * shift
    # truncated single-step tails compound at most linearly
    return _ComposedPRV(grid=grid, pmf=composed,
                        tail_low=min(steps * t_lo, 1.0),
                        tail_high=min(steps * t_hi, 1.0))


# ----------------------------------------------------------------------
# public API (mirrors the submodule's PRVAccountant surface)
# ----------------------------------------------------------------------
class PRVAccountant:
    """Near-exact ``(eps_lower, eps_estimate, eps_upper)`` for T-fold
    Poisson-subsampled Gaussian composition.

    ``eps_error`` controls the discretization mesh: the pessimistic /
    optimistic readings differ by O(mesh * sqrt(T)) plus truncated tail
    mass, and the bracket returned is (optimistic, midpoint, pessimistic).
    """

    def __init__(self, noise_multiplier: float, sampling_probability: float,
                 max_steps: int, eps_error: float = 0.1):
        if noise_multiplier <= 0:
            raise ValueError("noise_multiplier must be > 0")
        if not 0.0 < sampling_probability <= 1.0:
            raise ValueError("sampling_probability must be in (0, 1]")
        if max_steps < 1:
            raise ValueError("max_steps must be >= 1")
        self.sigma = float(noise_multiplier)
        self.q = float(sampling_probability)
        self.max_steps = int(max_steps)
        self.eps_error = float(eps_error)
        self._cache = {}

    def _composed(self, direction: str, steps: int) -> _ComposedPRV:
        key = (direction, steps)
        if key not in self._cache:
            make = (_remove_direction_cdf if direction == "remove"
                    else _add_direction_cdf)
            self._cache[key] = _compose(make(self.q, self.sigma), steps,
                                        eps_max=64.0,
                                        eps_error=self.eps_error)
        return self._cache[key]

    def compute_delta(self, eps: float, num_steps: int) -> float:
        """Pessimistic ``delta(eps)`` after ``num_steps`` compositions
        (worse of the two adjacency directions)."""
        self._check(num_steps)
        return max(self._composed(d, num_steps).delta(eps, True)
                   for d in ("remove", "add"))

    def compute_epsilon(self, delta: float, num_steps: int
                        ) -> Tuple[float, float, float]:
        """``(eps_lower, eps_estimate, eps_upper)`` at ``delta`` after
        ``num_steps`` compositions — the submodule's CLI contract
        (reference ``README.md:168-171``)."""
        self._check(num_steps)
        if not 0.0 < delta < 1.0:
            raise ValueError("delta must be in (0, 1)")
        lowers, uppers = [], []
        for d in ("remove", "add"):
            prv = self._composed(d, num_steps)
            uppers.append(prv.epsilon(delta, pessimistic=True))
            lowers.append(prv.epsilon(delta, pessimistic=False))
        # midpoint-quantization of the single-step PRV contributes at most
        # mesh/2 per step; accumulated as a random walk its 4-sigma spread
        # is 2 * mesh * sqrt(T) <= 2 * eps_error — widen the bracket by it
        margin = 2.0 * self.eps_error
        eps_up = max(uppers) + margin
        eps_lo = max(0.0, max(lowers) - margin)
        return eps_lo, 0.5 * (eps_lo + eps_up), eps_up

    def _check(self, num_steps: int) -> None:
        if num_steps > self.max_steps:
            raise ValueError(
                f"num_steps={num_steps} exceeds max_steps={self.max_steps} "
                "the accountant was sized for")


def compute_dp_epsilon(sampling_probability: float, noise_multiplier: float,
                       iterations: int, delta: float,
                       eps_error: float = 0.1) -> dict:
    """One-call helper backing ``tools/compute_dp_epsilon.py`` (the
    submodule's ``compute-dp-epsilon`` CLI, reference ``README.md:168``)."""
    acc = PRVAccountant(noise_multiplier, sampling_probability,
                        max_steps=iterations, eps_error=eps_error)
    lo, est, up = acc.compute_epsilon(delta, iterations)
    return {"eps_lower": lo, "eps_estimate": est, "eps_upper": up,
            "delta": delta, "iterations": iterations,
            "sampling_probability": sampling_probability,
            "noise_multiplier": noise_multiplier}
