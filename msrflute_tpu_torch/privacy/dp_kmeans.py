"""Differentially-private k-means.

The port's copy of ``msrflute_tpu/privacy/dp_kmeans.py``, numpy and
scipy only, equal to it on the same inputs and generator state.

Parity target: reference ``extensions/privacy/dp_kmeans.py`` — a research
tool with (a) sphere-packing initialization: centers sampled uniformly in a
ball, rejecting candidates within ``2 * min_cluster_radius`` of existing
centers and halving the radius after ``max_failed_cases`` rejections
(``dp_kmeans.py:23-48``); and (b) noisy Lloyd iterations: per iteration the
cluster sums and weights get Gaussian noise calibrated to
``sqrt(max_cluster_l2^2 + max_sample_weight^2)`` sensitivity with the
optional ``cluster_to_weight_ratio`` weight re-scaling trick
(``dp_kmeans.py:51-74``).

The reference monkey-patches sklearn's Lloyd internals; here the Lloyd loop
is a self-contained numpy implementation (the tool is host-side and tiny —
clustering client embeddings, not a hot path).  Per-iteration epsilon, so
total privacy loss <= eps * n_iter as in the reference docstring.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.special import gammainc


def _sample_ball(rng: np.random.Generator, ndim: int, radius: float,
                 num_samples: int = 1) -> np.ndarray:
    """Uniform samples in an ``ndim``-ball (reference ``sample``,
    ``dp_kmeans.py:14-20``)."""
    x = rng.normal(size=(num_samples, ndim))
    ssq = np.sum(x ** 2, axis=1)
    fr = radius * gammainc(ndim / 2, ssq / 2) ** (1 / ndim) / \
        np.maximum(np.sqrt(ssq), 1e-12)
    return x * fr[:, None]


def sphere_packing_initialization(n_clusters: int, n_dim: int,
                                  min_cluster_radius: float,
                                  max_space_size: float,
                                  max_failed_cases: int = 300,
                                  rng: Optional[np.random.Generator] = None,
                                  verbose: bool = False
                                  ) -> Tuple[np.ndarray, float]:
    """Rejection-sample centers at pairwise distance >= 2a
    (reference ``dp_kmeans.py:23-48``)."""
    rng = rng or np.random.default_rng(0)
    a = min_cluster_radius
    centers = np.empty((n_clusters, n_dim))
    cluster_id = 0
    fail_count = 0
    r = max_space_size - a
    while cluster_id < n_clusters:
        v = _sample_ball(rng, n_dim, r)[0]
        if cluster_id > 0 and np.min(np.linalg.norm(
                centers[:cluster_id] - v, axis=-1)) < 2 * a:
            fail_count += 1
            if fail_count >= max_failed_cases:
                fail_count = 0
                cluster_id = 0
                a = a / 2
                if verbose:
                    print(f"halving min_cluster_radius to {a}")
                r = max_space_size - a
            continue
        centers[cluster_id] = v
        cluster_id += 1
    return centers, a


def _noisy_update(x: np.ndarray, labels: np.ndarray, n_clusters: int,
                  eps: float, max_cluster_l2: float, max_sample_weight: float,
                  cluster_to_weight_ratio: float, delta: float,
                  rng: np.random.Generator) -> np.ndarray:
    """One DP Lloyd M-step (reference ``add_gaussian_noise``,
    ``dp_kmeans.py:51-74``)."""
    scaler = 1.0
    if cluster_to_weight_ratio > 0:
        scaler = max_cluster_l2 / (max_sample_weight * cluster_to_weight_ratio)
    scaled_max_weight = max_sample_weight * scaler
    sensitivity = np.sqrt(max_cluster_l2 ** 2 + scaled_max_weight ** 2)
    sigma = np.sqrt(2 * np.log(1.25 / delta)) * sensitivity / eps

    sums = np.zeros((n_clusters, x.shape[1]))
    weights = np.zeros((n_clusters,))
    for c in range(n_clusters):
        members = x[labels == c]
        sums[c] = members.sum(axis=0)
        weights[c] = len(members)
    sums += rng.normal(scale=sigma, size=sums.shape)
    weights = np.maximum(
        1e-10, weights * scaler + rng.normal(scale=sigma, size=weights.shape)
    ) / scaler
    return sums / weights[:, None]


def dp_kmeans(x: np.ndarray, n_clusters: int = 8, eps: float = 1.0,
              max_cluster_l2: float = 1.0, max_sample_weight: float = 1.0,
              max_iter: int = 300, tol: float = 1e-4,
              cluster_to_weight_ratio: float = -1.0, delta: float = 1e-7,
              max_failed_cases: int = 300,
              min_cluster_radius: Optional[float] = None,
              seed: int = 0, verbose: bool = False
              ) -> Tuple[np.ndarray, np.ndarray, int]:
    """DP k-means over row vectors clipped to ``max_cluster_l2``.

    Returns (centers, labels, n_iter).  Total privacy loss <=
    ``eps * n_iter`` (per-iteration epsilon, as in the reference).
    """
    rng = np.random.default_rng(seed)
    x = np.asarray(x, np.float64)
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    x = x * np.minimum(1.0, max_cluster_l2 / np.maximum(norms, 1e-12))

    if min_cluster_radius is None:
        min_cluster_radius = max_cluster_l2 / (2.0 * n_clusters)
    centers, _ = sphere_packing_initialization(
        n_clusters, x.shape[1], min_cluster_radius, max_cluster_l2,
        max_failed_cases, rng, verbose)

    labels = np.zeros((len(x),), np.int64)
    for it in range(1, max_iter + 1):
        dists = np.linalg.norm(x[:, None, :] - centers[None], axis=-1)
        labels = np.argmin(dists, axis=1)
        new_centers = _noisy_update(
            x, labels, n_clusters, eps, max_cluster_l2, max_sample_weight,
            cluster_to_weight_ratio, delta, rng)
        shift = np.linalg.norm(new_centers - centers)
        centers = new_centers
        if shift < tol:
            break
    return centers, labels, it
