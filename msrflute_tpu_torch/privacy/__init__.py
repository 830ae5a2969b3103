"""Differential privacy — the port's counterpart of the on-device mechanisms
of ``msrflute_tpu/privacy/__init__.py`` (reference
``extensions/privacy/__init__.py``), over the round's flat buffers.

- :func:`compute_ldp_noise_std` — the Gaussian mechanism's sigma
  (reference ``:15-16``).
- :func:`apply_local_dp` — per client row of ``[K, P]`` (reference
  ``:154-201``): ``eps < 0`` clips to ``max_grad``; else the update is
  normalized to norm ``max_grad``, the scaled and clamped aggregation
  weight is appended, Gaussian noise at the joint sensitivity
  ``sqrt(max_grad^2 + max_weight^2)`` is added, and the weight is clamped
  and unscaled.  The noise ``z [K, P + 1]`` is an argument, so tests can
  hand in the JAX package's own draws; the round engine draws it from a
  per-client generator.
- :func:`apply_global_dp` — server-side noise of std
  ``global_sigma * max_grad / num_clients`` on the aggregate
  (reference ``:128-151``), through kernel B2 (:mod:`..ops.gaussian_noise`).

- :func:`update_privacy_accountant` — the host-side RDP accounting of the
  run so far (reference ``:204-260``), over :mod:`.accountant`, a copy of
  the JAX package's numpy / scipy accountant.  Neither server calls it: it
  is a library function in both packages.

The attack metrics live in :mod:`.attacks`.  PRV accounting (:mod:`.prv`)
and DP k-means (:mod:`.dp_kmeans`) are library functions off every path;
as in the JAX package, neither is imported here (the PRV accountant is
offline accounting, and importing it would load ``scipy.stats``).
"""

from __future__ import annotations

import logging
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.gaussian_noise import fused_gaussian_noise
from .accountant import DEFAULT_ORDERS, compute_rdp, get_privacy_spent  # noqa: F401


def compute_ldp_noise_std(eps: float, max_sensitivity: float,
                          delta: float) -> float:
    """Gaussian-mechanism sigma (reference ``:15-16``)."""
    return float(np.sqrt(2.0 * np.log(1.25 / delta)) * max_sensitivity / eps)


def _row_norm(flat: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm`` of every row: ``sqrt(sum(x * x))``."""
    return torch.sqrt(torch.sum(flat * flat, dim=-1))


def _over(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` as one IEEE division (PyTorch spells a number over a
    tensor as a reciprocal and a product)."""
    return torch.full_like(den, num) / den


def apply_local_dp(flat: torch.Tensor, weight: torch.Tensor, dp_config,
                   add_weight_noise: bool, z: Optional[torch.Tensor] = None,
                   clip: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local DP of every client row: ``flat [K, P]``, ``weight [K]``, and
    ``z [K, P + 1]`` standard normals (unused, and may be ``None``, in the
    clip-only mode ``eps < 0``).  ``clip`` (a float32 scalar tensor, the
    adaptive clip of ``strategies/fedavg.py``) takes the place of
    ``max_grad`` where it is smaller (``clip_override``, reference
    ``privacy/__init__.py:133-199``); the noise keeps the static
    ``max_grad`` sensitivity, which bounds the clip.  Returns the new
    ``(flat, weight)``."""
    eps = float(dp_config.get("eps", -1.0))
    static_max_grad = float(dp_config.get("max_grad", 1.0))
    max_grad = static_max_grad
    if clip is not None:
        max_grad = torch.clamp(clip.to(torch.float32), max=static_max_grad)
    norm = torch.clamp(_row_norm(flat), min=1e-12)
    if eps < 0:
        over = (max_grad / norm if clip is not None
                else _over(max_grad, norm))
        scale = torch.clamp(over, max=1.0)
        return flat * scale[:, None], weight

    delta = float(dp_config.get("delta", 1e-7))
    max_weight = float(dp_config.get("max_weight", 100.0))
    min_weight = float(dp_config.get("min_weight", 0.0))
    weight_scaler = float(dp_config.get("weight_scaler", 1.0))
    if z is None or z.shape != (flat.shape[0], flat.shape[1] + 1):
        raise ValueError("apply_local_dp: z must be [K, P + 1] normals, got "
                         f"{None if z is None else tuple(z.shape)}")
    scaled_weight = torch.clamp(weight * weight_scaler, max=max_weight)
    normed = (max_grad * flat) / norm[:, None]
    max_sensitivity = math.sqrt(static_max_grad ** 2 + (
        max_weight ** 2 if add_weight_noise else 0.0))
    sigma = compute_ldp_noise_std(eps, max_sensitivity, delta)
    noisy = normed + sigma * z[:, :-1]
    noisy_weight = scaled_weight + sigma * z[:, -1]
    noisy_weight = torch.clamp(noisy_weight, min_weight, max_weight) \
        / torch.full_like(noisy_weight, weight_scaler)
    return noisy, (noisy_weight if add_weight_noise else weight)


def global_dp_sigma(dp_config, num_clients: float) -> float:
    """The float32 std of global DP's noise:
    ``global_sigma * max_grad / max(num_clients, 1)``."""
    sigma = float(dp_config.get("global_sigma", 0.0))
    max_grad = float(dp_config.get("max_grad", 1.0))
    return float(np.float32(sigma * max_grad)
                 / np.float32(max(float(num_clients), 1.0)))


def apply_global_dp(agg: torch.Tensor, dp_config, seed: int,
                    num_clients: float) -> torch.Tensor:
    """``agg [P] + sigma * N(0, 1)`` through kernel B2, its Philox stream
    keyed by ``seed``."""
    return fused_gaussian_noise(agg.contiguous(), 1.0,
                                global_dp_sigma(dp_config, num_clients),
                                seed)


def update_privacy_accountant(config, num_clients: int, curr_iter: int,
                              num_clients_curr_iter: int,
                              metrics=None) -> Optional[float]:
    """Host-side RDP accounting (``msrflute_tpu/privacy/__init__.py:
    202-246``): K, B, n, T, sigma and mu of the run so far, each logged to
    ``metrics`` (a :class:`..utils.logging.MetricsLog`) when one is given,
    and the RDP epsilon returned; None without local or global DP."""
    dp_config = getattr(config, "dp_config", None)
    if dp_config is None or not (dp_config.get("enable_global_dp", False) or
                                 dp_config.get("enable_local_dp", False)):
        return None
    from ..utils.logging import print_rank

    K = 1
    B = num_clients_curr_iter
    n = max(num_clients, 2)
    T_iters = curr_iter + 1
    delta = float(dp_config.get("delta") or
                  min(1e-7, 1.0 / (n * math.log(n))))
    if dp_config.get("global_sigma") in (None, 0.0):
        max_sensitivity = math.sqrt(
            float(dp_config.get("max_grad", 1.0)) ** 2 +
            float(dp_config.get("max_weight", 100.0)) ** 2)
        noise_scale = compute_ldp_noise_std(float(dp_config.get("eps", 1.0)),
                                            max_sensitivity, delta)
        global_sigma = noise_scale * math.sqrt(B) / max_sensitivity
    else:
        global_sigma = float(dp_config.get("global_sigma"))
        noise_scale = global_sigma * float(dp_config.get("max_grad", 1.0)) / B
    try:
        mu = K * B / n * math.sqrt(
            T_iters * math.exp((1.0 / global_sigma) ** 2 - 1))
    except OverflowError:
        mu = -1.0
    q = B / n
    rdp = compute_rdp(q, global_sigma, T_iters, DEFAULT_ORDERS)
    rdp_epsilon, opt_order = get_privacy_spent(DEFAULT_ORDERS, rdp, delta)
    props = {
        "dp_global_K": K, "dp_global_B": B, "dp_global_n": n,
        "dp_global_T": T_iters, "dp_sigma": global_sigma, "dp_global_mu": mu,
        "dp_epsilon_rdp": rdp_epsilon, "dp_opt_order": opt_order,
        "dp_delta": delta, "dp_noise_scale": noise_scale,
    }
    print_rank(f"DP accounting: {props}", loglevel=logging.DEBUG)
    if metrics is not None:
        for key, value in props.items():
            metrics.log(key, value, step=curr_iter)
    return rdp_epsilon
