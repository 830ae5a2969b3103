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

The attack metrics live in :mod:`.attacks`.  The RDP accountant, PRV
accounting and DP k-means are off the ported path (the JAX server calls
no accountant) and are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.gaussian_noise import fused_gaussian_noise


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
                   add_weight_noise: bool, z: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local DP of every client row: ``flat [K, P]``, ``weight [K]``, and
    ``z [K, P + 1]`` standard normals (unused, and may be ``None``, in the
    clip-only mode ``eps < 0``).  Returns the new ``(flat, weight)``."""
    eps = float(dp_config.get("eps", -1.0))
    max_grad = float(dp_config.get("max_grad", 1.0))
    norm = torch.clamp(_row_norm(flat), min=1e-12)
    if eps < 0:
        scale = torch.clamp(_over(max_grad, norm), max=1.0)
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
    max_sensitivity = math.sqrt(max_grad ** 2 + (max_weight ** 2
                                                 if add_weight_noise else 0.0))
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
