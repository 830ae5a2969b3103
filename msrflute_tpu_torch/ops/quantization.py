"""Gradient quantization — the port's counterpart of
``msrflute_tpu/ops/quantization.py`` (reference
``extensions/quantization/quant.py:9-100``), over the round's flat
``[K, P]`` payload.

Per client and per parameter leaf: ``lo``/``hi`` are the leaf's min and
max, the threshold is the ``quant_threshold`` quantile of ``|g|``, and
kernel B3 (:mod:`.quant_bin`) bins every element to the nearest of
``2 ** quant_bits`` levels between ``lo`` and ``hi`` and zeroes those whose
magnitude is not strictly above the threshold.  Min, max and quantile are
PyTorch reductions, as the JAX package leaves them to XLA.

The exact quantile repeats ``jnp.quantile``'s linear interpolation
(``jax/_src/numpy/reductions.py::_quantile``) op for op on a sorted row;
``torch.quantile`` is not used, as it refuses inputs above 16M elements.
``approx_quantile_abs`` is the JAX package's O(n) histogram-CDF estimate
(``client_config.quant_approx``), with integer counts.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from .quant_bin import quant_bin_sparsify

Scalar = Union[float, torch.Tensor]


def _as_q(q: Scalar, ref: torch.Tensor) -> torch.Tensor:
    """``q`` as a float32 scalar on ``ref``'s device, filled there (a copy
    from the host would wait for the stream)."""
    if isinstance(q, torch.Tensor):
        return q.to(dtype=torch.float32, device=ref.device)
    return _full(float(q), ref)


def _full(value: float, ref: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=ref.device)


def exact_quantile_abs(a: torch.Tensor, q: Scalar) -> torch.Tensor:
    """``jnp.quantile(a[k], q)`` (linear) for every row of ``a [K, n]``
    (``a`` holds magnitudes); a row with a NaN gives NaN, as in JAX."""
    n = a.shape[-1]
    q = _as_q(q, a)
    qn = q * _full(float(np.float32(n) - np.float32(1)), a)
    low, high = torch.floor(qn), torch.ceil(qn)
    high_weight = qn - low
    low_weight = 1 - high_weight
    low = torch.clamp(low, 0, n - 1).long()
    high = torch.clamp(high, 0, n - 1).long()
    ordered = torch.sort(a, dim=-1).values
    # index_select, not ordered[:, low]: indexing by a 0-d tensor reads it
    # on the host, a sync
    result = (ordered.index_select(1, low.reshape(1))[:, 0] * low_weight) \
        + (ordered.index_select(1, high.reshape(1))[:, 0] * high_weight)
    return torch.where(torch.isnan(a).any(dim=-1),
                       torch.full_like(result, float("nan")), result)


def approx_quantile_abs(a: torch.Tensor, q: Scalar,
                        n_bins: int = 2048) -> torch.Tensor:
    """Histogram-CDF approximation of the ``q`` quantile of every row of
    ``a [K, n]`` (magnitudes), interpolated inside the bin where the CDF
    crosses ``q``.  Error at most one bin width, ``max|x| / n_bins``.
    Counts are integers: float32 counts stop at 2^24."""
    K, n = a.shape
    q = _as_q(q, a)
    hi = torch.clamp(a.amax(dim=-1), min=1e-30)
    idx = torch.clamp((a / hi[:, None] * n_bins).to(torch.int32), 0,
                      n_bins - 1)
    rows = torch.arange(K, device=a.device)[:, None] * n_bins
    counts = torch.bincount((idx + rows).reshape(-1),
                            minlength=K * n_bins).reshape(K, n_bins)
    cdf = torch.cumsum(counts, dim=-1).to(torch.float32) / _full(float(n), a)
    bin_i = torch.argmax((cdf >= q).to(torch.uint8), dim=-1, keepdim=True)
    prev = torch.where(bin_i > 0,
                       cdf.gather(-1, torch.clamp(bin_i - 1, min=0)),
                       torch.zeros_like(cdf[:, :1]))
    frac = (q - prev) / torch.clamp(cdf.gather(-1, bin_i) - prev, min=1e-12)
    est = (bin_i.to(torch.float32) + torch.clamp(frac, 0.0, 1.0)) \
        * hi[:, None] / n_bins
    return est[:, 0]


def _quantize(flat: torch.Tensor, offsets: Sequence[int], q: Scalar,
              n_bins: int, approx: bool,
              offsets_dev: Optional[torch.Tensor]) -> torch.Tensor:
    lo, hi, thresh = [], [], []
    for a, b in zip(offsets[:-1], offsets[1:]):
        g = flat[:, a:b]
        lo.append(g.amin(dim=-1))
        hi.append(g.amax(dim=-1))
        mag = torch.abs(g)
        thresh.append(approx_quantile_abs(mag, q) if approx
                      else exact_quantile_abs(mag, q))
    if offsets_dev is None:
        offsets_dev = torch.tensor(list(offsets), dtype=torch.int64,
                                   device=flat.device)
    return quant_bin_sparsify(flat.contiguous(), offsets_dev,
                              torch.stack(lo, dim=1), torch.stack(hi, dim=1),
                              torch.stack(thresh, dim=1), n_bins)


def quantize_pytree(flat: torch.Tensor, offsets: Sequence[int],
                    quant_threshold: Optional[Scalar], quant_bits: int = 8,
                    approx: bool = False,
                    offsets_dev: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Quantize every leaf of every client row of ``flat [K, P]`` to
    ``2 ** quant_bits`` levels; the leaves are ``flat[:, offsets[l]:
    offsets[l + 1]]``.  ``offsets_dev`` is ``offsets`` as an int64 tensor
    on ``flat``'s device (made here when not given).  A ``None`` threshold
    quantizes nothing."""
    if quant_threshold is None:
        return flat
    return _quantize(flat, offsets, quant_threshold, 2 ** int(quant_bits),
                     approx, offsets_dev)

