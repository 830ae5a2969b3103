"""Host-side image augmentation — numpy RandAugment, the port's own copy of
``msrflute_tpu/data/augment.py``.

Parity target: reference ``experiments/semisupervision/dataloaders/
RandAugment.py`` (the public Cubuk et al. policy: pick N ops at magnitude M
from a fixed list), vectorized over a sample batch in numpy/scipy and run
once at featurize time, so a round only ever sees fixed-shape arrays
(``ux_rand`` in the FedLabels ``uda: 1`` path, ``strategies/fedlabels.py``).
The code is the JAX package's, draw for draw: one
``np.random.default_rng`` seed gives both packages the same images, bit for
bit (``tests/test_torch_augment.py``).

Value semantics: images may arrive as uint8 [0,255] or float (any range).
Ops are defined on a normalized [0,1] view and the original scale/dtype is
restored on the way out, so the augmented view stays distribution-compatible
with the clean view the way the reference's PIL pipeline does.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

# each op: (name, fn(img01, magnitude01, rng) -> img01, uses_magnitude)
# magnitudes follow the reference ranges (RandAugment.py:167-196), mapped
# onto the normalized [0,1] pixel view.


def _affine(img: np.ndarray, matrix: np.ndarray, offset) -> np.ndarray:
    from scipy import ndimage
    if img.ndim == 2:
        return ndimage.affine_transform(img, matrix, offset=offset,
                                        order=1, mode="nearest")
    out = np.empty_like(img)
    for c in range(img.shape[-1]):
        out[..., c] = ndimage.affine_transform(img[..., c], matrix,
                                               offset=offset, order=1,
                                               mode="nearest")
    return out


def _shear_x(img, m, rng):
    v = (m * 0.6 - 0.3) * _sign(rng)
    mat = np.array([[1.0, 0.0], [v, 1.0]])
    return _affine(img, mat, offset=(0.0, -v * img.shape[0] / 2))


def _shear_y(img, m, rng):
    v = (m * 0.6 - 0.3) * _sign(rng)
    mat = np.array([[1.0, v], [0.0, 1.0]])
    return _affine(img, mat, offset=(-v * img.shape[1] / 2, 0.0))


def _translate_x(img, m, rng):
    v = m * 0.45 * _sign(rng) * img.shape[1]
    return _affine(img, np.eye(2), offset=(0.0, v))


def _translate_y(img, m, rng):
    v = m * 0.45 * _sign(rng) * img.shape[0]
    return _affine(img, np.eye(2), offset=(v, 0.0))


def _rotate(img, m, rng):
    from scipy import ndimage
    angle = m * 30.0 * _sign(rng)
    if img.ndim == 2:
        return ndimage.rotate(img, angle, reshape=False, order=1,
                              mode="nearest")
    out = np.empty_like(img)
    for c in range(img.shape[-1]):
        out[..., c] = ndimage.rotate(img[..., c], angle, reshape=False,
                                     order=1, mode="nearest")
    return out


def _auto_contrast(img, m, rng):
    lo, hi = img.min(), img.max()
    if hi - lo < 1e-6:
        return img
    return (img - lo) / (hi - lo)


def _invert(img, m, rng):
    return 1.0 - img


def _equalize(img, m, rng):
    # histogram equalization on the [0,1] view (256 bins, like PIL)
    flat = img.reshape(-1)
    hist, bins = np.histogram(flat, bins=256, range=(0.0, 1.0))
    cdf = np.cumsum(hist).astype(np.float64)
    if cdf[-1] == 0:
        return img
    cdf = cdf / cdf[-1]
    return np.interp(flat, bins[:-1], cdf).reshape(img.shape).astype(
        img.dtype)


def _solarize(img, m, rng):
    thresh = 1.0 - m  # magnitude 0 -> no-op threshold 1.0
    return np.where(img >= thresh, 1.0 - img, img)


def _posterize(img, m, rng):
    bits = max(int(round(8 - 4 * m)), 1)  # 8 -> 4 bits over the range
    levels = 2 ** bits
    return np.floor(img * (levels - 1) + 0.5) / (levels - 1)


def _contrast(img, m, rng):
    f = 0.1 + m * 1.8  # reference range [0.1, 1.9]
    mean = img.mean()
    return np.clip((img - mean) * f + mean, 0.0, 1.0)


def _brightness(img, m, rng):
    f = 0.1 + m * 1.8
    return np.clip(img * f, 0.0, 1.0)


def _cutout(img, m, rng):
    frac = m * 0.2
    h, w = img.shape[0], img.shape[1]
    ch, cw = int(h * frac), int(w * frac)
    if ch == 0 or cw == 0:
        return img
    cy = int(rng.integers(0, h))
    cx = int(rng.integers(0, w))
    y0, y1 = max(cy - ch // 2, 0), min(cy + ch // 2, h)
    x0, x1 = max(cx - cw // 2, 0), min(cx + cw // 2, w)
    out = img.copy()
    out[y0:y1, x0:x1] = 0.5  # grey fill (reference fills (125,123,114))
    return out


def _identity(img, m, rng):
    return img


def _sign(rng) -> float:
    return 1.0 if rng.random() < 0.5 else -1.0


AUGMENT_OPS: List[Tuple[str, Callable]] = [
    ("identity", _identity),
    ("shear_x", _shear_x),
    ("shear_y", _shear_y),
    ("translate_x", _translate_x),
    ("translate_y", _translate_y),
    ("rotate", _rotate),
    ("auto_contrast", _auto_contrast),
    ("invert", _invert),
    ("equalize", _equalize),
    ("solarize", _solarize),
    ("posterize", _posterize),
    ("contrast", _contrast),
    ("brightness", _brightness),
    ("cutout", _cutout),
]


def rand_augment(images: np.ndarray, num_ops: int = 2, magnitude: int = 9,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Apply RandAugment(N=num_ops, M=magnitude/30) per image.

    ``images``: [B, H, W] or [B, H, W, C]; returns same shape/dtype.
    Flat-vector inputs (e.g. 784-dim rows) pass through with additive
    jitter only — geometric ops need spatial structure.
    """
    rng = rng or np.random.default_rng(0)
    x = np.asarray(images)
    if x.ndim < 3:  # no spatial structure: noise view only
        scale = max(float(np.std(x)), 1e-6)
        return (x + 0.05 * scale * rng.standard_normal(x.shape)).astype(
            x.dtype)
    # normalize to [0,1]
    if np.issubdtype(x.dtype, np.integer):
        lo, span = 0.0, float(np.iinfo(x.dtype).max)
    else:
        lo = float(x.min())
        span = max(float(x.max()) - lo, 1e-6)
    m01 = min(max(magnitude / 30.0, 0.0), 1.0)
    out = np.empty_like(x)
    for i in range(len(x)):
        img = ((x[i].astype(np.float32)) - lo) / span
        for k in range(num_ops):
            name, fn = AUGMENT_OPS[int(rng.integers(len(AUGMENT_OPS)))]
            img = fn(img, m01, rng)
        img = np.clip(img, 0.0, 1.0) * span + lo
        if np.issubdtype(x.dtype, np.integer):
            img = np.rint(img)
        out[i] = img.astype(x.dtype)
    return out
