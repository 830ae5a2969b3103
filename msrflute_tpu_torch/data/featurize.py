"""Featurization — the port's own copy of ``to_image`` from
``msrflute_tpu/data/featurize.py``."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def to_image(x: np.ndarray, example_shape: Sequence[int]) -> np.ndarray:
    """Reshape flat/CHW/HW samples to the task's example shape.

    Dtype-preserving: uint8 pixels stay uint8 (models normalize on the
    device, see ``models.base.to_float_image``); integer pixel values in
    [0, 255] become uint8; anything else becomes float32.
    """
    x = np.asarray(x)
    if x.dtype != np.uint8:
        if x.dtype.kind in "iu" and x.size and 0 <= x.min() and x.max() <= 255:
            x = x.astype(np.uint8)
        else:
            x = x.astype(np.float32)
    target = tuple(example_shape)
    n = x.shape[0]
    if x.shape[1:] == target:
        return x
    if x.ndim == 4 and x.shape[1] in (1, 3) and \
            (x.shape[2], x.shape[3], x.shape[1]) == target:
        return np.transpose(x, (0, 2, 3, 1))   # CHW -> HWC
    if x.ndim == 3 and x.shape[1:] + (1,) == target:
        return x[..., None]                    # HW -> HW1
    if int(np.prod(x.shape[1:])) == int(np.prod(target)):
        return x.reshape((n,) + target)
    raise ValueError(f"cannot reshape samples {x.shape} to {target}")
