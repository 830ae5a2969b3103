"""Static-shape round batching — the port's own copy of ``steps_for``,
``pack_round_batches`` and ``pack_eval_batches`` from
``msrflute_tpu/data/batching.py``.

The numpy code is the JAX package's, draw for draw: the same cohort and the
same ``np.random.Generator`` state give the same ``[K, S, B]`` grids and
masks in both packages, which is what makes trajectory parity possible.
A round's clients become arrays of static shape ``[K, S, B, ...]`` with a
``[K, S, B]`` sample mask; ragged client sizes are absorbed by masking.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from .dataset import BaseDataset


@dataclass
class RoundBatch:
    """One round's client data.

    arrays:       each ``[K, S, B, *feat]``
    sample_mask:  ``[K, S, B]`` — 1.0 for real samples
    num_samples:  ``[K]`` — real (capped) per-client sample counts
    client_mask:  ``[K]`` — 1.0 for real clients, 0.0 for padding
    client_ids:   ``[K]`` — dataset user indices (-1 for padding)
    """

    arrays: Dict[str, np.ndarray]
    sample_mask: np.ndarray
    num_samples: np.ndarray
    client_mask: np.ndarray
    client_ids: np.ndarray


def ceil_div(n: int, d: int) -> int:
    return -(-int(n) // int(d))


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (min 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def steps_for(max_samples: int, batch_size: int,
              desired_max_samples: Optional[int] = None) -> int:
    """Local-step count S: ``ceil(min(max, desired) / B)`` (reference
    ``desired_max_samples`` early stop, ``core/trainer.py:363-364``)."""
    cap = max_samples if desired_max_samples is None else min(
        max_samples, desired_max_samples)
    return max(1, ceil_div(cap, batch_size))


def _sample_cap(S: int, B: int, desired_max_samples: Optional[int]) -> int:
    """Batch-granular cap: the batch that crosses ``desired_max_samples``
    still trains in full, as in the reference."""
    if desired_max_samples is None:
        return S * B
    return min(S * B, ceil_div(desired_max_samples, B) * B)


def pack_round_batches(
    dataset: BaseDataset,
    client_indices: Sequence[int],
    batch_size: int,
    max_steps: int,
    rng: Optional[np.random.Generator] = None,
    desired_max_samples: Optional[int] = None,
    shuffle: bool = True,
) -> RoundBatch:
    """Assemble ``[K, S, B, ...]`` arrays for the sampled clients: per
    client, shuffle its samples with ``rng`` (one ``permutation`` draw per
    client, in cohort order; in order and with no draw when ``shuffle`` is
    false, as an eval packs them), truncate to the cap, and zero-pad."""
    rng = rng or np.random.default_rng(0)
    K = len(client_indices)
    S, B = max_steps, batch_size
    spec = dataset.element_spec
    ref = dataset.user_arrays(int(client_indices[0]) if K else 0)
    arrays = {k: np.zeros((K, S, B) + shape, dtype=ref[k].dtype)
              for k, shape in spec.items()}
    sample_mask = np.zeros((K, S, B), dtype=np.float32)
    num_samples = np.zeros((K,), dtype=np.float32)
    client_mask = np.zeros((K,), dtype=np.float32)
    client_ids = np.full((K,), -1, dtype=np.int32)

    cap = _sample_cap(S, B, desired_max_samples)
    for j, ci in enumerate(client_indices):
        user = dataset.user_arrays(int(ci))
        n = len(next(iter(user.values())))
        take = (rng.permutation(n) if shuffle else np.arange(n))[:cap]
        t = len(take)
        for k in spec:
            arrays[k][j].reshape((S * B,) + spec[k])[:t] = user[k][take]
        sample_mask[j].reshape(-1)[:t] = 1.0
        num_samples[j] = t
        client_mask[j] = 1.0
        client_ids[j] = ci
    return RoundBatch(arrays, sample_mask, num_samples, client_mask,
                      client_ids)


def pack_eval_batches(dataset: BaseDataset,
                      batch_size: int) -> Dict[str, np.ndarray]:
    """Flatten eval users into ``[T, B, ...]`` batches with a
    ``sample_mask`` and a ``user_idx`` grid."""
    idxs = list(range(len(dataset)))
    spec = dataset.element_spec
    total = sum(int(dataset.num_samples[i]) for i in idxs)
    T = max(1, math.ceil(total / batch_size))
    B = batch_size
    first = dataset.user_arrays(idxs[0]) if idxs else {}
    out = {k: np.zeros((T * B,) + shape, dtype=first[k].dtype)
           for k, shape in spec.items()}
    mask = np.zeros((T * B,), dtype=np.float32)
    user_idx = np.full((T * B,), -1, dtype=np.int32)
    pos = 0
    for i in idxs:
        user = dataset.user_arrays(i)
        n = len(next(iter(user.values())))
        for k, arr in user.items():
            out[k][pos:pos + n] = arr
        mask[pos:pos + n] = 1.0
        user_idx[pos:pos + n] = i
        pos += n
    batched = {k: v.reshape((T, B) + v.shape[1:]) for k, v in out.items()}
    batched["sample_mask"] = mask.reshape(T, B)
    batched["user_idx"] = user_idx.reshape(T, B)
    return batched
