"""Fleet-scale populations — the port's own copy of
``msrflute_tpu/data/fleet.py`` (``:85-290``), draw for draw, less
``lane_shard_map``, which places cohort lanes on the shards of a multi-device
mesh.

Population size is a free variable: a round's host work and memory are
O(cohort) or O(cache), never O(N).

- :func:`floyd_sample` and :func:`weighted_reservoir_sample` draw a cohort
  without an O(N) array (Floyd's algorithm; the Efraimidis-Spirakis
  exponential-key reservoir over the weights in bounded chunks).
  :func:`sample_cohort` is ``server_config.fleet.sampling``: ``uniform``
  keeps numpy's ``Generator.choice`` (already O(cohort), and the trail of a
  run without a ``fleet`` block), ``floyd`` and ``by_samples`` start new
  trails, deterministic and resume-stable within them.
- :class:`SyntheticFleetDataset` is a seeded synthetic population of any
  size: its ``num_samples`` is one vectorized int32 draw (4 bytes a user),
  its names a :class:`LazyNameList`, and each user's arrays are made on
  demand behind a bounded LRU cache.
- :func:`steps_for_array` (kept in :mod:`.batching`) is the one vectorized
  pass over the population's sample counts that the server's set-up needs.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Sequence

import numpy as np

from .batching import steps_for_array
from .dataset import BaseDataset

__all__ = [
    "floyd_sample", "weighted_reservoir_sample", "sample_cohort",
    "steps_for_array", "LazyNameList", "SyntheticFleetDataset",
]


# ----------------------------------------------------------------------
# O(cohort) samplers
# ----------------------------------------------------------------------
def floyd_sample(rng: np.random.Generator, population: int,
                 k: int) -> list:
    """``k`` distinct uniform indices from ``range(population)`` in
    O(k) time and memory (Robert Floyd's sampling algorithm), followed
    by an O(k) shuffle so cohort ORDER is uniform too (Floyd's raw
    output is biased toward placing large indices late, and cohort
    order feeds the packing shuffle trail).

    Deterministic in the generator state; consumes exactly ``k``
    ``integers`` draws plus one length-``k`` ``shuffle``.
    """
    population = int(population)
    k = int(min(k, population))
    chosen: set = set()
    out = []
    for j in range(population - k, population):
        t = int(rng.integers(0, j + 1))
        if t in chosen:
            t = j
        chosen.add(t)
        out.append(t)
    out = np.asarray(out, dtype=np.int64)
    rng.shuffle(out)
    return [int(i) for i in out]


def weighted_reservoir_sample(rng: np.random.Generator, weights,
                              k: int, chunk: int = 65536) -> list:
    """``k`` distinct indices drawn without replacement with
    probability proportional to ``weights`` — the Efraimidis–Spirakis
    A-Res reservoir: key ``u_i^(1/w_i)`` per item, keep the top-k.

    ``weights`` is any sequence/array-like of non-negative numbers;
    it is consumed in ``chunk``-sized slices, so peak memory is
    O(k + chunk) no matter the population size.  Zero-weight users are
    never sampled.  Returns indices in descending-key order (uniform
    given the weights), as a plain int list.
    """
    k = int(k)
    if k <= 0:
        return []
    best_keys = np.empty((0,), np.float64)
    best_idx = np.empty((0,), np.int64)
    n = len(weights)
    for lo in range(0, n, int(chunk)):
        w = np.asarray(weights[lo:lo + int(chunk)], np.float64)
        u = rng.random(w.shape[0])
        with np.errstate(divide="ignore"):
            keys = np.where(w > 0, u ** (1.0 / np.maximum(w, 1e-300)),
                            -1.0)
        keys = np.where(w > 0, keys, -1.0)
        cand_keys = np.concatenate([best_keys, keys])
        cand_idx = np.concatenate(
            [best_idx, np.arange(lo, lo + w.shape[0], dtype=np.int64)])
        live = cand_keys >= 0
        cand_keys, cand_idx = cand_keys[live], cand_idx[live]
        if cand_keys.shape[0] > k:
            top = np.argpartition(cand_keys, -k)[-k:]
            cand_keys, cand_idx = cand_keys[top], cand_idx[top]
        best_keys, best_idx = cand_keys, cand_idx
    order = np.argsort(-best_keys, kind="stable")
    return [int(i) for i in best_idx[order]]


def sample_cohort(rng: np.random.Generator, population: int, k: int,
                  mode: str = "uniform",
                  num_samples=None) -> list:
    """The ``fleet`` block's cohort draw.

    ``uniform`` (the default) is numpy ``Generator.choice`` without
    replacement — already O(cohort) (Floyd's algorithm internally) AND
    trail-identical to the non-fleet server path, so plain fleet runs
    stay bit-comparable to resident runs.  ``floyd`` is this module's
    explicit Floyd implementation (useful where numpy's algorithm is
    not contractual); ``by_samples`` is the sample-count-weighted
    reservoir.  The latter two draw NEW rng trails.
    """
    k = int(min(k, population))
    if mode == "uniform":
        return list(rng.choice(int(population), size=k, replace=False))
    if mode == "floyd":
        return floyd_sample(rng, population, k)
    if mode == "by_samples":
        if num_samples is None:
            raise ValueError(
                "fleet.sampling: by_samples needs the population's "
                "num_samples metadata")
        return weighted_reservoir_sample(rng, num_samples, k)
    raise ValueError(f"unknown fleet.sampling mode {mode!r} "
                     "(uniform | floyd | by_samples)")


# ----------------------------------------------------------------------
# fleet-scale synthetic population
# ----------------------------------------------------------------------
class LazyNameList(Sequence):
    """``["u0", "u1", ...]`` without materializing N strings — the
    ``user_list`` of a fleet population (names are only ever read for
    log lines and per-user blob keys)."""

    def __init__(self, n: int, prefix: str = "u"):
        self._n = int(n)
        self._prefix = prefix

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._n))]
        i = int(i)
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        return f"{self._prefix}{i}"


class SyntheticFleetDataset(BaseDataset):
    """Deterministic synthetic classification population of arbitrary
    size — the 10^6-user smoke workload.

    Host cost is O(cache) + one int32 metadata array:

    - ``num_samples`` is a single vectorized seeded draw (the "one
      streaming metadata pass"): 75% tiny users of ``base_samples``
      plus a heavy tail at 2/4/8x, the skew cohort bucketing is for;
    - ``user_arrays(i)`` regenerates user ``i``'s features from
      ``default_rng((seed, i))`` on demand, behind a bounded LRU cache
      with hit/miss/eviction counters (the same cache-stats contract
      as :class:`~.dataset.LazyUserDataset`).
    """

    def __init__(self, num_users: int, input_dim: int = 8,
                 num_classes: int = 4, base_samples: int = 8,
                 seed: int = 0, cache_users: int = 256):
        n = int(num_users)
        self.input_dim = int(input_dim)
        self.num_classes = int(num_classes)
        self.seed = int(seed)
        self.user_list = LazyNameList(n)
        # one vectorized metadata draw: int32, 4 bytes/user
        meta_rng = np.random.default_rng([self.seed, 0x1F1EE7, n])
        counts = np.full((n,), int(base_samples), np.int32)
        tail = meta_rng.integers(1, 4, size=(n + 3) // 4).astype(np.int32)
        counts[::4] = int(base_samples) * (2 ** tail)
        self.num_samples = counts
        self._cache: "OrderedDict[int, Dict[str, np.ndarray]]" = \
            OrderedDict()
        self._cache_users = max(int(cache_users), 1)
        self._cache_lock = threading.Lock()
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_evictions = 0

    def __len__(self) -> int:
        return len(self.user_list)

    def cache_stats(self) -> Dict[str, int]:
        """Monotone hit/miss/eviction counters plus the live resident
        size."""
        with self._cache_lock:
            return {"hits": self.cache_hits, "misses": self.cache_misses,
                    "evictions": self.cache_evictions,
                    "resident": len(self._cache)}

    def user_arrays(self, user_idx: int) -> Dict[str, np.ndarray]:
        user_idx = int(user_idx)
        with self._cache_lock:
            if user_idx in self._cache:
                self.cache_hits += 1
                self._cache.move_to_end(user_idx)
                return self._cache[user_idx]
            self.cache_misses += 1
        n = int(self.num_samples[user_idx])
        rng = np.random.default_rng([self.seed, 0xF7EE7, user_idx])
        y = rng.integers(0, self.num_classes, n).astype(np.int32)
        # class-conditioned means so the protocol actually learns
        x = (rng.normal(size=(n, self.input_dim)).astype(np.float32)
             + (y[:, None] - (self.num_classes - 1) / 2.0)
             .astype(np.float32))
        arrays = {"x": x, "y": y}
        with self._cache_lock:
            self._cache[user_idx] = arrays
            if len(self._cache) > self._cache_users:
                self._cache.popitem(last=False)
                self.cache_evictions += 1
        return arrays
