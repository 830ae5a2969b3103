"""Dataset contract — the port's own copy of ``msrflute_tpu/data/dataset.py``
(``BaseDataset``, ``ArraysDataset``, ``scrub_empty_clients`` and
``LazyUserDataset``).

Per user, a dataset exposes fixed-width numpy arrays whose leading axis is
the user's sample count.  :class:`ArraysDataset` featurizes every user once
at load time; :class:`LazyUserDataset` (``data_config.train.lazy``) reads
and featurizes a user on first access, behind a bounded LRU cache, so a
round touches only its sampled users.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np


class BaseDataset:
    user_list: List[str]
    num_samples: List[int]

    def __len__(self) -> int:
        return len(self.user_list)

    def user_arrays(self, user_idx: int) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    @property
    def element_spec(self) -> Dict[str, tuple]:
        """Trailing (per-sample) shapes, derived from the first user."""
        return {k: tuple(v.shape[1:]) for k, v in self.user_arrays(0).items()}


class ArraysDataset(BaseDataset):
    """Per-user numpy arrays held in memory."""

    def __init__(self, user_list: Sequence[str],
                 per_user: Sequence[Dict[str, np.ndarray]],
                 num_samples: Optional[Sequence[int]] = None):
        if len(user_list) != len(per_user):
            raise ValueError("user_list and per_user length mismatch")
        self.user_list = list(user_list)
        self._per_user = list(per_user)
        if num_samples is None:
            num_samples = [len(next(iter(u.values()))) for u in per_user]
        self.num_samples = [int(n) for n in num_samples]
        for i, arrays in enumerate(self._per_user):
            lens = {k: len(v) for k, v in arrays.items()}
            if any(n != self.num_samples[i] for n in lens.values()):
                raise ValueError(
                    f"user {user_list[i]}: array lengths {lens} != "
                    f"num_samples {self.num_samples[i]}")

    def user_arrays(self, user_idx: int) -> Dict[str, np.ndarray]:
        return self._per_user[user_idx]


def scrub_empty_clients(dataset: BaseDataset) -> BaseDataset:
    """Drop users with zero samples (reference ``utils/utils.py:563-582``);
    a lazy dataset becomes a view over the rest, with no sample IO."""
    keep = [i for i, n in enumerate(dataset.num_samples) if n > 0]
    if len(keep) == len(dataset.num_samples):
        return dataset
    if isinstance(dataset, LazyUserDataset):
        return dataset.subset(keep)
    return ArraysDataset([dataset.user_list[i] for i in keep],
                         [dataset.user_arrays(i) for i in keep],
                         [dataset.num_samples[i] for i in keep])


class LazyUserDataset(BaseDataset):
    """Featurize-on-access dataset over a
    :class:`~.user_blob.LazyHDF5Users` handle (``msrflute_tpu/data/
    dataset.py:98-173``): a user's samples are read and featurized on first
    access and kept in an LRU cache of ``cache_users`` users, with the JAX
    package's hit, miss and eviction counters.

    ``featurize(data_entry, label_or_None) -> {name: array}`` runs once a
    user (default: the numeric passthrough, ``x`` float32 and ``y`` int32).
    """

    def __init__(self, users, featurize=None, cache_users: int = 256,
                 keep: Optional[Sequence[int]] = None):
        self._users = users
        self._featurize = featurize or _numeric_featurize_user
        self._idx = (list(range(len(users.user_list))) if keep is None
                     else list(keep))
        self.user_list = [users.user_list[i] for i in self._idx]
        self.num_samples = [users.num_samples[i] for i in self._idx]
        self._cache: "OrderedDict[int, Dict[str, np.ndarray]]" = \
            OrderedDict()
        self._cache_users = max(int(cache_users), 1)
        # a reader on another thread must not race an insert's eviction
        self._cache_lock = threading.Lock()
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_evictions = 0

    def cache_stats(self) -> Dict[str, int]:
        """Hit, miss and eviction counters and the resident users."""
        with self._cache_lock:
            return {"hits": self.cache_hits, "misses": self.cache_misses,
                    "evictions": self.cache_evictions,
                    "resident": len(self._cache)}

    def user_arrays(self, user_idx: int) -> Dict[str, np.ndarray]:
        with self._cache_lock:
            if user_idx in self._cache:
                self.cache_hits += 1
                self._cache.move_to_end(user_idx)
                return self._cache[user_idx]
            self.cache_misses += 1
        data, label = self._users.read(self.user_list[user_idx])
        arrays = self._featurize(data, label)
        # as loud as the eager dataset's construction check
        want = self.num_samples[user_idx]
        lens = {k: len(v) for k, v in arrays.items()}
        if any(n != want for n in lens.values()):
            raise ValueError(
                f"user {self.user_list[user_idx]}: blob num_samples says "
                f"{want} but arrays have {lens} rows")
        with self._cache_lock:
            self._cache[user_idx] = arrays
            if len(self._cache) > self._cache_users:
                self._cache.popitem(last=False)
                self.cache_evictions += 1
        return arrays

    def subset(self, keep: Sequence[int]) -> "LazyUserDataset":
        """A view over a subset of users, with no sample IO."""
        return LazyUserDataset(self._users, self._featurize,
                               self._cache_users,
                               keep=[self._idx[i] for i in keep])


def _numeric_featurize_user(data, label) -> Dict[str, np.ndarray]:
    """The per-user numeric passthrough: ``x`` float32, ``y`` int32."""
    return ({"x": np.asarray(data, dtype=np.float32)} if label is None else
            {"x": np.asarray(data, dtype=np.float32),
             "y": np.asarray(label).astype(np.int32)})
