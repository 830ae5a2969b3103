"""Dataset contract — the port's own copy of ``msrflute_tpu/data/dataset.py``
(``BaseDataset``, ``ArraysDataset``, ``scrub_empty_clients``).

Per user, a dataset exposes fixed-width numpy arrays whose leading axis is
the user's sample count; featurization happens once at load time.
"""

from __future__ import annotations

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


def scrub_empty_clients(dataset: ArraysDataset) -> ArraysDataset:
    """Drop users with zero samples (reference ``utils/utils.py:563-582``)."""
    keep = [i for i, n in enumerate(dataset.num_samples) if n > 0]
    if len(keep) == len(dataset.num_samples):
        return dataset
    return ArraysDataset([dataset.user_list[i] for i in keep],
                         [dataset.user_arrays(i) for i in keep],
                         [dataset.num_samples[i] for i in keep])
