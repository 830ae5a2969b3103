"""Reader for FLUTE's "user blob" federated dataset format — the port's own
copy of ``msrflute_tpu/data/user_blob.py``, trimmed to the JSON layout.

A blob holds ``users`` (or ``user_list``), ``num_samples``, ``user_data``
(user id -> ``{'x': [...]}`` or a bare list) and optionally
``user_data_label`` (reference ``doc/sphinx/scenarios.rst:5-33``).  An
entry with streams beside ``x`` and ``y`` (semisupervision's unlabeled
``ux`` and ``ux_rand``) is kept whole for the task's featurizer.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, List, Optional

from ..config import NOT_PORTED


@dataclass
class UserBlob:
    user_list: List[str]
    num_samples: List[int]
    user_data: List[Any]
    user_labels: Optional[List[Any]] = None

    def __len__(self) -> int:
        return len(self.user_list)


def _normalize_samples(entry: Any) -> Any:
    if isinstance(entry, dict) and "x" in entry:
        if set(entry.keys()) - {"x", "y"}:
            return entry
        return entry["x"]
    return entry


def _entry_len(entry: Any) -> int:
    if isinstance(entry, dict):
        return len(entry.get("x", next(iter(entry.values()), [])))
    return len(entry)


def _labels_of(entry: Any) -> Optional[Any]:
    if isinstance(entry, dict) and "y" in entry:
        return entry["y"]
    return None


def load_user_blob(path: str) -> UserBlob:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".hdf5", ".h5"):
        raise NotImplementedError(f"hdf5 user blobs are {NOT_PORTED}")
    if ext not in (".json", ".txt"):
        raise ValueError(f"unsupported user-blob extension: {path}")
    with open(path, "r") as fh:
        blob = json.load(fh)
    users = blob.get("users", blob.get("user_list"))
    if users is None:
        raise ValueError(f"{path}: no 'users'/'user_list' key")
    user_data_map = blob.get("user_data", {})
    labels_map = blob.get("user_data_label")
    data, labels = [], []
    for user in users:
        entry = user_data_map.get(user, [])
        data.append(_normalize_samples(entry))
        if labels_map is not None:
            labels.append(labels_map[user] if isinstance(labels_map, dict)
                          else labels_map[len(labels)])
        else:
            labels.append(_labels_of(entry))
    have_labels = any(lab is not None for lab in labels)
    num_samples = blob.get("num_samples") or [_entry_len(d) for d in data]
    return UserBlob(user_list=list(users),
                    num_samples=[int(n) for n in num_samples],
                    user_data=data,
                    user_labels=labels if have_labels else None)
