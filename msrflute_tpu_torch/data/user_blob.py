"""Reader for FLUTE's "user blob" federated dataset format — the port's own
copy of ``msrflute_tpu/data/user_blob.py``: the JSON layout and the hdf5
layout of reference ``utils/preprocessing/create-hdf5.py``
(``_hdf5_decode``, ``_read_hdf5_user``, ``_read_hdf5_header``,
``_load_hdf5``, the per-user reader :class:`LazyHDF5Users` and the writer
:func:`save_user_blob_hdf5`, ``user_blob.py:111-272``).  ``h5py`` is
imported where an hdf5 blob is read or written, never at import.

A blob holds ``users`` (or ``user_list``), ``num_samples``, ``user_data``
(user id -> ``{'x': [...]}`` or a bare list) and optionally
``user_data_label`` (reference ``doc/sphinx/scenarios.rst:5-33``).  An
entry with streams beside ``x`` and ``y`` (semisupervision's unlabeled
``ux`` and ``ux_rand``) is kept whole for the task's featurizer.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np


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
        return _load_hdf5(path)
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


def _hdf5_decode(value):
    arr = np.asarray(value)
    if arr.dtype.kind == "S" or (
            arr.dtype.kind == "O" and arr.size and
            isinstance(arr.reshape(-1)[0], (bytes, str))):
        # variable-length strings come back as bytes
        return [v.decode() if isinstance(v, bytes) else str(v)
                for v in arr]
    if arr.dtype.kind == "O":
        # ragged numeric samples: one array a sample
        return [np.asarray(v) for v in arr]
    return arr


def _read_hdf5_user(fh, user: str):
    """One user's ``(data_entry, label or None)`` from an open blob."""
    import h5py

    entry = fh["user_data"][user]
    labels_grp = fh.get("user_data_label")
    label = (np.asarray(labels_grp[user][()])
             if labels_grp is not None else None)
    if isinstance(entry, h5py.Group):
        if set(entry.keys()) - {"x", "y"}:
            # a per-user dict of streams; '<key>.json' holds a stream with
            # no array form
            rich: Dict[str, Any] = {}
            for key in entry.keys():
                if key.endswith(".json"):
                    rich[key[:-len(".json")]] = json.loads(
                        bytes(entry[key][()]).decode("utf-8"))
                else:
                    rich[key] = _hdf5_decode(entry[key][()])
            if label is None and "y" in entry:
                label = np.asarray(entry["y"][()])
            return rich, label
        data = _hdf5_decode(entry["x"][()])
        if label is None and "y" in entry:
            label = np.asarray(entry["y"][()])
        return data, label
    return _hdf5_decode(entry[()]), label


def _read_hdf5_header(fh):
    """``(users, num_samples)`` of an open blob."""
    users_ds = fh.get("users", fh.get("user_list"))
    users = [u.decode() if isinstance(u, bytes) else str(u)
             for u in users_ds[()]]
    return users, [int(n) for n in fh["num_samples"][()]]


def _load_hdf5(path: str) -> UserBlob:
    import h5py

    with h5py.File(path, "r") as fh:
        users, num_samples = _read_hdf5_header(fh)
        data: List[Any] = []
        labels: List[Any] = []
        for user in users:
            entry, label = _read_hdf5_user(fh, user)
            data.append(entry)
            # None where absent: users and labels stay aligned when the
            # layouts mix
            labels.append(label)
    return UserBlob(
        user_list=users, num_samples=num_samples, user_data=data,
        user_labels=(labels if any(lab is not None for lab in labels)
                     else None))


class LazyHDF5Users:
    """Per-user on-demand reader over an hdf5 blob
    (``msrflute_tpu/data/user_blob.py:189-222``): ``users`` and
    ``num_samples`` are read at construction, a user's samples by
    :meth:`read`.  The file is opened on the first read and reads are
    serialized with a lock (h5py is not thread-safe)."""

    def __init__(self, path: str):
        import h5py
        self.path = path
        self._fh = None
        self._lock = threading.Lock()
        with h5py.File(path, "r") as fh:
            self.user_list, self.num_samples = _read_hdf5_header(fh)

    def read(self, user: str):
        """``(data_entry, label or None)`` of one user."""
        import h5py
        with self._lock:
            if self._fh is None:
                self._fh = h5py.File(self.path, "r")
            return _read_hdf5_user(self._fh, user)


def save_user_blob_hdf5(path: str, blob: UserBlob) -> None:
    """Write ``blob`` in the hdf5 layout of reference
    ``utils/preprocessing/create-hdf5.py``."""
    import h5py

    def as_dataset_value(samples):
        try:
            arr = np.asarray(samples)
        except ValueError:          # ragged lengths -> an object array
            arr = np.empty(len(samples), dtype=object)
            arr[:] = [np.asarray(s) for s in samples]
        if arr.dtype.kind == "U" or (
                arr.dtype.kind == "O" and len(samples) and
                isinstance(samples[0], (str, bytes))):
            return np.asarray([str(s) for s in samples],
                              dtype=h5py.string_dtype("utf-8"))
        if arr.dtype.kind == "O":
            return np.asarray([np.asarray(s, np.float64).reshape(-1)
                               for s in samples],
                              dtype=h5py.vlen_dtype(np.float64))
        return arr

    with h5py.File(path, "w") as fh:
        fh.create_dataset("users", data=np.array(blob.user_list, dtype="S"))
        fh.create_dataset("num_samples", data=np.asarray(blob.num_samples))
        grp = fh.create_group("user_data")
        for user, samples in zip(blob.user_list, blob.user_data):
            sub = grp.create_group(user)
            if isinstance(samples, dict):
                for key, value in samples.items():
                    try:
                        sub.create_dataset(key,
                                           data=as_dataset_value(value))
                    except (TypeError, ValueError):
                        sub.create_dataset(
                            f"{key}.json",
                            data=np.void(json.dumps(value).encode("utf-8")))
            else:
                sub.create_dataset("x", data=as_dataset_value(samples))
        if blob.user_labels is not None:
            lab = fh.create_group("user_data_label")
            for user, y in zip(blob.user_list, blob.user_labels):
                if y is not None:
                    lab.create_dataset(user, data=as_dataset_value(y))
