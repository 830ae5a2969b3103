"""Task dataset assembly — the port's counterpart of ``msrflute_tpu/tasks.py``:
the split files named in the config are read by the user-blob reader and
featurized by the task into :class:`~.data.dataset.ArraysDataset` (only the
train split is augmented); :func:`build_server_train_dataset` reads server
replay's ``train_data_server``.  With ``data_config.train.lazy`` the train
split of an hdf5 blob is a :class:`~.data.dataset.LazyUserDataset` over the
task's per-user ``featurize_user`` hook, ``lazy_cache_users`` users cached
(``tasks.py:58-79``)."""

from __future__ import annotations

import os
from typing import Optional, Tuple

from .config import FLUTEConfig
from .data import ArraysDataset, load_user_blob, scrub_empty_clients
from .data.dataset import LazyUserDataset
from .data.user_blob import LazyHDF5Users
from .models.base import BaseTask


def build_task_datasets(cfg: FLUTEConfig, task: BaseTask) -> Tuple[
        ArraysDataset, Optional[ArraysDataset], Optional[ArraysDataset]]:
    """(train, val, test): client train data from
    ``client_config.data_config.train``, evals from
    ``server_config.data_config.{val,test}``."""
    cc_train = cfg.client_config.data_config.train
    train_path = cc_train.get("list_of_train_data") or \
        cc_train.get("train_data")
    if not train_path:
        raise ValueError("client_config.data_config.train needs "
                         "list_of_train_data or train_data")
    if cc_train.get("lazy"):
        train = scrub_empty_clients(_lazy_train(task, train_path, cc_train))
    else:
        train = scrub_empty_clients(task.make_dataset(
            load_user_blob(train_path), data_config=cc_train,
            split="train"))

    def _load(split, key):
        split_cfg = cfg.server_config.data_config[split]
        path = split_cfg.get(key)
        return (task.make_dataset(load_user_blob(path), data_config=split_cfg,
                                  split=split) if path else None)

    return train, _load("val", "val_data"), _load("test", "test_data")


def _lazy_train(task: BaseTask, path: str, cc_train):
    """The lazy train split, with the JAX package's refusals: a blob that
    is not hdf5, a task with a whole-blob featurizer and no per-user hook,
    and ``augment`` (which needs one stream shared by every user)."""
    if os.path.splitext(path)[1].lower() not in (".hdf5", ".h5"):
        raise ValueError("data_config.train.lazy requires an hdf5 blob "
                         f"(got {path})")
    featurize = getattr(task, "featurize_user", None)
    if featurize is None:
        raise ValueError(
            f"task {task.name!r} has a whole-blob featurizer and no "
            "per-user featurize_user hook; lazy loading needs one")
    if cc_train.get("augment"):
        raise ValueError("augment needs a shared rng stream; use the "
                         "eager loader (lazy: false) with augment")
    return LazyUserDataset(LazyHDF5Users(path), featurize=featurize,
                           cache_users=int(cc_train.get("lazy_cache_users",
                                                        256)))


def build_server_train_dataset(cfg: FLUTEConfig, task: BaseTask
                               ) -> Optional[ArraysDataset]:
    """Server replay's dataset from ``server_config.data_config.train.
    train_data_server`` (``msrflute_tpu/tasks.py:97-104``), featurized as
    a train split without augmentation; None when the key is absent."""
    path = cfg.server_config.data_config.train.get("train_data_server")
    if not path:
        return None
    return task.make_dataset(load_user_blob(path), split="train")
