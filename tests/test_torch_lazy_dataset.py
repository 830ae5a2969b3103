"""Lazy hdf5 users (``client_config.data_config.train.lazy``) in the port
(``msrflute_tpu_torch/data/user_blob.py::LazyHDF5Users``,
``data/dataset.py::LazyUserDataset``, ``tasks.py``) against the JAX
package's:

- a lazy dataset's arrays equal the eager loader's and the JAX lazy
  dataset's, and an access pattern gives the JAX package's LRU counters
  (hits, misses, evictions, resident users) and reads;
- scrubbing empty users reads no samples;
- the config wiring (``lazy_cache_users``, the CV tasks' per-user
  ``featurize_user``) and its refusals (a JSON blob, a whole-blob
  featurizer with no per-user hook, ``augment``) with the JAX messages;
- a CNN run (CIFAR_CNN) with ``lazy: true`` is bitwise the run with
  ``lazy: false``.
"""

import copy

import numpy as np
import pytest
import torch

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.data.dataset import LazyUserDataset as JaxLazyUserDataset
from msrflute_tpu.data.user_blob import LazyHDF5Users as JaxLazyHDF5Users
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.tasks import build_task_datasets as jax_build_datasets
from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.data.dataset import (LazyUserDataset,
                                             scrub_empty_clients)
from msrflute_tpu_torch.data.user_blob import (LazyHDF5Users, UserBlob,
                                               load_user_blob,
                                               save_user_blob_hdf5)
from msrflute_tpu_torch.engine import OptimizationServer
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.tasks import build_task_datasets


def _write_blob(path, n_users=6, dim=8, empty=(), pixels=False):
    rng = np.random.default_rng(0)
    users, counts, data, labels = [], [], [], []
    for u in range(n_users):
        n = 0 if u in empty else int(rng.integers(3, 9))
        users.append(f"u{u}")
        counts.append(n)
        data.append(rng.integers(0, 256, size=(n, dim)).astype(np.uint8)
                    if pixels else rng.normal(size=(n, dim)))
        labels.append(rng.integers(0, 4, size=(n,)).astype(np.int64))
    save_user_blob_hdf5(str(path), UserBlob(users, counts, data, labels))
    return str(path)


def test_lazy_matches_eager_and_jax(tmp_path):
    path = _write_blob(tmp_path / "blob.hdf5")
    eager = load_user_blob(path)
    lazy = LazyUserDataset(LazyHDF5Users(path))
    jlazy = JaxLazyUserDataset(JaxLazyHDF5Users(path))
    assert lazy.user_list == eager.user_list == jlazy.user_list
    assert lazy.num_samples == eager.num_samples == jlazy.num_samples
    for i in range(len(lazy)):
        got, want = lazy.user_arrays(i), jlazy.user_arrays(i)
        assert got.keys() == want.keys() == {"x", "y"}
        for k in got:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])
        np.testing.assert_array_equal(
            got["x"], np.asarray(eager.user_data[i], np.float32))


def test_lru_counters_and_reads_match_jax(tmp_path):
    path = _write_blob(tmp_path / "blob.hdf5")
    pattern = [0, 0, 1, 2, 0, 3, 1, 4, 4, 5, 0]
    stats = []
    for users_cls, ds_cls in ((LazyHDF5Users, LazyUserDataset),
                              (JaxLazyHDF5Users, JaxLazyUserDataset)):
        users = users_cls(path)
        reads = []
        read = users.read
        users.read = lambda u, read=read, reads=reads: (reads.append(u)
                                                       or read(u))
        ds = ds_cls(users, cache_users=2)
        for i in pattern:
            ds.user_arrays(i)
        stats.append((ds.cache_stats(), reads))
    assert stats[0] == stats[1]
    assert stats[0][0]["resident"] == 2 and stats[0][0]["evictions"] > 0


def test_scrub_reads_no_samples(tmp_path):
    path = _write_blob(tmp_path / "blob.hdf5", empty=(1, 4))
    users = LazyHDF5Users(path)
    users.read = lambda u: pytest.fail(f"scrub read user {u}")
    ds = scrub_empty_clients(LazyUserDataset(users))
    assert isinstance(ds, LazyUserDataset)
    assert ds.user_list == ["u0", "u2", "u3", "u5"]


def _lr_raw(train_path, lazy=True, model="LR", **train):
    return {
        "model_config": {"model_type": model, "num_classes": 4,
                         "input_dim": 8},
        "strategy": "fedavg",
        "server_config": {"max_iteration": 2,
                          "num_clients_per_iteration": 2,
                          "initial_lr_client": 0.1, "pipeline_depth": 0,
                          "initial_val": False,
                          "optimizer_config": {"type": "sgd", "lr": 1.0},
                          "data_config": {"val": {"batch_size": 4}}},
        "client_config": {
            "optimizer_config": {"type": "sgd", "lr": 0.1},
            "data_config": {"train": {
                "list_of_train_data": train_path, "batch_size": 4,
                "lazy": lazy, "lazy_cache_users": 4, **train}}},
    }


def test_config_wiring_and_refusals_match_jax(tmp_path):
    path = _write_blob(tmp_path / "blob.hdf5", empty=(2,))
    raw = _lr_raw(path)
    train, _, _ = build_task_datasets(FLUTEConfig.from_dict(raw),
                                      make_task(FLUTEConfig.from_dict(
                                          raw).model_config))
    jcfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    jtrain, _, _ = jax_build_datasets(jcfg, jax_make_task(jcfg.model_config))
    assert isinstance(train, LazyUserDataset)
    assert train.user_list == jtrain.user_list and "u2" not in \
        train.user_list
    assert train._cache_users == 4
    for i in range(len(train)):
        got, want = train.user_arrays(i), jtrain.user_arrays(i)
        assert got["x"].shape[1:] == (8,) and got["y"].dtype == np.int32
        assert np.array_equal(got["x"], want["x"])
    cases = [_lr_raw(str(tmp_path / "x.json")),
             _lr_raw(path, augment={"num_ops": 2, "magnitude": 9})]
    for case in cases:
        with pytest.raises(ValueError) as want:
            c = JaxFLUTEConfig.from_dict(copy.deepcopy(case))
            jax_build_datasets(c, jax_make_task(c.model_config))
        with pytest.raises(ValueError) as got:
            c = FLUTEConfig.from_dict(copy.deepcopy(case))
            build_task_datasets(c, make_task(c.model_config))
        assert str(got.value) == str(want.value)
    # a task that featurizes the whole blob, with no per-user hook
    gru = _lr_raw(path, model="GRU")
    gru["model_config"].update(vocab_size=32, embed_dim=8, hidden_dim=8)
    c = FLUTEConfig.from_dict(gru)
    with pytest.raises(ValueError, match="featurize_user hook"):
        build_task_datasets(c, make_task(c.model_config))


def test_cnn_run_lazy_equals_eager(tmp_path):
    path = _write_blob(tmp_path / "img.hdf5", n_users=4, dim=32 * 32 * 3,
                       pixels=True)
    finals = []
    for lazy in (True, False):
        raw = _lr_raw(path, lazy=lazy, model="CIFAR_CNN")
        raw["model_config"] = {"model_type": "CIFAR_CNN", "num_classes": 4}
        raw["server_config"]["max_iteration"] = 1
        cfg = FLUTEConfig.from_dict(raw)
        task = make_task(cfg.model_config)
        train, _, _ = build_task_datasets(cfg, task)
        assert isinstance(train, LazyUserDataset) == lazy
        server = OptimizationServer(task, cfg, train,
                                    model_dir=str(tmp_path / str(lazy)),
                                    device="cpu", seed=0)
        server.train()
        finals.append(server.state.params)
    assert torch.equal(finals[0], finals[1])
