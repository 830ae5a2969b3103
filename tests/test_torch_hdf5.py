"""hdf5 user blobs (``msrflute_tpu_torch/data/user_blob.py``) against the
JAX package's reader and writer, and the shipped
``experiments/classif_cnn`` config, whose blobs are hdf5, through the
port's CLI against the JAX package's server:

- blobs written with ``h5py`` in every layout the reader knows (per-user
  groups with ``x`` and ``y`` or ``x`` alone, a bare dataset a user, a
  per-user dict of streams with a ``.json`` stream, text samples, ragged
  numeric samples; labels in ``user_data_label``, inside the group, or
  absent for some users) load into the JAX package's ``UserBlob`` field
  for field.  A ``user_data_label`` group must name every user, in both
  packages' readers;
- each package reads the other's writer;
- CIFAR_CNN on generated 32x32x3 hdf5 blobs, 3 rounds with val every
  round: val loss, accuracy and ``f1_score`` at ``rel 1e-5``.
"""

import copy
import json
import os

import h5py
import numpy as np
import pytest
import yaml

from msrflute_tpu.data.user_blob import load_user_blob as jax_load
from msrflute_tpu.data.user_blob import \
    save_user_blob_hdf5 as jax_save_hdf5
from msrflute_tpu_torch.data.user_blob import (UserBlob, load_user_blob,
                                               save_user_blob_hdf5)

from test_torch_strategies import jax_history_metrics, port_cli_history

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b):
    """Field-for-field equality of two decoded entries."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (a, b)


def _assert_blobs_equal(got, want):
    assert got.user_list == want.user_list
    assert got.num_samples == want.num_samples
    _same(list(got.user_data), list(want.user_data))
    assert (got.user_labels is None) == (want.user_labels is None)
    if want.user_labels is not None:
        for g, w in zip(got.user_labels, want.user_labels):
            assert (g is None) == (w is None)
            if w is not None:
                _same(np.asarray(g), np.asarray(w))


def _mixed_blob(path, label_group):
    """Seven users in seven layouts; with ``label_group`` every user has a
    ``user_data_label`` entry (the group's ``y`` is then not read),
    without it only ``grp_xy`` is labeled (by its ``y``)."""
    rng = np.random.default_rng(0)
    users = ["grp_xy", "grp_x_label", "bare", "rich", "text", "ragged",
             "unlabeled"]
    counts = [3, 2, 4, 2, 2, 3, 1]
    with h5py.File(path, "w") as fh:
        fh.create_dataset("users", data=np.array(users, dtype="S"))
        fh.create_dataset("num_samples", data=np.asarray(counts))
        ud = fh.create_group("user_data")
        lab = {}
        if label_group:
            lab = fh.create_group("user_data_label")
            for u, n in zip(users, counts):
                if u not in ("grp_x_label", "bare"):
                    lab.create_dataset(u, data=rng.integers(0, 4, n))
        g = ud.create_group("grp_xy")
        g.create_dataset("x", data=rng.integers(0, 255, (3, 4, 4, 3),
                                                dtype=np.uint8))
        g.create_dataset("y", data=np.asarray([1, 0, 2]))
        g = ud.create_group("grp_x_label")
        g.create_dataset("x", data=rng.normal(size=(2, 5)))
        if label_group:
            lab.create_dataset("grp_x_label", data=np.asarray([3, 1]))
        ud.create_dataset("bare", data=rng.normal(size=(4, 5)).astype(
            np.float32))
        if label_group:
            lab.create_dataset("bare", data=np.asarray([0, 1, 1, 0]))
        g = ud.create_group("rich")
        g.create_dataset("x", data=rng.normal(size=(2, 3)))
        g.create_dataset("ux", data=rng.normal(size=(5, 3)))
        g.create_dataset("meta.json", data=np.void(json.dumps(
            {"a": [1, 2], "b": {"c": "d"}}).encode("utf-8")))
        g = ud.create_group("text")
        g.create_dataset("x", data=np.asarray(
            ["to be or not", "that is"], dtype=h5py.string_dtype("utf-8")))
        g = ud.create_group("ragged")
        g.create_dataset("x", data=np.asarray(
            [np.arange(3.0), np.arange(5.0), np.arange(1.0)],
            dtype=h5py.vlen_dtype(np.float64)))
        ud.create_group("unlabeled").create_dataset(
            "x", data=np.zeros((1, 5)))


@pytest.mark.parametrize("label_group", [True, False])
def test_mixed_layouts_load_as_the_jax_reader_does(label_group, tmp_path):
    path = str(tmp_path / "mixed.hdf5")
    _mixed_blob(path, label_group)
    got, want = load_user_blob(path), jax_load(path)
    _assert_blobs_equal(got, want)
    assert got.user_labels[0] is not None
    assert (got.user_labels[6] is None) != label_group
    assert got.user_data[3]["meta"] == {"a": [1, 2], "b": {"c": "d"}}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_reads_the_others_writer(writer, tmp_path):
    from msrflute_tpu.data.user_blob import UserBlob as JaxUserBlob
    rng = np.random.default_rng(1)
    fields = dict(
        user_list=["a", "b", "c"], num_samples=[2, 3, 1],
        user_data=[rng.integers(0, 255, (2, 6, 6, 3), dtype=np.uint8),
                   {"x": rng.normal(size=(3, 4)), "ux": rng.normal(
                       size=(2, 4))},
                   ["one line"]],
        user_labels=[np.asarray([1, 2]), np.asarray([0, 3, 1]),
                     np.asarray([0])])
    path = str(tmp_path / "w.h5")
    if writer == "port":
        save_user_blob_hdf5(path, UserBlob(**fields))
    else:
        jax_save_hdf5(path, JaxUserBlob(**fields))
    _assert_blobs_equal(load_user_blob(path), jax_load(path))


def _cifar_hdf5(path, users, seed):
    """uint8 32x32x3 images whose class shifts one channel band."""
    rng = np.random.default_rng(seed)
    names = [f"c{seed}_{i:03d}" for i in range(users)]
    data, labels, counts = [], [], []
    for _ in names:
        n = int(rng.integers(4, 9))
        y = rng.integers(0, 10, n)
        x = rng.integers(0, 160, (n, 32, 32, 3))
        for i, c in enumerate(y):
            x[i, :, :, c % 3] += 8 * (c + 1) % 96
        data.append(x.astype(np.uint8))
        labels.append(y)
        counts.append(n)
    save_user_blob_hdf5(path, UserBlob(names, counts, data, labels))


def test_classif_cnn_shipped_config_on_hdf5_matches_jax(tmp_path,
                                                        monkeypatch):
    with open(os.path.join(REPO, "experiments", "classif_cnn",
                           "config.yaml")) as fh:
        raw = yaml.safe_load(fh)
    raw["server_config"].update(max_iteration=3, val_freq=1,
                                num_clients_per_iteration=2,
                                initial_lr_client=0.05)
    raw["client_config"]["optimizer_config"]["lr"] = 0.05
    data = tmp_path / "data"
    (data / "cifar").mkdir(parents=True)
    for split, users, seed in (("train", 6, 2), ("val", 3, 3),
                               ("test", 2, 4)):
        _cifar_hdf5(str(data / "cifar" / f"{split}.hdf5"), users, seed)
    init, want, n_val = jax_history_metrics(copy.deepcopy(raw), str(data),
                                            str(tmp_path / "jax"))
    server, _ = port_cli_history(copy.deepcopy(raw), str(data),
                                 tmp_path / "port", init, monkeypatch)
    got = [(h["round"], h) for h in server.history if h["split"] == "val"]
    assert [r for r, _ in got] == [r for r, _ in want] == [0, 1, 2, 3]
    for (r, g), (_, w) in zip(got, want):
        for key in ("loss", "acc", "f1_score"):
            assert abs(g[key] - w[key]) <= 1e-5 * abs(w[key]), (r, key, g, w)
    assert server.best_model_criterion == "f1_score"
    assert (tmp_path / "port" / "run" / "models" /
            "best_val_f1_score_model.pt").exists()


def test_importing_the_port_loads_no_h5py():
    """The card's machine may have no ``h5py``: only reading or writing an
    hdf5 blob imports it."""
    import subprocess
    import sys
    code = ("import importlib, pkgutil, sys\n"
            "import msrflute_tpu_torch\n"
            "for m in pkgutil.walk_packages(msrflute_tpu_torch.__path__,\n"
            "                               'msrflute_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "sys.exit(1 if 'h5py' in sys.modules else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
