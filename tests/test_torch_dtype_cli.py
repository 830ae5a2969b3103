"""The slice end to end: the port's CLI (``-device cpu``) in
``model_config.dtype: bfloat16`` against the JAX package's server on the same
generated blobs and initial weights, 3 FedAvg rounds, the val loss every
round:

- each family whose JAX module reads ``dtype``: LR, CNN_FEMNIST (plus
  ``precision: {params: bfloat16, compute: bfloat16}``, the local copy and
  its momentum trace in bf16), CIFAR_CNN, ResNet-18-GN (16x16 images), the
  Shakespeare LSTM (hidden 32, 20 chars) and RingLM with
  ``flash_attention: true`` (the kernels' plain versions here; small
  widths);
- ``pallas_apply`` is off on both sides: the JAX round engine refuses it
  off a TPU, and its optax arm is the one to compare with (kernel B1's
  bf16 arm is held to the JAX kernel in ``tests/test_torch_precision.py``).

Bound: the val loss within ``TRAJ_RTOL`` of the JAX package's at every
round: 1e-2, and 5e-2 for ResNet-18-GN.  Round 0 is the same weights in
both, and the port's bf16 forward equals the JAX module's run op by op
bitwise at ResNet's init; but the JAX server evaluates inside one jitted
program, where XLA fuses elementwise ops and keeps float32 between them
(excess precision), so its round-0 ResNet val loss is 2.6017 where its own
task's loss and the port's read 2.5990 (1.0e-3).  Over the local steps
such differences compound, as do those of the gradients' rounding
(``tests/test_torch_dtype.py``: 0.1-1.7 % apart); measured at most
1.7e-3 after 3 rounds on five families and 2.9e-2 on ResNet-18-GN (20
GroupNorms at batch 4), whose JAX bf16 run is itself 1.5 % from its
float32 run at round 2.  The params the server keeps stay float32.
"""

import json

import numpy as np
import pytest
import torch

from msrflute_tpu_torch.models import make_task
from test_torch_cli_trajectories import (_config, _image_blob, _jax_history,
                                         _port_cli_history, _published_model,
                                         _text_blob)
from test_torch_ringlm import write_longtext_blob

TRAJ_RTOL = {"resnet": 5e-2}


def _femnist_blob(path, users, seed, flat=False):
    rng = np.random.default_rng(seed)
    names = [f"f{seed}_{i:03d}" for i in range(users)]
    data, labels, counts = {}, {}, []
    for u in names:
        n = int(rng.integers(4, 9))
        y = rng.integers(0, 10, n)
        x = rng.integers(0, 100, (n, 28, 28))
        for i, c in enumerate(y):
            x[i, 2 * c:2 * c + 3] += 120
        data[u] = {"x": (x.reshape(n, -1) if flat else x).tolist()}
        labels[u] = y.tolist()
        counts.append(n)
    with open(path, "w") as fh:
        json.dump({"users": names, "num_samples": counts, "user_data": data,
                   "user_data_label": labels}, fh)


def _lr_blob(path, users, seed):
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(42).normal(size=(8, 4))
    names = [f"l{seed}_{i:03d}" for i in range(users)]
    data, labels, counts = {}, {}, []
    for u in names:
        n = int(rng.integers(5, 13))
        x = rng.normal(size=(n, 8))
        data[u] = {"x": x.tolist()}
        labels[u] = np.argmax(x @ w, axis=-1).tolist()
        counts.append(n)
    with open(path, "w") as fh:
        json.dump({"users": names, "num_samples": counts, "user_data": data,
                   "user_data_label": labels}, fh)


@pytest.fixture(scope="module")
def blobs16(tmp_path_factory):
    d = tmp_path_factory.mktemp("dtype_paths")
    writers = {
        "lr": lambda p, n, s: _lr_blob(p, n, s),
        "cnn": lambda p, n, s: _femnist_blob(p, n, s),
        "cifar": lambda p, n, s: _image_blob(p, n, 32, 10, s),
        "resnet": lambda p, n, s: _image_blob(p, n, 16, 10, s),
        "lstm": lambda p, n, s: _text_blob(p, n, s),
        "ringlm": lambda p, n, s: write_longtext_blob(p, n, 2, 5, s),
    }
    for kind, write in writers.items():
        (d / kind).mkdir()
        write(d / kind / "train.json", 6, 10)
        write(d / kind / "val.json", 3, 11)
    return {k: str(d / k) for k in writers}


RINGLM = {"model_type": "RINGLM", "vocab_size": 90, "embed_dim": 32,
          "num_heads": 2, "head_dim": 8, "mlp_dim": 64, "num_layers": 2,
          "seq_len": 33, "flash_attention": True}


def _family(name):
    """(model section, client learning rate, precision block)."""
    if name == "lr":
        return {"model_type": "LR", "num_classes": 4, "input_dim": 8}, \
            0.3, None
    if name == "cnn":
        # dropout off: the two packages' random streams differ
        return {"model_type": "CNN", "num_classes": 10, "dropout1": 0.0,
                "dropout2": 0.0}, 0.05, \
            {"params": "bfloat16", "compute": "bfloat16"}
    if name == "cifar":
        return _published_model("classif_cnn"), 0.05, None
    if name == "resnet":
        return _published_model("cv_resnet_fedcifar100", num_classes=10,
                                image_size=16), 0.02, None
    if name == "lstm":
        return _published_model("nlp_rnn_fedshakespeare", hidden_dim=32,
                                seq_len=20), 0.8, None
    return dict(RINGLM), 0.1, None


@pytest.mark.parametrize("name", ["lr", "cnn", "cifar", "resnet", "lstm",
                                  "ringlm"])
def test_bf16_cli_trajectory_matches_jax(name, blobs16, tmp_path,
                                         monkeypatch):
    model, client_lr, precision = _family(name)
    model = dict(model, dtype="bfloat16")
    raw = _config(model, criterion="loss", client_lr=client_lr)
    raw["server_config"].pop("megakernel")
    if precision:
        raw["server_config"]["precision"] = precision
    init, want, _ = _jax_history(raw, blobs16[name], str(tmp_path / "jax"))
    server, got = _port_cli_history(raw, blobs16[name], tmp_path / "port",
                                    init, monkeypatch, make_task(model))
    assert [r for r, _ in got] == [r for r, _ in want] == [0, 1, 2, 3]
    rtol = TRAJ_RTOL.get(name, 1e-2)
    for (r, g), (_, w) in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= rtol * abs(w["loss"]), \
            (r, g["loss"], w["loss"])
    assert server.state.params.dtype == torch.float32
    assert server.task.module.dtype == torch.bfloat16
    if precision:
        assert server.engine.precision == precision
