"""The port's CLI (``msrflute_tpu_torch.e2e_trainer`` on ``-device cpu``)
against the JAX package's server on the same generated user blob and the
same initial weights, 3 FedAvg rounds, val loss and accuracy every round:

- ResNet-18-GN (``experiments/cv_resnet_fedcifar100``'s model section at
  16x16 images and 10 classes);
- the Shakespeare LSTM (``experiments/nlp_rnn_fedshakespeare``'s model at
  hidden 32 and 20 chars);
- CIFAR_CNN (``experiments/classif_cnn``'s model section, micro F1 as the
  best-model criterion, on a JSON blob), its F1 scores too.

Val loss to ``rel 1e-5``: only the order of the float32 sums differs
between the two frameworks, a few 1e-7 after 3 rounds of local SGD.
Accuracy and F1 to one val sample (or char), as an argmax may flip where
two logits tie to float32 rounding.
"""

import json
import os

import jax
import numpy as np
import pytest
import yaml

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.engine import OptimizationServer as JaxServer
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu.tasks import build_task_datasets as jax_build_datasets
from msrflute_tpu_torch import e2e_trainer
from msrflute_tpu_torch.models.convert import from_jax_params


def _image_blob(path, users, side, classes, seed):
    """uint8 images whose class shifts the mean of one channel band, so
    there is a signal to learn."""
    rng = np.random.default_rng(seed)
    names = [f"u{seed}_{i:03d}" for i in range(users)]
    data, labels, counts = {}, {}, []
    for u in names:
        n = int(rng.integers(4, 9))
        y = rng.integers(0, classes, n)
        x = rng.integers(0, 160, (n, side, side, 3))
        for i, c in enumerate(y):
            x[i, :, :, c % 3] += 8 * (c + 1) % 96
        data[u] = {"x": x.tolist()}
        labels[u] = y.tolist()
        counts.append(n)
    with open(path, "w") as fh:
        json.dump({"users": names, "num_samples": counts, "user_data": data,
                   "user_data_label": labels}, fh)


def _text_blob(path, users, seed):
    rng = np.random.default_rng(seed)
    words = np.asarray("to be or not that is the question whether tis "
                       "nobler in mind suffer".split())
    names = [f"s{seed}_{i:03d}" for i in range(users)]
    data, counts = {}, []
    for u in names:
        n = int(rng.integers(3, 9))
        data[u] = {"x": [" ".join(rng.choice(words, 6))[:20]
                         for _ in range(n)]}
        counts.append(n)
    with open(path, "w") as fh:
        json.dump({"users": names, "num_samples": counts, "user_data": data},
                  fh)


def _config(model, criterion, client_lr=0.1):
    return {
        "model_config": model,
        "strategy": "fedavg",
        "server_config": {
            "max_iteration": 3, "num_clients_per_iteration": 2,
            "initial_lr_client": client_lr, "val_freq": 1, "rec_freq": 100,
            "initial_val": True, "best_model_criterion": criterion,
            "rounds_per_step": 1, "pipeline_depth": 0,
            "optimizer_config": {"type": "sgd", "lr": 1.0},
            "megakernel": {"pallas_apply": True},
            "data_config": {"val": {"batch_size": 16,
                                    "val_data": "val.json"}},
        },
        "client_config": {
            "optimizer_config": {"type": "sgd", "lr": client_lr},
            "data_config": {"train": {"batch_size": 4,
                                      "list_of_train_data": "train.json"}},
        },
    }


def _jax_history(raw, data_dir, model_dir):
    cfg = JaxFLUTEConfig.from_dict(raw)
    cfg.validate(data_dir)
    task = jax_make_task(cfg.model_config)
    train, val, _ = jax_build_datasets(cfg, task)
    # the JAX round engine refuses pallas_apply off a TPU: its optax arm
    cfg.server_config["megakernel"] = {"pallas_apply": False}
    server = JaxServer(task, cfg, train, val_dataset=val,
                       model_dir=model_dir, mesh=make_mesh(num_devices=1),
                       seed=0)
    init = jax.device_get(server.state.params)
    history, evaluate = [], server._maybe_eval

    def recording_eval(split, round_no, force=False):
        improved = evaluate(split, round_no, force=force)
        history.append((round_no, {k: m.value for k, m in
                                   server._last_val.items()}))
        return improved

    server._maybe_eval = recording_eval
    server.train()
    return init, history, val


def _port_cli_history(raw, data_dir, out, init_jax, monkeypatch, task):
    """The port's CLI in process, its task's init replaced by the JAX
    package's initial weights."""
    cfg_path = out / "cfg.yaml"
    out.mkdir()
    cfg_path.write_text(yaml.safe_dump(raw))

    def init_from_jax(self, seed):
        return from_jax_params(self, init_jax)

    monkeypatch.setattr(type(task), "init_params", init_from_jax)
    server = e2e_trainer.main(["-config", str(cfg_path), "-dataPath",
                               data_dir, "-outputPath", str(out / "run"),
                               "-device", "cpu"])
    return server, [(h["round"], h) for h in server.history
                    if h["split"] == "val"]


def _compare(got, want, n_val, loss_rel, extra=()):
    assert [r for r, _ in got] == [r for r, _ in want] == [0, 1, 2, 3]
    for (r, g), (_, w) in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= loss_rel * abs(w["loss"]), \
            (r, g["loss"], w["loss"])
        for key in ("acc",) + tuple(extra):
            assert abs(g[key] - w[key]) * n_val <= 1.0 + 1e-9, (r, key, g, w)


@pytest.fixture(scope="module")
def blobs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fedavg_paths")
    for kind in ("resnet", "cifar", "lstm"):
        (d / kind).mkdir()
    _image_blob(d / "resnet" / "train.json", 8, 16, 10, 0)
    _image_blob(d / "resnet" / "val.json", 3, 16, 10, 1)
    _image_blob(d / "cifar" / "train.json", 8, 32, 10, 2)
    _image_blob(d / "cifar" / "val.json", 3, 32, 10, 3)
    _text_blob(d / "lstm" / "train.json", 8, 4)
    _text_blob(d / "lstm" / "val.json", 3, 5)
    return {k: str(d / k) for k in ("resnet", "cifar", "lstm")}


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _published_model(name, **over):
    with open(os.path.join(REPO, "experiments", name, "config.yaml")) as fh:
        model = yaml.safe_load(fh)["model_config"]
    return dict(model, **over)


def test_resnet_cli_trajectory_matches_jax(blobs, tmp_path, monkeypatch):
    from msrflute_tpu_torch.models.resnet import make_resnet_task
    model = _published_model("cv_resnet_fedcifar100", num_classes=10,
                             image_size=16)
    raw = _config(model, criterion="acc")
    init, want, val = _jax_history(raw, blobs["resnet"],
                                   str(tmp_path / "jax"))
    server, got = _port_cli_history(raw, blobs["resnet"], tmp_path / "port",
                                    init, monkeypatch,
                                    make_resnet_task(model))
    _compare(got, want, sum(val.num_samples), 1e-5)
    assert server.engine.layout.numel == 11_181_642


def test_lstm_cli_trajectory_matches_jax(blobs, tmp_path, monkeypatch):
    from msrflute_tpu_torch.models.nlp import make_shakespeare_lstm_task
    model = _published_model("nlp_rnn_fedshakespeare", hidden_dim=32,
                             seq_len=20)
    raw = _config(model, criterion="acc", client_lr=0.8)
    init, want, val = _jax_history(raw, blobs["lstm"], str(tmp_path / "j"))
    _, got = _port_cli_history(raw, blobs["lstm"], tmp_path / "port", init,
                               monkeypatch, make_shakespeare_lstm_task(model))
    # accuracy here is over the predicted chars, not rows
    n_chars = sum(int(val.user_arrays(i)["tok_mask"][:, 1:].sum())
                  for i in range(len(val)))
    _compare(got, want, n_chars, 1e-5)
    assert got[-1][1]["loss"] < got[0][1]["loss"]     # it learned


def test_cifar_cnn_cli_trajectory_matches_jax(blobs, tmp_path, monkeypatch):
    from msrflute_tpu_torch.models.cv import make_cifar_cnn_task
    model = _published_model("classif_cnn")
    raw = _config(model, criterion="f1_score", client_lr=0.05)
    init, want, val = _jax_history(raw, blobs["cifar"],
                                   str(tmp_path / "jax"))
    server, got = _port_cli_history(raw, blobs["cifar"], tmp_path / "port",
                                    init, monkeypatch,
                                    make_cifar_cnn_task(model))
    _compare(got, want, sum(val.num_samples), 1e-5,
             extra=("f1_score", "f1_macro"))
    assert server.best_model_criterion == "f1_score"
    assert (tmp_path / "port" / "run" / "models" /
            "best_val_f1_score_model.pt").exists()
