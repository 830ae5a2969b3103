"""The ported slice as a whole: the port's ``OptimizationServer`` against the
JAX package's on one generated user blob and the same initial weights.

- LR, 20 rounds on the JAX 8-device mesh: per-round val loss to ``rel
  1e-5``, val accuracy to one sample, for both of the port's arms (the
  fused SGD kernel wrapper and the plain tail).  The JAX side runs its
  optax arm: its round engine refuses ``pallas_apply`` off a TPU.
- CNN_FEMNIST without dropout, 3 rounds: val loss to ``rel 1e-4``.
- The port's CLI end to end on ``-device cpu``; without ``-device`` (and
  the server without ``device=``) it asks for CUDA and raises without it.
- A run stopped at round k and resumed to N gives bit-identical params to
  an uninterrupted N-round run (CNN_FEMNIST with dropout on, so the
  per-client generators must replay too).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.engine import OptimizationServer as JaxServer
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu.tasks import build_task_datasets as jax_build_datasets
from msrflute_tpu_torch import e2e_trainer
from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.engine import OptimizationServer
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params
from msrflute_tpu_torch.tasks import build_task_datasets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_blob(path, num_users, kind, lo, hi, seed):
    rng = np.random.default_rng(seed)
    users = [f"u{i:03d}" for i in range(num_users)]
    w = np.random.default_rng(99).normal(size=(8, 4))   # shared by splits
    data, labels, counts = {}, {}, []
    for u in users:
        n = int(rng.integers(lo, hi + 1))
        if kind == "lr":
            x = rng.normal(size=(n, 8))
            y = np.argmax(x @ w + 0.1 * rng.normal(size=(n, 4)), axis=1)
        else:
            x = rng.integers(0, 256, size=(n, 28, 28))
            y = rng.integers(0, 62, size=(n,))
        data[u] = {"x": x.tolist()}
        labels[u] = y.tolist()
        counts.append(n)
    with open(path, "w") as fh:
        json.dump({"users": users, "num_samples": counts, "user_data": data,
                   "user_data_label": labels}, fh)


def _raw_config(kind, rounds, **server_over):
    model = ({"model_type": "LR", "num_classes": 4, "input_dim": 8}
             if kind == "lr" else
             {"model_type": "CNN", "num_classes": 62, "dropout1": 0.0,
              "dropout2": 0.0})
    return {
        "model_config": model,
        "strategy": "fedavg",
        "server_config": {
            "max_iteration": rounds,
            "num_clients_per_iteration": 4 if kind == "lr" else 2,
            "initial_lr_client": 0.2 if kind == "lr" else 0.1,
            "optimizer_config": {"type": "sgd", "lr": 1.0},
            "val_freq": 1, "rec_freq": 1000, "initial_val": True,
            "best_model_criterion": "loss",
            "pipeline_depth": 0,
            "data_config": {"val": {"batch_size": 16,
                                    "val_data": "val.json"}},
            **server_over,
        },
        "client_config": {
            # CNN: cv_cnn_femnist's client SGD.  With momentum on this
            # random-label CNN, float32 reduction-order differences grow
            # about tenfold a round, past any fixed tolerance by round 3.
            "optimizer_config": ({"type": "sgd", "lr": 0.2, "momentum": 0.5}
                                 if kind == "lr" else
                                 {"type": "sgd", "lr": 0.1}),
            "data_config": {"train": {"batch_size": 4,
                                      "list_of_train_data": "train.json"}},
        },
    }


@pytest.fixture(scope="module")
def blobs(tmp_path_factory):
    out = {}
    for kind, (users, lo, hi) in {"lr": (16, 6, 24),
                                  "cnn": (4, 5, 10)}.items():
        d = tmp_path_factory.mktemp(f"blob_{kind}")
        _write_blob(d / "train.json", users, kind, lo, hi, seed=0)
        _write_blob(d / "val.json", 3, kind, lo, hi, seed=1)
        out[kind] = str(d)
    return out


def _run_jax(raw, data_dir, model_dir, mesh):
    cfg = JaxFLUTEConfig.from_dict(raw)
    cfg.validate(data_dir)
    task = jax_make_task(cfg.model_config)
    train, val, _ = jax_build_datasets(cfg, task)
    server = JaxServer(task, cfg, train, val_dataset=val,
                       model_dir=model_dir, mesh=mesh, seed=0)
    init = jax.device_get(server.state.params)
    history = []
    evaluate = server._maybe_eval

    def recording_eval(split, round_no, force=False):
        improved = evaluate(split, round_no, force=force)
        history.append((round_no, server._last_val["loss"].value,
                        server._last_val["acc"].value))
        return improved

    server._maybe_eval = recording_eval
    server.train()
    return init, history, sum(val.num_samples)


def _port_server(raw, data_dir, model_dir, init_jax=None):
    cfg = FLUTEConfig.from_dict(raw)
    cfg.validate(data_dir)
    task = make_task(cfg.model_config)
    train, val, _ = build_task_datasets(cfg, task)
    init = None if init_jax is None else from_jax_params(task, init_jax)
    return OptimizationServer(task, cfg, train, val_dataset=val,
                              model_dir=model_dir, device="cpu", seed=0,
                              init_params=init)


def _port_history(server):
    server.train()
    return [(h["round"], h["loss"], h["acc"]) for h in server.history
            if h["split"] == "val"]


@pytest.fixture(scope="module")
def jax_lr_run(blobs, tmp_path_factory, mesh8):
    return _run_jax(_raw_config("lr", 20), blobs["lr"],
                    str(tmp_path_factory.mktemp("jax_lr")), mesh8)


@pytest.mark.parametrize("pallas", [False, True])
def test_lr_trajectory_matches_jax(pallas, jax_lr_run, blobs, tmp_path):
    init, want, n_val = jax_lr_run
    raw = _raw_config("lr", 20, megakernel={"pallas_apply": pallas})
    got = _port_history(_port_server(raw, blobs["lr"], str(tmp_path), init))
    assert [r for r, _, _ in got] == list(range(21))
    assert [r for r, _, _ in want] == list(range(21))
    for (r, gl, ga), (_, wl, wa) in zip(got, want):
        assert abs(gl - wl) <= 1e-5 * abs(wl), (r, gl, wl)
        assert abs(ga - wa) * n_val <= 1.0 + 1e-9, (r, ga, wa)
    assert got[-1][1] < got[0][1]       # it learned


def test_cnn_no_dropout_trajectory_matches_jax(blobs, tmp_path):
    raw = _raw_config("cnn", 3)
    init, want, _ = _run_jax(raw, blobs["cnn"], str(tmp_path / "jax"),
                             make_mesh(num_devices=1))
    got = _port_history(_port_server(raw, blobs["cnn"],
                                     str(tmp_path / "port"), init))
    assert len(got) == len(want) == 4
    for (r, gl, _), (_, wl, _) in zip(got, want):
        assert abs(gl - wl) <= 1e-4 * abs(wl), (r, gl, wl)


def _dropout_config(rounds, resume=False):
    raw = _raw_config("cnn", rounds, resume_from_checkpoint=resume,
                      megakernel={"pallas_apply": True})
    raw["model_config"].update(dropout1=0.25, dropout2=0.5)
    return raw


def test_resume_is_bit_identical(blobs, tmp_path):
    full = _port_server(_dropout_config(4), blobs["cnn"], str(tmp_path / "a"))
    full.train()
    first = _port_server(_dropout_config(2), blobs["cnn"], str(tmp_path / "b"))
    first.train()
    resumed = _port_server(_dropout_config(4, resume=True), blobs["cnn"],
                           str(tmp_path / "b"))
    assert resumed.state.round == 2
    resumed.train()
    assert resumed.state.round == full.state.round == 4
    assert torch.equal(resumed.state.params, full.state.params)
    status = json.loads((tmp_path / "b" / "status_log.json").read_text())
    assert status["i"] == 4
    assert status["np_rng_state"] == \
        full.ckpt.read_status()["np_rng_state"]


def test_entry_points_default_to_cuda_and_refuse_without_it(
        blobs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(_raw_config("lr", 1)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        e2e_trainer.main(["-config", str(cfg_path), "-dataPath", blobs["lr"],
                          "-outputPath", str(tmp_path / "out")])
    cfg = FLUTEConfig.from_dict(_raw_config("lr", 1))
    cfg.validate(blobs["lr"])
    task = make_task(cfg.model_config)
    train, _, _ = build_task_datasets(cfg, task)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OptimizationServer(task, cfg, train, model_dir=str(tmp_path / "m"))


def test_cli_end_to_end_on_cpu(blobs, tmp_path):
    cfg_path = tmp_path / "cfg.yaml"
    raw = _raw_config("lr", 3, megakernel={"pallas_apply": True},
                      val_freq=2, best_model_criterion="acc")
    cfg_path.write_text(yaml.safe_dump(raw))
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "msrflute_tpu_torch.e2e_trainer",
         "-config", str(cfg_path), "-dataPath", blobs["lr"],
         "-outputPath", str(out), "-task", "cv_lr_mnist", "-device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    models = out / "models"
    assert (models / "latest_model.pt").exists()
    assert (models / "latest_model.pt.sum").exists()
    assert (models / "best_val_acc_model.pt").exists()
    assert json.loads((models / "status_log.json").read_text())["i"] == 3
    metrics = [json.loads(line) for line in
               (out / "log" / "metrics.jsonl").read_text().splitlines()]
    assert any(m["name"] == "Val acc" for m in metrics)
    assert sum(m["name"] == "Training loss" for m in metrics) == 3
    assert (out / "cfg.yaml").exists()
