"""The port's two-slot ``latest`` checkpoint (``engine/checkpoint.py``), as the
JAX package's msgpack backend keeps it: every save rotates the previous
``latest`` and its crc32 sidecar to ``.prev``; a load whose ``latest`` is
corrupt or torn falls back to ``.prev`` and records a recovery event, and
raises when every slot is bad.  Driven through the FedAvg LR server on the
CPU, a checkpoint every round."""

import json
import os

import numpy as np
import pytest
import torch

from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.engine import OptimizationServer
from msrflute_tpu_torch.engine.checkpoint import LATEST, LATEST_PREV
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.resilience.integrity import (
    CheckpointCorruptionError, blob_checksum, read_sidecar)
from msrflute_tpu_torch.tasks import build_task_datasets


def _write_blob(path, num_users, seed):
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(99).normal(size=(8, 4))
    users = [f"u{i:03d}" for i in range(num_users)]
    data, labels, counts = {}, {}, []
    for u in users:
        n = int(rng.integers(6, 20))
        x = rng.normal(size=(n, 8))
        data[u] = {"x": x.tolist()}
        labels[u] = np.argmax(x @ w, axis=1).tolist()
        counts.append(n)
    with open(path, "w") as fh:
        json.dump({"users": users, "num_samples": counts, "user_data": data,
                   "user_data_label": labels}, fh)


def _raw(rounds, resume=False):
    return {
        "model_config": {"model_type": "LR", "num_classes": 4,
                         "input_dim": 8},
        "strategy": "fedavg",
        "server_config": {
            "max_iteration": rounds, "num_clients_per_iteration": 3,
            "initial_lr_client": 0.2, "rounds_per_step": 1,
            "model_backup_freq": 1, "val_freq": 100, "rec_freq": 100,
            "initial_val": False, "resume_from_checkpoint": resume,
            # adam, so the optimizer state is part of what must come back
            "optimizer_config": {"type": "adam", "lr": 0.01},
        },
        "client_config": {
            "optimizer_config": {"type": "sgd", "lr": 0.2, "momentum": 0.5},
            "data_config": {"train": {"batch_size": 4,
                                      "list_of_train_data": "train.json"}},
        },
    }


def _server(data_dir, model_dir, rounds, resume=False):
    cfg = FLUTEConfig.from_dict(_raw(rounds, resume))
    cfg.validate(data_dir)
    task = make_task(cfg.model_config)
    train, _, _ = build_task_datasets(cfg, task)
    return OptimizationServer(task, cfg, train, model_dir=model_dir,
                              device="cpu", seed=0)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("blob")
    _write_blob(d / "train.json", 12, seed=0)
    return str(d)


@pytest.fixture
def trained(data_dir, tmp_path):
    """3 rounds: ``latest`` at round 3, ``.prev`` and ``epoch2.pt`` at
    round 2."""
    server = _server(data_dir, str(tmp_path), 3)
    server.train()
    return server, tmp_path


def _same_state(a, b):
    assert a.round == b.round
    assert torch.equal(a.params, b.params)
    assert set(a.opt_state) == set(b.opt_state)
    for k in a.opt_state:
        assert torch.equal(a.opt_state[k], b.opt_state[k]), k


def test_every_save_rotates_latest_and_its_sidecar(trained):
    server, models = trained
    ckpt = server.ckpt
    for name in (LATEST, LATEST_PREV):
        blob = (models / name).read_bytes()
        assert read_sidecar(str(models / name)) == {
            "crc32": blob_checksum(blob), "size": len(blob)}
    assert ckpt.load(torch.device("cpu")).round == 3
    _same_state(ckpt.load(torch.device("cpu"), LATEST_PREV),
                ckpt.load(torch.device("cpu"), "epoch2.pt"))
    assert ckpt.recovery_events == []


def test_corrupt_latest_resumes_from_prev_bit_identically(trained,
                                                          data_dir):
    server, models = trained
    round2 = server.ckpt.load(torch.device("cpu"), "epoch2.pt")
    blob = bytearray((models / LATEST).read_bytes())
    blob[len(blob) // 2] ^= 0xFF                      # one flipped byte
    (models / LATEST).write_bytes(bytes(blob))
    resumed = _server(data_dir, str(models), 4, resume=True)
    _same_state(resumed.state, round2)
    events = resumed.ckpt.recovery_events
    assert [e["event"].split(":")[0] for e in events] == [
        "integrity check failed", "restored from backup slot"]
    assert events[1]["path"].endswith(LATEST_PREV)
    resumed.train()                                   # and it trains on
    assert resumed.state.round == 4


@pytest.mark.parametrize("sidecar", ["kept", "lost"])
def test_torn_latest_resumes_from_prev(trained, data_dir, sidecar):
    """A write cut short: the file holds half its bytes, with its sidecar
    (a size mismatch) or without one (the file does not unpickle)."""
    server, models = trained
    round2 = server.ckpt.load(torch.device("cpu"), "epoch2.pt")
    path = models / LATEST
    path.write_bytes(path.read_bytes()[: path.stat().st_size // 2])
    if sidecar == "lost":
        os.remove(str(path) + ".sum")
    resumed = _server(data_dir, str(models), 4, resume=True)
    _same_state(resumed.state, round2)
    assert resumed.ckpt.recovery_events[-1]["event"] == \
        "restored from backup slot"


def test_both_slots_bad_raises(trained, data_dir):
    _, models = trained
    for name in (LATEST, LATEST_PREV):
        path = models / name
        path.write_bytes(path.read_bytes()[:100])
    with pytest.raises(CheckpointCorruptionError, match="no loadable"):
        _server(data_dir, str(models), 4, resume=True)


def test_no_checkpoint_starts_fresh(data_dir, tmp_path):
    server = _server(data_dir, str(tmp_path), 2, resume=True)
    assert server.state.round == 0
    assert server.ckpt.load(torch.device("cpu")) is None


def test_corrupt_best_model_is_skipped_by_fall_back(trained):
    """A best-model file has one slot: when it is bad, the fallback to the
    best model records a recovery event and keeps the current state, as
    the JAX package's load returns None, and training is not aborted."""
    server, models = trained
    server.ckpt.save_best(server.state, server.best_model_criterion)
    name = f"best_val_{server.best_model_criterion}_model.pt"
    blob = bytearray((models / name).read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    (models / name).write_bytes(bytes(blob))
    before = server.state.params.clone()
    assert server.ckpt.load(torch.device("cpu"), name) is None
    server._fall_back()
    assert torch.equal(server.state.params, before)
    assert server.state.round == 3
    events = server.ckpt.recovery_events
    assert events and all(e["path"].endswith(name) for e in events)
    assert events[-1]["event"].startswith("integrity check failed")
