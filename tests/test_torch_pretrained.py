"""``model_config.pretrained_model_path`` in the port
(``engine/checkpoint.py::load_pretrained_params`` and the server's warm
start) against the JAX package's (``engine/checkpoint.py:81-106``,
``engine/server.py:698-716``), on the FedAvg LR model:

- the same warm params, written as the JAX package's msgpack and as the
  port's ``.pt``, give 2-round trajectories that agree: the val loss every
  round to ``rel 1e-5``, round 0 at the warm point in both (the JAX server
  directly, the port through its CLI on ``-device cpu``);
- a file the port's manager wrote (``latest_model.pt`` with its crc
  sidecar) warm-starts the same params; a bare ``{name: tensor}`` file
  too;
- FedAC's ``w_ag`` starts at the warm point, in both packages; the
  optimizer state is fresh and the round is 0;
- a relative path resolves against ``data_path`` when it does not exist
  as given; a resume wins over the warm start;
- a flax msgpack file or an orbax directory raises ``ValueError`` naming
  the format (the port reads torch files only).
"""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from flax import serialization
from jax.flatten_util import ravel_pytree

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.engine import OptimizationServer as JaxServer
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu.tasks import build_task_datasets as jax_build_datasets
from msrflute_tpu_torch import e2e_trainer
from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.engine import OptimizationServer
from msrflute_tpu_torch.engine.checkpoint import load_pretrained_params
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params
from msrflute_tpu_torch.tasks import build_task_datasets
from test_torch_checkpoint import _write_blob

MODEL = {"model_type": "LR", "num_classes": 4, "input_dim": 8}


def _raw(rounds, strategy="fedavg", pretrained=None, resume=False):
    raw = {
        "model_config": dict(MODEL),
        "strategy": strategy,
        "server_config": {
            "max_iteration": rounds, "num_clients_per_iteration": 3,
            "initial_lr_client": 0.2, "val_freq": 1, "rec_freq": 100,
            "initial_val": True, "pipeline_depth": 0,
            "resume_from_checkpoint": resume,
            "optimizer_config": {"type": "sgd", "lr": 1.0},
            "data_config": {"val": {"batch_size": 8,
                                    "val_data": "val.json"}},
        },
        "client_config": {
            "optimizer_config": {"type": "sgd", "lr": 0.2},
            "data_config": {"train": {"batch_size": 4,
                                      "list_of_train_data": "train.json"}},
        },
    }
    if strategy == "fedac":
        raw["server_config"].update(fedac_eta=0.5, fedac_gamma=1.0)
    if pretrained is not None:
        raw["model_config"]["pretrained_model_path"] = pretrained
    return raw


@pytest.fixture(scope="module")
def warm(tmp_path_factory):
    """A data dir with the blobs and the warm params in both formats: the
    JAX task's init from another key than the servers' seed, trained on
    by nothing."""
    d = tmp_path_factory.mktemp("warm")
    _write_blob(d / "train.json", 12, seed=0)
    _write_blob(d / "val.json", 4, seed=1)
    jt = jax_make_task(JaxFLUTEConfig.from_dict(_raw(1)).model_config)
    params = jax.device_get(jt.init_params(jax.random.PRNGKey(7)))
    (d / "warm.msgpack").write_bytes(serialization.to_bytes(params))
    ptask = make_task(dict(MODEL))
    port_params = from_jax_params(ptask, params)
    torch.save(port_params, d / "warm.pt")
    return str(d), params, ptask.layout().flatten(port_params)


def _jax_server(raw, data_dir, model_dir):
    cfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    cfg.validate(data_dir)
    cfg.data_path = data_dir
    task = jax_make_task(cfg.model_config)
    train, val, _ = jax_build_datasets(cfg, task)
    return JaxServer(task, cfg, train, val_dataset=val, model_dir=model_dir,
                     mesh=make_mesh(num_devices=1), seed=0)


def _port_server(raw, data_dir, model_dir):
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    cfg.data_path = data_dir
    cfg.validate(data_dir)
    task = make_task(cfg.model_config)
    train, val, _ = build_task_datasets(cfg, task)
    return OptimizationServer(task, cfg, train, val_dataset=val,
                              model_dir=model_dir, device="cpu", seed=0)


def test_msgpack_and_pt_warm_starts_give_one_trajectory(warm, tmp_path):
    data_dir, _, flat = warm
    jserver = _jax_server(_raw(2, pretrained="warm.msgpack"), data_dir,
                          str(tmp_path / "jax"))
    want, evaluate = [], jserver._maybe_eval

    def recording_eval(split, round_no, force=False):
        improved = evaluate(split, round_no, force=force)
        want.append((round_no, jserver._last_val["loss"].value))
        return improved

    jserver._maybe_eval = recording_eval
    jserver.train()

    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(
        _raw(2, pretrained="warm.pt")))
    server = e2e_trainer.main(["-config", str(tmp_path / "cfg.yaml"),
                               "-dataPath", data_dir, "-outputPath",
                               str(tmp_path / "port"), "-device", "cpu"])
    got = [(h["round"], h["loss"]) for h in server.history
           if h["split"] == "val"]
    assert [r for r, _ in got] == [r for r, _ in want] == [0, 1, 2]
    for (r, g), (_, w) in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w), (r, g, w)
    # round 0 is the warm point, not the seed's init
    cold = _port_server(_raw(0), data_dir, str(tmp_path / "cold"))
    assert not torch.equal(cold.state.params, flat)


def test_manager_files_and_bare_dicts_warm_start_the_same_params(
        warm, tmp_path):
    data_dir, _, flat = warm
    first = _port_server(_raw(1, pretrained="warm.pt"), data_dir,
                         str(tmp_path / "first"))
    assert torch.equal(first.state.params, flat)
    assert first.state.round == 0
    assert all(float(v.abs().max()) == 0.0
               for v in first.state.opt_state.values()
               if v.is_floating_point())
    first.train()
    latest = str(tmp_path / "first" / "latest_model.pt")
    assert os.path.exists(latest + ".sum")
    second = _port_server(_raw(1, pretrained=latest), data_dir,
                          str(tmp_path / "second"))
    assert torch.equal(second.state.params, first.state.params)
    assert second.state.round == 0
    layout = second.engine.layout
    bare = load_pretrained_params(latest, layout)
    assert list(bare) == layout.names
    assert torch.equal(layout.flatten(bare), first.state.params)


def test_fedac_w_ag_starts_at_the_warm_point(warm, tmp_path):
    data_dir, params, flat = warm
    raw = _raw(1, strategy="fedac", pretrained="warm.pt")
    server = _port_server(raw, data_dir, str(tmp_path / "port"))
    assert torch.equal(server.state.strategy_state["w_ag"], flat)
    jraw = _raw(1, strategy="fedac", pretrained="warm.msgpack")
    jserver = _jax_server(jraw, data_dir, str(tmp_path / "jax"))
    w_ag = jax.device_get(jserver.state.strategy_state["w_ag"])
    np.testing.assert_array_equal(np.asarray(ravel_pytree(w_ag)[0]),
                                  np.asarray(ravel_pytree(params)[0]))
    assert torch.equal(server.state.strategy_state["w_ag"],
                       server.engine.layout.flatten(
                           from_jax_params(server.task, w_ag)))


def test_relative_paths_resolve_against_data_path(warm, tmp_path,
                                                  monkeypatch):
    data_dir, _, flat = warm
    layout = make_task(dict(MODEL)).layout()
    monkeypatch.chdir(tmp_path)
    got = load_pretrained_params("warm.pt", layout, data_dir)
    assert torch.equal(layout.flatten(got), flat)
    # a relative path that exists as given is taken as given
    other = {k: v + 1.0 for k, v in got.items()}
    torch.save(other, tmp_path / "warm.pt")
    again = load_pretrained_params("warm.pt", layout, data_dir)
    assert torch.equal(layout.flatten(again), flat + 1.0)
    with pytest.raises(FileNotFoundError):
        load_pretrained_params("missing.pt", layout, data_dir)


def test_resume_wins_over_the_warm_start(warm, tmp_path):
    data_dir, _, flat = warm
    models = str(tmp_path / "models")
    trained = _port_server(_raw(2), data_dir, models)
    trained.train()
    resumed = _port_server(_raw(3, pretrained="warm.pt", resume=True),
                           data_dir, models)
    assert resumed.state.round == 2
    assert torch.equal(resumed.state.params, trained.state.params)
    assert not torch.equal(resumed.state.params, flat)


@pytest.mark.parametrize("fmt", ["msgpack", "orbax"])
def test_jax_checkpoint_formats_are_refused_naming_the_format(warm, fmt,
                                                              tmp_path):
    data_dir, _, _ = warm
    layout = make_task(dict(MODEL)).layout()
    if fmt == "msgpack":
        path = os.path.join(data_dir, "warm.msgpack")
    else:
        path = str(tmp_path / "ckpt_orbax")
        os.makedirs(path)
        (tmp_path / "ckpt_orbax" / "_METADATA").write_text(json.dumps({}))
    with pytest.raises(ValueError, match=fmt):
        load_pretrained_params(path, layout, data_dir)
