"""Layer controls, server replay and the optimizer family end to end: the
port's CLI (``-device cpu``) against the JAX package's server on one
generated LR blob and the same initial weights, and the client update
against the JAX package's.

- ``client_config.freeze_layer``: frozen leaves' pseudo-gradients are
  exactly 0 (patterns are substrings of the ``/``-joined flax path, so
  ``Conv_0`` takes its kernel and bias and ``Dense_1/bias`` one leaf), the
  others bitwise those of an unfrozen run; the JAX package freezes the
  same leaves.
- ``updatable_layers`` (``re.match`` on the ``.``-joined path): the client
  update against the JAX package's, ``rtol 1e-5`` (as
  ``tests/test_torch_client_update.py``), frozen leaves exactly 0 in both.
- 3 CLI rounds of LR against the JAX server, the val loss every round to
  ``rel 1e-5`` and the accuracy to one sample (the existing trajectory
  tolerance, ``tests/test_torch_cli_trajectories.py``): ``freeze_layer``;
  server ``lamb``, ``lars`` and ``yogi`` under ``rampup-keep-expdecay-keep``;
  client SGD with nesterov and weight decay, and client adamW with weight
  decay; server replay on ``train_data_server`` with ``updatable_names``
  (a kernel-only allowlist, and the empty list, which freezes every leaf)
  after the clients' own rounds, with the final params to ``rtol 1e-5``
  and, with the clients' learning rate 0, the bias unmoved.
"""

import json

import jax
import numpy as np
import pytest
import torch

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.config import ModelConfig as JaxModelConfig
from msrflute_tpu.config import OptimizerConfig as JaxOptimizerConfig
from msrflute_tpu.engine import OptimizationServer as JaxServer
from msrflute_tpu.engine.client_update import \
    ClientHParams as JaxClientHParams
from msrflute_tpu.engine.client_update import \
    build_client_update as jax_build_client_update
from msrflute_tpu.engine.client_update import _freeze_layers
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu.tasks import build_server_train_dataset as jax_replay_ds
from msrflute_tpu.tasks import build_task_datasets as jax_build_datasets
from msrflute_tpu_torch.config import ModelConfig, OptimizerConfig
from msrflute_tpu_torch.engine.client_update import (ClientHParams,
                                                     build_client_update)
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params, to_jax_params
from test_torch_cli_trajectories import _compare, _port_cli_history

LR_MODEL = {"model_type": "LR", "num_classes": 4, "input_dim": 8}
CNN_MODEL = {"model_type": "CNN", "num_classes": 5, "dropout1": 0.0,
             "dropout2": 0.0}


def _lr_blob(path, users, seed, w_true):
    rng = np.random.default_rng(seed)
    names = [f"u{seed}_{i:03d}" for i in range(users)]
    data, labels, counts = {}, {}, []
    for u in names:
        n = int(rng.integers(5, 13))
        x = rng.normal(size=(n, 8)).astype(np.float32)
        y = np.argmax(x @ w_true, axis=-1)
        data[u] = {"x": x.tolist()}
        labels[u] = y.tolist()
        counts.append(n)
    with open(path, "w") as fh:
        json.dump({"users": names, "num_samples": counts, "user_data": data,
                   "user_data_label": labels}, fh)


@pytest.fixture(scope="module")
def lr_blob(tmp_path_factory):
    d = tmp_path_factory.mktemp("lr_controls")
    w = np.random.default_rng(99).normal(size=(8, 4))
    _lr_blob(d / "train.json", 10, 0, w)
    _lr_blob(d / "val.json", 4, 1, w)
    _lr_blob(d / "server.json", 3, 2, w)
    return str(d)


def _config(server_opt=None, client_opt=None, annealing=None, client=None,
            replay=None, client_lr=0.3):
    raw = {
        "model_config": dict(LR_MODEL),
        "strategy": "fedavg",
        "server_config": {
            "max_iteration": 3, "num_clients_per_iteration": 3,
            "initial_lr_client": client_lr, "val_freq": 1, "rec_freq": 100,
            "initial_val": True, "best_model_criterion": "acc",
            "rounds_per_step": 1,
            "optimizer_config": server_opt or {"type": "sgd", "lr": 1.0},
            "data_config": {"val": {"batch_size": 16,
                                    "val_data": "val.json"}},
        },
        "client_config": {
            "optimizer_config": client_opt or {"type": "sgd",
                                               "lr": client_lr},
            "data_config": {"train": {"batch_size": 4,
                                      "list_of_train_data": "train.json"}},
            **(client or {}),
        },
    }
    if annealing:
        raw["server_config"]["annealing_config"] = annealing
    if replay is not None:
        raw["server_config"]["server_replay_config"] = replay
        raw["server_config"]["data_config"]["train"] = {
            "batch_size": 4, "train_data_server": "server.json"}
    return raw


def _jax_run(raw, data_dir, model_dir):
    """The JAX server in process (one device), with server replay's data
    when the config names it; records the val metrics every round.  The
    JAX schema refuses ``server_replay_config.updatable_names``, which its
    server reads from there: it is set after validation, as the JAX
    package's own test does (``tests/test_plugins_and_nbest.py``)."""
    raw = json.loads(json.dumps(raw))
    replay = raw["server_config"].get("server_replay_config") or {}
    names = replay.pop("updatable_names", None)
    cfg = JaxFLUTEConfig.from_dict(raw)
    if names is not None:
        cfg.server_config.server_replay_config.extra["updatable_names"] = \
            names
    cfg.validate(data_dir)
    task = jax_make_task(cfg.model_config)
    train, val, _ = jax_build_datasets(cfg, task)
    server = JaxServer(task, cfg, train, val_dataset=val,
                       model_dir=model_dir, mesh=make_mesh(num_devices=1),
                       seed=0,
                       server_train_dataset=jax_replay_ds(cfg, task))
    init = jax.device_get(server.state.params)
    history, evaluate = [], server._maybe_eval

    def recording_eval(split, round_no, force=False):
        improved = evaluate(split, round_no, force=force)
        history.append((round_no, {k: m.value for k, m in
                                   server._last_val.items()}))
        return improved

    server._maybe_eval = recording_eval
    server.train()
    return server, init, history, val


def _both(raw, lr_blob, tmp_path, monkeypatch):
    jserver, init, want, val = _jax_run(raw, lr_blob, str(tmp_path / "jax"))
    server, got = _port_cli_history(raw, lr_blob, tmp_path / "port", init,
                                    monkeypatch,
                                    make_task(ModelConfig.from_dict(
                                        LR_MODEL)))
    _compare(got, want, sum(val.num_samples), 1e-5)
    return jserver, server, init


TRAJECTORIES = {
    "freeze_bias": dict(client={"freeze_layer": "Dense_0/bias"}),
    "server_lamb_rampup": dict(
        server_opt={"type": "lamb", "lr": 0.5, "weight_decay": 0.01},
        annealing={"type": "rampup-keep-expdecay-keep", "peak_lr": 0.5,
                   "floor_lr": 0.05, "rampup_steps": 1, "hold_steps": 1,
                   "decay_steps": 2}),
    "server_lars": dict(server_opt={"type": "LarsSGD", "lr": 20.0,
                                    "momentum": 0.5}),
    "server_yogi": dict(server_opt={"type": "yogi", "lr": 0.05,
                                    "weight_decay": 1e-3}),
    "client_sgd_nesterov_wd": dict(client_opt={
        "type": "sgd", "lr": 0.3, "momentum": 0.9, "nesterov": True,
        "weight_decay": 1e-3}),
    "client_adamw_wd": dict(client_opt={"type": "adamW", "lr": 0.01,
                                        "weight_decay": 0.01}),
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_cli_trajectory_matches_jax(name, lr_blob, tmp_path, monkeypatch):
    _, server, _ = _both(_config(**TRAJECTORIES[name]), lr_blob, tmp_path,
                         monkeypatch)
    assert server.state.round == 3


@pytest.mark.parametrize("names", [[r".*\.kernel"], []],
                         ids=["kernel_only", "freeze_all"])
def test_server_replay_trajectory_matches_jax(names, lr_blob, tmp_path,
                                              monkeypatch):
    """Clients at learning rate 0: only the replay moves the model."""
    raw = _config(client_lr=0.0, replay={
        "server_iterations": 2, "updatable_names": names,
        "optimizer_config": {"type": "sgd", "lr": 0.5}})
    jserver, server, init = _both(raw, lr_blob, tmp_path, monkeypatch)
    assert server.server_replay is not None
    want = jax.device_get(jserver.state.params)["Dense_0"]
    got = to_jax_params(server.engine.params_dict(server.state))["Dense_0"]
    for leaf in ("kernel", "bias"):
        np.testing.assert_allclose(got[leaf], want[leaf], rtol=1e-5,
                                   atol=1e-7)
    start = init["Dense_0"]
    np.testing.assert_array_equal(got["bias"], start["bias"])
    assert (not np.array_equal(got["kernel"], start["kernel"])) == \
        bool(names)


def _cnn_inputs(K=2, S=2, B=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(K, S, B, 28, 28, 1)).astype(np.uint8)
    y = rng.integers(0, 5, size=(K, S, B)).astype(np.int32)
    return x, y, np.ones((K, S, B), np.float32)


def test_freeze_layer_zeroes_exactly_the_jax_package_leaves():
    task = make_task(ModelConfig.from_dict(CNN_MODEL))
    layout = task.layout()
    params = layout.flatten(task.init_params(0))
    x, y, mask = _cnn_inputs()
    arrays = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    freeze = ("Conv_0", "Dense_1/bias")
    run = lambda hp: build_client_update(  # noqa: E731
        task, OptimizerConfig(type="sgd", lr=0.1), hp)(
            params, arrays, torch.from_numpy(mask), 0.1)[0]
    free = run(ClientHParams())
    frozen = run(ClientHParams(freeze_layers=freeze))
    jtree = _freeze_layers(to_jax_params(layout.views(free[0])), freeze)
    want_zero = {n for n, v in from_jax_params(task, jtree).items()
                 if not v.any()}
    assert want_zero == {"Conv_0.weight", "Conv_0.bias", "Dense_1.bias"}
    for name, a, n in zip(layout.names, layout.offsets, layout.sizes):
        cols = slice(a, a + n)
        if name in want_zero:
            assert not frozen[:, cols].any(), name
        else:
            assert torch.equal(frozen[:, cols], free[:, cols]), name


def test_updatable_layers_client_update_matches_jax():
    rng = np.random.default_rng(5)
    K, S, B = 3, 3, 4
    x = rng.normal(size=(K, S, B, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=(K, S, B)).astype(np.int32)
    mask = np.ones((K, S, B), np.float32)
    patterns = (r"Dense_0\.k",)
    opt = {"type": "sgd", "lr": 0.1, "momentum": 0.9}
    task = make_task(ModelConfig.from_dict(LR_MODEL))
    params = task.layout().flatten(task.init_params(1))
    pg = build_client_update(
        task, OptimizerConfig.from_dict(opt),
        ClientHParams(num_epochs=2, updatable_layers=patterns))(
            params, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
            torch.from_numpy(mask), 0.1)[0]
    jtask = jax_make_task(JaxModelConfig.from_dict(LR_MODEL))
    jcu = jax_build_client_update(
        jtask, JaxOptimizerConfig.from_dict(opt),
        JaxClientHParams(num_epochs=2, updatable_layers=patterns))
    jp = to_jax_params(task.layout().views(params))
    jpg = jax.vmap(lambda a, b, m: jcu(
        jp, {"x": a, "y": b}, m, 0.1, jax.random.PRNGKey(0))[0])(x, y, mask)
    for k in range(K):
        want = from_jax_params(task, jax.device_get(
            jax.tree.map(lambda t: t[k], jpg)))
        got = task.layout().views(pg[k])
        np.testing.assert_allclose(got["Dense_0.weight"].numpy(),
                                   want["Dense_0.weight"].numpy(),
                                   rtol=1e-5, atol=1e-7)
        assert not got["Dense_0.bias"].any()
        assert not want["Dense_0.bias"].any()
