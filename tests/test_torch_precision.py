"""``server_config.precision`` in the port (``engine/client_update.py``,
``engine/round.py``), mirroring the JAX package's ``tests/test_precision.py``
and held to the JAX package's runs on the same data and initial weights:

- absent and an explicit all-float32 block run the same code: bitwise;
- ``compute: bfloat16`` keeps the master params, the pseudo-gradient and
  the stats float32; ``stats: bfloat16`` makes the loss accumulators bf16,
  as in the JAX package;
- the final population loss of a bf16-compute run is within
  ``BF16_FINAL_LOSS_RTOL`` (the JAX suite's: LR 0.10, CNN 0.15) of the JAX
  package's bf16 run, and both learn;
- ``params: bfloat16`` trains, and the server's params stay float32;
- with ``pallas_apply`` the bf16 local copy runs kernel B1's bf16 arm
  (its plain version on the CPU), held to the JAX client update with its
  Pallas kernel in interpret mode, and the same update without the
  kernel to its optax arm: pseudo-gradients within ``B1_BF16_ATOL`` 1e-2
  absolute, a bf16 ulp at the weights' largest magnitude (2^-7 in [1, 2);
  the two packages' bf16 forward passes and trace updates round
  differently), measured 0 (kernel arm) and 5.9e-3 (optax arm).
"""

import jax
import jax.numpy as jnp
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
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu_torch.config import FLUTEConfig, ModelConfig
from msrflute_tpu_torch.config import OptimizerConfig
from msrflute_tpu_torch.data import ArraysDataset
from msrflute_tpu_torch.engine import OptimizationServer
from msrflute_tpu_torch.engine.client_update import (ClientHParams,
                                                     build_client_update)
from msrflute_tpu_torch.engine.round import RoundEngine
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params, to_jax_params
from msrflute_tpu_torch.strategies import select_strategy

BF16_FINAL_LOSS_RTOL = {"lr": 0.10, "cnn": 0.15}
B1_BF16_ATOL = 1e-2
LR_MODEL = {"model_type": "LR", "num_classes": 4, "input_dim": 8}
CNN_MODEL = {"model_type": "CNN", "num_classes": 5, "dropout1": 0.0,
             "dropout2": 0.0}


def _raw_cfg(precision=None, model=None, rounds=6, clients=8):
    raw = {
        "model_config": dict(model or LR_MODEL),
        "strategy": "fedavg",
        "server_config": {
            "max_iteration": rounds, "num_clients_per_iteration": clients,
            "initial_lr_client": 0.3, "rounds_per_step": 1,
            "optimizer_config": {"type": "sgd", "lr": 1.0},
            "val_freq": 10_000, "initial_val": False,
            "data_config": {"val": {"batch_size": 64}},
        },
        "client_config": {
            "num_epochs": 2,
            "optimizer_config": {"type": "sgd", "lr": 0.3},
            "data_config": {"train": {"batch_size": 4}},
        },
    }
    if precision is not None:
        raw["server_config"]["precision"] = precision
    return raw


def _image_dataset(users=6, seed=0):
    """CNN_FEMNIST-shaped users: 28x28 uint8 images whose class sets the
    brightness of one row band."""
    from msrflute_tpu.data import ArraysDataset as JaxArraysDataset
    rng = np.random.default_rng(seed)
    per_user, counts = [], []
    for _ in range(users):
        n = int(rng.integers(4, 9))
        y = rng.integers(0, 5, n).astype(np.int32)
        x = rng.integers(0, 100, (n, 28, 28, 1)).astype(np.uint8)
        for i, c in enumerate(y):
            x[i, 5 * c:5 * c + 5] += 120
        per_user.append({"x": x, "y": y})
        counts.append(n)
    return JaxArraysDataset([f"u{i}" for i in range(users)], per_user,
                            counts)


def _port_dataset(ds):
    return ArraysDataset(ds.user_list, [ds.user_arrays(i)
                                        for i in range(len(ds))],
                         ds.num_samples)


def _population(ds, users=8):
    users = min(users, len(ds))
    return {k: np.concatenate([ds.user_arrays(i)[k] for i in range(users)])
            for k in ("x", "y")}


def _jax_loss(task, params, ds):
    b = _population(ds)
    batch = {"x": jnp.asarray(b["x"]), "y": jnp.asarray(b["y"]),
             "sample_mask": jnp.ones((len(b["y"]),), jnp.float32)}
    return float(task.loss(params, batch, jax.random.PRNGKey(0), False)[0])


def _port_loss(task, params, ds):
    b = _population(ds)
    batch = {"x": torch.from_numpy(b["x"]), "y": torch.from_numpy(b["y"]),
             "sample_mask": torch.ones((len(b["y"]),))}
    return float(task.loss_masked(params, batch))


def _jax_run(raw, ds, tmp_path, tag):
    cfg = JaxFLUTEConfig.from_dict(raw)
    task = jax_make_task(cfg.model_config)
    server = JaxServer(task, cfg, ds, model_dir=str(tmp_path / tag),
                       mesh=make_mesh(num_devices=1), seed=0)
    init = jax.device_get(server.state.params)
    init_loss = _jax_loss(task, server.state.params, ds)
    server.train()
    return init, (init_loss, _jax_loss(task, server.state.params, ds))


def _port_run(raw, ds, tmp_path, tag, init=None):
    cfg = FLUTEConfig.from_dict(raw)
    task = make_task(cfg.model_config)
    server = OptimizationServer(
        task, cfg, _port_dataset(ds), model_dir=str(tmp_path / tag),
        device="cpu", seed=0,
        init_params=None if init is None else from_jax_params(task, init))
    views = lambda: server.engine.params_dict(server.state)  # noqa: E731
    init_loss = _port_loss(task, views(), ds)
    server.train()
    return server, (init_loss, _port_loss(task, views(), ds))


def test_absent_precision_bitwise_equals_explicit_f32(synth_dataset,
                                                      tmp_path):
    a, _ = _port_run(_raw_cfg(), synth_dataset, tmp_path, "none")
    b, _ = _port_run(_raw_cfg({"params": "float32", "compute": "float32",
                               "stats": "float32"}),
                     synth_dataset, tmp_path, "f32")
    assert torch.equal(a.state.params, b.state.params)
    off, _ = _port_run(_raw_cfg({"enable": False, "compute": "bfloat16"}),
                       synth_dataset, tmp_path, "off")
    assert torch.equal(a.state.params, off.state.params)


@pytest.mark.parametrize("family", ["lr", "cnn"])
def test_bf16_compute_final_loss_within_jax_tolerance(family, synth_dataset,
                                                      tmp_path):
    if family == "lr":
        ds, model, rounds, clients = synth_dataset, LR_MODEL, 6, 8
    else:
        ds, model, rounds, clients = _image_dataset(), CNN_MODEL, 3, 3
    raw = _raw_cfg({"compute": "bfloat16"}, model, rounds, clients)
    init, (j0, j1) = _jax_run(raw, ds, tmp_path, "jax")
    _, (p0, p1) = _port_run(raw, ds, tmp_path, "port", init)
    np.testing.assert_allclose(p0, j0, rtol=1e-5)     # the same start
    np.testing.assert_allclose(p1, j1, rtol=BF16_FINAL_LOSS_RTOL[family])
    assert j1 < j0 and p1 < p0        # both learn


def test_bf16_params_policy_trains(synth_dataset, tmp_path):
    server, (init_loss, final_loss) = _port_run(
        _raw_cfg({"params": "bfloat16", "compute": "bfloat16"}),
        synth_dataset, tmp_path, "pbf16")
    assert server.state.params.dtype == torch.float32
    assert final_loss < init_loss


def _client_inputs(K=3, S=4, B=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(K, S, B, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=(K, S, B)).astype(np.int32)
    mask = np.ones((K, S, B), np.float32)
    mask[1, 2:] = 0.0                    # client 1 runs out of data
    return x, y, mask


def _port_client(hp, opt=None, x=None, y=None, mask=None, params=None):
    task = make_task(ModelConfig.from_dict(LR_MODEL))
    if params is None:
        params = task.layout().flatten(task.init_params(0))
    cu = build_client_update(task, opt or OptimizerConfig(type="sgd",
                                                          lr=0.1), hp)
    return cu(params, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
              torch.from_numpy(mask), 0.1), task, params


def test_bf16_compute_keeps_f32_master_params_and_stats():
    x, y, mask = _client_inputs()
    (pg, tl, ns, stats), _, _ = _port_client(
        ClientHParams(num_epochs=2, compute_dtype="bfloat16"), x=x, y=y,
        mask=mask)
    assert pg.dtype == tl.dtype == ns.dtype == torch.float32
    for key in ("mean", "mag", "norm"):
        assert stats[key].dtype == torch.float32, key
    assert bool(torch.isfinite(tl).all())
    (_, tl16, ns16, _), _, _ = _port_client(
        ClientHParams(stats_dtype="bfloat16"), x=x, y=y, mask=mask)
    assert tl16.dtype == ns16.dtype == torch.bfloat16


def test_rejects_non_float_precision_dtype():
    task = make_task(ModelConfig.from_dict(LR_MODEL))
    with pytest.raises(ValueError, match="floating"):
        build_client_update(task, OptimizerConfig(type="sgd", lr=0.1),
                            ClientHParams(compute_dtype="int32"))


def test_engine_exposes_precision_policy(synth_dataset):
    for block, want in (({"compute": "bfloat16"}, {"compute": "bfloat16"}),
                        ({"enable": False, "params": "bfloat16"}, {}),
                        (None, {})):
        cfg = FLUTEConfig.from_dict(_raw_cfg(block))
        task = make_task(cfg.model_config)
        engine = RoundEngine(task, cfg, select_strategy(cfg.strategy)(cfg),
                             torch.device("cpu"))
        assert engine.precision == want
        assert engine.hparams.compute_dtype == want.get("compute")


@pytest.mark.parametrize("pallas", [True, False])
def test_bf16_local_copy_matches_its_jax_arm(pallas):
    """``params: bfloat16`` with and without ``pallas_apply``: each arm
    against the JAX package's own (the kernel keeps ``m'`` in float32 for
    ``p'``, optax rounds the trace first, so the two arms differ)."""
    x, y, mask = _client_inputs(seed=4)
    hp = dict(num_epochs=2, pallas_apply=pallas, param_dtype="bfloat16",
              compute_dtype="bfloat16")
    opt = {"type": "sgd", "lr": 0.1, "momentum": 0.9}
    (pg, _, _, _), task, params = _port_client(
        ClientHParams(**hp), OptimizerConfig.from_dict(opt), x, y, mask)
    jtask = jax_make_task(JaxModelConfig.from_dict(LR_MODEL))
    jcu = jax_build_client_update(jtask, JaxOptimizerConfig.from_dict(opt),
                                  JaxClientHParams(**hp))
    jp = to_jax_params(task.layout().views(params))
    jpg = jax.vmap(lambda a, b, m: jcu(
        jp, {"x": a, "y": b}, m, jnp.float32(0.1),
        jax.random.PRNGKey(0))[0])(jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(mask))
    want = np.stack([task.layout().flatten(from_jax_params(
        task, jax.device_get(jax.tree.map(lambda t, k=k: t[k], jpg))))
        .numpy() for k in range(x.shape[0])])
    assert pg.dtype == torch.float32
    np.testing.assert_allclose(pg.numpy(), want, rtol=0, atol=B1_BF16_ATOL)
    assert float(np.abs(want).max()) > 10 * B1_BF16_ATOL   # it moved
