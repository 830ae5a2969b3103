"""The strategies beyond FedAvg / DGA — q-FFL, FedAC, SCAFFOLD (host store
and device table) and error-feedback quantization (host store and device
table) — through the port's CLI (``-device cpu``) against the JAX
package's server, on one generated LR blob (no dropout) and the same
initial weights, 6 rounds with val loss and accuracy every round; and the
pieces they are built of, each against its JAX counterpart:

- q-FFL's weight, FedAC's broadcast point and coupled server update;
- the client update with a ``grad_offset`` (SCAFFOLD's ``c - c_i``), on
  both arms (kernel B1's wrapper and the plain tail);
- EF's quantized payload, bitwise against the JAX plain path (op by op)
  on the same ``corrected`` input;
- ``apply_custom_weights`` twice from one state leaves it untouched.

Tolerances: val loss ``rel 1e-5`` (the frameworks differ in reduction
order only), accuracy to one val sample; the unit pieces ``rtol 1e-6``
(``1e-5`` through local training), EF's payload bitwise.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.config import ModelConfig as JaxModelConfig
from msrflute_tpu.config import OptimizerConfig as JaxOptimizerConfig
from msrflute_tpu.engine import OptimizationServer as JaxServer
from msrflute_tpu.engine.client_update import ClientHParams as JaxHParams
from msrflute_tpu.engine.client_update import \
    build_client_update as jax_build_client_update
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu.strategies import select_strategy as jax_select_strategy
from msrflute_tpu.tasks import build_task_datasets as jax_build_datasets
from msrflute_tpu_torch import e2e_trainer
from msrflute_tpu_torch.config import FLUTEConfig, ModelConfig, \
    OptimizerConfig
from msrflute_tpu_torch.engine import RoundEngine
from msrflute_tpu_torch.engine.client_update import (ClientHParams,
                                                     build_client_update)
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params, to_jax_params
from msrflute_tpu_torch.strategies import select_strategy

ROUNDS = 6
LOSS_REL = 1e-5


def write_lr_blob(path, num_users, lo, hi, seed):
    """Linearly separable 8-feature, 4-class users (the labels of every
    split come from one shared weight matrix)."""
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(99).normal(size=(8, 4))
    users = [f"u{i:03d}" for i in range(num_users)]
    data, labels, counts = {}, {}, []
    for u in users:
        n = int(rng.integers(lo, hi + 1))
        x = rng.normal(size=(n, 8))
        y = np.argmax(x @ w + 0.1 * rng.normal(size=(n, 4)), axis=1)
        data[u] = {"x": x.tolist()}
        labels[u] = y.tolist()
        counts.append(n)
    with open(path, "w") as fh:
        json.dump({"users": users, "num_samples": counts, "user_data": data,
                   "user_data_label": labels}, fh)


def lr_config(strategy, rounds=ROUNDS, server=None, client=None):
    raw = {
        "model_config": {"model_type": "LR", "num_classes": 4,
                         "input_dim": 8},
        "strategy": strategy,
        "server_config": {
            "max_iteration": rounds, "num_clients_per_iteration": 4,
            "initial_lr_client": 0.2,
            "optimizer_config": {"type": "sgd", "lr": 1.0},
            "val_freq": 1, "rec_freq": 1000, "initial_val": True,
            "best_model_criterion": "loss", "pipeline_depth": 0,
            "data_config": {"val": {"batch_size": 16,
                                    "val_data": "val.json"}}},
        "client_config": {
            "optimizer_config": {"type": "sgd", "lr": 0.2},
            "data_config": {"train": {"batch_size": 4,
                                      "list_of_train_data": "train.json"}}},
    }
    raw["server_config"].update(server or {})
    raw["client_config"].update(client or {})
    return raw


@pytest.fixture(scope="module")
def lr_blob(tmp_path_factory):
    d = tmp_path_factory.mktemp("lr_blob")
    write_lr_blob(d / "train.json", 16, 6, 24, seed=0)
    write_lr_blob(d / "val.json", 3, 6, 24, seed=1)
    return str(d)


def jax_history(raw, data_dir, model_dir):
    """The JAX package's server on ``raw``: its initial params, the val
    ``(round, loss, acc)`` of every evaluation, and the val sample count."""
    init, history, n_val = jax_history_metrics(raw, data_dir, model_dir)
    return init, [(r, m["loss"], m["acc"]) for r, m in history], n_val


def jax_history_metrics(raw, data_dir, model_dir):
    """:func:`jax_history` with every val metric: ``(round, {name:
    value})``."""
    cfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    cfg.validate(data_dir)
    task = jax_make_task(cfg.model_config)
    train, val, _ = jax_build_datasets(cfg, task)
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
    return init, history, sum(val.num_samples)


def port_cli_history(raw, data_dir, out, init_jax, monkeypatch):
    """The port's CLI in process, its task's init replaced by the JAX
    package's initial weights: the server and its val history."""
    out.mkdir()
    cfg_path = out / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    task = make_task(ModelConfig.from_dict(raw["model_config"]))
    monkeypatch.setattr(type(task), "init_params",
                        lambda self, seed: from_jax_params(self, init_jax))
    server = e2e_trainer.main(["-config", str(cfg_path), "-dataPath",
                               data_dir, "-outputPath", str(out / "run"),
                               "-device", "cpu"])
    return server, [(h["round"], h["loss"], h["acc"])
                    for h in server.history if h["split"] == "val"]


def assert_same_trajectory(got, want, n_val):
    assert [r for r, _, _ in got] == [r for r, _, _ in want] == \
        list(range(ROUNDS + 1))
    for (r, gl, ga), (_, wl, wa) in zip(got, want):
        assert abs(gl - wl) <= LOSS_REL * abs(wl), (r, gl, wl)
        assert abs(ga - wa) * n_val <= 1.0 + 1e-9, (r, ga, wa)
    assert got[-1][1] < got[0][1]          # it learned


TRAJECTORIES = {
    "qffl": lr_config("qffl", server={"qffl_q": 2.0}),
    "fedac": lr_config("fedac", server={"fedac_eta": 0.5,
                                        "fedac_gamma": 1.0}),
    "scaffold_host": lr_config("scaffold", client={"num_epochs": 2}),
    "scaffold_device": lr_config(
        "scaffold", server={"scaffold_device_controls": True,
                            "scaffold_flush_freq": 2},
        client={"num_epochs": 2}),
    "ef_quant_host": lr_config("ef_quant", client={
        "quant_bits": 4, "quant_thresh": 0.2, "quant_anneal": 0.95}),
    "ef_quant_device": lr_config(
        "ef_quant", server={"ef_device_residuals": True},
        client={"quant_bits": 4, "quant_thresh": 0.2}),
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_cli_trajectory_matches_jax(name, lr_blob, tmp_path, monkeypatch):
    raw = TRAJECTORIES[name]
    init, want, n_val = jax_history(raw, lr_blob, str(tmp_path / "jax"))
    server, got = port_cli_history(raw, lr_blob, tmp_path / "port", init,
                                   monkeypatch)
    assert_same_trajectory(got, want, n_val)
    if name.startswith("scaffold"):
        assert server.scaffold_store.round() == ROUNDS
        assert (server.scaffold_device is not None) == \
            name.endswith("device")
    if name.startswith("ef_quant"):
        assert server.ef_store.round() == ROUNDS
        assert (server.ef_device is not None) == name.endswith("device")


# ----------------------------------------------------------------------
def _both(raw):
    jcfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    pcfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    return (jax_select_strategy(raw["strategy"])(jcfg, None),
            select_strategy(raw["strategy"])(pcfg))


@pytest.mark.parametrize("q", [0.0, 0.5, 2.0, 7.0])
def test_qffl_weight_matches_jax(q):
    jstrat, pstrat = _both(lr_config("qffl", server={"qffl_q": q}))
    rng = np.random.default_rng(0)
    ns = np.asarray([0.0, 3.0, 50.0, 400.0, 12.0], np.float32)
    loss = np.asarray([0.0, 0.3, 2.5, 9.0, np.nan], np.float32)
    tl = rng.uniform(0, 5, 5).astype(np.float32)
    want = jax.vmap(lambda n, t, m: jstrat.client_weight(
        num_samples=n, train_loss=t, stats={"mean_sample_loss": m},
        rng=jax.random.PRNGKey(0)))(jnp.asarray(ns), jnp.asarray(tl),
                                    jnp.asarray(loss))
    got = pstrat.client_weight(
        num_samples=torch.from_numpy(ns), train_loss=torch.from_numpy(tl),
        stats={"mean_sample_loss": torch.from_numpy(loss)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    if q == 0.0:        # FedAvg weight for weight
        fedavg = select_strategy("fedavg")(FLUTEConfig.from_dict(
            lr_config("fedavg")))
        np.testing.assert_array_equal(
            got.numpy(), fedavg.client_weight(
                num_samples=torch.from_numpy(ns), train_loss=None,
                stats=None).numpy())


@pytest.mark.parametrize("server", [
    {"fedac_eta": 0.5, "fedac_gamma": 1.0},
    {"fedac_eta": 1.0, "fedac_gamma": 1.0, "fedac_alpha": 1.0,
     "fedac_beta": 1.0},
    {"fedac_eta": 0.2, "fedac_gamma": 3.0, "fedac_alpha": 4.0,
     "fedac_beta": 2.5}])
def test_fedac_sequences_match_jax(server):
    jstrat, pstrat = _both(lr_config("fedac", server=server))
    rng = np.random.default_rng(1)
    w, ag, agg = (rng.normal(size=40).astype(np.float32) for _ in range(3))
    jstate = {"w_ag": jnp.asarray(ag)}
    pstate = {"w_ag": torch.from_numpy(ag)}
    np.testing.assert_allclose(
        pstrat.broadcast_params(torch.from_numpy(w), pstate).numpy(),
        np.asarray(jstrat.broadcast_params(jnp.asarray(w), jstate)),
        rtol=1e-6)
    jw, jst = jstrat.apply_server_update(jnp.asarray(w), jnp.asarray(agg),
                                         jstate, 0.7)
    pw, pst = pstrat.apply_server_update(torch.from_numpy(w),
                                         torch.from_numpy(agg), pstate, 0.7)
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(pst["w_ag"].numpy(),
                               np.asarray(jst["w_ag"]), rtol=1e-6)
    init = pstrat.init_state(torch.from_numpy(w))["w_ag"]
    assert torch.equal(init, torch.from_numpy(w))


K, S, B = 4, 3, 4


@pytest.mark.parametrize("pallas", [False, True])
def test_client_update_with_grad_offset_matches_jax(pallas):
    """SCAFFOLD's offset enters every local step before the clip, in the
    JAX association ``clip((g + o) + mu (w - w0))``; with ``pallas_apply``
    the offset goes in before kernel B1 (its plain version here)."""
    model = {"num_classes": 4, "input_dim": 8}
    jt = jax_make_task(JaxModelConfig(model_type="LR", extra=dict(model)))
    pt = make_task(ModelConfig(model_type="LR", extra=dict(model)))
    jp = jax.device_get(jt.init_params(jax.random.PRNGKey(0)))
    layout = pt.layout()
    g0 = layout.flatten(from_jax_params(pt, jp))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(K, S, B, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=(K, S, B)).astype(np.int32)
    mask = np.ones((K, S, B), np.float32)
    mask[1, -1] = 0.0
    mask[3] = 0.0
    off = (0.1 * rng.normal(size=(K, layout.numel))).astype(np.float32)
    off[3] = 0.0
    # the same offsets in flax's layout (the port transposes Dense kernels)
    joff = jax.tree.map(lambda *rows: np.stack(rows), *[
        to_jax_params(layout.views(torch.from_numpy(off[k])))
        for k in range(K)])

    jcu = jax_build_client_update(
        jt, JaxOptimizerConfig(type="sgd", lr=0.2),
        JaxHParams(max_grad_norm=0.8, fedprox_mu=0.01, num_epochs=2))
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(1), i))(
        jnp.arange(K))
    jpg, jtl, _, _ = jax.jit(jax.vmap(
        lambda a, m, k, o: jcu(jp, a, m, jnp.float32(0.2), k,
                               grad_offset=o)))(
        {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jnp.asarray(mask), keys,
        joff)
    pcu = build_client_update(
        pt, OptimizerConfig(type="sgd", lr=0.2),
        ClientHParams(max_grad_norm=0.8, fedprox_mu=0.01, num_epochs=2,
                      pallas_apply=pallas))
    ppg, ptl, _, _ = pcu(g0, {"x": torch.from_numpy(x),
                              "y": torch.from_numpy(y)},
                         torch.from_numpy(mask), 0.2, None,
                         grad_offset=torch.from_numpy(off))
    want = np.stack([layout.flatten(from_jax_params(pt, jax.tree.map(
        lambda a, k=k: np.asarray(a)[k], jax.device_get(jpg)))).numpy()
        for k in range(K)])
    np.testing.assert_allclose(ppg.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ptl.numpy(), np.asarray(jtl), rtol=1e-5)
    np.testing.assert_array_equal(ppg[3].numpy(), 0.0)


@pytest.mark.parametrize("bits,thresh", [(4, 0.0), (4, 0.3), (2, 0.6),
                                         (10, 0.9)])
def test_ef_payload_is_bitwise_the_jax_plain_path(bits, thresh):
    """Given the same ``pg`` and residual rows (so the same ``corrected``),
    the quantized payload and the new residual are bitwise the JAX
    package's: each row one leaf, kernel B3's plain version here."""
    raw = lr_config("ef_quant", client={"quant_bits": bits,
                                        "quant_thresh": thresh})
    jstrat, pstrat = _both(raw)
    rng = np.random.default_rng(bits)
    pgs = (rng.normal(size=(5, 1003)) *
           np.logspace(-3, 0, 5)[:, None]).astype(np.float32)
    res = (0.01 * rng.normal(size=(5, 1003))).astype(np.float32)
    res[4] = 0.0
    # op by op, as the other quantization tests hold B3: under jax.jit
    # XLA's CPU fusion contracts ``lo + idx * width`` into a fused
    # multiply-add, an ulp off the JAX package's own unjitted result
    jq, jres = jstrat.ef_step(jnp.asarray(pgs), jnp.asarray(res))
    pq, pres = pstrat.ef_step(torch.from_numpy(pgs), torch.from_numpy(res))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(pres.numpy(), np.asarray(jres))
    # the EF identity q + e' == corrected, to one rounding of the
    # subtraction ``corrected - q``
    corrected = pgs + res
    ulp = np.spacing(np.maximum(np.abs(corrected), np.abs(pq.numpy())))
    assert np.all(np.abs((pq + pres).numpy() - corrected) <= ulp)


@pytest.mark.parametrize("opt", [{"type": "sgd", "lr": 1.0,
                                  "momentum": 0.9},
                                 {"type": "adam", "lr": 0.1}])
def test_apply_custom_weights_twice_leaves_the_state_untouched(opt):
    """The RL hook builds candidates A and B from one state: the server
    optimizer must not step that state's buffers in place."""
    raw = lr_config("dga", server={"optimizer_config": opt})
    cfg = FLUTEConfig.from_dict(raw)
    task = make_task(cfg.model_config)
    engine = RoundEngine(task, cfg, select_strategy("dga")(cfg),
                         torch.device("cpu"))
    state = engine.init_state(task.init_params(0))
    state.opt_state = {k: v + 0.5 for k, v in state.opt_state.items()}
    before = (state.params.clone(),
              {k: v.clone() for k, v in state.opt_state.items()})
    rng = np.random.default_rng(3)
    pgs = torch.from_numpy(rng.normal(size=(4, engine.layout.numel))
                           .astype(np.float32))
    a = engine.apply_custom_weights(state, pgs, np.ones(4, np.float32), 1.0)
    b = engine.apply_custom_weights(state, pgs, np.asarray(
        [0.1, 3.0, 0.0, 1.0], np.float32), 1.0)
    assert torch.equal(state.params, before[0])
    assert all(torch.equal(v, before[1][k])
               for k, v in state.opt_state.items())
    again = engine.apply_custom_weights(state, pgs, np.ones(4, np.float32),
                                        1.0)
    assert torch.equal(a.params, again.params)
    assert not torch.equal(a.params, b.params)
    assert a.round == b.round == state.round + 1
