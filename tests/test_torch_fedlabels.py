"""FedLabels in the port (``msrflute_tpu_torch/strategies/fedlabels.py``)
against the JAX package's (``msrflute_tpu/strategies/fedlabels.py``) on the
same seeded inputs:

- the unsupervised pass (VAT pseudo-labels, ``comp: var``, plain SGD at
  ``eta``) of a few clients, LR and CIFAR_CNN: params to ``rel 1e-5`` of
  the update (float32 sums in another order, a few 1e-7);
- the burnout gate: before ``burnout_round`` the new params are half the
  supervised average plus half the global params, as
  ``tests/test_fedlabels.py::test_fedlabels_burnout_is_half_sup_average``
  pins it for JAX, and equal the JAX round's to ``rel 1e-5``;
- ``combine_parts`` to float32 rounding;
- ``experiments/semisupervision/config.yaml`` (CIFAR_CNN, RandAugment's
  ``ux_rand`` view under ``uda: 1``) for 3 rounds through the port's CLI
  with ``burnout_round: 1`` against the JAX package's server: val loss to
  ``rel 1e-5``, accuracy to one val sample.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.data import ArraysDataset as JaxArraysDataset
from msrflute_tpu.data import pack_round_batches as jax_pack
from msrflute_tpu.engine import OptimizationServer as JaxServer
from msrflute_tpu.engine.round import RoundEngine as JaxRoundEngine
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu.strategies import select_strategy as jax_select_strategy
from msrflute_tpu.tasks import build_task_datasets as jax_build_datasets
from msrflute_tpu_torch import e2e_trainer
from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.data import ArraysDataset, pack_round_batches
from msrflute_tpu_torch.engine.round import RoundEngine
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params
from msrflute_tpu_torch.models.cv import ClassificationTask
from msrflute_tpu_torch.strategies import FedLabels, select_strategy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

SEMISUP = {"eta": 0.05, "burnout_round": 1, "temp": 0.5, "thre": 0.3,
           "vat_consis": 0.5, "l2_lambda": 0.01, "unsup_lamb": 1.0,
           "uda": 1, "unsuptrain_ep": 2}
MODELS = {
    "LR": ({"model_type": "LR", "num_classes": 4, "input_dim": 8}, (8,)),
    "CIFAR_CNN": ({"model_type": "CIFAR_CNN", "num_classes": 10},
                  (32, 32, 3)),
}


def _raw(model, burnout=1):
    return {
        "model_config": dict(model),
        "strategy": "fedlabels",
        "server_config": {
            "max_iteration": 3, "num_clients_per_iteration": 4,
            "initial_lr_client": 0.2,
            "optimizer_config": {"type": "sgd", "lr": 1.0},
            "val_freq": 100, "initial_val": False,
            "data_config": {"val": {"batch_size": 8}}},
        "client_config": {
            "optimizer_config": {"type": "sgd", "lr": 0.2},
            "data_config": {"train": {"batch_size": 4}},
            "semisupervision": dict(SEMISUP, burnout_round=burnout)},
    }


def _flat(task, params_np):
    return task.layout().flatten(from_jax_params(task, params_np))


def _semisup_arrays(shape, K, S, B, seed):
    rng = np.random.default_rng(seed)
    ux = rng.normal(size=(K, S, B) + shape).astype(np.float32)
    mask = np.ones((K, S, B), np.float32)
    mask[0, -1, B // 2:] = 0.0
    return {"ux": ux, "ux_rand": (ux + 0.1 * rng.normal(size=ux.shape)
                                  ).astype(np.float32)}, mask


@pytest.mark.parametrize("name", ["LR", "CIFAR_CNN"])
def test_unsup_train_matches_jax(name):
    model, shape = MODELS[name]
    raw = _raw(model)
    jtask = jax_make_task(JaxFLUTEConfig.from_dict(raw).model_config)
    jstrat = jax_select_strategy("fedlabels")(JaxFLUTEConfig.from_dict(raw),
                                              None)
    jstrat.task = jtask
    task = make_task(FLUTEConfig.from_dict(raw).model_config)
    strat = FedLabels(FLUTEConfig.from_dict(raw))
    strat.task = task

    init = jax.device_get(jtask.init_params(jax.random.PRNGKey(0)))
    K, S, B = 3, 2, 4
    rng = np.random.default_rng(5)
    sups = [jax.tree.map(lambda w: (w + 0.3 * rng.normal(size=w.shape)
                                    ).astype(np.float32), init)
            for _ in range(K)]
    arrays, mask = _semisup_arrays(shape, K, S, B, seed=6)

    want = []
    for k in range(K):
        out = jstrat._unsup_train(
            init, sups[k], {n: jnp.asarray(v[k]) for n, v in arrays.items()},
            jnp.asarray(mask[k]), jax.random.PRNGKey(0))
        want.append(_flat(task, jax.device_get(out)))
    want = torch.stack(want).double()

    init_flat = _flat(task, init)
    got = strat.unsup_train(
        init_flat, torch.stack([_flat(task, s) for s in sups]),
        {n: torch.from_numpy(v) for n, v in arrays.items()},
        torch.from_numpy(mask)).double()
    moved = (want - init_flat.double()).norm(dim=-1)
    assert (moved > 0).all(), moved          # every client took steps
    err = (got - want).norm(dim=-1) / moved
    assert (err <= 1e-5).all(), err


def _semisup_dataset(cls, num_users=8, n=12, dim=8, classes=4, seed=0):
    """Labeled x/y plus unlabeled ux and its augmented view ux_rand (the
    JAX test's generator)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(dim, classes))
    users, per_user = [], []
    for u in range(num_users):
        x = rng.normal(size=(n, dim)).astype(np.float32)
        ux = rng.normal(size=(n, dim)).astype(np.float32)
        per_user.append({
            "x": x, "y": np.argmax(x @ w, axis=1).astype(np.int32),
            "ux": ux, "ux_rand": ux + 0.05 * rng.normal(size=(n, dim)
                                                       ).astype(np.float32)})
        users.append(f"u{u}")
    return cls(users, per_user)


def test_burnout_gate_is_half_sup_average_and_matches_jax():
    model = MODELS["LR"][0]
    raw = _raw(model, burnout=1000)   # the unsupervised pass never runs
    jcfg = JaxFLUTEConfig.from_dict(raw)
    jtask = jax_make_task(jcfg.model_config)
    jengine = JaxRoundEngine(jtask, jcfg,
                             jax_select_strategy("fedlabels")(jcfg, None),
                             make_mesh(num_devices=1))
    jstate = jengine.init_state(jax.random.PRNGKey(0))
    w0_np = jax.device_get(jstate.params)   # the round donates its state
    jbatch = jax_pack(_semisup_dataset(JaxArraysDataset), [0, 1, 2, 3], 4,
                      3, rng=np.random.default_rng(0))
    jnew, _ = jengine.run_round(jstate, jbatch, 0.2, 1.0,
                               jax.random.PRNGKey(1))

    cfg = FLUTEConfig.from_dict(raw)
    task = make_task(cfg.model_config)
    engine = RoundEngine(task, cfg, select_strategy("fedlabels")(cfg), CPU)
    w0 = _flat(task, w0_np)
    state = engine.init_state(task.layout().views(w0))
    batch = pack_round_batches(_semisup_dataset(ArraysDataset), [0, 1, 2, 3],
                               4, 3, rng=np.random.default_rng(0))
    new, _ = engine.run_round(state, batch, 0.2, 1.0)

    labeled = {k: torch.from_numpy(batch.arrays[k]) for k in ("x", "y")}
    pg = engine.client_update(w0, labeled,
                              torch.from_numpy(batch.sample_mask), 0.2)[0]
    sup_avg = (w0 - pg).mean(0)
    half = (w0 + sup_avg) / 2
    assert not torch.equal(new.params, w0)
    rel = lambda a, b: float((a - b).norm() / (b - w0).norm())  # noqa: E731
    assert rel(new.params, half) <= 1e-6
    assert rel(new.params, _flat(task, jax.device_get(jnew.params))) <= 1e-5


def test_combine_parts_matches_jax():
    rng = np.random.default_rng(3)
    P = 37
    w0, g_sup, g_unsup = (rng.normal(size=P).astype(np.float32)
                          for _ in range(3))
    sums = {"sup": (g_sup, np.float32(4.0)),
            "unsup": (g_unsup, np.float32(37.0))}
    cfg = _raw(MODELS["LR"][0])
    jstrat = jax_select_strategy("fedlabels")(JaxFLUTEConfig.from_dict(cfg),
                                              None)
    want, _ = jstrat.combine_parts(
        {k: {"grad_sum": jnp.asarray(g), "weight_sum": jnp.asarray(w)}
         for k, (g, w) in sums.items()}, None, (), jax.random.PRNGKey(0),
        jnp.asarray(4.0), global_params=jnp.asarray(w0))
    got, state = FedLabels(FLUTEConfig.from_dict(cfg)).combine_parts(
        {k: {"grad_sum": torch.from_numpy(g),
             "weight_sum": torch.tensor(float(w))}
         for k, (g, w) in sums.items()}, None, {}, 0, 4.0,
        global_params=torch.from_numpy(w0))
    assert state == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


# ----------------------------------------------------------------------
def _image_blob(path, users, seed, unlabeled, classes=10):
    """CIFAR-shaped blob of uint8 images, the class shifting one channel
    band; with ``unlabeled``, each user also holds as many unlabeled
    images ``ux`` (a semisupervision blob)."""
    rng = np.random.default_rng(seed)
    names = [f"s{seed}_{i:03d}" for i in range(users)]
    data, labels, counts = {}, {}, []
    for u in names:
        n = int(rng.integers(4, 9))
        y = rng.integers(0, classes, n)
        x = rng.integers(0, 160, (n, 32, 32, 3))
        for i, c in enumerate(y):
            x[i, :, :, c % 3] += 8 * (c + 1) % 96
        data[u] = {"x": x.tolist()}
        if unlabeled:
            data[u]["ux"] = rng.integers(0, 256, (n, 32, 32, 3)).tolist()
        labels[u] = y.tolist()
        counts.append(n)
    with open(path, "w") as fh:
        json.dump({"users": names, "num_samples": counts, "user_data": data,
                   "user_data_label": labels}, fh)


def test_semisupervision_cli_trajectory_matches_jax(tmp_path, monkeypatch):
    data = tmp_path / "data"
    (data / "cifar").mkdir(parents=True)
    _image_blob(data / "cifar" / "train_semisup.json", 8, 0, True)
    _image_blob(data / "cifar" / "val.json", 3, 1, False)
    with open(os.path.join(REPO, "experiments", "semisupervision",
                           "config.yaml")) as fh:
        raw = yaml.safe_load(fh)
    sc, cc = raw["server_config"], raw["client_config"]
    sc.update(max_iteration=3, num_clients_per_iteration=3, val_freq=1,
              rec_freq=100, initial_lr_client=0.05)
    sc["data_config"]["val"]["batch_size"] = 16
    del sc["data_config"]["test"]
    cc["optimizer_config"]["lr"] = 0.05
    cc["data_config"]["train"]["batch_size"] = 4
    cc["semisupervision"].update(burnout_round=1, thre=0.15, eta=0.05)

    jcfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    jcfg.validate(str(data))
    jtask = jax_make_task(jcfg.model_config)
    train, val, _ = jax_build_datasets(jcfg, jtask)
    assert "ux_rand" in train.user_arrays(0)
    jserver = JaxServer(jtask, jcfg, train, val_dataset=val,
                        model_dir=str(tmp_path / "jax"),
                        mesh=make_mesh(num_devices=1), seed=0)
    init = jax.device_get(jserver.state.params)
    want, evaluate = [], jserver._maybe_eval

    def recording_eval(split, round_no, force=False):
        improved = evaluate(split, round_no, force=force)
        want.append((round_no, {k: m.value for k, m in
                                jserver._last_val.items()}))
        return improved

    jserver._maybe_eval = recording_eval
    jserver.train()
    final_jax = jax.device_get(jserver.state.params)

    raw["server_config"]["megakernel"] = {"pallas_apply": True}
    out = tmp_path / "port"
    out.mkdir()
    (out / "cfg.yaml").write_text(yaml.safe_dump(raw))
    monkeypatch.setattr(ClassificationTask, "init_params",
                        lambda self, seed: from_jax_params(self, init))
    moved, unsup_train = [], FedLabels.unsup_train

    def recording_unsup_train(self, initial, sup, arrays, mask):
        out = unsup_train(self, initial, sup, arrays, mask)
        moved.append(int(((out - initial).abs().amax(-1) > 0).sum()))
        return out

    monkeypatch.setattr(FedLabels, "unsup_train", recording_unsup_train)
    server = e2e_trainer.main(["-config", str(out / "cfg.yaml"), "-dataPath",
                               str(data), "-outputPath", str(out / "run"),
                               "-device", "cpu"])
    assert np.array_equal(server.train_dataset.user_arrays(0)["ux_rand"],
                          train.user_arrays(0)["ux_rand"])
    got = [(h["round"], h) for h in server.history if h["split"] == "val"]
    # rounds 1 and 2 (from burnout_round on) ran the unsupervised pass,
    # and it moved some client's model off the round's global params
    assert len(moved) == 2 and all(n > 0 for n in moved), moved
    assert [r for r, _ in got] == [r for r, _ in want] == [0, 1, 2, 3]
    n_val = sum(val.num_samples)
    for (r, g), (_, w) in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"]), (r, g, w)
        assert abs(g["acc"] - w["acc"]) * n_val <= 1.0 + 1e-9, (r, g, w)
    w0 = _flat(server.task, init)
    jfinal = _flat(server.task, final_jax)
    assert float((server.state.params - jfinal).norm()
                 / (jfinal - w0).norm()) <= 1e-5
