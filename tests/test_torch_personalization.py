"""The personalization server of the port
(``msrflute_tpu_torch/engine/personalization.py``) against the JAX
package's (``msrflute_tpu/engine/personalization.py``, its host path) on
the same seeded inputs and initial weights:

- the personal pass of one cohort (the global and the local models'
  client updates on one batch, then the alpha step) against the JAX
  ``_build_personal_fn``: new local params to ``rel 1e-5`` of their update
  and alphas to ``rel 1e-5`` (float32 sums in another order) — the LR
  model, as the JAX package's own test uses, and ``experiments/cv``'s
  ResNet-18-GN at 16x16 images;
- the personalized eval under ``probs`` and ``logprobs`` against the JAX
  ``_build_personal_eval_fn``: correct predictions to one sample, the
  loss to ``rel 1e-5``;
- 3 rounds through the port's CLI against the JAX server: val loss,
  personalized loss to ``rel 1e-5``, personalized accuracy to one val
  sample, every stored alpha to ``rel 1e-5`` — with the cohort draw, the
  personal pass's shuffle and the round's shuffle taken from one numpy
  generator in that order;
- the store's save and load (crc-checked), a run resumed after 2 rounds
  equal bit for bit to one of 4 rounds, and the ``random`` and ``initial``
  cold starts.
"""

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
from msrflute_tpu.engine import select_server as jax_select_server
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu.tasks import build_task_datasets as jax_build_datasets
from msrflute_tpu_torch import e2e_trainer
from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.data import ArraysDataset
from msrflute_tpu_torch.engine import select_server
from msrflute_tpu_torch.engine.evaluation import personalized_eval_sums
from msrflute_tpu_torch.engine.personalization import (
    PersonalizationServer, PersonalizationStore, personal_step)
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params
from msrflute_tpu_torch.resilience.integrity import CheckpointCorruptionError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
LR_MODEL = {"model_type": "LR", "num_classes": 4, "input_dim": 8}


def _raw(model=LR_MODEL, **server):
    raw = {
        "model_config": dict(model),
        "strategy": "fedavg",
        "server_config": {
            "type": "personalization",
            "max_iteration": 3, "num_clients_per_iteration": 4,
            "initial_lr_client": 0.2,
            "optimizer_config": {"type": "sgd", "lr": 1.0},
            "val_freq": 100, "initial_val": False,
            "data_config": {"val": {"batch_size": 8}}},
        "client_config": {
            "convex_model_interp": 0.75,
            "optimizer_config": {"type": "sgd", "lr": 0.2,
                                 "momentum": 0.9},
            "data_config": {"train": {"batch_size": 4}}},
    }
    raw["server_config"].update(server)
    return raw


def _per_user(shape, classes, num_users, seed, lo=6, hi=14):
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(77).normal(size=(int(np.prod(shape)),
                                               classes))
    users, per_user = [], []
    for u in range(num_users):
        n = int(rng.integers(lo, hi + 1))
        x = rng.normal(size=(n,) + shape).astype(np.float32)
        y = np.argmax(x.reshape(n, -1) @ w, axis=1).astype(np.int32)
        users.append(f"user{u:03d}")
        per_user.append({"x": x, "y": y})
    return users, per_user


def _flat(task, params_np):
    return task.layout().flatten(from_jax_params(task, params_np))


def _servers(tmp_path, raw, users, per_user):
    jcfg = JaxFLUTEConfig.from_dict(raw)
    jtask = jax_make_task(jcfg.model_config)
    jds = JaxArraysDataset(users, per_user)
    jserver = jax_select_server("personalization")(
        jtask, jcfg, jds, val_dataset=jds, model_dir=str(tmp_path / "jax"),
        mesh=make_mesh(num_devices=1), seed=0)
    init = jax.device_get(jserver.state.params)
    cfg = FLUTEConfig.from_dict(raw)
    task = make_task(cfg.model_config)
    server = PersonalizationServer(
        task, cfg, ArraysDataset(users, per_user),
        val_dataset=ArraysDataset(users, per_user),
        model_dir=str(tmp_path / "port"), device=CPU,
        init_params=from_jax_params(task, init))
    return jserver, server, init


CASES = {
    "LR": (LR_MODEL, (8,), 4),
    "RESNET": ({"model_type": "RESNET", "depth": 18, "num_classes": 10,
                "image_size": 16}, (16, 16, 3), 10),
}


@pytest.mark.parametrize("name", ["LR", "RESNET"])
def test_personal_pass_matches_jax(tmp_path, name):
    model, shape, classes = CASES[name]
    K = 4 if name == "LR" else 2
    users, per_user = _per_user(shape, classes, K, seed=1)
    jserver, server, init = _servers(tmp_path, _raw(model), users,
                                     per_user)
    task = server.task
    rng = np.random.default_rng(2)
    # user 0 starts from the global model, the others from their own
    locals_np = [init] + [jax.tree.map(
        lambda w: (w + 0.05 * rng.normal(size=w.shape)).astype(np.float32),
        init) for _ in range(K - 1)]
    alphas = [0.75, 0.5, 0.9, 0.2][:K]
    batch = jax_pack(JaxArraysDataset(users, per_user), list(range(K)), 4, 3,
                     rng=np.random.default_rng(0))
    lr = 0.2

    fn = jserver._build_personal_fn()
    lps, alph, arrays, smask, cmask, stage = \
        jserver._stage_on_clients_axis(locals_np, alphas, batch)
    j_lp, j_alpha, _ = fn(jserver.state.params, lps, alph, arrays, smask,
                          cmask, stage(batch.client_ids),
                          jnp.asarray(lr, jnp.float32),
                          jax.random.PRNGKey(0))
    j_lp, j_alpha = jax.device_get((j_lp, j_alpha))
    want = torch.stack([_flat(task, jax.tree.map(lambda x: x[k], j_lp))
                        for k in range(K)]).double()

    start = torch.stack([_flat(task, lp) for lp in locals_np])
    got_lp, got_alpha = personal_step(
        server.engine.client_update, _flat(task, init), start,
        torch.tensor(alphas), {k: torch.from_numpy(v)
                               for k, v in batch.arrays.items()},
        torch.from_numpy(batch.sample_mask),
        torch.from_numpy(batch.client_mask), lr, 0.75)
    moved = (want - start.double()).norm(dim=-1)
    assert (moved > 0).all()
    err = (got_lp.double() - want).norm(dim=-1) / moved
    assert (err <= 1e-5).all(), err
    np.testing.assert_allclose(got_alpha.numpy(), j_alpha, rtol=1e-5)
    assert not np.allclose(j_alpha, alphas)        # alpha took its step


@pytest.mark.parametrize("interp", ["probs", "logprobs"])
def test_personalized_eval_matches_jax(tmp_path, interp):
    users, per_user = _per_user((8,), 4, 5, seed=3)
    raw = _raw(personalization_interp=interp)
    jserver, server, init = _servers(tmp_path, raw, users, per_user)
    task = server.task
    rng = np.random.default_rng(4)
    locals_np = [jax.tree.map(
        lambda w: (w + 0.5 * rng.normal(size=w.shape)).astype(np.float32),
        init) for _ in users]
    alphas = [0.75, 0.1, 0.5, 0.9, 0.3]
    batch = jax_pack(JaxArraysDataset(users, per_user), list(range(5)), 8, 2,
                     shuffle=False)
    fn = jserver._build_personal_eval_fn()
    lps, alph, arrays, smask, cmask, _ = \
        jserver._stage_on_clients_axis(locals_np, alphas, batch)
    c, t, ls = (float(v) for v in fn(jserver.state.params, lps, alph,
                                      arrays, smask, cmask))

    gc, gt, gl = (float(v) for v in personalized_eval_sums(
        task, task.layout(), _flat(task, init),
        torch.stack([_flat(task, lp) for lp in locals_np]),
        torch.tensor(alphas), {k: torch.from_numpy(v)
                               for k, v in batch.arrays.items()},
        torch.from_numpy(batch.sample_mask), interp == "logprobs"))
    assert gt == t == sum(len(u["y"]) for u in per_user)
    assert abs(gc - c) <= 1.0
    assert abs(gl - ls) <= 1e-5 * abs(ls)


# ----------------------------------------------------------------------
def _blob(path, users, seed):
    names, per_user = _per_user((8,), 4, users, seed)
    with open(path, "w") as fh:
        json.dump({"users": names,
                   "num_samples": [len(u["y"]) for u in per_user],
                   "user_data": {n: {"x": u["x"].tolist()}
                                 for n, u in zip(names, per_user)},
                   "user_data_label": {n: u["y"].tolist()
                                       for n, u in zip(names, per_user)}},
                  fh)


def _cli_raw(**server):
    raw = _raw(**server)
    raw["server_config"].update(val_freq=1, initial_val=True, rec_freq=100)
    raw["server_config"]["data_config"]["val"]["val_data"] = "val.json"
    raw["client_config"]["data_config"]["train"]["list_of_train_data"] = \
        "train.json"
    return raw


@pytest.fixture(scope="module")
def blob_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("personalization")
    _blob(d / "train.json", 12, 10)
    _blob(d / "val.json", 5, 11)
    return d


def _run_port(raw, data, out, init=None, monkeypatch=None):
    """The port's CLI in process, its task's init replaced by the JAX
    package's initial weights ``init`` where given."""
    out.mkdir(exist_ok=True)
    (out / "cfg.yaml").write_text(yaml.safe_dump(raw))
    if init is not None:
        task = make_task(FLUTEConfig.from_dict(raw).model_config)
        monkeypatch.setattr(type(task), "init_params",
                            lambda self, seed: from_jax_params(self, init))
    return e2e_trainer.main(["-config", str(out / "cfg.yaml"), "-dataPath",
                             str(data), "-outputPath", str(out / "run"),
                             "-device", "cpu"])


def test_personalization_cli_trajectory_matches_jax(blob_dir, tmp_path,
                                                    monkeypatch):
    raw = _cli_raw()
    jcfg = JaxFLUTEConfig.from_dict(raw)
    jcfg.validate(str(blob_dir))
    jtask = jax_make_task(jcfg.model_config)
    train, val, _ = jax_build_datasets(jcfg, jtask)
    jserver = jax_select_server("personalization")(
        jtask, jcfg, train, val_dataset=val, model_dir=str(tmp_path / "jax"),
        mesh=make_mesh(num_devices=1), seed=0)
    init = jax.device_get(jserver.state.params)
    want_val, want_pers = [], []
    evaluate, pers = jserver._maybe_eval, jserver.personalized_eval

    def recording_eval(split, round_no, force=False):
        improved = evaluate(split, round_no, force=force)
        want_val.append((round_no, jserver._last_val["loss"].value))
        return improved

    def recording_pers(dataset):
        res = pers(dataset)
        want_pers.append((jserver.state.round, res))
        return res

    jserver._maybe_eval = recording_eval
    jserver.personalized_eval = recording_pers
    jserver.train()

    raw["server_config"]["megakernel"] = {"pallas_apply": True}
    server = _run_port(raw, blob_dir, tmp_path / "port", init, monkeypatch)
    got_val = [(h["round"], h["loss"]) for h in server.history
               if h["split"] == "val"]
    got_pers = [(h["round"], (h["acc"], h["loss"])) for h in server.history
                if h["split"] == "personalized_val"]
    assert [r for r, _ in got_val] == [r for r, _ in want_val] == \
        [0, 1, 2, 3]
    for (r, g), (_, w) in zip(got_val, want_val):
        assert abs(g - w) <= 1e-5 * abs(w), (r, g, w)
    assert [r for r, _ in got_pers] == [r for r, _ in want_pers] == [1, 2, 3]
    n_val = sum(val.num_samples)
    for (r, (ga, gl)), (_, (wa, wl)) in zip(got_pers, want_pers):
        assert abs(ga - wa) * n_val <= 1.0 + 1e-9, (r, ga, wa)
        assert abs(gl - wl) <= 1e-5 * abs(wl), (r, gl, wl)
    assert set(server.store.alpha) == set(jserver.store.alpha)
    for uid, alpha in jserver.store.alpha.items():
        assert abs(server.store.alpha[uid] - alpha) <= 1e-5 * alpha
        assert alpha != 0.75 and 1e-4 <= alpha <= 0.9999
    # the JAX store holds flax trees; the port's flat rows carry across
    for uid, lp in jserver.store.params.items():
        want = _flat(server.task, jax.device_get(lp)).double()
        moved = (want - _flat(server.task, init).double()).norm()
        assert float((server.store.params[uid].double() - want).norm()
                     / moved) <= 1e-5
    names = {json.loads(line)["name"] for line in open(
        tmp_path / "port" / "run" / "log" / "metrics.jsonl")}
    assert {"Personalized val acc", "Personalized val loss"} <= names


def test_store_saves_dirty_users_and_loads_them_checked(tmp_path):
    store = PersonalizationStore(0.75, str(tmp_path / "s"))
    assert store.get(3) == (None, 0.75)
    store.put(3, torch.arange(5, dtype=torch.float32), 0.5)
    store.put(7, torch.ones(5), 0.25)
    store.save()
    files = sorted(os.listdir(tmp_path / "s"))
    assert files == ["user3_model.pt", "user3_model.pt.sum",
                     "user7_model.pt", "user7_model.pt.sum"]
    store.put(7, torch.zeros(5), 0.125)
    mtime = os.path.getmtime(tmp_path / "s" / "user3_model.pt")
    store.save()          # only the dirty user 7 is written again
    assert os.path.getmtime(tmp_path / "s" / "user3_model.pt") == mtime
    again = PersonalizationStore(0.75, str(tmp_path / "s"))
    assert again.load()
    assert again.alpha == {3: 0.5, 7: 0.125}
    assert torch.equal(again.params[3], torch.arange(5, dtype=torch.float32))
    assert torch.equal(again.params[7], torch.zeros(5))
    path = tmp_path / "s" / "user7_model.pt"
    blob = bytearray(path.read_bytes())
    blob[-5] ^= 0xFF
    path.write_bytes(bytes(blob))
    with pytest.raises(CheckpointCorruptionError):
        PersonalizationStore(0.75, str(tmp_path / "s")).load()
    assert not PersonalizationStore(0.75, str(tmp_path / "none")).load()


def test_resume_after_two_rounds_equals_four_rounds_bitwise(blob_dir,
                                                            tmp_path):
    raw = _cli_raw(max_iteration=4, model_backup_freq=1)
    raw["server_config"]["megakernel"] = {"pallas_apply": True}
    whole = _run_port(raw, blob_dir, tmp_path / "whole")
    first = dict(raw, server_config=dict(raw["server_config"],
                                         max_iteration=2))
    _run_port(first, blob_dir, tmp_path / "split")
    again = dict(raw, server_config=dict(raw["server_config"],
                                         resume_from_checkpoint=True))
    resumed = _run_port(again, blob_dir, tmp_path / "split")
    assert resumed.state.round == whole.state.round == 4
    assert torch.equal(resumed.state.params, whole.state.params)
    assert resumed.store.alpha == whole.store.alpha
    assert set(resumed.store.params) == set(whole.store.params)
    for uid, lp in whole.store.params.items():
        assert torch.equal(resumed.store.params[uid], lp), uid
    # rounds 3 and 4 evaluated alike, the personalized eval included
    assert resumed.history == whole.history[-4:]
    assert [h["split"] for h in resumed.history] == \
        ["val", "personalized_val"] * 2


@pytest.mark.parametrize("kind", ["random", "initial"])
def test_cold_starts(blob_dir, tmp_path, kind):
    raw = _cli_raw(max_iteration=2, personalization_init=kind)
    server = _run_port(raw, blob_dir, tmp_path / kind)
    P = server.engine.layout.numel
    assert len(server.store.params) >= 4
    for uid, lp in server.store.params.items():
        assert lp.shape == (P,) and torch.isfinite(lp).all()
        assert 1e-4 <= server.store.alpha[uid] <= 0.9999
    first = server._default_local()
    init = server.engine.layout.flatten(server.task.init_params(0))
    if kind == "initial":
        assert torch.equal(first, init)
    else:
        assert first.shape == (P,) and torch.isfinite(first).all()
        assert not torch.equal(first, init)


def test_select_server_and_the_published_cv_config():
    assert select_server("personalization") is PersonalizationServer
    with open(os.path.join(REPO, "experiments", "cv", "config.yaml")) as fh:
        cfg = FLUTEConfig.from_dict(yaml.safe_load(fh))
    assert cfg.server_config.type == "personalization"
    assert cfg.client_config["convex_model_interp"] == 0.75
    # ResNet-18-GN at 10 classes: Fed-CIFAR-100's less the 90 classes'
    # dense weights and biases
    assert make_task(cfg.model_config).layout().numel == \
        11_227_812 - 90 * 513 == 11_181_642


def _image_blob(path, users, seed, side=16, classes=10):
    rng = np.random.default_rng(seed)
    names = [f"c{seed}_{i:03d}" for i in range(users)]
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


def test_cv_config_cli_trajectory_matches_jax(tmp_path, monkeypatch):
    """``experiments/cv/config.yaml`` (ResNet-18-GN, 10 classes) at 16x16
    images, 2 rounds of 2 clients: val loss and personalized loss to
    ``rel 1e-5``, accuracies to one val sample."""
    data = tmp_path / "data"
    (data / "cifar").mkdir(parents=True)
    _image_blob(data / "cifar" / "train.json", 6, 0)
    _image_blob(data / "cifar" / "val.json", 3, 1)
    with open(os.path.join(REPO, "experiments", "cv", "config.yaml")) as fh:
        raw = yaml.safe_load(fh)
    raw["model_config"]["image_size"] = 16
    sc = raw["server_config"]
    sc.update(max_iteration=2, num_clients_per_iteration=2, val_freq=1,
              rec_freq=100)
    sc["data_config"]["val"]["batch_size"] = 16
    del sc["data_config"]["test"]
    raw["client_config"]["data_config"]["train"]["batch_size"] = 4

    jcfg = JaxFLUTEConfig.from_dict(raw)
    jcfg.validate(str(data))
    jtask = jax_make_task(jcfg.model_config)
    train, val, _ = jax_build_datasets(jcfg, jtask)
    jserver = jax_select_server("personalization")(
        jtask, jcfg, train, val_dataset=val, model_dir=str(tmp_path / "jax"),
        mesh=make_mesh(num_devices=1), seed=0)
    init = jax.device_get(jserver.state.params)
    want, pers = [], jserver.personalized_eval
    evaluate = jserver._maybe_eval

    def recording_eval(split, round_no, force=False):
        improved = evaluate(split, round_no, force=force)
        want.append(("val", round_no, jserver._last_val["loss"].value,
                     jserver._last_val["acc"].value))
        return improved

    def recording_pers(dataset):
        acc, loss = pers(dataset)
        want.append(("personalized_val", jserver.state.round, loss, acc))
        return acc, loss

    jserver._maybe_eval = recording_eval
    jserver.personalized_eval = recording_pers
    jserver.train()

    raw["server_config"]["megakernel"] = {"pallas_apply": True}
    server = _run_port(raw, data, tmp_path / "port", init, monkeypatch)
    assert server.engine.layout.numel == 11_181_642
    got = [(h["split"], h["round"], h["loss"], h["acc"])
           for h in server.history]
    assert [g[:2] for g in got] == [w[:2] for w in want] == [
        ("val", 0), ("val", 1), ("personalized_val", 1), ("val", 2),
        ("personalized_val", 2)]
    n_val = sum(val.num_samples)
    for g, w in zip(got, want):
        assert abs(g[2] - w[2]) <= 1e-5 * abs(w[2]), (g, w)
        assert abs(g[3] - w[3]) * n_val <= 1.0 + 1e-9, (g, w)
    for uid, alpha in jserver.store.alpha.items():
        assert abs(server.store.alpha[uid] - alpha) <= 1e-5 * alpha
