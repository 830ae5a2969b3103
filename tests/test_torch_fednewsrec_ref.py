"""NRMS's ``arch: fednewsrec`` in the port
(``msrflute_tpu_torch/models/fednewsrec.py::FedNewsRecRefTask``, the
reference's own net on a frozen word table) against the JAX package's
(``msrflute_tpu/models/fednewsrec.py:101-270``) at vocab 500, embed 12,
2 heads of 6, 12 conv filters, history 6, titles of 8 and a GRU tail of 4,
with the JAX weights carried across:

- the frozen table bitwise the numpy draw ``default_rng(0).normal(scale=
  0.1)`` cast to float32, and the JAX task's; it is no parameter (P and
  the leaves are the JAX package's, at these widths and the published
  ones); a config's ``embedding_matrix`` takes its place;
- deterministic passes (no dropout): scores within ``1e-5`` of the
  largest, the npratio loss ``rtol 1e-5``, grads to ``1e-5`` of the
  largest, the ranking metrics ``rtol 1e-5``;
- train passes draw the seven dropout sites' keep masks at rate 0.2 (the
  streams differ from JAX's, so they are held in law: the keep share
  within 5 sigma);
- one round through the port's CLI on ``-device cpu``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torch.func import grad_and_value

from msrflute_tpu.config import ModelConfig as JaxModelConfig
from msrflute_tpu.models.fednewsrec import make_fednewsrec_task
from msrflute_tpu_torch import e2e_trainer
from msrflute_tpu_torch.config import ModelConfig
from msrflute_tpu_torch.models.convert import from_jax_params
from msrflute_tpu_torch.models.fednewsrec import (REF_DROPOUT,
                                                  FedNewsRecRefTask,
                                                  make_nrms_task)
from test_torch_cli_trajectories import _published_model
from test_torch_fednewsrec import _stack, _users

SMALL = {"model_type": "NRMS", "arch": "fednewsrec", "vocab_size": 500,
         "embed_dim": 12, "num_heads": 2, "head_dim": 6, "conv_filters": 12,
         "max_history": 6, "max_title_length": 8, "npratio": 2,
         "max_candidates": 6, "gru_tail": 4}


def _carried(**over):
    mc = dict(SMALL, **over)
    jt = make_fednewsrec_task(JaxModelConfig.from_dict(mc))
    pt = make_nrms_task(ModelConfig.from_dict(mc))
    jp = jax.device_get(jt.init_params(jax.random.PRNGKey(0)))
    return jt, pt, jp, from_jax_params(pt, jp)


def _batch(split, seed=0, n=8):
    from msrflute_tpu_torch.data.user_blob import UserBlob
    pt = make_nrms_task(ModelConfig.from_dict(SMALL))
    users = _users(seed, n)
    ds = pt.make_dataset(UserBlob([f"u{i}" for i in range(n)], [1] * n,
                                  users, None), None, split)
    return _stack(ds)


def test_frozen_table_is_the_numpy_draw_and_no_parameter():
    jt, pt, jp, tp = _carried()
    assert isinstance(pt, FedNewsRecRefTask)
    draw = np.random.default_rng(0).normal(scale=0.1, size=(500, 12))
    np.testing.assert_array_equal(pt.table.numpy(),
                                  draw.astype(np.float32))
    np.testing.assert_array_equal(pt.table.numpy(),
                                  np.asarray(jt._frozen_emb))
    assert pt.layout().numel == ravel_pytree(jp)[0].size == 10_623
    np.testing.assert_array_equal(pt.layout().flatten(tp).numpy(),
                                  np.asarray(ravel_pytree(jp)[0]))
    assert not any("embed" in n.lower() for n in pt.layout().names)


def test_published_widths_match_the_jax_tree():
    model = _published_model("fednewsrec", arch="fednewsrec")
    with torch.device("meta"):
        layout = FedNewsRecRefTask(ModelConfig.from_dict(model)).layout()
    jt = make_fednewsrec_task(JaxModelConfig.from_dict(model))
    shapes = jax.eval_shape(jt.init_params, jax.random.PRNGKey(0))
    paths = [".".join(str(p.key) for p in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(shapes)[0]]
    assert layout.names == paths
    assert layout.numel == sum(int(np.prod(s.shape)) for s in
                               jax.tree.leaves(shapes)) == 2_523_203


def test_embedding_matrix_takes_the_tables_place():
    emb = np.random.default_rng(3).normal(size=(500, 12))
    jt, pt, _, _ = _carried(embedding_matrix=emb)
    np.testing.assert_array_equal(pt.table.numpy(), emb.astype(np.float32))
    np.testing.assert_array_equal(pt.table.numpy(),
                                  np.asarray(jt._frozen_emb))


def test_deterministic_scores_loss_and_grads_match_jax():
    jt, pt, jp, tp = _carried()
    b = _batch("train")
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want = np.asarray(jax.jit(jt._scores)(jp, jb))
    with torch.no_grad():
        got = pt._scores(tp, tb).numpy()
    assert got.shape == (len(b["y"]), 3)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jt.loss(p, jb, None, False), has_aux=True))(jp)
    tg, tl = grad_and_value(pt.loss_masked)(tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    g_want = np.asarray(ravel_pytree(jg)[0])
    np.testing.assert_allclose(pt.layout().flatten(tg).numpy(), g_want,
                               rtol=1e-5, atol=1e-5 * np.abs(g_want).max())


def test_ranking_metrics_match_jax():
    jt, pt, jp, tp = _carried()
    b = _batch("val", seed=1, n=10)
    want = jax.jit(jt.eval_stats)(jp, {k: jnp.asarray(v)
                                       for k, v in b.items()})
    with torch.no_grad():
        got = pt.eval_stats(tp, {k: torch.from_numpy(v)
                                 for k, v in b.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_train_pass_draws_the_reference_dropout_in_law():
    _, pt, _, tp = _carried()
    b = {k: torch.from_numpy(v) for k, v in _batch("train").items()}
    B = b["y"].shape[0]
    gens = [torch.Generator().manual_seed(s) for s in range(2)]
    masks = pt.draw_masks(gens, B, torch.device("cpu"))
    docs = 6 + 2 + 1
    assert [tuple(m.shape[2:]) for m in masks] == [
        (docs, 8, 12), (docs, 6, 12), (docs, 6, 12), (docs, 6, 12),
        (6, 12), (6, 12), (2, 12)]
    keep = torch.cat([m.reshape(-1) for m in masks]).float()
    sigma = (REF_DROPOUT * (1 - REF_DROPOUT) / keep.numel()) ** 0.5
    assert abs(float(keep.mean()) - (1 - REF_DROPOUT)) < 5 * sigma
    with torch.no_grad():
        plain = pt.loss_masked(tp, b)
        dropped = pt.loss_masked(tp, b, tuple(m[0] for m in masks))
    assert torch.isfinite(dropped) and not torch.equal(plain, dropped)


@pytest.fixture(scope="module")
def mind_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mind_ref")
    for split, seed, n in (("train", 5, 6), ("val", 6, 3)):
        users = _users(seed, n)
        names = [f"{split}{i}" for i in range(n)]
        with open(d / f"{split}.json", "w") as fh:
            json.dump({"users": names, "num_samples": [1] * n,
                       "user_data": dict(zip(names, users))}, fh)
    return str(d)


def test_cli_runs_the_reference_net_on_cpu(mind_dir, tmp_path):
    import yaml
    raw = {
        "model_config": _published_model("fednewsrec", **SMALL),
        "strategy": "fedavg",
        "server_config": {
            "max_iteration": 1, "num_clients_per_iteration": 2,
            "initial_lr_client": 0.01, "val_freq": 1, "rec_freq": 100,
            "initial_val": True, "best_model_criterion": "auc",
            "optimizer_config": {"type": "sgd", "lr": 1.0},
            "data_config": {"val": {"batch_size": 4,
                                    "val_data": "val.json"}}},
        "client_config": {
            "optimizer_config": {"type": "adam", "lr": 0.001},
            "data_config": {"train": {"batch_size": 4,
                                      "list_of_train_data": "train.json"}}},
    }
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(raw))
    server = e2e_trainer.main(["-config", str(tmp_path / "cfg.yaml"),
                               "-dataPath", mind_dir, "-outputPath",
                               str(tmp_path / "out"), "-device", "cpu"])
    assert isinstance(server.task, FedNewsRecRefTask)
    assert server.engine.random             # the dropout sites are live
    records = [json.loads(line) for line in (
        tmp_path / "out" / "log" / "metrics.jsonl").read_text().splitlines()]
    loss = [r["value"] for r in records if r["name"] == "Training loss"]
    auc = [r["value"] for r in records if r["name"] == "Val auc"]
    assert len(loss) == 1 and np.isfinite(loss).all() and len(auc) == 2


def test_reference_net_round_trips_through_convert():
    from msrflute_tpu_torch.models.convert import to_jax_params
    _, _, jp, tp = _carried()
    back = to_jax_params(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)
