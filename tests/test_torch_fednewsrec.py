"""The port's NRMS (``msrflute_tpu_torch/models/fednewsrec.py``) against
the JAX package's ``FedNewsRecTask`` (``arch: nrms``) at vocab 500, embed
32, 4 heads of 8, history 5 and titles of 8, with the JAX weights carried
across:

- the leaves in the JAX package's ``ravel_pytree`` order, and P =
  13,320,802 in 17 leaves at the published widths;
- ``make_dataset``'s arrays bitwise (the train slates are drawn from the
  same ``default_rng`` draw for draw), train and eval splits;
- scores, the npratio loss and its grads: ``rtol 1e-5`` (float32 sums in
  other orders);
- AUC, MRR, nDCG@5 / @10 and the slate loss against ``eval_stats``:
  ``rtol 1e-5`` (the ranks come from the same stable sort of nearly equal
  scores);
- the word lookup (``models/embed.py``) equal to indexing under
  ``vmap(grad)``, forward and backward;
- ``experiments/fednewsrec``'s model section and optimizers (client adam,
  server SGD) through the port's CLI on ``-device cpu`` against the JAX
  package's server, 3 rounds of 2 clients: the val loss every round to
  ``rel 1e-5`` and the ranking metrics to ``1e-5``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torch.func import grad, grad_and_value, vmap

from msrflute_tpu.config import ModelConfig as JaxModelConfig
from msrflute_tpu.data.user_blob import UserBlob as JaxUserBlob
from msrflute_tpu.models.fednewsrec import make_fednewsrec_task
from msrflute_tpu_torch.config import ModelConfig
from msrflute_tpu_torch.data.user_blob import UserBlob
from msrflute_tpu_torch.models.convert import from_jax_params
from msrflute_tpu_torch.models.embed import embed_gather
from msrflute_tpu_torch.models.fednewsrec import make_nrms_task
from test_torch_cli_trajectories import (_jax_history, _port_cli_history,
                                         _published_model)

SMALL = {"model_type": "NRMS", "vocab_size": 500, "embed_dim": 32,
         "num_heads": 4, "head_dim": 8, "max_history": 5,
         "max_title_length": 8, "npratio": 4, "max_candidates": 6}
METRICS = ("auc", "mrr", "ndcg@5", "ndcg@10")


def _carried():
    jt = make_fednewsrec_task(JaxModelConfig.from_dict(SMALL))
    pt = make_nrms_task(ModelConfig.from_dict(SMALL))
    jp = jax.device_get(jt.init_params(jax.random.PRNGKey(0)))
    return jt, pt, jp, from_jax_params(pt, jp)


def _users(seed, n):
    """MIND-style user dicts: titles of 2-11 ids (some past ``max_title
    _length``), 0-7 clicks, 1-3 impressions of 2-8 candidates (some past
    ``max_candidates``, some without a positive)."""
    rng = np.random.default_rng(seed)

    def title():
        return rng.integers(1, 500, rng.integers(2, 12)).tolist()

    users = []
    for _ in range(n):
        imps = []
        for _ in range(int(rng.integers(1, 4))):
            c = int(rng.integers(2, 9))
            imps.append({"cands": [title() for _ in range(c)],
                         "labels": (rng.random(c) < 0.3).astype(int)
                         .tolist()})
        users.append({"clicked": [title() for _ in
                                  range(int(rng.integers(0, 8)))],
                      "impressions": imps})
    return users


def _datasets(split, seed=0, n=8):
    jt, pt, _, _ = _carried()
    users = _users(seed, n)
    names = [f"u{i}" for i in range(n)]
    want = jt.make_dataset(JaxUserBlob(names, [1] * n, users, None),
                           JaxModelConfig.from_dict(SMALL), split)
    got = pt.make_dataset(UserBlob(names, [1] * n, users, None), None, split)
    return want, got


def _stack(ds, masked_last=True):
    arrays = {k: np.concatenate([ds.user_arrays(i)[k]
                                 for i in range(len(ds))])
              for k in ds.user_arrays(0)}
    sm = np.ones(len(arrays["clicked"]), np.float32)
    if masked_last:
        sm[-1] = 0.0
    arrays["sample_mask"] = sm
    return arrays


def test_layout_is_the_jax_ravel_order():
    _, pt, jp, tp = _carried()
    np.testing.assert_array_equal(pt.layout().flatten(tp).numpy(),
                                  np.asarray(ravel_pytree(jp)[0]))


def test_published_widths_parameter_count():
    with torch.device("meta"):
        layout = make_nrms_task(ModelConfig.from_dict(
            _published_model("fednewsrec"))).layout()
    assert layout.numel == 13_320_802 and len(layout.names) == 17


@pytest.mark.parametrize("split", ["train", "val"])
def test_make_dataset_matches_jax_bitwise(split):
    want, got = _datasets(split)
    assert got.user_list == want.user_list
    assert got.num_samples == want.num_samples
    for i in range(len(want)):
        w, g = want.user_arrays(i), got.user_arrays(i)
        assert set(w) == set(g)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])


def test_scores_loss_and_grads_match_jax():
    jt, pt, jp, tp = _carried()
    _, ds = _datasets("train")
    b = _stack(ds)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want = np.asarray(jt._scores(jp, jb))
    got = pt._scores(tp, tb).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jt.loss(p, jb, None, True), has_aux=True)(jp)
    tg, tl = grad_and_value(pt.loss_masked)(tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    g_want = np.asarray(ravel_pytree(jg)[0])
    np.testing.assert_allclose(pt.layout().flatten(tg).numpy(), g_want,
                               rtol=1e-5, atol=1e-6 * np.abs(g_want).max())


@pytest.mark.parametrize("split", ["train", "val"])
def test_ranking_metrics_match_jax(split):
    jt, pt, jp, tp = _carried()
    _, ds = _datasets(split, seed=1, n=10)
    b = _stack(ds)
    want = jt.eval_stats(jp, {k: jnp.asarray(v) for k, v in b.items()})
    got = pt.eval_stats(tp, {k: torch.from_numpy(v) for k, v in b.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    sums = {k: float(v) for k, v in got.items()}
    assert set(pt.finalize_metrics(sums)) == {"loss", *METRICS}


def test_embed_gather_equals_indexing_under_vmap_grad():
    rng = np.random.default_rng(4)
    tables = torch.from_numpy(rng.normal(size=(3, 11, 5)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 11, size=(3, 4, 7)))
    w = torch.from_numpy(rng.normal(size=(3, 4, 7, 5)).astype(np.float32))

    def loss(lookup):
        return lambda t, i, c: (lookup(t, i) * c).sum()

    got = vmap(grad(loss(embed_gather)))(tables, ids, w)
    want = vmap(grad(loss(lambda t, i: t[i])))(tables, ids, w)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(vmap(embed_gather)(tables, ids),
                       vmap(lambda t, i: t[i])(tables, ids))


@pytest.fixture(scope="module")
def mind_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mind")
    for split, seed, n in (("train", 5, 8), ("val", 6, 4)):
        users = _users(seed, n)
        names = [f"{split}{i}" for i in range(n)]
        with open(d / f"{split}.json", "w") as fh:
            json.dump({"users": names, "num_samples": [1] * n,
                       "user_data": dict(zip(names, users))}, fh)
    return str(d)


def test_nrms_cli_trajectory_matches_jax(mind_dir, tmp_path, monkeypatch):
    model = _published_model("fednewsrec", **SMALL)
    raw = {
        "model_config": model, "strategy": "fedavg",
        "server_config": {
            "max_iteration": 3, "num_clients_per_iteration": 2,
            "initial_lr_client": 0.01, "val_freq": 1, "rec_freq": 100,
            "initial_val": True, "best_model_criterion": "auc",
            "pipeline_depth": 0,
            "optimizer_config": {"type": "sgd", "lr": 1.0},
            "data_config": {"val": {"batch_size": 4,
                                    "val_data": "val.json"}}},
        "client_config": {
            "optimizer_config": {"type": "adam", "lr": 0.0001},
            "data_config": {"train": {"batch_size": 2,
                                      "list_of_train_data": "train.json"}}},
    }
    init, want, _ = _jax_history(raw, mind_dir, str(tmp_path / "jax"))
    _, got = _port_cli_history(raw, mind_dir, tmp_path / "port", init,
                               monkeypatch,
                               make_nrms_task(ModelConfig.from_dict(model)))
    assert [r for r, _ in got] == [r for r, _ in want] == [0, 1, 2, 3]
    for (r, g), (_, w) in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"]), (r, g, w)
        for k in METRICS:
            assert abs(g[k] - w[k]) <= 1e-5, (r, k, g, w)
    assert got[-1][1]["loss"] != got[0][1]["loss"]
