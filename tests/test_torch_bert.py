"""The port's BERT masked LM (``msrflute_tpu_torch/models/bert.py``, no
``transformers``) against the JAX package's ``BertMLMTask`` over HF Flax
``FlaxBertForMaskedLM`` at 2 layers, hidden 32, 2 heads, vocabulary 1,000
and 16 tokens, with the JAX weights carried across:

- the leaves are HF Flax's, in ``ravel_pytree`` order; P = 109,514,298
  in 202 leaves at the shipped widths, and the privacy attack's leaf is
  ``position_embeddings`` there, as in the JAX package;
- logits: ``rtol 1e-5`` (float32 sums in other orders);
- premasked loss (with and without label smoothing), its grads and the
  eval stats: ``rtol 1e-5``; grads to ``1e-5`` of the largest, since the
  key biases' grads are 0 up to rounding (softmax ignores a per-query
  shift);
- ``_mlm_mask``: the 15 % selection and its 80/10/10 split, held
  statistically (5 sigma) against the rates and against the JAX task's
  own draws, as the random streams cannot match;
- 3-round DGA trajectories of ``experiments/mlm_bert``'s strategy
  (softmax weights), DP off and dropout 0 on both sides' built model,
  premasked rows: the val loss every round to ``rel 1e-5`` (measured: at
  most 1.5e-7).  The shipped client and server adamW run with
  quantization off; quantization (0.7 quantile, 10 bits; B3's plain
  version here, ``quant_bin_sparsify`` as the JAX tests run it on the
  CPU) runs with SGD on both sides.  An adam pseudo-gradient is a few
  ``lr``-sized steps whose magnitudes agree to float32 noise, so the 0.7
  quantile sits in that cluster, and float32 order decides which of its
  elements are kept: 4e-4 of the val loss after one round here, where
  the JAX package is deterministic but the two packages differ;
- local DP on: one round's server step held statistically (its spread
  within 10 % of the JAX package's).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.flatten_util import ravel_pytree
from torch.func import grad_and_value

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.config import ModelConfig as JaxModelConfig
from msrflute_tpu.engine import OptimizationServer as JaxServer
from msrflute_tpu.models.bert import make_bert_mlm_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu.tasks import build_task_datasets as jax_build_datasets
from msrflute_tpu_torch import e2e_trainer
from msrflute_tpu_torch.config import ModelConfig
from msrflute_tpu_torch.models import bert
from msrflute_tpu_torch.models.bert import make_bert_task
from msrflute_tpu_torch.models.convert import from_jax_params
from msrflute_tpu_torch.strategies.base import find_embedding_leaf
from test_torch_cli_trajectories import REPO, _published_model

V, L = 1000, 16
SMALL = {"vocab_size": V, "hidden_size": 32, "num_hidden_layers": 2,
         "num_attention_heads": 2, "intermediate_size": 64,
         "max_seq_length": L, "mlm_probability": 0.15, "mask_token_id": 103}


def _model(**over):
    return {"model_type": "BERT",
            "BERT": {"model": dict(SMALL, **over),
                     "training": {"batch_size": 4,
                                  "label_smoothing_factor": 0.0}}}


def _carried(**over):
    jt = make_bert_mlm_task(JaxModelConfig.from_dict(_model(**over)))
    pt = make_bert_task(ModelConfig.from_dict(_model(**over)))
    jp = jax.device_get(jt.init_params(jax.random.PRNGKey(0)))
    return jt, pt, jp, from_jax_params(pt, jp)


def _batch(seed=0, B=4):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, V, (B, L)).astype(np.int32)
    x[1, 10:] = 0
    y = np.where((rng.random((B, L)) < 0.3) & (x > 0), x, -100).astype(
        np.int32)
    x = np.where(y >= 0, 103, x).astype(np.int32)
    sm = np.ones((B,), np.float32)
    sm[3] = 0.0
    return {"x": x, "y": y, "sample_mask": sm}


def test_layout_is_the_hf_flax_tree_in_ravel_order():
    _, pt, jp, tp = _carried()
    paths = [".".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert pt.layout().names == paths
    np.testing.assert_array_equal(pt.layout().flatten(tp).numpy(),
                                  np.asarray(ravel_pytree(jp)[0]))


def test_shipped_widths_and_the_attack_leaf():
    with torch.device("meta"):
        layout = make_bert_task(ModelConfig.from_dict(
            _published_model("mlm_bert"))).layout()
    assert layout.numel == 109_514_298 and len(layout.names) == 202
    off, size, shape = find_embedding_leaf(layout)
    name = layout.names[layout.offsets.index(off)]
    assert name == "bert.embeddings.position_embeddings.embedding"
    assert shape == (512, 768) and size == 512 * 768


def test_logits_match_hf_flax():
    jt, pt, jp, tp = _carried()
    x = _batch()["x"]
    want = np.asarray(jt.apply(jp, jnp.asarray(x)))
    got = pt.logits(tp, torch.from_numpy(x).long(),
                    torch.ones((4, L), dtype=torch.long)).numpy()
    assert got.shape == (4, L, V)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_premasked_loss_grads_and_eval_stats_match_jax(smoothing):
    jt, pt, jp, tp = _carried(premasked=True)
    jt.label_smoothing = pt.label_smoothing = smoothing
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jt.loss(p, jb, None, False), has_aux=True)(jp)
    tg, (tl, taux) = grad_and_value(pt.loss_and_aux, has_aux=True)(tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(taux["train_sample_count"]) == \
        float(jaux["train_sample_count"]) == 42.0
    g_want = np.asarray(ravel_pytree(jg)[0])
    np.testing.assert_allclose(pt.layout().flatten(tg).numpy(), g_want,
                               rtol=1e-5, atol=1e-5 * np.abs(g_want).max())
    want = jt.eval_stats(jp, jb)
    got = pt.eval_stats(tp, tb)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def _proportions(masked, labels, ids, real):
    sel = labels != -100
    n = sel.sum()
    return {"select": n / real.sum(),
            "mask": (sel & (masked == 103)).sum() / n,
            "kept": (sel & (masked == ids)).sum() / n}


def test_mlm_mask_proportions():
    """Over 64 x 16 x 50 tokens (about 7,700 selected): the selection rate
    is 15 % of the real tokens, [MASK] 80 % of those, the original kept
    10 % (plus the random draws that hit it, 0.01 %), in both packages,
    within 5 binomial sigma; labels only where selected, never on
    padding."""
    jt, pt, _, _ = _carried()
    rng = np.random.default_rng(5)
    ids = rng.integers(104, V, (64 * 50, L))
    am = (rng.random((64 * 50, L)) < 0.95).astype(np.int64)
    gen = torch.Generator().manual_seed(0)
    t_ids, t_am = torch.from_numpy(ids), torch.from_numpy(am)
    draws = pt._mlm_draws(gen, tuple(t_ids.shape), "cpu")
    masked, labels = (t.numpy() for t in pt._mlm_mask(draws, t_ids, t_am))
    jm, jl = (np.asarray(t) for t in jt._mlm_mask(
        jax.random.PRNGKey(0), jnp.asarray(ids, jnp.int32),
        jnp.asarray(am, jnp.int32)))
    assert ((labels != -100) <= (am > 0)).all()
    assert (labels[labels != -100] == ids[labels != -100]).all()
    real = am > 0
    got, want = (_proportions(m, lab, ids, real)
                 for m, lab in ((masked, labels), (jm, jl)))
    n_real, n_sel = real.sum(), (labels != -100).sum()
    for key, rate, n in (("select", 0.15, n_real), ("mask", 0.8, n_sel),
                         ("kept", 0.1, n_sel)):
        sigma = np.sqrt(rate * (1 - rate) / n)
        assert abs(got[key] - rate) < 5 * sigma, (key, got[key])
        assert abs(want[key] - rate) < 5 * sigma, (key, want[key])


def test_dynamic_eval_mask_is_fixed():
    _, pt, _, tp = _carried()
    b = {k: torch.from_numpy(v) for k, v in _batch().items()}
    a, c = pt.eval_stats(tp, b), pt.eval_stats(tp, b)
    assert all(torch.equal(a[k], c[k]) for k in a)
    assert float(a["sample_count"]) > 0


# ----------------------------------------------------------------------
def _token_blob(path, users, seed):
    """Premasked token rows: ``[CLS]`` ids ``[SEP]`` padded to L, 15 % of
    the words masked with their labels in ``y``."""
    rng = np.random.default_rng(seed)
    names = [f"b{seed}_{i:02d}" for i in range(users)]
    data = {}
    for u in names:
        n = int(rng.integers(3, 9))
        x = np.zeros((n, L), np.int64)
        for j in range(n):
            m = int(rng.integers(4, L - 1))
            x[j, 0], x[j, m + 1] = 101, 102
            x[j, 1:m + 1] = rng.integers(104, 200, m)
        sel = (rng.random(x.shape) < 0.15) & (x > 103)
        data[u] = {"x": np.where(sel, 103, x).tolist(),
                   "y": np.where(sel, x, -100).tolist()}
    with open(path, "w") as fh:
        json.dump({"users": names, "num_samples": [len(d["x"]) for d in
                                                   data.values()],
                   "user_data": data}, fh)


@pytest.fixture(scope="module")
def tokens_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tokens")
    _token_blob(d / "train.json", 8, 0)
    _token_blob(d / "val.json", 3, 1)
    return str(d)


def _dga_raw(rounds, local_dp, quant=True, server_opt=None):
    with open(f"{REPO}/experiments/mlm_bert/config.yaml") as fh:
        raw = yaml.safe_load(fh)
    raw["model_config"]["BERT"]["model"].update(SMALL, premasked=True)
    raw["mesh_config"]["model_axis_size"] = 1
    raw["dp_config"]["enable_local_dp"] = local_dp
    if not quant:
        del raw["model_config"]["quant_threshold"]
    raw["privacy_metrics_config"]["apply_metrics"] = False
    sc = raw["server_config"]
    sc.update(max_iteration=rounds, num_clients_per_iteration=3, val_freq=1,
              rec_freq=100, pipeline_depth=0, initial_lr_client=0.01,
              optimizer_config=server_opt or {"type": "adamW",
                                               "lr": 0.001})
    sc["data_config"] = {"val": {"batch_size": 8, "val_data": "val.json"}}
    raw["client_config"].update(desired_max_samples=8)
    raw["client_config"]["data_config"]["train"].update(
        batch_size=4, list_of_train_data="train.json")
    return raw


def _jax_run(raw, data_dir, model_dir):
    cfg = JaxFLUTEConfig.from_dict(raw)
    cfg.validate(data_dir)
    task = make_bert_mlm_task(cfg.model_config)
    task.config.hidden_dropout_prob = 0.0
    task.config.attention_probs_dropout_prob = 0.0
    train, val, _ = jax_build_datasets(cfg, task)
    server = JaxServer(task, cfg, train, val_dataset=val,
                       model_dir=model_dir, mesh=make_mesh(num_devices=1),
                       seed=0)
    init = jax.device_get(server.state.params)
    losses, evaluate = [], server._maybe_eval

    def recording_eval(split, round_no, force=False):
        improved = evaluate(split, round_no, force=force)
        losses.append((round_no, server._last_val["loss"].value))
        return improved

    server._maybe_eval = recording_eval
    server.train()
    return init, losses, jax.device_get(server.state.params)


def _port_run(raw, data_dir, out, init, monkeypatch):
    """The port's CLI in process, dropout 0 on the model it builds and
    the JAX package's initial weights."""
    monkeypatch.setattr(bert, "HIDDEN_DROPOUT", 0.0)
    monkeypatch.setattr(bert, "ATTENTION_DROPOUT", 0.0)
    monkeypatch.setattr(bert.BertMLMTask, "init_params",
                        lambda self, seed: from_jax_params(self, init))
    out.mkdir()
    (out / "cfg.yaml").write_text(yaml.safe_dump(raw))
    server = e2e_trainer.main(["-config", str(out / "cfg.yaml"), "-dataPath",
                               data_dir, "-outputPath", str(out / "run"),
                               "-device", "cpu"])
    assert not server.engine.random
    return server


@pytest.mark.parametrize("quant,client_opt,server_opt", [
    (True, "sgd", "sgd"), (False, "adamW", "adamW")],
    ids=["quantized", "shipped_optimizers"])
def test_dga_trajectory_matches_jax(tokens_dir, tmp_path, monkeypatch,
                                    quant, client_opt, server_opt):
    raw = _dga_raw(3, local_dp=False, quant=quant)
    raw["client_config"]["optimizer_config"] = {"type": client_opt,
                                                "lr": 0.01}
    raw["server_config"]["optimizer_config"] = {
        "type": server_opt, "lr": 1.0 if server_opt == "sgd" else 0.001}
    init, want, _ = _jax_run(raw, tokens_dir, str(tmp_path / "jax"))
    server = _port_run(raw, tokens_dir, tmp_path / "port", init,
                       monkeypatch)
    got = [(h["round"], h["loss"]) for h in server.history
           if h["split"] == "val"]
    assert [r for r, _ in got] == [r for r, _ in want] == [0, 1, 2, 3]
    for (r, g), (_, w) in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w), (r, g, w)
    assert got[-1][1] != got[0][1]


def test_local_dp_payload_is_held_statistically():
    """``experiments/mlm_bert``'s local DP (eps 100, delta 1e-7, weights
    scaled by 1e-4 up to 10,000) on three clients' payloads of the small
    BERT's P: the port's noise (its generators) and the JAX package's
    (its keys) have one spread, within 2 % (76,040 draws a client put the
    sampling error near 0.5 %), and a mean near 0."""
    from msrflute_tpu.strategies.dga import DGA as JaxDGA
    from msrflute_tpu_torch.config import FLUTEConfig
    from msrflute_tpu_torch.strategies.dga import DGA
    raw = _dga_raw(1, local_dp=True, quant=False)
    jcfg, pcfg = JaxFLUTEConfig.from_dict(raw), FLUTEConfig.from_dict(raw)
    P = make_bert_task(ModelConfig.from_dict(raw["model_config"])) \
        .layout().numel
    rng = np.random.default_rng(7)
    pg = (rng.normal(size=(3, P)) * 1e-3).astype(np.float32)
    w = np.asarray([1.0, 0.5, 2.0], np.float32)
    gens = [torch.Generator().manual_seed(s) for s in range(3)]
    got, _ = DGA(pcfg).transform_payload(
        torch.from_numpy(pg), torch.from_numpy(w),
        client_rngs=lambda tag: gens)
    jdga = JaxDGA(jcfg, jcfg.dp_config)
    want = np.stack([np.asarray(jdga.transform_payload(
        {"g": jnp.asarray(pg[k])}, jnp.asarray(w[k]),
        jax.random.PRNGKey(k))[0]["g"]) for k in range(3)])
    got = got.numpy()
    assert abs(got.std() / want.std() - 1.0) < 0.02, (got.std(), want.std())
    for a in (got, want):
        assert abs(a.mean()) < 0.01 * a.std()
