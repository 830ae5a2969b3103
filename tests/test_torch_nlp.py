"""The nlg_gru GRU word LM of the PyTorch port against the JAX package's, at
small widths (vocab 64, embed 8, hidden 16, 6 words):

- logits, loss, ``train_sample_count`` and grads with carried weights:
  ``rtol 1e-5`` (float32; the two packages sum the products of a matmul in
  different orders);
- ``make_dataset`` ids and masks bitwise;
- one DGA trajectory, 5 rounds, quantization on (0.7 quantile, 10 bits)
  and DP off, with the nlg_gru config's adam server optimizer: the val
  loss per round to ``rel 1e-5`` (measured: at most 1.1e-7).  The room is
  for quantization, which is discontinuous: an element within float32
  noise of the threshold or of a half-bin lands on another level in one
  package than in the other, which moves the aggregate by one bin width
  there;
- the port's CLI end to end on ``-device cpu`` with the nlg_gru config plus
  the DP and quantization knobs (global DP through kernel B2's plain
  version, local DP with eps 100).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.flatten_util import ravel_pytree
from torch.func import grad_and_value

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.data.user_blob import load_user_blob as jax_load_blob
from msrflute_tpu.engine import OptimizationServer as JaxServer
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.models.nlp import make_gru_lm_task as jax_gru_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu.tasks import build_task_datasets as jax_build_datasets
from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.data.user_blob import load_user_blob
from msrflute_tpu_torch.engine import OptimizationServer
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params, to_jax_params
from msrflute_tpu_torch.models.nlp import make_gru_lm_task
from msrflute_tpu_torch.tasks import build_task_datasets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"model_type": "GRU", "vocab_size": 64, "embed_dim": 8,
         "hidden_dim": 16, "max_num_words": 6}


def write_reddit_blob(path, vocab, num_users, lo, hi, seed):
    """Users with ``lo..hi`` utterances of 2-8 words drawn from ``vocab``
    (Zipf-like frequencies), a few words outside it (unk)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    users = [f"r{seed}_{i:03d}" for i in range(num_users)]
    data, counts = {}, []
    for u in users:
        n = int(rng.integers(lo, hi + 1))
        utts = []
        for _ in range(n):
            words = list(rng.choice(vocab, size=int(rng.integers(2, 9)), p=p))
            if rng.random() < 0.2:
                words.append("OUTSIDE")
            utts.append(words)
        data[u] = {"x": utts}
        counts.append(n)
    with open(path, "w") as fh:
        json.dump({"users": users, "num_samples": counts, "user_data": data},
                  fh)


@pytest.fixture(scope="module")
def reddit(tmp_path_factory):
    d = tmp_path_factory.mktemp("reddit")
    vocab = ["<unk>"] + [f"w{i}" for i in range(1, 64)]
    (d / "vocab.vocab").write_text("\n".join(vocab) + "\n")
    write_reddit_blob(d / "train.json", vocab[1:], 12, 3, 20, seed=0)
    write_reddit_blob(d / "val.json", vocab[1:], 3, 4, 8, seed=1)
    return str(d)


def _batch(seed=0, B=5):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 64, size=(B, 6)).astype(np.int32)
    tok = np.ones((B, 6), np.float32)
    tok[1, 4:] = 0.0
    x[1, 4:] = 0
    x[2, 1] = 0                                  # a real unk word
    sm = np.ones((B,), np.float32)
    sm[3] = 0.0
    return {"x": x, "tok_mask": tok, "sample_mask": sm}


def _carried():
    jt, pt = jax_gru_task(SMALL), make_gru_lm_task(SMALL)
    jp = jax.device_get(jt.init_params(jax.random.PRNGKey(0)))
    return jt, pt, jp, from_jax_params(pt, jp)


def test_layout_is_the_jax_ravel_order():
    jt, pt, jp, tp = _carried()
    np.testing.assert_array_equal(pt.layout().flatten(tp).numpy(),
                                  np.asarray(ravel_pytree(jp)[0]))
    back = to_jax_params(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)


def test_full_width_parameter_count():
    task = make_gru_lm_task({"model_type": "GRU"})
    assert task.layout().numel == 2_727_184
    assert len(task.layout().names) == 7


def test_logits_loss_count_and_grads_match_jax():
    jt, pt, jp, tp = _carried()
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want_logits = np.asarray(jt.module.apply({"params": jp},
                                             jb["x"][:, :-1]))
    got_logits = pt.apply(tp, tb["x"][:, :-1].long()).numpy()
    assert got_logits.shape == (5, 6, 64)
    np.testing.assert_allclose(got_logits, want_logits, rtol=1e-5, atol=1e-6)
    (jl, jaux), jg = jax.value_and_grad(
        lambda p: jt.loss(p, jb, None, True), has_aux=True)(jp)
    tg, (tl, taux) = grad_and_value(pt.loss_and_aux, has_aux=True)(tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(taux["train_sample_count"]) == \
        float(jaux["train_sample_count"]) == 22.0
    np.testing.assert_allclose(pt.layout().flatten(tg).numpy(),
                               np.asarray(ravel_pytree(jg)[0]),
                               rtol=1e-5, atol=1e-7)


def test_eval_stats_match_jax():
    jt, pt, jp, tp = _carried()
    b = _batch(seed=3)
    want = jt.eval_stats(jp, {k: jnp.asarray(v) for k, v in b.items()})
    got = pt.eval_stats(tp, {k: torch.from_numpy(v) for k, v in b.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


def test_make_dataset_matches_jax_bitwise(reddit):
    mc = dict(SMALL, vocab_dict=os.path.join(reddit, "vocab.vocab"))
    blob_path = os.path.join(reddit, "train.json")
    want = jax_gru_task(mc).make_dataset(jax_load_blob(blob_path), mc,
                                         "train")
    got = make_gru_lm_task(mc).make_dataset(load_user_blob(blob_path))
    assert got.user_list == want.user_list
    assert got.num_samples == want.num_samples
    for i in range(len(want)):
        w, g = want.user_arrays(i), got.user_arrays(i)
        assert set(w) == set(g) == {"x", "tok_mask"}
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def _dga_config(rounds, **server_over):
    return {
        "model_config": dict(SMALL, vocab_dict="vocab.vocab",
                             quant_threshold=0.7, quant_bits=10),
        "strategy": "dga",
        "dp_config": {"enable_local_dp": False},
        "server_config": {
            "max_iteration": rounds, "num_clients_per_iteration": 4,
            "initial_lr_client": 1.0, "val_freq": 1, "rec_freq": 1000,
            "initial_val": True, "best_model_criterion": "loss",
            "aggregate_median": "softmax", "softmax_beta": 1.0,
            "weight_train_loss": "train_loss", "stale_prob": 0.0,
            "optimizer_config": {"type": "adam", "lr": 0.001,
                                 "amsgrad": True},
            "annealing_config": {"type": "step_lr", "step_interval": "epoch",
                                 "step_size": 1, "gamma": 1.0},
            "data_config": {"val": {"batch_size": 16,
                                    "val_data": "val.json"}},
            **server_over,
        },
        "client_config": {
            "meta_learning": "basic", "type": "optimization",
            "desired_max_samples": 16,
            "optimizer_config": {"type": "sgd", "lr": 1.0},
            "annealing_config": {"type": "step_lr", "step_interval": "epoch",
                                 "step_size": 1, "gamma": 1.0},
            "data_config": {"train": {"batch_size": 4,
                                      "list_of_train_data": "train.json",
                                      "max_num_words": 6}},
        },
    }


def test_dga_quantized_trajectory_matches_jax(reddit, tmp_path):
    raw = _dga_config(5)
    cfg = JaxFLUTEConfig.from_dict(raw)
    cfg.validate(reddit)
    task = jax_make_task(cfg.model_config)
    train, val, _ = jax_build_datasets(cfg, task)
    jserver = JaxServer(task, cfg, train, val_dataset=val,
                        model_dir=str(tmp_path / "jax"),
                        mesh=make_mesh(num_devices=1), seed=0)
    init = jax.device_get(jserver.state.params)
    want = []
    evaluate = jserver._maybe_eval

    def recording_eval(split, round_no, force=False):
        improved = evaluate(split, round_no, force=force)
        want.append((round_no, jserver._last_val["loss"].value))
        return improved

    jserver._maybe_eval = recording_eval
    jserver.train()

    pcfg = FLUTEConfig.from_dict(raw)
    pcfg.validate(reddit)
    ptask = make_task(pcfg.model_config)
    ptrain, pval, _ = build_task_datasets(pcfg, ptask)
    server = OptimizationServer(ptask, pcfg, ptrain, val_dataset=pval,
                                model_dir=str(tmp_path / "port"),
                                device="cpu", seed=0,
                                init_params=from_jax_params(ptask, init))
    server.train()
    got = [(h["round"], h["loss"]) for h in server.history
           if h["split"] == "val"]
    assert [r for r, _ in got] == [r for r, _ in want] == list(range(6))
    for (r, gl), (_, wl) in zip(got, want):
        assert abs(gl - wl) <= 1e-5 * abs(wl), (r, gl, wl)
    assert got[-1][1] < got[0][1]        # it learned
    assert int(server.state.opt_state["count"]) == 5


def test_cli_runs_nlg_gru_with_dp_and_quantization_on_cpu(reddit, tmp_path):
    with open(os.path.join(REPO, "experiments", "nlg_gru",
                           "config.yaml")) as fh:
        raw = yaml.safe_load(fh)
    # the published config plus the DP and quantization knobs, cut to
    # small widths, 2 rounds and this test's blobs
    raw["model_config"].update(SMALL, vocab_dict="vocab.vocab",
                               quant_threshold=0.7, quant_bits=10)
    raw["dp_config"] = {"enable_local_dp": True, "eps": 100.0,
                        "delta": 1e-7, "max_grad": 1.0,
                        "max_weight": 10000.0, "min_weight": 0.0,
                        "weight_scaler": 0.0001, "enable_global_dp": True,
                        "global_sigma": 1.0}
    sc = raw["server_config"]
    sc.update(max_iteration=2, val_freq=1, num_clients_per_iteration=4,
              megakernel={"pallas_apply": True})
    sc["data_config"] = {"val": {"batch_size": 16, "val_data": "val.json",
                                 "vocab_dict": "vocab.vocab"}}
    raw["client_config"]["desired_max_samples"] = 16
    raw["client_config"]["data_config"]["train"].update(
        batch_size=4, list_of_train_data="train.json",
        vocab_dict="vocab.vocab")
    cfg_path = tmp_path / "nlg_gru.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "msrflute_tpu_torch.e2e_trainer",
         "-config", str(cfg_path), "-dataPath", reddit,
         "-outputPath", str(out), "-task", "nlg_gru", "-device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    metrics = [json.loads(line) for line in
               (out / "log" / "metrics.jsonl").read_text().splitlines()]
    by_name = {}
    for m in metrics:
        by_name.setdefault(m["name"], []).append(m)
    assert [m["value"] for m in by_name["Quantization Thresh."]] == \
        pytest.approx([0.7, 0.7])
    assert len(by_name["Training loss"]) == 2
    assert all(np.isfinite(m["value"]) for m in by_name["Val loss"])
    status = json.loads((out / "models" / "status_log.json").read_text())
    assert status["i"] == 2 and status["quant_thresh"] == pytest.approx(0.7)
    assert "amsgrad" in (out / "log" / "log.out").read_text()
