"""The RingLM char LM of the PyTorch port (local attention, the mode that
rides the federated engine) against the JAX package's, at the small widths
of ``tests/test_ringlm.py`` (vocab 40, embed 32, 2 heads of 8, mlp 64, 2
layers, seq_len 33):

- the parameter layout is the JAX ``ravel_pytree`` order (46 leaves and
  P = 945,370 at the published widths) and weights round-trip;
- logits, loss and grads with carried weights, flash attention on and off:
  ``rtol 1e-5`` (float32; the two packages sum matmul products in other
  orders), and ``eval_stats`` likewise;
- the char ``make_dataset`` bitwise;
- a 5-round FedAvg trajectory from the same initial weights: the val loss
  per round to ``rel 1e-5`` (measured: at most about 1e-7);
- the port's CLI end to end on ``-device cpu`` with ``-task ringlm``.
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
from msrflute_tpu.config import ModelConfig as JaxModelConfig
from msrflute_tpu.data.user_blob import load_user_blob as jax_load_blob
from msrflute_tpu.engine import OptimizationServer as JaxServer
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu.tasks import build_task_datasets as jax_build_datasets
from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.data.user_blob import load_user_blob
from msrflute_tpu_torch.engine import OptimizationServer
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params, to_jax_params
from msrflute_tpu_torch.models.ringlm import embed_lookup
from msrflute_tpu_torch.tasks import build_task_datasets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MC = {"vocab_size": 40, "embed_dim": 32, "num_heads": 2, "head_dim": 8,
      "mlp_dim": 64, "num_layers": 2, "seq_len": 33}
#: the char table's vocabulary (ids 1..86 and the OOV id 87)
CHARS = dict(MC, vocab_size=90)
WORDS = ("the of and to in a is that it was for on are with as his they "
         "at be this have from or one had by word but not").split()


def write_longtext_blob(path, num_users, lo, hi, seed, chars=45):
    """Users with ``lo..hi`` documents of word soup; most are longer than
    the 33-char window, some shorter (padded rows), and a few carry chars
    outside the table (OOV id 87)."""
    rng = np.random.default_rng(seed)
    users = [f"t{seed}_{i:03d}" for i in range(num_users)]
    data, counts = {}, []
    for u in users:
        n = int(rng.integers(lo, hi + 1))
        docs = [" ".join(rng.choice(WORDS, size=20))[:int(rng.integers(
            chars // 2, chars))] for _ in range(n)]
        docs[0] = docs[0] + "~@"
        data[u] = {"x": docs}
        counts.append(n)
    with open(path, "w") as fh:
        json.dump({"users": users, "num_samples": counts, "user_data": data},
                  fh)


@pytest.fixture(scope="module")
def longtext(tmp_path_factory):
    d = tmp_path_factory.mktemp("longtext")
    write_longtext_blob(d / "train.json", 10, 3, 12, seed=0)
    write_longtext_blob(d / "val.json", 3, 2, 6, seed=1)
    return str(d)


def _carried(flash=False, mc=MC):
    mc = dict(mc, flash_attention=flash)
    jt = jax_make_task(JaxModelConfig(model_type="RINGLM", extra=mc))
    pt = make_task({"model_type": "RINGLM", **mc})
    jp = jax.device_get(jt.init_params(jax.random.PRNGKey(0)))
    return jt, pt, jp, from_jax_params(pt, jp)


def _batch(seed=0, B=4, L=33):
    rng = np.random.default_rng(seed)
    x = rng.integers(1, 40, size=(B, L)).astype(np.int32)
    tok = np.ones((B, L), np.float32)
    tok[1, 20:] = 0.0
    x[1, 20:] = 0
    sm = np.ones((B,), np.float32)
    sm[3] = 0.0
    return {"x": x, "tok_mask": tok, "sample_mask": sm}


def test_layout_is_the_jax_ravel_order():
    jt, pt, jp, tp = _carried()
    np.testing.assert_array_equal(pt.layout().flatten(tp).numpy(),
                                  np.asarray(ravel_pytree(jp)[0]))
    back = to_jax_params(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)


def test_published_widths_parameter_count_and_order():
    with open(os.path.join(REPO, "experiments", "ringlm",
                           "config.yaml")) as fh:
        mc = yaml.safe_load(fh)["model_config"]
    task = make_task(mc)
    layout = task.layout()
    assert layout.numel == 945_370 and len(layout.names) == 46
    shapes = jax.eval_shape(
        jax_make_task(JaxModelConfig(model_type="RINGLM", extra={
            k: v for k, v in mc.items() if k != "model_type"})).init_params,
        jax.random.PRNGKey(0))
    paths = [".".join(str(p.key) for p in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(shapes)[0]]
    assert layout.names == paths


def test_more_than_ten_blocks_sort_as_strings():
    task = make_task(dict(MC, model_type="RINGLM", num_layers=11))
    blocks = [n.split(".")[0] for n in task.layout().names
              if n.startswith("block_")]
    assert blocks.index("block_10") < blocks.index("block_2")


def test_init_distributions():
    task = make_task(dict(MC, model_type="RINGLM", embed_dim=128))
    p = task.init_params(0)
    assert abs(float(p["Embed_0.embedding"].std()) - 128 ** -0.5) < 0.01
    assert abs(float(p["pos"].std()) - 0.02) < 0.002
    assert float(p["block_0.LayerNorm_0.scale"].min()) == 1.0
    assert float(p["block_0.Dense_0.bias"].abs().max()) == 0.0
    kernel = p["block_0._MHA_0.Dense_0.kernel"]
    assert float(kernel.abs().max()) <= 2 * 128 ** -0.5 / 0.8796 + 1e-6


def test_embedding_lookup_is_exact():
    """The module looks tokens up as a one-hot product (deterministic on
    the card): bitwise the gather it replaces."""
    task = make_task(dict(CHARS, model_type="RINGLM"))
    table = task.init_params(0)["Embed_0.embedding"]
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 90, size=(3, 17)))
    np.testing.assert_array_equal(embed_lookup(x, table).numpy(),
                                  torch.nn.functional.embedding(x, table)
                                  .numpy())


@pytest.mark.parametrize("flash", [False, True])
def test_logits_loss_and_grads_match_jax(flash):
    jt, pt, jp, tp = _carried(flash)
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want = np.asarray(jt.module.apply({"params": jp}, jb["x"][:, :-1]))
    got = pt.apply(tp, tb["x"][:, :-1].long()).detach().numpy()
    assert got.shape == (4, 32, 40)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jt.loss(p, jb, None, True), has_aux=True)(jp)
    tg, (tl, taux) = grad_and_value(pt.loss_and_aux, has_aux=True)(tp, tb)
    assert taux == {}                         # RingLM counts rows
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(pt.layout().flatten(tg).numpy(),
                               np.asarray(ravel_pytree(jg)[0]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("flash", [False, True])
def test_eval_stats_match_jax(flash):
    jt, pt, jp, tp = _carried(flash)
    b = _batch(seed=3)
    want = jt.eval_stats(jp, {k: jnp.asarray(v) for k, v in b.items()})
    with torch.no_grad():
        got = pt.eval_stats(tp, {k: torch.from_numpy(v)
                                 for k, v in b.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


def test_make_dataset_matches_jax_bitwise(longtext):
    mc = dict(CHARS, model_type="RINGLM")
    blob_path = os.path.join(longtext, "train.json")
    want = jax_make_task(JaxModelConfig(model_type="RINGLM", extra=CHARS)
                         ).make_dataset(jax_load_blob(blob_path), mc, "train")
    got = make_task(mc).make_dataset(load_user_blob(blob_path))
    assert got.user_list == want.user_list
    assert got.num_samples == want.num_samples
    saw_oov = saw_pad = False
    for i in range(len(want)):
        w, g = want.user_arrays(i), got.user_arrays(i)
        assert set(w) == set(g) == {"x", "tok_mask"}
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
        saw_oov |= bool((g["x"] == 87).any())
        saw_pad |= bool((g["tok_mask"] == 0).any())
    assert saw_oov and saw_pad


def _fedavg_config(rounds):
    return {
        "model_config": dict(CHARS, model_type="RINGLM",
                             flash_attention=True),
        "strategy": "fedavg",
        "server_config": {
            "max_iteration": rounds, "num_clients_per_iteration": 4,
            "initial_lr_client": 0.1, "val_freq": 1, "rec_freq": 1000,
            "initial_val": True, "best_model_criterion": "loss",
            "optimizer_config": {"type": "sgd", "lr": 1.0},
            "data_config": {"val": {"batch_size": 8,
                                    "val_data": "val.json"}},
        },
        "client_config": {
            "optimizer_config": {"type": "sgd", "lr": 0.1},
            "data_config": {"train": {"batch_size": 3,
                                      "list_of_train_data": "train.json"}},
        },
    }


def test_fedavg_trajectory_matches_jax(longtext, tmp_path):
    raw = _fedavg_config(5)
    cfg = JaxFLUTEConfig.from_dict(raw)
    cfg.validate(longtext)
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

    # the port runs the slice's whole path: flash attention and the
    # optimizer tail of kernel B1 (plain versions on the CPU; the JAX
    # package runs pallas_apply on a TPU only)
    raw["server_config"]["megakernel"] = {"pallas_apply": True}
    pcfg = FLUTEConfig.from_dict(raw)
    pcfg.validate(longtext)
    ptask = make_task(pcfg.model_config)
    ptrain, pval, _ = build_task_datasets(pcfg, ptask)
    server = OptimizationServer(ptask, pcfg, ptrain, val_dataset=pval,
                                model_dir=str(tmp_path / "port"),
                                device="cpu", seed=0,
                                init_params=from_jax_params(ptask, init))
    assert server.engine.hparams.pallas_apply
    server.train()
    got = [(h["round"], h["loss"]) for h in server.history
           if h["split"] == "val"]
    assert [r for r, _ in got] == [r for r, _ in want] == list(range(6))
    for (r, gl), (_, wl) in zip(got, want):
        assert abs(gl - wl) <= 1e-5 * abs(wl), (r, gl, wl)
    assert got[-1][1] < got[0][1]        # it learned


def test_cli_runs_ringlm_on_cpu(longtext, tmp_path):
    with open(os.path.join(REPO, "experiments", "ringlm",
                           "config.yaml")) as fh:
        raw = yaml.safe_load(fh)
    # the published config with the slice's knobs, cut to small widths,
    # 2 rounds and this test's blobs
    raw["model_config"].update(CHARS, flash_attention=True, flash_block_q=256,
                               flash_block_k=256)
    sc = raw["server_config"]
    sc.update(max_iteration=2, val_freq=1, num_clients_per_iteration=4,
              megakernel={"pallas_apply": True})
    sc["data_config"] = {"val": {"batch_size": 8, "val_data": "val.json"}}
    raw["client_config"]["data_config"]["train"].update(
        list_of_train_data="train.json")
    cfg_path = tmp_path / "ringlm.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "msrflute_tpu_torch.e2e_trainer",
         "-config", str(cfg_path), "-dataPath", longtext,
         "-outputPath", str(out), "-task", "ringlm", "-device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    metrics = [json.loads(line) for line in
               (out / "log" / "metrics.jsonl").read_text().splitlines()]
    by_name = {}
    for m in metrics:
        by_name.setdefault(m["name"], []).append(m["value"])
    assert len(by_name["Training loss"]) == 2
    assert len(by_name["Val loss"]) == 3 and \
        all(np.isfinite(by_name["Val loss"]))
    status = json.loads((out / "models" / "status_log.json").read_text())
    assert status["i"] == 2
    assert (out / "models" / "latest_model.pt").exists()
