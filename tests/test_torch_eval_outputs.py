"""The eval outputs of a split's ``data_config`` in the port
(``engine/server.py::_dump_predictions`` / ``_log_per_user_stats``,
``engine/evaluation.py``) against the JAX server's
(``msrflute_tpu/engine/server.py:2949-3100``,
``engine/evaluation.py:88-150``):

- ``wantLogits`` on the FedAvg LR model, from the JAX server's initial
  weights, at round 0 and after one round: the
  ``predictions_val_r<N>.jsonl`` rows against the JAX dump, users,
  predictions and labels equal and the logits within 2e-6, one row per
  real val sample (the port through its CLI on ``-device cpu``);
- ``per_user_stats``: the six metrics under the JAX names, within 1e-6 of
  the JAX server's;
- the sequence payload (``topk_predictions``, top 3) against the JAX
  task's on RingLM, the probabilities within 2e-6 and the ids and labels
  equal, and a RingLM dump through the CLI;
- the warnings: ``per_user_stats`` on a sequence task and ``wantLogits``
  on a task with neither hook skip, as in the JAX package.
"""

import copy
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import msrflute_tpu.engine.server as jax_server_module
from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.engine import OptimizationServer as JaxServer
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu.tasks import build_task_datasets as jax_build_datasets
from msrflute_tpu_torch import e2e_trainer
from msrflute_tpu_torch.models.convert import from_jax_params
from test_torch_checkpoint import _write_blob
from test_torch_pretrained import _raw
from test_torch_ringlm import _carried, longtext  # noqa: F401

PER_USER = ("worst user", "user p10", "user p50", "user p90", "user std",
            "users evaluated")


@pytest.fixture(scope="module")
def blobs(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval_outputs")
    _write_blob(d / "train.json", 12, seed=0)
    _write_blob(d / "val.json", 5, seed=1)
    return str(d)


def _outputs_raw():
    raw = _raw(1)
    raw["server_config"]["data_config"]["val"].update(wantLogits=True,
                                                      per_user_stats=True)
    return raw


def _rows(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def test_dump_and_per_user_metrics_match_the_jax_server(blobs, tmp_path,
                                                        monkeypatch):
    raw = _outputs_raw()
    cfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    cfg.validate(blobs)
    task = jax_make_task(cfg.model_config)
    train, val, _ = jax_build_datasets(cfg, task)
    logged = {}
    real_log = jax_server_module.log_metric

    def recording_log(name, value, step=None, **kw):
        logged[(name, step)] = value
        return real_log(name, value, step=step, **kw)

    monkeypatch.setattr(jax_server_module, "log_metric", recording_log)
    jserver = JaxServer(task, cfg, train, val_dataset=val,
                        model_dir=str(tmp_path / "jax"),
                        mesh=make_mesh(num_devices=1), seed=0)
    init = jax.device_get(jserver.state.params)
    jserver.train()

    from msrflute_tpu_torch.models import cv
    monkeypatch.setattr(cv.ClassificationTask, "init_params",
                        lambda self, seed: from_jax_params(self, init))
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(raw))
    server = e2e_trainer.main(["-config", str(tmp_path / "cfg.yaml"),
                               "-dataPath", blobs, "-outputPath",
                               str(tmp_path / "port"), "-device", "cpu"])
    n_real = sum(val.num_samples)
    for r in (0, 1):
        want = _rows(tmp_path / "jax" / f"predictions_val_r{r}.jsonl")
        got = _rows(tmp_path / "port" / "models" /
                    f"predictions_val_r{r}.jsonl")
        assert len(got) == len(want) == n_real
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"user", "pred", "label", "logits"}
            assert (g["user"], g["pred"], g["label"]) == \
                (w["user"], w["pred"], w["label"])
            np.testing.assert_allclose(g["logits"], w["logits"], rtol=0,
                                       atol=2e-6)
    records = [json.loads(line) for line in (
        tmp_path / "port" / "log" / "metrics.jsonl").read_text()
        .splitlines()]
    got_metrics = {(m["name"], m.get("step")): m["value"] for m in records}
    for r in (0, 1):
        for what in PER_USER:
            key = (f"Val acc ({what})", r)
            assert abs(got_metrics[key] - logged[key]) <= 1e-6, key
    assert got_metrics[("Val acc (users evaluated)", 0)] == len(val)
    assert not list((tmp_path / "port" / "models").glob("*.tmp"))


def test_topk_predictions_match_the_jax_task():
    jt, pt, jp, tp = _carried()
    rng = np.random.default_rng(2)
    x = rng.integers(1, 40, (4, 33)).astype(np.int32)
    tok = np.ones((4, 33), np.float32)
    tok[2, 25:] = 0.0
    b = {"x": x, "tok_mask": tok, "sample_mask": np.ones(4, np.float32)}
    want = [np.asarray(a) for a in jt.topk_predictions(
        jp, {k: jnp.asarray(v) for k, v in b.items()}, 3)]
    with torch.no_grad():
        got = [a.numpy() for a in pt.topk_predictions(
            tp, {k: torch.from_numpy(v) for k, v in b.items()}, 3)]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2e-6)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert (got[2][2, 24:] == -1).all()


def test_sequence_dump_and_the_per_user_warning_through_the_cli(
        longtext, tmp_path):
    from test_torch_ringlm import _fedavg_config
    raw = _fedavg_config(1)
    raw["model_config"].update(num_layers=1, flash_attention=False)
    raw["server_config"]["data_config"]["val"].update(wantLogits=True,
                                                      per_user_stats=True)
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(raw))
    server = e2e_trainer.main(["-config", str(tmp_path / "cfg.yaml"),
                               "-dataPath", longtext, "-outputPath",
                               str(tmp_path / "out"), "-task", "ringlm",
                               "-device", "cpu"])
    assert "per_user_stats set for val but task RingLMTask" in (
        tmp_path / "out" / "log" / "log.out").read_text()
    rows = _rows(tmp_path / "out" / "models" / "predictions_val_r1.jsonl")
    assert len(rows) == sum(server.val_dataset.num_samples)
    row = rows[0]
    assert set(row) == {"user", "topk_ids", "topk_probs", "labels"}
    assert np.asarray(row["topk_ids"]).shape == (32, 3)
    # rounded to 6 digits, then held as float32 (the JAX dump's values)
    assert all(abs(p - round(p, 6)) <= 1e-7 for ps in row["topk_probs"]
               for p in ps)
    records = (tmp_path / "out" / "log" / "metrics.jsonl").read_text()
    assert "acc (worst user)" not in records


def test_want_logits_warns_on_a_task_without_either_hook(monkeypatch):
    from msrflute_tpu_torch.engine import server as server_module
    said = []
    monkeypatch.setattr(server_module, "print_rank",
                        lambda msg, loglevel=logging.INFO:
                        said.append((msg, loglevel)))
    server = server_module.OptimizationServer.__new__(
        server_module.OptimizationServer)
    server.task = object()
    server._dump_predictions("val", 0)
    assert len(said) == 1 and said[0][1] == logging.WARNING
    assert "exposes neither topk_predictions nor predict" in said[0][0]
