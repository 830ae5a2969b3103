"""The port's ECG_CNN (``msrflute_tpu_torch/models/ecg.py``) against the
JAX package's ``make_ecg_task`` at hidden 16 and 40 frames, with the JAX
weights carried across:

- the leaves in the JAX package's ``ravel_pytree`` order, and P =
  136,709 in 39 leaves at the published widths;
- logits, loss and grads: ``rtol 1e-5`` (float32 sums in other orders:
  the convolutions, GroupNorm's statistics, the 10-step LSTM);
- ``experiments/ecg_cnn``'s model and optimizers (client and server adam)
  through the port's CLI on ``-device cpu`` against the JAX package's
  server, 3 rounds of 2 clients: val loss every round to ``rel 1e-5`` and
  accuracy to one val sample.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.flatten_util import ravel_pytree
from torch.func import grad_and_value

from msrflute_tpu.config import ModelConfig as JaxModelConfig
from msrflute_tpu.models.ecg import make_ecg_task as jax_ecg_task
from msrflute_tpu_torch.config import ModelConfig
from msrflute_tpu_torch.models.convert import from_jax_params
from msrflute_tpu_torch.models.ecg import make_ecg_task
from test_torch_cli_trajectories import (REPO, _compare, _jax_history,
                                         _port_cli_history, _published_model)

SMALL = {"model_type": "ECG_CNN", "num_classes": 5, "num_frames": 40,
         "hidden_dim": 16}


def _carried():
    jt = jax_ecg_task(JaxModelConfig.from_dict(SMALL))
    pt = make_ecg_task(ModelConfig.from_dict(SMALL))
    jp = jax.device_get(jt.init_params(jax.random.PRNGKey(0)))
    return jt, pt, jp, from_jax_params(pt, jp)


def _batch(seed=0, B=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 40)).astype(np.float32)
    y = rng.integers(0, 5, size=B).astype(np.int32)
    sm = np.ones((B,), np.float32)
    sm[4] = 0.0
    return {"x": x, "y": y, "sample_mask": sm}


def test_layout_is_the_jax_ravel_order():
    jt, pt, jp, tp = _carried()
    np.testing.assert_array_equal(pt.layout().flatten(tp).numpy(),
                                  np.asarray(ravel_pytree(jp)[0]))


def test_published_widths_parameter_count():
    with torch.device("meta"):
        layout = make_ecg_task(ModelConfig.from_dict(
            _published_model("ecg_cnn"))).layout()
    assert layout.numel == 136_709 and len(layout.names) == 39


def test_logits_loss_and_grads_match_jax():
    jt, pt, jp, tp = _carried()
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    want = np.asarray(jt.module.apply({"params": jp}, jb["x"]))
    got = pt.apply(tp, tb["x"]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jt.loss(p, jb, None, False), has_aux=True)(jp)
    tg, (tl, _) = grad_and_value(pt.loss_and_aux, has_aux=True)(tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    g_want = np.asarray(ravel_pytree(jg)[0])
    np.testing.assert_allclose(pt.layout().flatten(tg).numpy(), g_want,
                               rtol=1e-5, atol=1e-6 * np.abs(g_want).max())


def _ecg_blob(path, users, seed):
    """Beats whose class sets a bump's place, so there is a signal."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, 40)
    names = [f"e{seed}_{i:02d}" for i in range(users)]
    data, labels = {}, {}
    for u in names:
        n = int(rng.integers(4, 10))
        y = rng.integers(0, 5, n)
        x = np.exp(-((t[None] - (0.15 + 0.15 * y)[:, None]) / 0.05) ** 2)
        x += rng.normal(0.0, 0.05, x.shape)
        data[u] = {"x": x.round(4).tolist()}
        labels[u] = y.tolist()
    with open(path, "w") as fh:
        json.dump({"users": names, "num_samples": [len(v) for v in
                                                   labels.values()],
                   "user_data": data, "user_data_label": labels}, fh)


@pytest.fixture(scope="module")
def ecg_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ecg")
    _ecg_blob(d / "train.json", 8, 0)
    _ecg_blob(d / "val.json", 3, 1)
    return str(d)


def test_ecg_cli_trajectory_matches_jax(ecg_dir, tmp_path, monkeypatch):
    with open(os.path.join(REPO, "experiments", "ecg_cnn",
                           "config.yaml")) as fh:
        raw = yaml.safe_load(fh)
    raw["model_config"].update(num_frames=40, hidden_dim=16)
    sc = raw["server_config"]
    sc.update(max_iteration=3, num_clients_per_iteration=2, val_freq=1,
              rec_freq=100, pipeline_depth=0)
    sc["data_config"] = {"val": {"batch_size": 16, "val_data": "val.json"}}
    raw["client_config"]["data_config"]["train"].update(
        batch_size=4, list_of_train_data="train.json")
    init, want, val = _jax_history(raw, ecg_dir, str(tmp_path / "jax"))
    server, got = _port_cli_history(
        raw, ecg_dir, tmp_path / "port", init, monkeypatch,
        make_ecg_task(ModelConfig.from_dict(raw["model_config"])))
    _compare(got, want, sum(val.num_samples), 1e-5)
    assert int(server.state.opt_state["count"]) == 3
