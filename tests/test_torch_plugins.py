"""The port's ``model_folder`` plugin loader
(``msrflute_tpu_torch/models/registry.py``) and its hello_mlp twin
(``msrflute_tpu_torch/plugins/hello_mlp.py``):

- ``<model_type>Config.defaults`` of the folder's ``config.py`` fill the
  keys the YAML leaves out, and the YAML wins;
- the folder's ``task.py`` (flax) is never executed: a subprocess builds
  the task with ``jax``, ``flax`` and ``msrflute_tpu`` kept out of
  ``sys.modules``;
- ``task_torch.py`` in the folder wins over the built-in twin, and neither
  existing raises ``NotImplementedError`` naming both;
- ``experiments/hello_mlp/config.yaml``'s 12 rounds through the port's CLI
  against the JAX package's server on the same blob and initial weights:
  val loss to ``rel 1e-5`` (only the order of float32 sums differs),
  accuracy and ``top2_acc`` to one val sample (an argmax or a top-2 may
  flip where two logits tie to float32 rounding).
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import yaml

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.engine import OptimizationServer as JaxServer
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu.tasks import build_task_datasets as jax_build_datasets
from msrflute_tpu_torch import e2e_trainer
from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params
from msrflute_tpu_torch.plugins.hello_mlp import HelloMLPTask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELLO = os.path.join(REPO, "experiments", "hello_mlp")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msrflute_tpu")


def _hello_config(folder=HELLO):
    with open(os.path.join(HELLO, "config.yaml")) as fh:
        raw = yaml.safe_load(fh)
    raw["model_config"]["model_folder"] = folder
    return raw


def test_hello_mlp_defaults_merge_and_build_the_twin():
    cfg = FLUTEConfig.from_dict(_hello_config())
    task = make_task(cfg.model_config)
    assert isinstance(task, HelloMLPTask)
    assert cfg.model_config["hidden"] == 64          # from config.py
    assert task.param_spec() == [("Dense_0.weight", (64, 16)),
                                 ("Dense_0.bias", (64,)),
                                 ("Dense_1.weight", (3, 64)),
                                 ("Dense_1.bias", (3,))]
    assert task.layout().numel == 16 * 64 + 64 + 64 * 3 + 3 == 1283


def test_yaml_keys_win_over_plugin_defaults():
    raw = _hello_config()
    raw["model_config"].update(hidden=8, num_classes=5)
    cfg = FLUTEConfig.from_dict(raw)
    task = make_task(cfg.model_config)
    assert cfg.model_config["input_dim"] == 16
    assert task.layout().shapes[0] == (8, 16)
    assert task.layout().shapes[2] == (5, 8)


def test_plugin_task_py_is_never_executed():
    code = (
        "import sys, yaml\n"
        "from msrflute_tpu_torch.config import FLUTEConfig\n"
        "from msrflute_tpu_torch.models import make_task\n"
        "raw = yaml.safe_load(open('experiments/hello_mlp/config.yaml'))\n"
        "task = make_task(FLUTEConfig.from_dict(raw).model_config)\n"
        "assert type(task).__name__ == 'HelloMLPTask', type(task)\n"
        "bad = sorted(n for n in sys.modules if any(\n"
        f"    n == f or n.startswith(f + '.') for f in {FORBIDDEN!r}))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]


def test_a_task_py_that_would_fail_is_not_run(tmp_path):
    folder = tmp_path / "hello_mlp"
    folder.mkdir()
    shutil.copy(os.path.join(HELLO, "config.py"), folder / "config.py")
    (folder / "task.py").write_text("raise RuntimeError('executed')\n")
    cfg = FLUTEConfig.from_dict(_hello_config(str(folder)))
    assert isinstance(make_task(cfg.model_config), HelloMLPTask)


def test_task_torch_py_wins_over_the_builtin_twin(tmp_path):
    folder = tmp_path / "hello_mlp"
    folder.mkdir()
    (folder / "config.py").write_text(
        "class HELLOMLPConfig:\n    defaults = {'hidden': 5}\n")
    (folder / "task_torch.py").write_text(
        "from msrflute_tpu_torch.models.cv import make_lr_task\n"
        "def make_task(model_config):\n"
        "    assert model_config.get('hidden') == 5\n"
        "    return make_lr_task(model_config)\n")
    cfg = FLUTEConfig.from_dict(_hello_config(str(folder)))
    task = make_task(cfg.model_config)
    assert task.name == "cv_lr_mnist"
    assert task.layout().shapes[0] == (3, 16)


def test_a_folder_without_a_torch_task_raises(tmp_path):
    folder = tmp_path / "my_plugin"
    folder.mkdir()
    (folder / "task.py").write_text("raise RuntimeError('executed')\n")
    raw = _hello_config(str(folder))
    cfg = FLUTEConfig.from_dict(raw)
    with pytest.raises(NotImplementedError) as err:
        make_task(cfg.model_config)
    msg = str(err.value)
    assert "task_torch.py" in msg and os.path.join(
        "plugins", "my_plugin.py") in msg and "not yet ported" in msg


def test_model_folder_must_be_a_path():
    raw = _hello_config()
    raw["model_config"]["model_folder"] = 3
    with pytest.raises(ValueError, match="model_folder"):
        FLUTEConfig.from_dict(raw)


# ----------------------------------------------------------------------
def _blob(path, users, seed, lo=8, hi=30):
    """16-dim points of 3 classes, separable by a fixed linear map."""
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(99).normal(size=(16, 3))
    names = [f"h{seed}_{i:03d}" for i in range(users)]
    data, labels, counts = {}, {}, []
    for u in names:
        n = int(rng.integers(lo, hi + 1))
        x = rng.normal(size=(n, 16)).astype(np.float32)
        data[u] = {"x": x.tolist()}
        labels[u] = np.argmax(x @ w, axis=1).tolist()
        counts.append(n)
    with open(path, "w") as fh:
        json.dump({"users": names, "num_samples": counts, "user_data": data,
                   "user_data_label": labels}, fh)


def test_hello_mlp_cli_trajectory_matches_jax(tmp_path, monkeypatch):
    data = tmp_path / "data"
    data.mkdir()
    _blob(data / "train.json", 24, 0)
    _blob(data / "val.json", 6, 1)
    raw = _hello_config()

    jcfg = JaxFLUTEConfig.from_dict(raw)
    jcfg.validate(str(data))
    jtask = jax_make_task(jcfg.model_config)
    train, val, _ = jax_build_datasets(jcfg, jtask)
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

    # the port: pallas_apply on (B1's plain version on the CPU), the JAX
    # round engine's optax arm off a TPU
    raw["server_config"]["megakernel"] = {"pallas_apply": True}
    out = tmp_path / "port"
    out.mkdir()
    (out / "cfg.yaml").write_text(yaml.safe_dump(raw))
    monkeypatch.setattr(HelloMLPTask, "init_params",
                        lambda self, seed: from_jax_params(self, init))
    server = e2e_trainer.main(["-config", str(out / "cfg.yaml"), "-dataPath",
                               str(data), "-outputPath", str(out / "run"),
                               "-device", "cpu"])
    got = [(h["round"], h) for h in server.history if h["split"] == "val"]
    assert [r for r, _ in got] == [r for r, _ in want] == [0, 3, 6, 9, 12]
    n_val = sum(val.num_samples)
    for (r, g), (_, w) in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"]), (r, g, w)
        for key in ("acc", "top2_acc"):
            assert abs(g[key] - w[key]) * n_val <= 1.0 + 1e-9, (r, key, g, w)
    assert got[-1][1]["acc"] > 0.5          # above chance (1/3)
    assert server.config.model_config["hidden"] == 64
    with open(out / "run" / "log" / "metrics.jsonl") as fh:
        names = {json.loads(line)["name"] for line in fh}
    assert "Val top2_acc" in names
