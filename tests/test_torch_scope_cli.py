"""The port's scope reader (``msrflute_tpu_torch/telemetry/scope_cli.py``)
against the JAX package's (``msrflute_tpu/telemetry/scope_cli.py``) on the
same directories — a port run's and the JAX package's recorded fixture —:
``summarize``, the scorecard ``diff``, the ``health`` oracle and the
``watch`` view agree, in process and through ``python -m``.
"""

import copy
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

from msrflute_tpu.telemetry import scope_cli as jax_scope
from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.engine import OptimizationServer
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.tasks import build_task_datasets
from msrflute_tpu_torch.telemetry import scope_cli
from test_torch_strategies import lr_blob, lr_config  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "data", "scope_fixture")


@pytest.fixture(scope="module")
def port_dirs(lr_blob, tmp_path_factory):  # noqa: F811
    """Two port runs with telemetry on (depth 1 and depth 2)."""
    out = []
    for depth in (1, 2):
        raw = lr_config("fedavg", rounds=4, server={
            "pipeline_depth": depth, "val_freq": 2,
            "telemetry": {"enable": True, "rollup_window": 2}})
        cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
        cfg.validate(lr_blob)
        task = make_task(cfg.model_config)
        train, val, _ = build_task_datasets(cfg, task)
        model_dir = str(tmp_path_factory.mktemp(f"scope_d{depth}"))
        OptimizationServer(task, cfg, train, val_dataset=val,
                           model_dir=model_dir, device="cpu").train()
        out.append(model_dir)
    return out


@pytest.mark.parametrize("which", ["port_run", "jax_fixture"])
def test_summarize_equals_the_jax_reader(which, port_dirs):
    run_dir = port_dirs[1] if which == "port_run" else FIXTURE
    got = scope_cli.summarize(run_dir)
    assert got == jax_scope.summarize(run_dir)
    if which == "port_run":
        assert got["overlap"]["max_rounds_in_flight"] >= 2
        assert got["scorecard"]["rounds"] == 4
        assert "xla_compile" in got["events"]


def test_diff_and_health_equal_the_jax_reader(port_dirs):
    a, b = (scope_cli.load_scorecard(d) for d in port_dirs)
    assert a == jax_scope.load_scorecard(port_dirs[0])
    for pct in (None, 1.0):
        assert scope_cli.diff_scorecards(a, b, pct=pct) == \
            jax_scope.diff_scorecards(a, b, pct=pct)
    assert scope_cli.DIFF_RULES == jax_scope.DIFF_RULES
    for d in port_dirs:
        got = scope_cli.health(d)
        assert got == jax_scope.health(d)
        assert got["ok"], got["findings"]


def test_watch_once_prints_the_jax_lines(port_dirs):
    outs = []
    for main in (scope_cli.main, jax_scope.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(["watch", port_dirs[0], "--once"]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].count("\n") >= 2


def test_module_entry_point_prints_the_summary(port_dirs):
    proc = subprocess.run(
        [sys.executable, "-m", "msrflute_tpu_torch.telemetry.scope_cli",
         port_dirs[0]], capture_output=True, text=True, timeout=60,
        cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-500:]
    assert json.loads(proc.stdout) == scope_cli.summarize(port_dirs[0])
    gate = subprocess.run(
        [sys.executable, "-m", "msrflute_tpu_torch.telemetry.scope_cli",
         "health", port_dirs[0], "--gate"], capture_output=True,
        text=True, timeout=60, cwd=REPO)
    assert gate.returncode == 0, gate.stderr[-500:]
    assert scope_cli.main(["/no/such/run"]) == 2
