"""Graceful preemption in the port (``msrflute_tpu_torch/resilience/
preemption.py``, ``engine/server.py::train``, ``e2e_trainer``), the twin of
``tests/test_preempt_resume.py`` and of ``tests/test_universal_overlap.py::
test_preempt_drain_resume_depth3_with_chaos``:

- the drill ``chaos.preempt_at_round: 3`` stops the run at round 3 at
  depth 0, 1 and 2 and at ``rounds_per_step: 3`` on the serial loop (whose
  lookahead packing has drawn the next chunk's cohort already); a resume
  with the same chaos block trains on to params and server optimizer
  state bitwise those of the uninterrupted run, and so does a second
  ``train()`` on the preempted server;
- the SIGTERM handler: installed by ``train`` on the main thread and
  restored after, a repeat signal restores the previous disposition, and
  off the main thread install degrades to the flag alone;
- the CLI in a subprocess, sent SIGTERM mid-run, exits 75 with a durable
  checkpoint, and the resume replays the uninterrupted run bitwise;
- ``fused_carry`` SCAFFOLD with chaos at depth 2, preempted and resumed,
  bitwise (its carry tables ride the checkpoint), and the personalization
  server's host store, saved when the preempted ``train`` returns;
- the port and the JAX server, preempted on the same config, stop at the
  same round and write ``preempted`` with the same reason.
"""

import copy
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import pytest
import torch
import yaml

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.engine import OptimizationServer as JaxServer
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu_torch.resilience.preemption import PreemptionHandler
from test_torch_chaos import lr_blob  # noqa: F401
from test_torch_fused_carry import (CHAOS, assert_same_state, port_dataset,
                                    port_run, port_server, raw_config)
from test_torch_strategies import lr_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRILL = {"preempt_at_round": 3}


def _raw(depth, rps=1, chaos=None, **over):
    return raw_config("fedavg", depth=depth, fused=False, chaos=chaos,
                      rounds_per_step=rps, **over)


def _same(a, b, what):
    assert_same_state(a.state, b.state, what)
    for k, v in a.state.opt_state.items():
        assert torch.equal(v, b.state.opt_state[k]), (what, k)


_refs = {}


def _ref(rps, tmp_path_factory):
    if rps not in _refs:
        _refs[rps] = port_run(_raw(1, rps),
                              str(tmp_path_factory.mktemp(f"ref{rps}")))
    return _refs[rps]


@pytest.mark.parametrize("depth,rps", [(0, 1), (1, 1), (2, 1), (0, 3)],
                         ids=["serial", "depth1", "depth2",
                              "serial_lookahead"])
def test_drill_then_resume_is_bitwise(depth, rps, tmp_path,
                                      tmp_path_factory):
    ref = _ref(rps, tmp_path_factory)
    run = str(tmp_path / "run")
    pre = port_server(_raw(depth, rps, chaos=DRILL), run)
    pre.train()
    assert pre.preempted and pre.state.round == 3
    with open(os.path.join(run, "status_log.json")) as fh:
        status = json.load(fh)
    assert status["i"] == 3
    assert status["preempted"] == "chaos preempt_at_round=3"
    assert "np_rng_state" in status
    # the relaunch keeps the chaos block: the drill fires only when a run
    # crosses its round from below
    res = port_server(_raw(depth, rps, chaos=DRILL,
                           resume_from_checkpoint=True), run)
    assert res.state.round == 3
    res.train()
    assert not res.preempted and res.state.round == 6
    _same(res, ref, "resumed")
    with open(os.path.join(run, "status_log.json")) as fh:
        assert json.load(fh)["preempted"] is None
    # a second train() on the preempted server clears the latched request
    pre.train()
    assert not pre.preempted and pre.state.round == 6
    _same(pre, ref, "continued in process")


def test_personalization_store_survives_the_drill(tmp_path):
    """The personalization server's host store is saved when a preempted
    ``train`` returns, so the resume (which reloads it) is bitwise too."""
    raw = raw_config("personalization", depth=0, fused=False)
    ref = port_run(raw, str(tmp_path / "ref"))
    run = str(tmp_path / "run")
    pre = port_run(raw_config("personalization", depth=0, fused=False,
                              chaos=DRILL), run)
    assert pre.preempted and pre.state.round == 3
    res = port_run(raw_config("personalization", depth=0, fused=False,
                              chaos=DRILL, resume_from_checkpoint=True), run)
    assert res.state.round == 6 and not res.preempted
    _same(res, ref, "personalization resumed")
    assert sorted(res.store.params) == sorted(ref.store.params)
    for uid, local in ref.store.params.items():
        assert torch.equal(res.store.params[uid], local), uid
        assert res.store.alpha[uid] == ref.store.alpha[uid], uid


def test_fused_carry_scaffold_with_chaos_depth2_preempt_resume(tmp_path):
    ref = port_run(raw_config("scaffold", depth=2, rounds=7, chaos=CHAOS),
                   str(tmp_path / "ref"))
    chaos = dict(CHAOS, preempt_at_round=3)
    run = str(tmp_path / "run")
    pre = port_run(raw_config("scaffold", depth=2, rounds=7, chaos=chaos),
                   run)
    assert pre.preempted and pre.state.round == 3
    assert pre.scaffold_store is None and "ci" in pre.state.strategy_state
    res = port_run(raw_config("scaffold", depth=2, rounds=7, chaos=chaos,
                              resume_from_checkpoint=True), run)
    assert res.state.round == 7 and not res.preempted
    _same(res, ref, "fused scaffold resumed")


def test_train_installs_and_restores_the_handlers(tmp_path):
    before = {s: signal.getsignal(s) for s in PreemptionHandler.SIGNALS}
    server = port_server(_raw(0, rounds=2), str(tmp_path))
    seen = {}
    sample = server._sample

    def spying():
        seen.update({s: signal.getsignal(s)
                     for s in PreemptionHandler.SIGNALS})
        return sample()

    server._sample = spying
    server.train()
    for sig in PreemptionHandler.SIGNALS:
        assert seen[sig] == server.preemption._on_signal
        assert signal.getsignal(sig) is before[sig]
    assert not server.preemption.installed


def test_sigterm_handler_requests_and_restores():
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        handler = PreemptionHandler(escalate_after=2)
        assert handler.install()
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(100):
            if handler.requested:
                break
            time.sleep(0.01)
        assert handler.requested and "SIGTERM" in handler.reason
        assert seen == []
        # the second signal restores the previous disposition, which sees
        # the third
        os.kill(os.getpid(), signal.SIGTERM)
        os.kill(os.getpid(), signal.SIGTERM)
        assert seen == [signal.SIGTERM]
        handler.uninstall()
        handler.reset()
        assert not handler.requested and handler.reason is None
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_install_degrades_off_the_main_thread():
    results = {}
    flushed = []

    def worker():
        handler = PreemptionHandler()
        handler.add_flush_hook(lambda: flushed.append(1))
        results["installed"] = handler.install()
        handler.request("test")
        results["requested"] = handler.requested

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert results == {"installed": False, "requested": True}
    assert flushed == [1]


def _cli_cfg(path, raw):
    with open(path, "w") as fh:
        yaml.safe_dump(raw, fh)
    return str(path)


def test_cli_sigterm_exits_75_and_resumes(lr_blob, tmp_path):
    """A real SIGTERM to a CLI run in a subprocess: the loop drains, the
    checkpoint is durable, the exit code is 75; the relaunch with
    ``resume_from_checkpoint`` matches an uninterrupted run of the same
    length bitwise."""
    raw = lr_config("fedavg", rounds=100000, server={
        "pipeline_depth": 1, "val_freq": 100000, "initial_val": False})
    out = tmp_path / "run"
    cmd = [sys.executable, "-m", "msrflute_tpu_torch.e2e_trainer",
           "-config", _cli_cfg(tmp_path / "cfg.yaml", raw),
           "-dataPath", lr_blob, "-outputPath", str(out), "-device", "cpu"]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    status = out / "models" / "status_log.json"
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                if json.loads(status.read_text())["i"] >= 2:
                    break
            except (OSError, ValueError, KeyError):
                pass
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=120) == os.EX_TEMPFAIL == 75
    finally:
        if proc.poll() is None:
            proc.kill()
    stopped = json.loads(status.read_text())
    assert stopped["preempted"] == "signal SIGTERM"
    n = stopped["i"] + 2
    from msrflute_tpu_torch import e2e_trainer
    resumed_raw = copy.deepcopy(raw)
    resumed_raw["server_config"].update(max_iteration=n,
                                        resume_from_checkpoint=True)
    resumed = e2e_trainer.main([
        "-config", _cli_cfg(tmp_path / "resume.yaml", resumed_raw),
        "-dataPath", lr_blob, "-outputPath", str(out), "-device", "cpu"])
    assert resumed.state.round == n and not resumed.preempted
    ref_raw = copy.deepcopy(raw)
    ref_raw["server_config"]["max_iteration"] = n
    ref = e2e_trainer.main([
        "-config", _cli_cfg(tmp_path / "ref.yaml", ref_raw),
        "-dataPath", lr_blob, "-outputPath", str(tmp_path / "ref"),
        "-device", "cpu"])
    _same(resumed, ref, "CLI resumed after SIGTERM")


def test_cli_drill_exits_75(lr_blob, tmp_path):
    from msrflute_tpu_torch import e2e_trainer
    raw = lr_config("fedavg", rounds=6, server={"chaos": DRILL})
    with pytest.raises(SystemExit) as info:
        e2e_trainer.main(["-config", _cli_cfg(tmp_path / "c.yaml", raw),
                          "-dataPath", lr_blob, "-outputPath",
                          str(tmp_path / "run"), "-device", "cpu"])
    assert info.value.code == 75


def test_port_and_jax_stop_at_the_same_round(tmp_path):
    raw = _raw(1, chaos=DRILL)
    port = port_server(raw, str(tmp_path / "port"))
    port.train()
    cfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    jds = port_dataset()
    from msrflute_tpu.data import ArraysDataset as JaxArrays
    jserver = JaxServer(jax_make_task(cfg.model_config), cfg,
                        JaxArrays(jds.user_list,
                                  [jds.user_arrays(i)
                                   for i in range(len(jds))]),
                        model_dir=str(tmp_path / "jax"),
                        mesh=make_mesh(num_devices=1), seed=7)
    jstate = jserver.train()
    assert port.preempted and jserver.preempted
    assert port.state.round == int(jax.device_get(jstate.round)) == 3
    statuses = []
    for d in ("port", "jax"):
        with open(tmp_path / d / "status_log.json") as fh:
            statuses.append(json.load(fh))
    port_status, jax_status = statuses
    assert port_status["preempted"] == jax_status["preempted"]
    assert port_status["i"] == jax_status["i"] == 3
    assert set(port_status) <= set(jax_status)
