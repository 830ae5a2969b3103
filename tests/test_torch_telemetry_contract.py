"""The zero-cost contract of the port's telemetry, the twin of
``tests/test_telemetry_contract.py``:

- telemetry off (no block, or ``enable: false``) builds no scope, no
  tracer, no device-truth registry and an off bus, and writes no
  ``telemetry/`` directory;
- telemetry on leaves the params bitwise those of telemetry off, through
  the ring and under cohort bucketing, with strict transfers on too;
- one packed readback a round, either way (a chunk of one round each);
- ``profile_rounds`` writes its window's trace, ``do_profiling`` beside it
  its chunk's, and a window opened inside another raises for
  ``do_profiling``, as ``jax.profiler`` refuses a second trace;
- ``megabatch.autotune`` under ``telemetry.xla`` prices both arms of each
  tape geometry once and keeps one.
"""

import copy
import os

import pytest
import torch

from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.engine import OptimizationServer
from msrflute_tpu_torch.engine import round as round_mod
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.tasks import build_task_datasets
from msrflute_tpu_torch.telemetry import spans
from msrflute_tpu_torch.utils import strict
from test_torch_strategies import lr_blob, lr_config  # noqa: F401

ROUNDS = 4
BLOCK = {"enable": True, "rollup_window": 2,
         "watchdog": {"round_time_action": "log"}}


def _run(raw, data_dir, model_dir):
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    cfg.validate(data_dir)
    task = make_task(cfg.model_config)
    train, val, _ = build_task_datasets(cfg, task)
    server = OptimizationServer(task, cfg, train, val_dataset=val,
                                model_dir=str(model_dir), device="cpu")
    server.train()
    return server


def _raw(telemetry=None, bucketed=False, **server):
    over = {"pipeline_depth": 2, "val_freq": 2, **server}
    if telemetry is not None:
        over["telemetry"] = copy.deepcopy(telemetry)
    if bucketed:
        over["cohort_bucketing"] = {"enable": True, "max_buckets": 2}
    return lr_config("fedavg", rounds=ROUNDS, server=over)


@pytest.mark.parametrize("block", [None, {"enable": False, "xla": True}],
                         ids=["absent", "disabled"])
def test_telemetry_off_builds_nothing(block, lr_blob, tmp_path,  # noqa
                                      monkeypatch):
    built = []
    init = spans.Tracer.__init__
    monkeypatch.setattr(spans.Tracer, "__init__",
                        lambda self, *a, **k: (built.append(1),
                                               init(self, *a, **k))[1])
    server = _run(_raw(block), lr_blob, tmp_path)
    assert server.scope is None
    assert server.engine.xla is None and server._chip is None
    assert not server.engine.devbus.enabled
    assert server.strategy.devbus is server.engine.devbus
    assert built == []
    assert not os.path.exists(tmp_path / "telemetry")
    assert server.run_stats["mfuPerRound"] == []
    # the always-on sentinel counter still runs
    assert server.engine.compile_log


@pytest.fixture(scope="module")
def off_params(lr_blob, tmp_path_factory):  # noqa: F811
    cache = {}

    def get(bucketed):
        if bucketed not in cache:
            cache[bucketed] = _run(
                _raw(bucketed=bucketed), lr_blob,
                tmp_path_factory.mktemp("off")).state.params.clone()
        return cache[bucketed]
    return get


@pytest.mark.parametrize("bucketed", [False, True],
                         ids=["monolithic", "bucketed"])
def test_telemetry_on_is_bitwise_telemetry_off(bucketed, lr_blob,  # noqa
                                               tmp_path, off_params):
    server = _run(_raw(BLOCK, bucketed=bucketed), lr_blob, tmp_path)
    assert server.scope is not None and server.engine.xla is not None
    assert torch.equal(server.state.params, off_params(bucketed))
    assert (tmp_path / "telemetry" / "scorecard.json").exists()


def test_strict_transfers_run_is_bitwise(lr_blob, tmp_path,  # noqa: F811
                                         monkeypatch, off_params):
    monkeypatch.setenv(strict.ENV_FLAG, "1")
    assert strict.strict_transfers_enabled()
    with strict.strict_transfer_scope(torch.device("cpu")):
        pass                              # no card: nothing to guard
    with strict.allow_sync():
        pass
    server = _run(_raw(BLOCK), lr_blob, tmp_path)
    assert torch.equal(server.state.params, off_params(False))


@pytest.mark.parametrize("block", [None, BLOCK], ids=["off", "on"])
def test_one_packed_readback_a_round(block, lr_blob, tmp_path,  # noqa
                                     monkeypatch):
    fetches = []
    fetch = round_mod.PackedStats.fetch
    monkeypatch.setattr(round_mod.PackedStats, "fetch",
                        lambda self: (fetches.append(self.rounds),
                                      fetch(self))[1])
    server = _run(_raw(block), lr_blob, tmp_path)
    assert fetches == [1] * ROUNDS
    assert server.state.round == ROUNDS


def test_profile_rounds_and_do_profiling(lr_blob, tmp_path):  # noqa: F811
    # disjoint windows: do_profiling's chunk (the second) and rounds 2-3
    raw = _raw(dict(BLOCK, profile_rounds="2:3"), do_profiling=True)
    server = _run(raw, lr_blob, tmp_path / "a")
    assert server.scope.profiler.captured
    assert os.path.exists(tmp_path / "a" / "telemetry" / "xla_profile" /
                          "rounds_r2.pt.trace.json")
    assert os.path.exists(tmp_path / "a" / "profile" /
                          "chunk_r1.pt.trace.json")
    # the same chunk: the window opens first, do_profiling's start raises
    raw = _raw(dict(BLOCK, profile_rounds=1), do_profiling=True)
    with pytest.raises(RuntimeError, match="only one profile"):
        _run(raw, lr_blob, tmp_path / "b")
    assert os.path.exists(tmp_path / "b" / "telemetry" / "flight.json")
    assert not torch._C._autograd._profiler_enabled()


@pytest.mark.parametrize("autotune", [True, False], ids=["on", "off"])
def test_megabatch_autotune_prices_both_arms(autotune, tmp_path):
    """``megabatch.autotune`` under ``telemetry.xla``
    (``round.py:2855-2896``): each tape geometry's first dispatch runs the
    vmap arm and the lane scan, counted, and keeps one (a kept vmap arm
    is one ``megabatch_fallback`` record with ``reason: "aot_cost"``);
    the arm not kept trains nothing the run sees.  Off, the tape the
    analytic gate attached runs, as without telemetry."""
    from test_torch_cohort_bucketing import BUCKETS, port_run, raw_cfg
    mega = {"enable": True, "autotune": autotune}
    raw = raw_cfg(BUCKETS, mega=mega, rounds=3)
    plain = port_run(copy.deepcopy(raw), tmp_path / "plain")
    raw["server_config"]["telemetry"] = {"enable": True, "trace": False}
    server = port_run(raw, tmp_path / "tel")
    engine = server.engine
    tuned = engine._autotuned
    assert engine.local_steps == plain.engine.local_steps
    fallbacks = [e for e in server.metrics.events
                 if e["event"] == "megabatch_fallback"
                 and e.get("reason") == "aot_cost"]
    if not autotune:
        assert tuned == {} and not fallbacks
        assert torch.equal(server.state.params, plain.state.params)
        return
    assert tuned
    for (K, S), arm in tuned.items():
        assert {f"bucket_collect_s{S}", f"megabatch_collect_s{S}"} <= \
            set(engine.xla.entries)
        assert engine.mega_gate[(K, S)] == arm
    assert len(fallbacks) == sum(a == "vmap" for a in tuned.values())
    if all(a == "mega" for a in tuned.values()):
        assert torch.equal(server.state.params, plain.state.params)
