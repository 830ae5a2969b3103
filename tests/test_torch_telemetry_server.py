"""The port's server with ``server_config.telemetry`` on, against the JAX
server on the same config, blob and initial weights
(``models/convert.py::from_jax_params``): LR on one generated blob whose
users need 1 to 6 local steps, 2 a round (so the step bucket, and with it
the monolithic round's operand signature, changes between chunks), through
the depth-2 ring, monolithic and under cohort bucketing:

- the span names of ``trace.json``, the event kinds of ``events.jsonl``,
  the rollup records' rounds and clients, ``devbus/update_ratio`` of each
  round within 1e-6 relative;
- the signature sentinel's compiles and recompiles at each entry point,
  and on the bucketed run ``bucket_grid_variants`` (both packages pack
  its grids draw for draw);
- the scorecard's key set;
- ``nan_loss: abort``: both raise ``WatchdogAbort`` at the same round and
  leave ``flight.json``, ``trace.json`` and the scorecard;
- ``chaos.infra.writer_error_rate``: the rollup writer's fault counts and
  dropped windows equal the JAX server's on the paged SCAFFOLD run.
"""

import copy
import json
import os

import jax
import pytest

from conftest import make_synthetic_classification
from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.engine import OptimizationServer as JaxServer
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu.tasks import build_task_datasets as jax_build_datasets
from msrflute_tpu.telemetry.watchdog import WatchdogAbort as JaxAbort
from msrflute_tpu_torch.telemetry import WatchdogAbort
from test_torch_default_parity import port_run
from test_torch_infra_faults import _raw as infra_raw
from test_torch_fused_carry import port_server
from test_torch_strategies import lr_config, write_lr_blob

#: the full block, but ``profile_rounds`` (a ``jax.profiler`` capture in
#: the JAX package; ``tests/test_torch_telemetry.py`` holds the port's
#: window) and the stall monitor (a thread on a wall clock)
BLOCK = {"enable": True, "trace": True, "devbus": True, "xla": True,
         "scorecard": True, "rollup": True, "rollup_window": 2,
         "flight": True, "flight_events": 64,
         "watchdog": {"nan_loss": "abort", "round_time_action": "log"}}

LAYOUTS = {
    "monolithic": {},
    "bucketed": {"cohort_bucketing": {"enable": True, "max_buckets": 3}},
}

#: scorecard keys the two packages do not share, each with its reason
#: (none: every key of the JAX card is the port's, and no other)
SCORECARD_KEYS_NOT_HELD = {}


def raw_config(layout, rounds=5, block=BLOCK, **server):
    return lr_config("fedavg", rounds=rounds, server={
        "num_clients_per_iteration": 2, "pipeline_depth": 2, "val_freq": 5, "telemetry": copy.deepcopy(block),
        **LAYOUTS[layout], **server})


@pytest.fixture(scope="module")
def blob(tmp_path_factory):
    d = tmp_path_factory.mktemp("tel_blob")
    write_lr_blob(d / "train.json", 24, 2, 24, seed=4)
    write_lr_blob(d / "val.json", 3, 6, 24, seed=1)
    return str(d)


def jax_server(raw, data_dir, model_dir):
    cfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    cfg.validate(data_dir)
    task = jax_make_task(cfg.model_config)
    train, val, _ = jax_build_datasets(cfg, task)
    return JaxServer(task, cfg, train, val_dataset=val, model_dir=model_dir,
                     mesh=make_mesh(num_devices=1), seed=0)


def read_run(model_dir):
    tdir = os.path.join(model_dir, "telemetry")
    with open(os.path.join(tdir, "trace.json")) as fh:
        trace = json.load(fh)["traceEvents"]
    with open(os.path.join(tdir, "events.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    with open(os.path.join(tdir, "rollups.jsonl")) as fh:
        rollups = [json.loads(line) for line in fh]
    with open(os.path.join(tdir, "scorecard.json")) as fh:
        card = json.load(fh)
    return {"spans": sorted({e["name"] for e in trace if e["ph"] == "X"}),
            "kinds": sorted({r["name"] for r in records
                             if r["kind"] == "event"}),
            "rollups": [(r["round_lo"], r["round_hi"], r["rounds"],
                         r["clients"]) for r in rollups],
            "ratios": [r["value"] for r in records if r["kind"] == "counter"
                       and r["name"] == "devbus/update_ratio"],
            "card": card}


_RUNS = {}


@pytest.fixture(scope="module")
def runs(blob, tmp_path_factory):
    """``{layout: (jax run, port run, port server)}``, each run once."""
    def get(layout):
        if layout not in _RUNS:
            raw = raw_config(layout)
            jdir = str(tmp_path_factory.mktemp(f"jax_{layout}"))
            js = jax_server(raw, blob, jdir)
            init = jax.device_get(js.state.params)
            js.train()
            out = tmp_path_factory.mktemp(f"port_{layout}")
            server = port_run(raw, blob, out, init)
            _RUNS[layout] = (read_run(jdir),
                             read_run(str(out / "models")), server, js)
        return _RUNS[layout]
    return get


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_spans_events_and_rollups_equal_the_jax_servers(layout, runs):
    want, got, _, _ = runs(layout)
    assert got["spans"] == want["spans"]
    assert {"pack", "dispatch", "round_device", "stats_fetch", "host_tail",
            "housekeeping", "ckpt_submit", "eval", "eval_device",
            "ckpt_async_write"} <= set(got["spans"])
    assert got["kinds"] == want["kinds"]
    assert "xla_compile" in got["kinds"]
    assert got["rollups"] == want["rollups"]
    assert [r[:2] for r in got["rollups"]] == [(0, 1), (2, 3), (4, 4)]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_update_ratio_each_round_within_1e6(layout, runs):
    want, got, _, _ = runs(layout)
    assert len(got["ratios"]) == len(want["ratios"]) == 5
    for g, w in zip(got["ratios"], want["ratios"]):
        assert abs(g - w) <= 1e-6 * abs(w), (g, w)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_sentinel_counts_and_grid_variants_equal_jax(layout, runs):
    want, got, server, js = runs(layout)
    wcard, gcard = want["card"], got["card"]
    counts = {name: (e["compiles"]) for name, e in
              gcard["entry_points"].items()}
    assert counts == {name: e["compiles"] for name, e in
                      wcard["entry_points"].items()}
    assert (gcard["compiles"], gcard["recompiles"]) == \
        (wcard["compiles"], wcard["recompiles"])
    assert gcard["recompiles"] == server.engine.recompile_count
    xla = server.engine.xla
    assert (xla.compiles, xla.recompiles) == (js.engine.xla.compiles,
                                              js.engine.xla.recompiles)
    if layout == "bucketed":
        assert gcard["cohort_bucketing"] == wcard["cohort_bucketing"]
        assert gcard["cohort_bucketing"]["bucket_grid_variants"] > 1
    else:
        # the step bucket changed between chunks: a recompile with its diff
        assert gcard["recompiles"] > 0
        assert any(n.startswith("staged_r") for n in counts)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_scorecard_keys_equal_the_jax_scorecard(layout, runs):
    want, got, server, _ = runs(layout)
    assert set(got["card"]) ^ set(want["card"]) == \
        set(SCORECARD_KEYS_NOT_HELD)
    card = got["card"]
    assert card["rounds"] == 5 and card["max_rounds_in_flight"] >= 2
    # the CPU's nominal peak: an MFU of about 1e-6, which the card's
    # 6-decimal rounding may show as 0.0
    assert card["mfu_p50"] is not None
    assert card["chip"]["kind"] == "cpu"
    assert card["hbm_peak_bytes"] is None          # no card here
    mfu = server.run_stats["mfuPerRound"]
    assert len(mfu) == 5 and all(0 < m < 1 for m in mfu)


def _abort_raw():
    # every client's payload NaN from round 0: the params are NaN after
    # it, and round 1's training loss is the first NaN
    return raw_config("monolithic", rounds=4, chaos={
        "seed": 1, "corrupt_nan_rate": 1.0})


def test_nan_loss_abort_at_the_jax_round_leaves_the_files(blob, tmp_path):
    raw = _abort_raw()
    js = jax_server(raw, blob, str(tmp_path / "jax"))
    init = jax.device_get(js.state.params)
    with pytest.raises(JaxAbort) as want:
        js.train()
    with pytest.raises(WatchdogAbort) as got:
        port_run(raw, blob, tmp_path / "port", init)
    pdir = tmp_path / "port" / "models" / "telemetry"
    jdir = tmp_path / "jax" / "telemetry"
    for name in ("flight.json", "trace.json", "scorecard.json"):
        assert (pdir / name).exists() and (jdir / name).exists(), name
    wf = json.loads((jdir / "flight.json").read_text())
    gf = json.loads((pdir / "flight.json").read_text())
    assert [r["reason"] for r in gf["reasons"]] == \
        [r["reason"] for r in wf["reasons"]] == ["exception: WatchdogAbort"]

    def abort_round(flight):
        return [e["round"] for e in flight["events"]
                if e["kind"] == "watchdog_nan_loss"]
    assert abort_round(gf) == abort_round(wf) == [1]
    assert "round': 1" in str(got.value) and "round': 1" in str(want.value)
    card = json.loads((pdir / "scorecard.json").read_text())
    assert card["watchdog_fires"] == {"nan_loss": 1}


def _writer_raw():
    raw = infra_raw(chaos={"seed": 3, "infra": {"writer_error_rate": 0.5}},
                    rounds=4)
    raw["server_config"]["telemetry"] = {"enable": True, "trace": False,
                                         "rollup_window": 1}
    return raw


def test_rollup_writer_faults_equal_the_jax_servers(tmp_path):
    raw = _writer_raw()
    cfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    js = JaxServer(jax_make_task(cfg.model_config), cfg,
                   make_synthetic_classification(),
                   model_dir=str(tmp_path / "jax"),
                   mesh=make_mesh(num_devices=1), seed=7)
    js.train()
    server = port_server(raw, str(tmp_path / "port"))
    server.train()
    got, want = server.chaos.infra.counters, js.chaos.infra.counters
    assert got["writer_faults"] == want["writer_faults"] > 0
    assert got == dict(want)
    rollup, jrollup = server.scope.rollup, js.scope.rollup
    assert (rollup.windows_flushed, rollup.windows_dropped) == \
        (jrollup.windows_flushed, jrollup.windows_dropped)
    dropped = [e for e in server.metrics.events
               if e["event"] == "rollup_windows_dropped"]
    assert len(dropped) == rollup.windows_dropped
    card = json.loads((tmp_path / "port" / "telemetry" /
                       "scorecard.json").read_text())
    assert card["infra_faults"]["writer_faults"] == got["writer_faults"]
    assert card["rollup_windows_dropped"] == rollup.windows_dropped
