"""The port's telemetry modules (``msrflute_tpu_torch/telemetry/``) against
the JAX package's (``msrflute_tpu/telemetry/``), module against module:
the same calls, made from a seed with numpy, with the clocks injected,
give equal trace events, records, findings and files:

- the tracer (thread tracks, overlapping begin/end spans, instants,
  counters, the event cap, ``events.jsonl`` rotation);
- the device-metric bus, a round's scalars through publish, drain and the
  scope's decode, and the one-time skip of a non-scalar;
- every watchdog detector and the stall monitor;
- ``parse_profile_rounds``, ``P2Quantile``, the rollup windows and the
  flight recorder;
- the jsonl rotation helpers and ``MetricsLog``'s size cap;
- the device-truth layer's pure parts: ``signature_diff``, ``mfu``, the
  hand kernels' reported counts against ``PERF.md`` §6's formulas (B1
  5 values a parameter, B2 and B3 2 values an element, B4-B6 2 flops a
  multiply-add over the causal pairs), through their plain versions on the
  CPU, and the counted FLOPs of an LR round against the analytic count and
  ``msrflute_tpu/utils/flops.py``'s ``dot`` bucket of the JAX grad step;
- counting never changes a bit of the result.
"""

import json
import os
import threading
import types

import numpy as np
import pytest
import torch

import msrflute_tpu.telemetry as jax_tel
from msrflute_tpu.telemetry import devbus as jax_devbus
from msrflute_tpu.telemetry import metrics as jax_metrics
from msrflute_tpu.telemetry import profiling as jax_profiling
from msrflute_tpu.telemetry import rollup as jax_rollup
from msrflute_tpu.telemetry import spans as jax_spans
from msrflute_tpu.telemetry import watchdog as jax_watchdog
from msrflute_tpu.telemetry import xla as jax_xla
from msrflute_tpu_torch import telemetry as tel
from msrflute_tpu_torch.telemetry import devbus, metrics, profiling, rollup
from msrflute_tpu_torch.telemetry import spans, watchdog, xla
from msrflute_tpu_torch.utils.logging import MetricsLog


class FakeClock:
    """``time``'s clocks, advanced by hand: both packages read the same
    instants."""

    def __init__(self, t0=1000.0):
        self.t = float(t0)

    def tick(self, dt=0.25):
        self.t += dt

    def module(self):
        return types.SimpleNamespace(perf_counter=lambda: self.t,
                                     time=lambda: self.t,
                                     monotonic=lambda: self.t,
                                     sleep=lambda s: None)


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    for mod in (spans, jax_spans, rollup, jax_rollup):
        monkeypatch.setattr(mod, "time", c.module())
    return c


# ----------------------------------------------------------------------
# the tracer
# ----------------------------------------------------------------------
def _drive_tracer(mod, out_dir, clock, cap=None):
    tr = mod.Tracer(out_dir)
    if cap is not None:
        tr.MAX_EVENTS = cap
    tr.max_log_bytes = 600
    with tr.span("pack", rounds=2):
        clock.tick()
    a = tr.begin("round_device", round0=0, rounds=1)
    clock.tick()
    b = tr.begin("round_device", round0=1, rounds=1)
    clock.tick()
    tr.end(a)
    with tr.span("host_tail", round0=0, rounds=1):
        clock.tick()
        tr.instant("chaos_faults", round=0, dropped=1.0)
    tr.counter("devbus/update_ratio", 0.125)

    def writer():
        with tr.span("ckpt_async_write"):
            clock.tick()
    t = threading.Thread(target=writer, name="ckpt-writer-test")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    clock.tick()
    tr.end(b)
    tr.end(b)        # a second end is a no-op
    tr.flush()
    for i in range(3):
        tr.instant("probe", i=i)
    tr.close()
    with open(tr.trace_path) as fh:
        trace = json.load(fh)
    # a thread's track is its OS ident, which a new thread may or may not
    # reuse: tracks are compared by their order of first appearance
    tids = {}
    for ev in trace["traceEvents"]:
        ev["tid"] = tids.setdefault(ev["tid"], len(tids))
    records = []
    for seg in metrics.jsonl_segment_paths(tr.events_path):
        with open(seg) as fh:
            records += [json.loads(line) for line in fh]
    return tr, trace, records, sorted(os.listdir(out_dir))


@pytest.mark.parametrize("cap", [None, 4], ids=["full", "capped"])
def test_tracer_events_equal_the_jax_tracers(cap, tmp_path, clock):
    c0 = clock.t
    got = _drive_tracer(spans, str(tmp_path / "port"), clock, cap)
    clock.t = c0
    want = _drive_tracer(jax_spans, str(tmp_path / "jax"), clock, cap)
    assert got[1] == want[1]                 # trace.json, to the event
    assert got[2] == want[2]                 # events.jsonl, all segments
    assert got[3] == want[3]                 # the segment files
    assert got[0].dropped == want[0].dropped == (0 if cap is None else
                                                 got[0].dropped)
    names = {e["name"] for e in got[1]["traceEvents"] if e["ph"] == "M"}
    assert "thread_name" in names
    tracks = {e["args"]["name"] for e in got[1]["traceEvents"]
              if e["ph"] == "M"}
    assert "ckpt-writer-test" in tracks
    assert {"rounds in flight (slot 0)",
            "rounds in flight (slot 1)"} <= tracks
    if cap is not None:
        assert got[0].dropped > 0


# ----------------------------------------------------------------------
# the device-metric bus
# ----------------------------------------------------------------------
def test_devbus_round_scalars_equal_the_jax_decode(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    values = rng.random((2, 3)).astype(np.float32)   # 2 rounds x 3 names
    names = ["update_ratio", "dp_clip_frac", "dp_clip"]
    want = []
    monkeypatch.setattr(jax_metrics, "log_metric",
                        lambda name, value, step=None, extra=None:
                        want.append((name, value, step)))
    jscope = jax_tel.Telemetry({"trace": False, "rollup": False,
                                "flight": False}, str(tmp_path / "jax"))
    jbus = jax_devbus.DeviceMetricBus(True)
    jstats = {}
    for j in range(2):
        for i, n in enumerate(names):
            jbus.publish(n, values[j, i])
        for k, v in jbus.drain().items():
            jstats.setdefault(k, []).append(v)
    jscope.consume_devbus({k: np.asarray(v) for k, v in jstats.items()},
                          round0=5, rounds=2)
    log = MetricsLog()
    got = []
    log.log = lambda name, value, step=None: got.append((name, value, step))
    scope = tel.Telemetry({"trace": False, "rollup": False,
                           "flight": False}, str(tmp_path / "port"), log)
    bus = devbus.DeviceMetricBus(True)
    per_round = []
    for j in range(2):
        for i, n in enumerate(names):
            bus.publish(n, torch.tensor(values[j, i]))
        per_round.append({k: float(v) for k, v in bus.drain().items()})
    scope.consume_devbus(per_round, round0=5)
    assert got == want
    assert [n for n, _, _ in got].count("devbus/update_ratio") == 2
    # off: every publish is dropped, as the JAX bus drops them
    off = devbus.DeviceMetricBus(False)
    off.publish("x", torch.tensor(1.0))
    assert off.drain() == {} == jax_devbus.DeviceMetricBus(False).drain()


def test_devbus_skips_a_nonscalar_once_with_the_jax_event(tmp_path,
                                                          monkeypatch):
    jevents = []
    monkeypatch.setattr(jax_metrics, "log_event",
                        lambda kind, **f: jevents.append((kind, f)))
    monkeypatch.setattr(jax_metrics, "log_metric",
                        lambda *a, **k: None)
    jscope = jax_tel.Telemetry({"trace": False, "rollup": False,
                                "flight": False}, str(tmp_path / "jax"))
    jscope.consume_devbus({"devbus_vec": np.zeros((2, 4), np.float32)},
                          round0=0, rounds=2)
    log = MetricsLog()
    scope = tel.Telemetry({"trace": False, "rollup": False,
                           "flight": False}, str(tmp_path / "port"), log)
    bus = devbus.DeviceMetricBus(True)
    bus.on_nonscalar = scope.devbus_nonscalar
    for _ in range(2):
        bus.publish("vec", torch.zeros(4))
    assert bus.drain() == {}
    got = [(e["event"], {k: v for k, v in e.items()
                         if k not in ("ts", "event")}) for e in log.events]
    assert got == jevents == [("devbus_nonscalar_skipped",
                               {"metric": "vec", "shape": [4]})]


# ----------------------------------------------------------------------
# the watchdog
# ----------------------------------------------------------------------
#: ``(config, per-round observations)`` of each detector's drill
WATCHDOG_DRILLS = {
    "nan_loss": ({"nan_loss": "mark"},
                 [dict(train_loss=1.0), dict(train_loss=float("nan")),
                  dict(train_loss=float("inf"))]),
    "round_time": ({"nan_loss": "off", "round_time_action": "log",
                    "round_time_window": 4, "round_time_factor": 2.0},
                   [dict(round_secs=s) for s in
                    (1.0, 1.1, 0.9, 1.0, 5.0, 1.0, 9.0)]),
    "ckpt_failures": ({"ckpt_failure_action": "mark",
                       "ckpt_failure_streak": 2},
                      [dict(ckpt_failures=n) for n in (0, 1, 2, 3, 0, 2)]),
    "quarantine_rate": ({"quarantine_rate_action": "log",
                         "quarantine_rate_threshold": 0.3},
                        [dict(quarantine_frac=f) for f in
                         (0.1, 0.5, 0.2, 0.9)]),
    "recompile_storm": ({"recompile_storm_action": "log",
                         "recompile_storm_threshold": 2,
                         "recompile_storm_warmup_rounds": 2},
                        [dict(recompiles=n) for n in
                         (0, 3, 3, 4, 5, 6, 6, 7)]),
    "rss_leak": ({"rss_leak_action": "log", "rss_leak_window": 4,
                  "rss_leak_mb_per_round": 1.0},
                 [dict(host_rss_bytes=int(100e6 + r * 3 * 2 ** 20))
                  for r in range(9)]),
    "throughput_drift": ({"throughput_drift_action": "log",
                          "throughput_drift_window": 4,
                          "throughput_drift_factor": 1.5,
                          "round_time_action": "off"},
                         [dict(round_secs=s) for s in
                          (1.0,) * 4 + (1.0, 2.0, 2.0, 2.0, 2.0, 1.0,
                                        1.0, 1.0, 1.0)]),
}


def _drill(mod, cfg, rounds):
    events, marks = [], []
    wd = mod.Watchdog(cfg, on_event=lambda kind, **f: events.append(
        (kind, f)), on_mark=lambda kind, f: marks.append((kind, f)))
    for r, obs in enumerate(rounds):
        wd.observe_round(r, **obs)
    return wd.findings, events, marks


@pytest.mark.parametrize("detector", sorted(WATCHDOG_DRILLS))
def test_watchdog_findings_equal_the_jax_watchdogs(detector):
    cfg, rounds = WATCHDOG_DRILLS[detector]
    got = _drill(watchdog, cfg, rounds)
    want = _drill(jax_watchdog, cfg, rounds)
    assert got == want
    assert got[0], f"{detector} never fired"


def test_watchdog_abort_and_actions_match_jax():
    for mod in (watchdog, jax_watchdog):
        wd = mod.Watchdog({})
        with pytest.raises(mod.WatchdogAbort, match="nan_loss"):
            wd.observe_round(3, train_loss=float("nan"))
        with pytest.raises(ValueError, match="explode"):
            mod.Watchdog({"nan_loss": "explode"})
    assert watchdog.ACTIONS == jax_watchdog.ACTIONS
    assert watchdog._DEFAULTS == jax_watchdog._DEFAULTS
    assert watchdog.ACTION_KEYS == jax_watchdog.ACTION_KEYS


def test_stall_monitor_persists_the_flight_then_interrupts(monkeypatch):
    """The monitor thread of both packages: ``log`` fires one finding a
    stalled heartbeat; ``abort`` writes the flight record, then interrupts
    the main thread (``watchdog.py:355-397``)."""
    interrupted = []
    import _thread
    monkeypatch.setattr(_thread, "interrupt_main",
                        lambda: interrupted.append(1))
    results = {}
    for name, mod in (("port", watchdog), ("jax", jax_watchdog)):
        order = []
        wd = mod.Watchdog({"stall_action": "abort", "stall_poll_secs": 0.01,
                           "stall_grace_secs": 0.05, "stall_factor": 1.0},
                          on_event=lambda kind, **f: order.append(kind))
        wd.on_flight = lambda reason, _o=order: _o.append("flight")
        assert wd.start_stall_monitor()
        wd.observe_round(0, round_secs=0.01)
        thread = wd._stall_thread
        thread.join(timeout=5)
        assert not thread.is_alive()
        wd.stop_stall_monitor()
        results[name] = (order, [f["kind"] for f in wd.findings])
    assert results["port"] == results["jax"] == (
        ["watchdog_stall", "flight"], ["stall"])
    assert interrupted == [1, 1]
    assert not watchdog.Watchdog({}).start_stall_monitor()


# ----------------------------------------------------------------------
# profile_rounds, P2, rollups, flight
# ----------------------------------------------------------------------
@pytest.mark.parametrize("spec", [None, 5, "2:4", [1, 3], "3", True,
                                  "7:3", [1, 2, 3], -1])
def test_parse_profile_rounds_equals_jax(spec):
    def run(fn):
        try:
            return ("ok", fn(spec))
        except ValueError as exc:
            return ("err", str(exc))
    assert run(profiling.parse_profile_rounds) == \
        run(jax_profiling.parse_profile_rounds)


def test_round_profiler_window_edges(tmp_path):
    prof = profiling.RoundProfiler("1:3", str(tmp_path))
    edges = []
    for r in range(5):
        prof.observe(r)
        edges.append(prof.active)
    assert edges == [False, True, True, False, False]
    assert prof.captured and os.path.exists(prof.path)
    assert prof.path.endswith(os.path.join("xla_profile",
                                           "rounds_r1.pt.trace.json"))
    # one window at a time: a window opened while another is open fails
    # the profile-rounds window and raises for do_profiling's
    outer = profiling.start_window(torch.device("cpu"))
    try:
        second = profiling.RoundProfiler(0, str(tmp_path / "b"))
        second.observe(0)
        assert second.failed and not second.active
        with pytest.raises(RuntimeError, match="only one profile"):
            profiling.start_window(torch.device("cpu"))
    finally:
        profiling.stop_window(outer, torch.device("cpu"),
                              str(tmp_path / "outer.json"))


@pytest.mark.parametrize("p", [0.5, 0.95])
def test_p2_quantile_equals_jax(p):
    data = np.random.default_rng(11).lognormal(size=400)
    got, want = rollup.P2Quantile(p), jax_rollup.P2Quantile(p)
    seen = []
    for i, v in enumerate(data):
        got.observe(v)
        want.observe(v)
        if i in (0, 3, 4, 10, 100, 399):
            seen.append((got.value, want.value))
    assert all(g == w for g, w in seen)
    assert abs(got.value - np.quantile(data, p)) < 0.25 * np.quantile(
        data, p)


def _drive_rollup(mod, out, clock, ladder=None):
    eng = mod.RollupEngine(str(out), window=3, ladder=ladder)
    dropped = []
    eng.on_drop = dropped.append
    rng = np.random.default_rng(5)
    recs = []
    for r in range(8):
        clock.tick(0.5)
        eng.observe_phase("host_tail", float(rng.random()))
        eng.observe_phase("pack", float(rng.random()))
        if r % 3 == 1:
            eng.observe_event("chaos_faults")
        eng.update_gauges({"recompiles": r // 4})
        eng.observe_round(r, float(rng.random()), clients=4.0,
                          mfu=float(rng.random()) if r % 2 else None,
                          rss_bytes=1000 + r)
        recs.append(eng.maybe_flush())
    live = eng.window_record(partial=True)
    eng.close()
    lines = []
    if os.path.exists(eng.path):
        with open(eng.path) as fh:
            lines = [json.loads(line) for line in fh]
    return recs, live, lines, eng.windows_flushed, dropped


def test_rollup_windows_equal_the_jax_engines(tmp_path, clock):
    c0 = clock.t
    got = _drive_rollup(rollup, tmp_path / "port", clock)
    clock.t = c0
    want = _drive_rollup(jax_rollup, tmp_path / "jax", clock)
    assert got == want
    assert [r["round_lo"] for r in got[2]] == [0, 3, 6]
    assert got[2][-1]["partial"]


def test_rollup_writer_drops_through_the_ladder(tmp_path, clock):
    """A writer that fails every attempt drops each window, counted, in
    both packages' engines under their ladders."""
    from msrflute_tpu.resilience import integrity as jax_integrity
    from msrflute_tpu_torch.resilience import integrity

    def boom():
        raise OSError("injected writer fault")

    out = []
    for mod, integ in ((rollup, integrity), (jax_rollup, jax_integrity)):
        pol = integ.RetryPolicy(retries=2, backoff_base_s=0.0,
                                backoff_max_s=0.0, jitter=0.0)
        ladder = integ.DurableIOLadder(policy=pol,
                                       fault_hooks={"writer": boom})
        res = _drive_rollup(mod, tmp_path / mod.__name__, clock,
                            ladder=ladder)
        out.append((res[3], len(res[4]), res[2]))
    assert out[0][:2] == out[1][:2] == (3, 3)
    assert out[0][2] == out[1][2] == []


def test_flight_record_equals_the_jax_recorders(tmp_path, clock,
                                                monkeypatch):
    monkeypatch.setattr(rollup, "host_rss_bytes", lambda: 123)
    monkeypatch.setattr(jax_rollup, "host_rss_bytes", lambda: 123)
    docs = []
    for mod in (rollup, jax_rollup):
        fr = mod.FlightRecorder(str(tmp_path / mod.__name__), max_events=8)
        eng = mod.RollupEngine(str(tmp_path / mod.__name__), window=4)
        fr.rollup = eng
        fr.card_fn = lambda: {"rounds": 3}
        eng.observe_round(0, 0.5, 4.0)
        for i in range(12):
            fr.record_event("probe", {"i": i})
        fr.persist("watchdog_abort", detail="x" * 3000)
        fr.persist("exception: WatchdogAbort")
        with open(fr.path) as fh:
            docs.append(json.load(fh))
    assert docs[0] == docs[1]
    assert len(docs[0]["events"]) == 8 and len(docs[0]["reasons"]) == 2


# ----------------------------------------------------------------------
# rotation
# ----------------------------------------------------------------------
def test_rotation_helpers_equal_jax(tmp_path):
    for mod, name in ((metrics, "port"), (jax_metrics, "jax")):
        path = str(tmp_path / f"{name}.jsonl")
        fh = open(path, "a")
        for seg in range(3):
            fh.write(json.dumps({"seg": seg}) + "\n")
            fh, n = mod.rotate_jsonl(path, fh)
            assert n == seg + 1
        fh.close()
    rel = [[os.path.basename(p) for p in mod.jsonl_segment_paths(
        str(tmp_path / f"{name}.jsonl"))]
        for mod, name in ((metrics, "port"), (jax_metrics, "jax"))]
    assert [p.replace("port", "x") for p in rel[0]] == \
        [p.replace("jax", "x") for p in rel[1]]
    assert len(rel[0]) == 4


def test_metrics_log_rotates_at_its_cap(tmp_path):
    log = MetricsLog(str(tmp_path))
    scope = tel.Telemetry({"max_log_mb": 0.001, "trace": False},
                          str(tmp_path / "m"), log)
    assert log.max_log_bytes == int(0.001 * 2 ** 20)
    for i in range(40):
        log.log("Training loss", float(i), step=i)
    log.flush()
    paths = metrics.jsonl_segment_paths(log.path)
    assert len(paths) == 2
    with open(paths[1]) as fh:
        first = json.loads(fh.readline())
    assert first["event"] == "log_rotated" and first["segment"] == 1
    lines = sum(1 for p in paths for _ in open(p))
    assert lines == 41
    # a scope without the knob gives the unbounded default back
    tel.Telemetry({"trace": False}, str(tmp_path / "n"), log)
    assert log.max_log_bytes == 0
    scope.close()
    log.close()


# ----------------------------------------------------------------------
# the device-truth layer
# ----------------------------------------------------------------------
def test_signature_diff_and_mfu_equal_jax():
    old = {"[0]": [[4, 8], "float32", False], "[1]": [[4], "int32", False]}
    new = {"[0]": [[8, 8], "float32", False], "[2]": [[], "int", False]}
    assert xla.signature_diff(old, new) == jax_xla.signature_diff(old, new)
    for args in ((1e12, 0.5, 67e12), (0.0, 1.0, 1e11), (1e9, 0.0, 1e11),
                 (3.2e10, 0.07, 1e11), (1e9, 1.0, None)):
        want = (jax_xla.mfu(*args) if args[2] is not None else None)
        assert xla.mfu(*args) == want
    sig_a, desc = xla.operand_signature(
        {"x": torch.zeros(4, 8), "n": 3, "y": [np.zeros(2, np.int32)]})
    assert desc == {"['n']": [[], "int", False],
                    "['x']": [[4, 8], "float32", False],
                    "['y'][0]": [[2], "int32", False]}
    sig_b, _ = xla.operand_signature({"x": torch.zeros(4, 9), "n": 3,
                                      "y": [np.zeros(2, np.int32)]})
    assert sig_a != sig_b


def test_card_table_gives_no_peak_for_an_unknown_card(monkeypatch):
    from msrflute_tpu_torch import device
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA Made-Up GPU")
    cuda = torch.device("cuda")
    assert device.chip_peak_flops(cuda) == ("NVIDIA Made-Up GPU", None)
    assert device.chip_bytes_per_sec(cuda)[1] is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert device.chip_peak_flops(cuda, "bfloat16")[1] == 989e12
    assert device.chip_peak_flops(cuda)[1] == 67e12
    from msrflute_tpu.utils import compat
    assert device.chip_peak_flops(torch.device("cpu")) == \
        ("cpu", compat.CPU_NOMINAL_PEAK_FLOPS)
    assert xla.mfu(1e9, 1.0, device.chip_peak_flops(cuda.__class__(
        "cuda"))[1]) == 1e9 / 67e12


def _brute_pairs(B, Lq, Lk, H, causal, q_off, k_off):
    """``chip_smoke.py::_visible_pairs``, row by row."""
    if not causal:
        return B * H * Lq * Lk
    q_pos = q_off + torch.arange(Lq)
    return B * H * int(torch.clamp(q_pos - k_off + 1, min=0,
                                   max=Lk).sum())


@pytest.mark.parametrize("shape", [
    (2, 17, 17, 2, True, 0, 0), (1, 9, 30, 1, True, 20, 0),
    (2, 12, 5, 1, True, 0, 3), (1, 6, 6, 3, False, 0, 0),
    (40, 1023, 1023, 4, True, 0, 0)])
def test_visible_pairs_closed_form(shape):
    assert xla.visible_pairs(*shape) == _brute_pairs(*shape)


def _counted(fn):
    mode = xla.CostMode()
    with mode:
        out = fn()
    return mode, out


def test_hand_kernel_counts_are_the_perf_formulas():
    """Each wrapper, through its plain version on the CPU, reports the
    bound's counts of ``PERF.md`` §6 and none of its plain ops."""
    from msrflute_tpu_torch.ops import (flash_dkv, flash_dq, flash_fwd,
                                        fused_gaussian_noise,
                                        fused_sgd_apply, quant_bin_sparsify)
    gen = torch.Generator().manual_seed(0)
    K, P = 3, 1000
    p, g, m = (torch.randn(K, P, generator=gen) for _ in range(3))
    gate = torch.ones(K)
    mode, _ = _counted(lambda: fused_sgd_apply(p, g, m, 0.1, 0.9, gate))
    assert (mode.flops, mode.bytes_accessed) == (0.0, 20.0 * K * P)
    assert mode.kernels == {"fused_sgd_apply": 1}
    half = [p.to(torch.bfloat16) for _ in range(3)]
    mode, _ = _counted(lambda: fused_sgd_apply(*half, 0.1, 0.9, gate))
    assert mode.bytes_accessed == 10.0 * K * P
    x = torch.randn(P, generator=gen)
    mode, _ = _counted(lambda: fused_gaussian_noise(x, 1.0, 0.5, 7))
    assert (mode.flops, mode.bytes_accessed) == (0.0, 8.0 * P)
    offs = torch.tensor([0, 400, P], dtype=torch.int64)
    lo, hi = torch.zeros(K, 2), torch.ones(K, 2)
    th = torch.full((K, 2), 0.3)
    mode, _ = _counted(lambda: quant_bin_sparsify(p, offs, lo, hi, th, 16))
    assert (mode.flops, mode.bytes_accessed) == (0.0, 8.0 * K * P)
    B, L, H, D = 2, 33, 2, 8
    q, k, v, go = (torch.randn(B, L, H, D, generator=gen) for _ in range(4))
    pairs = _brute_pairs(B, L, L, H, True, 0, 0)
    qb = kb = 4 * B * L * H * D
    sb = 4 * B * H * L
    mode, (out, lse) = _counted(lambda: flash_fwd(q, k, v, True))
    assert (mode.flops, mode.bytes_accessed) == (
        2 * 2 * D * pairs, qb + 2 * kb + qb + sb)
    g_lse = torch.randn(B, H, L, generator=gen)
    delta = (out * go).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, go, lse, delta, g_lse, True)
    mode, _ = _counted(lambda: flash_dq(*args))
    assert (mode.flops, mode.bytes_accessed) == (
        3 * 2 * D * pairs, 2 * qb + 2 * kb + 3 * sb + qb)
    mode, _ = _counted(lambda: flash_dkv(*args))
    assert (mode.flops, mode.bytes_accessed) == (
        4 * 2 * D * pairs, 2 * qb + 2 * kb + 3 * sb + 2 * kb)
    assert mode.kernels == {"flash_dkv_launch": 1}


@pytest.fixture(scope="module")
def lr_round():
    """One LR round of the port's engine (K clients, S steps of B), its
    inputs and its JAX twin's grad-step dot FLOPs."""
    import copy
    from test_torch_strategies import lr_config
    from msrflute_tpu_torch.config import FLUTEConfig
    from msrflute_tpu_torch.data.batching import pack_round_batches
    from msrflute_tpu_torch.engine.round import RoundEngine
    from msrflute_tpu_torch.models import make_task
    from msrflute_tpu_torch.strategies import select_strategy
    from conftest import make_synthetic_classification
    raw = lr_config("fedavg")
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    task = make_task(cfg.model_config)
    engine = RoundEngine(task, cfg, select_strategy("fedavg")(cfg),
                         torch.device("cpu"))
    ds = make_synthetic_classification()
    batch = pack_round_batches(ds, [0, 1, 2, 3], 4, 5,
                               rng=np.random.default_rng(0))
    return cfg, task, engine, batch


def _jax_dot_flops(cfg, B):
    import jax
    import jax.numpy as jnp
    from msrflute_tpu.models import make_task as jax_make_task
    from msrflute_tpu.utils.flops import flops_by_op
    task = jax_make_task(cfg.model_config)
    params = task.init_params(jax.random.PRNGKey(0))
    batch = {"x": jnp.zeros((B, 8), jnp.float32),
             "y": jnp.zeros((B,), jnp.int32),
             "sample_mask": jnp.ones((B,), jnp.float32)}
    return flops_by_op(
        lambda p: jax.grad(lambda pp: task.loss(pp, batch, None,
                                                train=False)[0])(p),
        params)["dot"]


def test_lr_round_flops_are_analytic_and_the_jax_dot_bucket(lr_round):
    cfg, task, engine, batch = lr_round
    state = engine.init_state(task.init_params(0))
    mode, _ = _counted(lambda: engine.run_round(state, batch, 0.1, 1.0))
    K, S, B = batch.sample_mask.shape
    P = engine.layout.numel
    # per sample: the forward x @ W and the weight gradient x^T @ dlogits,
    # 2 x 8 x 4 flops each; then the aggregate w @ pg, 2 K P
    analytic = K * S * B * 2 * (2 * 8 * 4) + 2 * K * P
    assert mode.flops == analytic
    assert mode.flops == K * S * _jax_dot_flops(cfg, B) + 2 * K * P
    assert mode.bytes_accessed > 0


def test_counting_changes_no_bit_of_the_round(lr_round):
    cfg, task, engine, batch = lr_round
    init = task.init_params(0)
    plain, plain_stats = engine.run_round(engine.init_state(init), batch,
                                          0.1, 1.0)
    mode, (counted, stats) = _counted(lambda: engine.run_round(
        engine.init_state(init), batch, 0.1, 1.0))
    assert torch.equal(plain.params, counted.params)
    assert plain_stats == stats
    assert mode.flops > 0


def test_vmapped_cnn_step_counts_k_times_one_clients():
    """Under ``vmap(grad)`` each convolution becomes a grouped one;
    ``torch.utils.flop_counter``'s weight-gradient formula counts every
    group against every other (K times too many), which the cost mode
    corrects: K clients' step counts K times one client's."""
    from msrflute_tpu_torch.config import ModelConfig
    from msrflute_tpu_torch.models import make_task
    task = make_task(ModelConfig.from_dict({
        "model_type": "CNN", "num_classes": 62, "image_size": 28}))
    layout = task.layout()
    flat = layout.flatten(task.init_params(0))
    gen = torch.Generator().manual_seed(1)
    batch = {"x": torch.randn(4, 28, 28, 1, generator=gen),
             "y": torch.zeros(4, dtype=torch.int64),
             "sample_mask": torch.ones(4)}

    def loss(p):
        return task.loss(layout.views(p), batch, train=False)[0]

    K = 3
    one, _ = _counted(lambda: torch.func.grad(loss)(flat))
    many, _ = _counted(lambda: torch.func.vmap(torch.func.grad(loss))(
        flat.expand(K, -1).contiguous()))
    assert many.flops == K * one.flops > 0
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as plain:
        torch.func.grad(loss)(flat)
    assert one.flops == plain.get_total_flops()


def test_stopwatch_and_scalar_time_on_the_host_clock():
    from msrflute_tpu_torch.telemetry.timing import Stopwatch, scalar_time
    with Stopwatch() as sw:
        sum(range(10_000))
    assert sw.secs > 0
    calls = []
    secs = scalar_time(lambda: (calls.append(1), torch.tensor(2.0))[1],
                       iters=5)
    assert secs > 0 and len(calls) == 6     # one untimed call, then 5
