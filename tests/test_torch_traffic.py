"""The arrival plane (``server_config.traffic``) in the port
(``msrflute_tpu_torch/traffic/``, ``engine/server.py``, ``engine/round.py``,
``strategies/fedbuff.py``) against the JAX package:

- each trace's ``probs`` and ``duration_scale``, and each schedule's fires
  (cohort, staleness, tick, wait ticks), counters and histogram in both
  modes over all four traces, bitwise the JAX package's (both are numpy);
  ``fast_forward`` replays the same prefix; the constructors' refusals;
- the server's refusals raise the JAX server's exception types;
- an LR FedBuff run under buffered traffic against the JAX server: val
  losses within the port's LR tolerance, and the cohorts, the staleness
  histogram of every round, the ``buffer_fired`` records and
  ``rounds_to_target_accuracy`` equal; ``sync`` mode has no staleness;
- the same run at depth 0, at depth 2 with two rounds a chunk, and cut by
  the preemption drill and resumed: params and fires bitwise;
- a bucketed run and a pooled one against the JAX server's.
"""

import copy

import numpy as np
import pytest
import torch

from msrflute_tpu import traffic as jax_traffic
from msrflute_tpu_torch import traffic
from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.engine import OptimizationServer
from msrflute_tpu_torch.models import make_task
from test_torch_default_parity import jax_events, normalized, port_run  # noqa
from test_torch_strategies import jax_history, lr_blob, lr_config  # noqa

TRACES = {
    "poisson": {"rate": 3.0},
    "diurnal": {"rate": 4.0, "period": 16, "depth": 1.0},
    "bursty": {"rate": 1.0, "burst_rate": 12.0, "burst_every": 10,
               "burst_len": 3},
    "device_classes": {"period": 8, "classes": [
        {"fraction": 0.5, "rate": 4.0, "window": 1.0},
        {"fraction": 0.3, "rate": 3.0, "window": 0.5, "phase": 0.5,
         "duration_scale": 2.0},
        {"fraction": 0.2, "rate": 2.0, "window": 0.25,
         "duration_scale": 3.0}]},
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_trace_probs_match_jax(name):
    raw = {"trace": name, **TRACES[name]}
    got, want = traffic.make_trace(raw, 50), jax_traffic.make_trace(raw, 50)
    assert got.describe() == want.describe()
    for tick in range(40):
        assert np.array_equal(got.probs(tick), want.probs(tick))
    assert np.array_equal(got.duration_scale(), want.duration_scale())


def _fires(mod, name, mode, n=12):
    raw = {"trace": name, "mode": mode, "seed": 5, "buffer_size": 4,
           "duration_hi": 5, **TRACES[name]}
    sched = mod.make_traffic({"traffic": raw,
                              "num_clients_per_iteration": 4}, 40)
    fires = [sched.fire(r) for r in range(n)]
    return sched, [(f["round"], f["tick"], f["wait_ticks"],
                    f["cohort"].tolist(), f["staleness"].tolist())
                   for f in fires]


@pytest.mark.parametrize("mode", ["buffered", "sync"])
@pytest.mark.parametrize("name", sorted(TRACES))
def test_schedule_fires_match_jax(name, mode):
    got_s, got = _fires(traffic, name, mode)
    want_s, want = _fires(jax_traffic, name, mode)
    assert got == want
    assert got_s.counters == want_s.counters
    assert np.array_equal(got_s.stale_hist, want_s.stale_hist)
    assert got_s.describe() == want_s.describe()
    stale = [s for f in got for s in f[4]]
    if mode == "sync":
        assert not any(stale)
    for f in got:
        assert len(set(f[3])) == len(f[3]) == 4


def test_fast_forward_replays_the_same_prefix():
    _, want = _fires(traffic, "bursty", "buffered")
    sched = traffic.make_traffic({"traffic": {
        "trace": "bursty", "mode": "buffered", "seed": 5, "buffer_size": 4,
        "duration_hi": 5, **TRACES["bursty"]},
        "num_clients_per_iteration": 4}, 40)
    sched.fast_forward(7)
    jsched = jax_traffic.make_traffic({"traffic": {
        "trace": "bursty", "mode": "buffered", "seed": 5, "buffer_size": 4,
        "duration_hi": 5, **TRACES["bursty"]},
        "num_clients_per_iteration": 4}, 40)
    jsched.fast_forward(7)
    assert sched._tick == jsched._tick
    assert len(sched._fires) == len(jsched._fires) >= 7
    got = [sched.fire(r) for r in range(12)]
    assert [(f["tick"], f["cohort"].tolist()) for f in got] == \
        [(t, c) for _, t, _, c, _ in want]


@pytest.mark.parametrize("kwargs", [
    {"mode": "async"}, {"buffer_size": 0}, {"buffer_size": 41},
    {"duration_lo": 3, "duration_hi": 2}, {"max_idle_ticks": 0}])
def test_schedule_refusals_match_jax(kwargs):
    def build(mod):
        trace = mod.PoissonTrace(40)
        return mod.TrafficSchedule(trace, **{"buffer_size": 4, **kwargs})

    with pytest.raises(ValueError) as want:
        build(jax_traffic)
    with pytest.raises(ValueError) as got:
        build(traffic)
    assert str(got.value) == str(want.value)


def test_starved_trace_raises_as_jax():
    for mod in (traffic, jax_traffic):
        sched = mod.TrafficSchedule(mod.PoissonTrace(20, rate=1e-9),
                                    buffer_size=4, max_idle_ticks=30)
        with pytest.raises(RuntimeError, match="starved"):
            sched.fire(0)


# ----------------------------------------------------------------------
# the server
# ----------------------------------------------------------------------
def _servers(raw, tmp_path):
    """Both packages' servers on ``raw`` over the same 4-user dataset,
    built without training; each an exception instead when it raises."""
    from test_torch_strategy_config import _dataset
    from test_torch_defense_config import _jax_server
    from msrflute_tpu_torch.data.dataset import ArraysDataset

    def port():
        cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
        data = _dataset()
        return OptimizationServer(
            make_task(cfg.model_config), cfg,
            ArraysDataset(data.user_list, [data.user_arrays(i)
                                           for i in range(len(data))]),
            model_dir=str(tmp_path / "port"), device="cpu", seed=0)

    out = []
    for build in (lambda: _jax_server(raw, tmp_path / "jax"), port):
        try:
            out.append(build())
        except Exception as exc:  # noqa: BLE001 - compared below
            out.append(exc)
    return out


def _traffic_raw(strategy="fedbuff", ncpi=2, **server):
    from test_torch_strategy_config import _with
    raw = _with(strategy, ("server_config.traffic", {"seed": 1}))
    raw["server_config"]["num_clients_per_iteration"] = ncpi
    raw["server_config"].update(server)
    return raw


REFUSED = {
    "host_rounds": _traffic_raw("scaffold"),
    "buffer_not_cohort": _traffic_raw(traffic={"seed": 1, "buffer_size": 3}),
    "ranged_cohort": _traffic_raw(ncpi="1:2"),
    "fleet_floyd": _traffic_raw(fleet={"sampling": "floyd"}),
    "megabatch": _traffic_raw(cohort_bucketing={"enable": True},
                              megabatch={"enable": True}),
    "clients_per_chunk": _traffic_raw(clients_per_chunk=1),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_server_refusals_match_jax(name, tmp_path):
    want, got = _servers(REFUSED[name], tmp_path)
    assert isinstance(want, ValueError), want
    assert type(got) is type(want), got
    assert str(got) == str(want)


def test_drawn_staleness_strategies_and_sync_stage_no_operand(tmp_path):
    for raw in (_traffic_raw("fedavg"),
                _traffic_raw(traffic={"seed": 1, "mode": "sync"})):
        jserver, server = _servers(raw, tmp_path)
        assert server.traffic is not None
        assert server.engine.traffic_staleness is False
        assert jserver.engine.traffic_staleness is False
    jserver, server = _servers(_traffic_raw(), tmp_path)
    assert server.engine.traffic_staleness and \
        jserver.engine.traffic_staleness


BUFFERED = lr_config("fedbuff", rounds=4, server={
    "fedbuff": {"max_staleness": 3},
    "traffic": {"mode": "buffered", "trace": "poisson", "rate": 3.0,
                "seed": 1, "target_accuracy": 0.6}})
LOSS_REL = 1e-5


def _run_both(raw, blob, tmp_path, jax_events):
    init, want, n_val = jax_history(raw, blob, str(tmp_path / "jax"))
    jev = normalized(jax_events)
    server = port_run(raw, blob, tmp_path / "port", init)
    got = [(h["round"], h["loss"], h["acc"]) for h in server.history
           if h["split"] == "val"]
    assert [r for r, _, _ in got] == [r for r, _, _ in want]
    for (r, gl, ga), (_, wl, wa) in zip(got, want):
        assert abs(gl - wl) <= LOSS_REL * abs(wl), (r, gl, wl)
        assert abs(ga - wa) * n_val <= 1.0 + 1e-9, (r, ga, wa)
    return server, normalized(server.metrics.events), jev


@pytest.mark.parametrize("mode", ["buffered", "sync"])
def test_traffic_run_matches_jax(mode, lr_blob, tmp_path, jax_events):
    raw = copy.deepcopy(BUFFERED)
    raw["server_config"]["traffic"]["mode"] = mode
    if mode == "sync":
        # FedBuff draws its staleness off the traced path, which matches the
        # JAX package's in law only: one version, no draw
        raw["server_config"]["fedbuff"]["max_staleness"] = 1
    server, got, want = _run_both(raw, lr_blob, tmp_path, jax_events)
    assert got == want
    fired = [f for k, f in got if k == "buffer_fired"]
    assert [f["round"] for f in fired] == [0.0, 1.0, 2.0, 3.0]
    stale = [f for k, f in got if k == "traffic_staleness"]
    if mode == "sync":
        assert not stale and not any(f["stale_sum"] for f in fired)
        return
    # the device histogram of each round is the host replay's
    for r, f in enumerate(stale):
        s = server.traffic.staleness(r)
        hist = np.bincount(np.minimum(s, traffic.STALE_HIST_BINS - 1),
                           minlength=traffic.STALE_HIST_BINS)
        assert f["hist"] == hist.astype(float).tolist()
        assert f["stale_sum"] == float(s.sum())
    assert sum(f["stale_sum"] for f in stale) > 0
    assert server.rounds_to_target_accuracy is not None
    reached = [f for k, f in got if k == "target_accuracy_reached"]
    assert reached == [{"round": float(server.rounds_to_target_accuracy),
                        "acc": reached[0]["acc"], "target": 0.6}]
    summary = server.traffic_summary()
    assert summary["rounds_to_target_accuracy"] == \
        server.rounds_to_target_accuracy
    assert summary["stale_hist"] == server.traffic.stale_hist.tolist()


def _fires_of(server):
    return [(f["round"], f["tick"], f["stale_sum"])
            for f in server.metrics.events if f["event"] == "buffer_fired"]


def test_depths_and_a_resume_are_bitwise(lr_blob, tmp_path):
    raw = copy.deepcopy(BUFFERED)
    raw["server_config"].update(max_iteration=5, val_freq=5)
    serial = port_run(raw, lr_blob, tmp_path / "d0")
    ring = copy.deepcopy(raw)
    ring["server_config"].update(pipeline_depth=2, rounds_per_step=2,
                                 val_freq=4)
    piped = port_run(ring, lr_blob, tmp_path / "d2")
    assert torch.equal(serial.state.params, piped.state.params)
    assert _fires_of(serial) == _fires_of(piped)
    cut = copy.deepcopy(raw)
    cut["server_config"].update(pipeline_depth=1,
                                chaos={"preempt_at_round": 3})
    first = port_run(cut, lr_blob, tmp_path / "cut")
    assert first.preempted and first.state.round == 3
    cut["server_config"]["resume_from_checkpoint"] = True
    resumed = port_run(cut, lr_blob, tmp_path / "cut")
    assert resumed.state.round == 5
    assert torch.equal(resumed.state.params, serial.state.params)
    assert _fires_of(first) + _fires_of(resumed) == _fires_of(serial)


@pytest.mark.parametrize("plane", ["bucketed", "pooled"])
def test_bucketed_and_pooled_traffic_match_jax(plane, lr_blob, tmp_path,
                                               jax_events):
    raw = copy.deepcopy(BUFFERED)
    if plane == "bucketed":
        raw["server_config"]["cohort_bucketing"] = {"max_buckets": 2}
    else:
        raw["client_config"]["data_config"]["train"]["device_resident"] = \
            True
    server, got, want = _run_both(raw, lr_blob, tmp_path, jax_events)
    assert got == want
    if plane == "bucketed":
        assert len(server.cohort_bucketing["boundaries"]) == 2
    else:
        assert server.engine.pool_mode
