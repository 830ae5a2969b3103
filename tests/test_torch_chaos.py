"""The port's chaos schedule (``msrflute_tpu_torch/resilience/chaos.py``, the
client half of ``msrflute_tpu/resilience/chaos.py``) against the JAX
package's, and the round's fold of its vectors:

- the ``drop``, ``keep_steps`` and corruption-mode vectors over 50 rounds,
  for several seeds and rates: bitwise (the same ``SeedSequence`` entropy
  and draw order);
- the constructor's checks, as ``ValueError`` in both;
- one round of the engine with the vectors: the fault counters equal the
  host's replay of the schedule, a dropped client leaves the weight sum,
  and a straggler's steps past its budget leave its payload;
- the firewall: a zero-rate chaos block gives a run bitwise equal to no
  block (params and every logged metric);
- the trajectory helpers that ``test_torch_robust.py``,
  ``test_torch_secagg.py`` and ``test_torch_dp_fedavg.py`` hold the port's
  CLI to the JAX server with: val loss ``rel 1e-5``, accuracy to one val
  sample, and the per-round defense counters equal.
"""

import copy
import json

import numpy as np
import pytest
import torch

import msrflute_tpu.engine.server as jax_server_module
from msrflute_tpu.resilience.chaos import ChaosSchedule as JaxChaos
from msrflute_tpu_torch.resilience.chaos import (CORRUPT_NAN, CORRUPT_NONE,
                                                 NO_BOUND, ChaosSchedule,
                                                 make_chaos)
from test_torch_strategies import (LOSS_REL, ROUNDS, jax_history, lr_config,
                                   port_cli_history, write_lr_blob)

#: the defense metrics both servers log every round
DEFENSE_METRICS = (
    "Chaos dropped clients", "Chaos stragglers", "Chaos steps lost",
    "Chaos NaN-injected clients", "Chaos scaled clients",
    "Chaos sign-flipped clients", "Quarantined clients (non-finite)",
    "Quarantined clients (norm outlier)", "SecAgg recovered (dropout)",
    "SecAgg recovered (quarantine)", "SecAgg aborted round",
    "DP clip norm")

#: dropout, stragglers and all three corruption modes at K = 4
CHAOS = {"seed": 3, "dropout_rate": 0.25, "straggler_rate": 0.3,
         "corrupt_nan_rate": 0.15, "corrupt_scale_rate": 0.15,
         "corrupt_scale_factor": 50.0, "corrupt_sign_flip_rate": 0.15}


@pytest.fixture(scope="module")
def lr_blob(tmp_path_factory):
    d = tmp_path_factory.mktemp("lr_blob")
    write_lr_blob(d / "train.json", 16, 6, 24, seed=0)
    write_lr_blob(d / "val.json", 3, 6, 24, seed=1)
    return str(d)


def defense_histories(raw, data_dir, tmp_path, monkeypatch):
    """Both servers on ``raw`` from the same initial weights: ``(port val
    history, JAX val history, val samples, port defense metrics, JAX
    defense metrics, port server)``, the metrics as ``{name: [(step,
    value)]}``."""
    recorded = []
    log_metric = jax_server_module.log_metric

    def recording(name, value, step=None, **kw):
        recorded.append((name, step, value))
        return log_metric(name, value, step=step, **kw)

    monkeypatch.setattr(jax_server_module, "log_metric", recording)
    init, want, n_val = jax_history(raw, data_dir, str(tmp_path / "jax"))
    monkeypatch.setattr(jax_server_module, "log_metric", log_metric)
    server, got = port_cli_history(copy.deepcopy(raw), data_dir,
                                   tmp_path / "port", init, monkeypatch)
    with open(tmp_path / "port" / "run" / "log" / "metrics.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    port = {name: [(r["step"], r["value"]) for r in records
                   if r.get("name") == name] for name in DEFENSE_METRICS}
    jax_m = {name: [(s, float(v)) for n, s, v in recorded if n == name]
             for name in DEFENSE_METRICS}
    return got, want, n_val, port, jax_m, server


def assert_defense_trajectory(got, want, n_val, port, jax_m,
                              clip_rtol=0.0):
    """Val loss ``rel 1e-5`` and accuracy to one val sample every round,
    and each defense metric logged at the same rounds with the same
    values (``DP clip norm`` within ``clip_rtol``)."""
    assert [r for r, _, _ in got] == [r for r, _, _ in want] == \
        list(range(ROUNDS + 1))
    for (r, gl, ga), (_, wl, wa) in zip(got, want):
        assert abs(gl - wl) <= LOSS_REL * abs(wl), (r, gl, wl)
        assert abs(ga - wa) * n_val <= 1.0 + 1e-9, (r, ga, wa)
    for name in DEFENSE_METRICS:
        assert [s for s, _ in port[name]] == [s for s, _ in jax_m[name]], \
            (name, port[name], jax_m[name])
        np.testing.assert_allclose([v for _, v in port[name]],
                                   [v for _, v in jax_m[name]],
                                   rtol=clip_rtol, atol=0, err_msg=name)


# ----------------------------------------------------------------------
SCHEDULES = {
    "dropout_straggle": dict(seed=0, dropout_rate=0.3, straggler_rate=0.4,
                             straggler_inflation=3.0),
    "corrupt_only": dict(seed=11, corrupt_nan_rate=0.1,
                         corrupt_scale_rate=0.2,
                         corrupt_sign_flip_rate=0.3),
    "everything": dict(seed=12345, dropout_rate=0.2, straggler_rate=0.2,
                       corrupt_nan_rate=0.1, corrupt_scale_rate=0.1,
                       corrupt_sign_flip_rate=0.1, corrupt_scale_factor=50),
    "certain": dict(seed=7, dropout_rate=1.0, straggler_rate=1.0,
                    corrupt_sign_flip_rate=1.0),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_vectors_match_jax_bitwise_over_50_rounds(name):
    kw = SCHEDULES[name]
    ours, theirs = ChaosSchedule(**kw), JaxChaos(**kw)
    rng = np.random.default_rng(5)
    for r in range(50):
        k = int(rng.integers(1, 13))
        # ragged step grids with empty (padding) clients
        mask = (rng.random((k, 8, 4)) < 0.6).astype(np.float32)
        mask[rng.random(k) < 0.2] = 0.0
        drop, keep = ours.client_faults(r, mask)
        jdrop, jkeep = theirs.client_faults(r, mask)
        assert drop.dtype == jdrop.dtype and keep.dtype == jkeep.dtype
        np.testing.assert_array_equal(drop, jdrop)
        np.testing.assert_array_equal(keep, jkeep)
        modes = ours.corrupt_modes(r, k)
        assert modes.dtype == np.int32
        np.testing.assert_array_equal(modes, theirs.corrupt_modes(r, k))
    assert ours.has_client_faults == theirs.has_client_faults
    assert ours.has_corruption == theirs.has_corruption


def test_certain_faults_hit_every_slot():
    sched = ChaosSchedule(**SCHEDULES["certain"])
    mask = np.ones((3, 5, 2), np.float32)
    drop, keep = sched.client_faults(0, mask)
    np.testing.assert_array_equal(drop, 1.0)
    np.testing.assert_array_equal(keep, 3.0)   # ceil(5 / 2)
    quiet = ChaosSchedule(seed=7)
    drop, keep = quiet.client_faults(0, mask)
    assert not drop.any() and (keep == NO_BOUND).all()
    assert (quiet.corrupt_modes(0, 3) == CORRUPT_NONE).all()
    assert (ChaosSchedule(corrupt_nan_rate=1.0).corrupt_modes(4, 6)
            == CORRUPT_NAN).all()


@pytest.mark.parametrize("kw", [
    {"dropout_rate": 1.5}, {"straggler_rate": -0.1},
    {"straggler_inflation": 0.5}, {"ckpt_io_error_rate": 2.0},
    {"corrupt_nan_rate": 1.1},
    {"corrupt_nan_rate": 0.5, "corrupt_scale_rate": 0.4,
     "corrupt_sign_flip_rate": 0.2},
    {"corrupt_scale_factor": 0.0}, {"corrupt_sign_flip_scale": -1.0},
], ids=lambda kw: ",".join(kw))
def test_constructor_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError):
        JaxChaos(**kw)
    with pytest.raises(ValueError):
        ChaosSchedule(**kw)


def test_make_chaos_reads_the_block():
    assert make_chaos({}) is None
    assert make_chaos({"chaos": {"enable": False,
                                 "dropout_rate": 0.5}}) is None
    sched = make_chaos({"chaos": {"seed": 4, "dropout_rate": 0.5,
                                  "corrupt_scale_rate": 0.1}})
    assert sched.seed == 4 and sched.has_client_faults and \
        sched.has_corruption
    assert sched.dropout_rate == 0.5 and sched.corrupt_scale_rate == 0.1
    # the client half's counters and, since the checkpoint-IO stream is
    # ported, its fault count: the JAX schedule's keys
    assert set(sched.counters) == {"dropped", "straggled", "steps_lost",
                                   "ckpt_io_faults", "nan_injected",
                                   "scaled", "sign_flipped"}
    from msrflute_tpu.resilience.chaos import ChaosSchedule as JaxSchedule
    assert set(sched.counters) == set(JaxSchedule().counters)


# ----------------------------------------------------------------------
def _engine_round(raw, lr_blob, chaos):
    from msrflute_tpu_torch.config import FLUTEConfig
    from msrflute_tpu_torch.data.batching import pack_round_batches
    from msrflute_tpu_torch.engine import RoundEngine
    from msrflute_tpu_torch.models import make_task
    from msrflute_tpu_torch.strategies import select_strategy
    from msrflute_tpu_torch.tasks import build_task_datasets
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    cfg.validate(lr_blob)
    task = make_task(cfg.model_config)
    train, _, _ = build_task_datasets(cfg, task)
    engine = RoundEngine(task, cfg, select_strategy(cfg.strategy)(cfg),
                         torch.device("cpu"))
    batch = pack_round_batches(train, [0, 3, 5, 7], 4, 8,
                               rng=np.random.default_rng(0))
    state = engine.init_state(task.init_params(0))
    return engine, batch, engine.run_round(state, batch, 0.2, 1.0,
                                           chaos=chaos)


def test_round_counters_equal_the_host_replay(lr_blob):
    raw = lr_config("fedavg", server={"chaos": {"dropout_rate": 0.5,
                                                "straggler_rate": 0.5}})
    sched = make_chaos(raw["server_config"])
    engine, batch, _ = _engine_round(raw, lr_blob, None)
    assert engine.chaos_client_faults and not engine.chaos_corruption
    for r in range(6):
        drop, keep = sched.client_faults(r, batch.sample_mask)
        _, (_, stats) = _engine_round(raw, lr_blob, {"drop": drop,
                                                     "keep": keep})[1:]
        live = batch.client_mask * (1.0 - drop)
        steps = (batch.sample_mask.sum(axis=2) > 0)
        real = steps.sum(axis=1)
        lost = sum(int(steps[k, int(keep[k]):].sum()) * live[k]
                   for k in range(len(keep)) if keep[k] < NO_BOUND)
        assert stats["chaos_dropped"] == float((batch.client_mask
                                                * drop).sum())
        assert stats["chaos_straggled"] == float((live * (keep < real))
                                                 .sum())
        assert stats["chaos_steps_lost"] == float(lost)
        assert stats["client_count"] == float(live.sum())


def test_dropped_client_leaves_the_round(lr_blob):
    """Dropping every client but one gives the round of that client
    alone; a straggler's truncated steps change its payload."""
    raw = lr_config("fedavg", server={"chaos": {"dropout_rate": 0.5}})
    k = 4
    keep_all = np.full(k, NO_BOUND, np.float32)
    drop = np.array([1, 0, 1, 1], np.float32)
    _, batch, (dropped, stats) = _engine_round(
        raw, lr_blob, {"drop": drop, "keep": keep_all})
    solo_raw = lr_config("fedavg")
    engine, _, _ = _engine_round(solo_raw, lr_blob, None)
    batch1 = copy.copy(batch)
    batch1.client_mask = batch.client_mask * (1.0 - drop)
    state = engine.init_state(engine.task.init_params(0))
    solo, solo_stats = engine.run_round(state, batch1, 0.2, 1.0)
    assert torch.equal(dropped.params, solo.params)
    assert stats["weight_sum"] == solo_stats["weight_sum"]
    _, _, (straggled, _) = _engine_round(
        raw, lr_blob, {"drop": np.zeros(k, np.float32),
                       "keep": np.array([1, NO_BOUND, NO_BOUND, NO_BOUND],
                                        np.float32)})
    _, _, (clean, _) = _engine_round(
        raw, lr_blob, {"drop": np.zeros(k, np.float32), "keep": keep_all})
    assert not torch.equal(straggled.params, clean.params)


def port_cli(raw, data_dir, out):
    """The port's CLI in process on ``raw`` (its own initial weights):
    the server and the lines of its metrics stream, timestamps left out."""
    import yaml
    from msrflute_tpu_torch import e2e_trainer
    out.mkdir()
    (out / "cfg.yaml").write_text(yaml.safe_dump(raw))
    server = e2e_trainer.main(["-config", str(out / "cfg.yaml"),
                               "-dataPath", data_dir, "-outputPath",
                               str(out / "run"), "-device", "cpu"])
    with open(out / "run" / "log" / "metrics.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    return server, [(r["name"], r.get("step"), r["value"]) for r in records
                    if "name" in r and "secsPerRound" not in r["name"]]


def test_zero_rate_chaos_block_is_bitwise_no_block(lr_blob, tmp_path):
    """The firewall: a chaos block whose rates are all 0 (and one with
    ``enable: false``) runs the exact rounds of no block: params and every
    logged metric bitwise."""
    runs = {}
    for name, block in (("none", None),
                        ("zero", {"seed": 9, "dropout_rate": 0.0,
                                  "corrupt_nan_rate": 0.0}),
                        ("off", {"enable": False, "dropout_rate": 0.5})):
        raw = lr_config("fedavg", rounds=3)
        if block is not None:
            raw["server_config"]["chaos"] = block
        server, records = port_cli(raw, lr_blob, tmp_path / name)
        runs[name] = (server.state.params.clone(), records)
    for name in ("zero", "off"):
        assert torch.equal(runs[name][0], runs["none"][0]), name
        assert runs[name][1] == runs["none"][1], name
