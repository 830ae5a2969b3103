"""Cohort bucketing in the port (``msrflute_tpu_torch/data/batching.py``,
``engine/server.py::_pack_bucketed_round``, ``engine/round.py::
dispatch_bucketed_rounds``) against the JAX package's
(``data/batching.py:362-502, 665-683``, ``engine/server.py:492-572,
2213-2343``, ``engine/round.py:2031-2940``):

- the host planners equal the JAX functions on the same needs, and the
  server's bucket grids equal the JAX server's array for array;
- the bucketed CLI run against the JAX package's at ``rtol 1e-5, atol
  1e-7`` (plain, with chaos faults and corruption, with fused SCAFFOLD);
- the port's own invariants: a client's payload bitwise across bucket
  shapes, two bucketed runs bitwise, bucketed against monolithic at
  ``rtol 2e-4, atol 1e-6``, secure aggregation bucketed bitwise its
  monolithic run, the per-client stats in bucket order, kernel B1's
  optimizer tail once a bucket grid a local step;
- every refusal of the JAX package on the same condition.
"""

import copy
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from msrflute_tpu.data import batching as jb
from msrflute_tpu.data.fleet import steps_for_array as jax_steps_for_array
from msrflute_tpu_torch.config import FLUTEConfig, SchemaError
from msrflute_tpu_torch.data import batching as pb
from msrflute_tpu_torch.data.dataset import ArraysDataset
from msrflute_tpu_torch.engine.server import select_server
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params
from test_torch_dp_strategies import _jax_run
from test_torch_strategies import port_cli_history, write_lr_blob
from test_torch_strategy_config import _with

#: a heavy-tailed pool: mostly small clients, a few large
SIZES = [3, 4, 5, 5, 6, 6, 7, 8, 9, 10, 12, 14, 30, 34, 70, 80]
BUCKETS = {"enable": True, "max_buckets": 3}


def hetero_users(sizes=SIZES, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(8, 4))
    out = []
    for n in sizes:
        x = rng.normal(size=(n, 8)).astype(np.float32)
        out.append({"x": x, "y": np.argmax(x @ w, -1).astype(np.int32)})
    return [f"u{u:03d}" for u in range(len(sizes))], out


def port_hetero(sizes=SIZES):
    return ArraysDataset(*hetero_users(sizes))


def jax_hetero(sizes=SIZES):
    from msrflute_tpu.data import ArraysDataset as JaxArraysDataset
    return JaxArraysDataset(*hetero_users(sizes))


def raw_cfg(bucketing=None, *, rounds=4, strategy="fedavg", ncpi=8,
            epochs=1, mega=None, **server):
    sc = {"max_iteration": rounds, "num_clients_per_iteration": ncpi,
          "initial_lr_client": 0.2, "pipeline_depth": 0, "val_freq": 100,
          "initial_val": False,
          "optimizer_config": {"type": "sgd", "lr": 1.0},
          "data_config": {"val": {"batch_size": 8}}}
    if bucketing is not None:
        sc["cohort_bucketing"] = bucketing
    if mega is not None:
        sc["megabatch"] = mega
    if strategy == "personalization":
        strategy = "fedavg"
        sc["type"] = "personalization"
    sc.update(server)
    return {"model_config": {"model_type": "LR", "num_classes": 4,
                             "input_dim": 8},
            "strategy": strategy, "server_config": sc,
            "client_config": {
                "num_epochs": epochs,
                "optimizer_config": {"type": "sgd", "lr": 0.2},
                "data_config": {"train": {"batch_size": 4}}}}


def port_server(raw, model_dir, sizes=SIZES, seed=7):
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    cls = select_server(cfg.server_config.get("type"))
    return cls(make_task(cfg.model_config), cfg, port_hetero(sizes),
               model_dir=str(model_dir), device="cpu", seed=seed)


def port_run(raw, model_dir, **kw):
    server = port_server(raw, model_dir, **kw)
    server.train()
    return server


def jax_server(raw, model_dir, sizes=SIZES, seed=7):
    from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
    from msrflute_tpu.engine import select_server as jax_select
    from msrflute_tpu.models import make_task as jax_make_task
    from msrflute_tpu.parallel import make_mesh
    cfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    cls = jax_select(cfg.server_config.get("type"))
    return cls(jax_make_task(cfg.model_config), cfg, jax_hetero(sizes),
               model_dir=str(model_dir), seed=seed,
               mesh=make_mesh(num_devices=1))


# ----------------------------------------------------------------------
# host planners against the JAX functions
# ----------------------------------------------------------------------
def _needs(seed):
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(0, np.log(60), size=40)).astype(np.int64) + 1


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("max_buckets", [1, 2, 3, 4, 6])
def test_bucket_boundaries_equal_the_jax_function(seed, max_buckets):
    needs = _needs(seed)
    for max_steps in (16, 64):
        assert pb.bucket_boundaries(needs, max_buckets, max_steps) == \
            jb.bucket_boundaries(needs, max_buckets, max_steps)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("slack", [1.0, 1.5, 2.5])
def test_capacities_and_assignment_equal_the_jax_functions(seed, slack):
    needs = _needs(seed)
    bounds = jb.bucket_boundaries(needs, 3, 64)
    caps = pb.bucket_capacities(needs, bounds, 10, slack=slack)
    assert caps == jb.bucket_capacities(needs, bounds, 10, slack=slack)
    cohort = np.random.default_rng(seed + 9).choice(needs, 10,
                                                    replace=False)
    for c in (None, caps):
        assert pb.assign_step_buckets(cohort, bounds, capacities=c) == \
            jb.assign_step_buckets(cohort, bounds, capacities=c)


def test_step_needs_and_meter_equal_the_jax_functions():
    ns = np.array([0, 1, 3, 4, 5, 79, 80, 81, 1000])
    for desired in (None, 50):
        np.testing.assert_array_equal(
            pb.steps_for_array(ns, 4, desired),
            jax_steps_for_array(ns, 4, desired))
    ds, jds = port_hetero(), jax_hetero()
    rng_p, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    grids = [(pb.pack_round_batches(ds, ids, 4, s, rng=rng_p,
                                    pad_clients_to=pad),
              jb.pack_round_batches(jds, ids, 4, s, rng=rng_j,
                                    pad_clients_to=pad))
             for ids, s, pad in (([0, 3, 5], 2, 4), ([12, -1, 14], 20, 3),
                                 ([], 8, 2))]
    mine, ref = [g[0] for g in grids], [g[1] for g in grids]
    assert pb.grid_slots(mine) == jb.grid_slots(ref)
    assert pb.padding_efficiency(mine) == jb.padding_efficiency(ref)
    assert pb.padding_efficiency([mine[-1]]) == 0.0


def _assert_same_grid(mine, ref):
    assert sorted(mine.arrays) == sorted(ref.arrays)
    for k in mine.arrays:
        np.testing.assert_array_equal(mine.arrays[k], ref.arrays[k])
    for key in ("sample_mask", "num_samples", "client_mask", "client_ids"):
        np.testing.assert_array_equal(getattr(mine, key), getattr(ref, key))


def test_packing_with_holes_padding_and_orders_equals_the_jax_packer():
    ds, jds = port_hetero(), jax_hetero()
    orders = {c: np.random.default_rng(c).permutation(SIZES[c])
              for c in (2, 7, 13)}
    for ids, S, pad in (([2, -1, 7], 4, 5), ([13], 20, 1), ([-1, -1], 2, 2)):
        _assert_same_grid(
            pb.pack_round_batches(ds, ids, 4, S, pad_clients_to=pad,
                                  orders=orders),
            jb.pack_round_batches(jds, ids, 4, S, pad_clients_to=pad,
                                  orders=orders))


@pytest.mark.parametrize("bucketing", [
    BUCKETS, {"enable": True, "max_buckets": 4, "boundaries": [2, 8, 32]},
    {"enable": True, "max_buckets": 2, "slack": 1.0}],
    ids=["derived", "explicit", "tight"])
def test_bucket_grids_equal_the_jax_servers(bucketing, tmp_path):
    """Boundaries, capacities and three rounds of bucket grids (with the
    numpy state after each) array for array; the explicit list's top is
    clamped to the largest need."""
    raw = raw_cfg(bucketing)
    mine = port_server(raw, tmp_path / "p")
    ref = jax_server(raw, tmp_path / "j")
    assert mine.cohort_bucketing == ref.cohort_bucketing
    for _ in range(3):
        sampled = mine._sample()
        assert sampled == ref._sample()
        got = mine._pack_bucketed_round(sampled)
        want = ref._pack_bucketed_round(sampled)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same_grid(a, b)
        assert mine._np_rng.bit_generator.state == \
            ref._np_rng.bit_generator.state
    if "boundaries" in bucketing:
        assert mine.cohort_bucketing["boundaries"][-1] == 20


# ----------------------------------------------------------------------
# the CLI against the JAX package
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def hetero_blob(tmp_path_factory):
    d = tmp_path_factory.mktemp("hetero_blob")
    write_lr_blob(d / "train.json", 16, 2, 60, seed=0)
    write_lr_blob(d / "val.json", 3, 6, 24, seed=1)
    return str(d)


def cli_config(**server):
    raw = raw_cfg(BUCKETS, rounds=3, ncpi=6, **server)
    raw["server_config"].update(val_freq=1, initial_val=True, rec_freq=1000)
    raw["server_config"]["data_config"] = {
        "val": {"batch_size": 16, "val_data": "val.json"}}
    raw["client_config"]["data_config"]["train"]["list_of_train_data"] = \
        "train.json"
    return raw


CLI_CASES = {
    "fedavg": cli_config(pipeline_depth=1),
    "chaos": cli_config(chaos={"seed": 5, "dropout_rate": 0.2,
                               "straggler_rate": 0.3,
                               "corrupt_sign_flip_rate": 0.2}),
    "scaffold_fused": dict(cli_config(fused_carry=True),
                           strategy="scaffold"),
}


def assert_cli_matches(raw, blob, tmp_path, monkeypatch):
    init, want, _, jserver = _jax_run(raw, blob, str(tmp_path / "j"))
    server, got = port_cli_history(raw, blob, tmp_path / "port", init,
                                   monkeypatch)
    assert [r for r, _, _ in got] == [r for r, _, _ in want]
    for (r, gl, ga), (_, wl, wa) in zip(got, want):
        np.testing.assert_allclose(gl, wl, rtol=1e-5, err_msg=f"round {r}")
        assert ga == pytest.approx(wa, abs=1e-9), r
    task = server.task
    np.testing.assert_allclose(
        server.state.params.numpy(),
        task.layout().flatten(from_jax_params(
            task, jax.device_get(jserver.state.params))).numpy(),
        rtol=1e-5, atol=1e-7)
    assert server.padding_efficiency == pytest.approx(
        jserver.padding_efficiency, rel=1e-12)
    return server, jserver


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_bucketed_cli_matches_the_jax_run(case, hetero_blob, tmp_path,
                                          monkeypatch):
    server, jserver = assert_cli_matches(CLI_CASES[case], hetero_blob,
                                         tmp_path, monkeypatch)
    assert server.cohort_bucketing == jserver.cohort_bucketing
    assert len(server.cohort_bucketing["boundaries"]) == 3
    if case == "chaos":
        assert server.chaos.counters == pytest.approx(
            jserver.chaos.counters)


# ----------------------------------------------------------------------
# the port's invariants
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def mono_and_bucketed(tmp_path_factory):
    d = tmp_path_factory.mktemp("runs")
    return (port_run(raw_cfg(), d / "mono"), port_run(raw_cfg(BUCKETS),
                                                      d / "b1"),
            port_run(raw_cfg(BUCKETS), d / "b2"))


def test_bucketed_matches_monolithic_and_repeats_bitwise(mono_and_bucketed):
    mono, b1, b2 = mono_and_bucketed
    assert torch.equal(b1.state.params, b2.state.params)
    torch.testing.assert_close(b1.state.params, mono.state.params,
                               rtol=2e-4, atol=1e-6)
    assert not torch.equal(mono.state.params,
                           torch.zeros_like(mono.state.params))
    # the meter: bucketing's padding efficiency well above monolithic's
    assert mono.padding_efficiency < b1.padding_efficiency <= 1.0
    assert len(b1.run_stats["paddingEfficiency"]) == 4


def test_payloads_bitwise_across_bucket_shapes(tmp_path):
    """A client's pseudo-gradient on a compact grid equals its row of the
    monolithic grid, bit for bit (padding steps are no-ops, the dropout
    stream is keyed on the client id)."""
    server = port_server(raw_cfg(), tmp_path)
    ds = port_hetero()
    ids = [0, 2, 12, 15]
    mono = pb.pack_round_batches(ds, ids, 4, 20, shuffle=False)
    pg_m, w_m, _, _ = server.engine.client_payloads(server.state, mono, 0.2)
    for bucket_ids, s_b, pad in (([0, 2], 2, 3), ([12], 8, 1),
                                 ([15], 20, 2)):
        small = pb.pack_round_batches(ds, bucket_ids, 4, s_b, shuffle=False,
                                      pad_clients_to=pad)
        pg_b, w_b, _, _ = server.engine.client_payloads(server.state, small,
                                                        0.2)
        for row, cid in enumerate(bucket_ids):
            assert torch.equal(pg_b[row], pg_m[ids.index(cid)]), cid
            assert torch.equal(w_b[row], w_m[ids.index(cid)]), cid


DGA_DP = {"enable_local_dp": True, "eps": 100.0, "delta": 1e-7,
          "max_grad": 1.0, "max_weight": 10000.0, "min_weight": 0.0,
          "weight_scaler": 1e-4, "enable_global_dp": True,
          "global_sigma": 0.5}


@pytest.mark.parametrize("rounds", [1, 2])
def test_dga_bucketed_matches_monolithic(rounds, tmp_path):
    """DGA with local and global DP, quantization and staleness: a round's
    payloads, noise and coins are keyed on the client id and the round, so
    bucketing moves only the sums' order (``rtol 2e-4, atol 1e-6``); and
    quantization runs once a bucket grid."""
    runs = []
    for name, cb in (("mono", None), ("buck", BUCKETS)):
        raw = raw_cfg(cb, strategy="dga", rounds=rounds, stale_prob=0.3)
        raw["model_config"].update(quant_threshold=0.5, quant_bits=4)
        raw["dp_config"] = dict(DGA_DP)
        runs.append(port_run(raw, tmp_path / name))
    mono, buck = runs
    torch.testing.assert_close(buck.state.params, mono.state.params,
                               rtol=2e-4, atol=1e-6)
    for key, v in mono.state.strategy_state.items():
        torch.testing.assert_close(buck.state.strategy_state[key], v,
                                   rtol=2e-4, atol=1e-6)


def test_secure_agg_bucketed_equals_monolithic_bitwise(tmp_path):
    """Each bucket masks toward its own grid: the int32 sums, and so the
    params, equal the monolithic run's bit for bit
    (``test_secagg_compose.py:256-270``)."""
    mono = port_run(raw_cfg(strategy="secure_agg"), tmp_path / "m")
    buck = port_run(raw_cfg(BUCKETS, strategy="secure_agg"), tmp_path / "b")
    assert torch.equal(buck.state.params, mono.state.params)


def test_secure_agg_bucketed_recovers_dropouts_per_bucket(tmp_path):
    """Under chaos dropout each bucket's lost clients' masks are recovered
    a bucket at a time: the run repeats bitwise, the counters fire, and
    the decoded aggregate is FedAvg's under the same salted per-bucket
    schedule to fixed-point resolution (``test_secagg_compose.py:
    273-290``)."""
    chaos = {"seed": 2, "dropout_rate": 0.3}
    runs = [port_run(raw_cfg(BUCKETS, strategy=s, chaos=chaos), tmp_path / n)
            for n, s in (("a", "secure_agg"), ("b", "secure_agg"),
                         ("u", "fedavg"))]
    assert torch.equal(runs[0].state.params, runs[1].state.params)
    assert runs[0].strategy.counters["recovered_dropout"] > 0
    assert runs[0].strategy.counters == runs[1].strategy.counters
    torch.testing.assert_close(runs[0].state.params, runs[2].state.params,
                               rtol=0.0, atol=2e-3)


def test_per_client_stats_come_back_in_bucket_order(tmp_path, monkeypatch):
    """A round's ``[K]`` stats are its grids' rows, concatenated in
    ascending bucket order (JAX ``BucketedStats``), with the client mask
    beside them."""
    from msrflute_tpu_torch.strategies.base import BaseStrategy

    def norms(self, pg, weight, stats, *args):
        stats["privacy_dropped"] = torch.linalg.vector_norm(pg, dim=1)
        return weight

    monkeypatch.setattr(BaseStrategy, "_apply_privacy_metrics", norms)
    server = port_server(raw_cfg(BUCKETS), tmp_path)
    grids = server._pack_chunk(1)[0]
    _, packed = server.engine.dispatch_bucketed_rounds(
        server.state, [grids], [0.2], [1.0])
    priv = packed.fetch()[0]["privacy"]
    mask = np.concatenate([g.client_mask for g in grids])
    np.testing.assert_array_equal(priv["client_mask"], mask)
    want = []
    for g in grids:
        pg, _, _, _ = server.engine.client_payloads(server.state, g, 0.2)
        want.append(torch.linalg.vector_norm(pg, dim=1).numpy())
    np.testing.assert_array_equal(priv["privacy_dropped"],
                                  np.concatenate(want))


def test_optimizer_tail_runs_once_a_bucket_grid_a_local_step(tmp_path):
    """With ``pallas_apply`` (kernel B1 on a card) the tail runs
    ``sum_b E * S_b`` times a round."""
    raw = raw_cfg(BUCKETS, rounds=2, epochs=2,
                  megakernel={"pallas_apply": True})
    server = port_server(raw, tmp_path)
    grids = [server._pack_bucketed_round(server._sample())
             for _ in range(2)]
    server.engine.dispatch_bucketed_rounds(server.state, grids, [0.2] * 2,
                                           [1.0] * 2)
    assert server.engine.local_steps == sum(
        2 * g.sample_mask.shape[1] for row in grids for g in row)


def test_chaos_draws_a_salted_stream_per_bucket(tmp_path):
    raw = raw_cfg(BUCKETS, chaos={"seed": 1, "dropout_rate": 0.5,
                                  "corrupt_nan_rate": 0.3})
    mine = port_server(raw, tmp_path / "p")
    ref = jax_server(raw, tmp_path / "j")
    grids = mine._pack_bucketed_round(mine._sample())
    vecs = mine.chaos_vectors(4, grids)
    for bi, (g, v) in enumerate(zip(grids, vecs)):
        drop, keep = ref.chaos.client_faults(4, g.sample_mask, salt=bi + 1)
        np.testing.assert_array_equal(v["drop"], drop)
        np.testing.assert_array_equal(v["keep"], keep)
        np.testing.assert_array_equal(
            v["corrupt"], ref.chaos.corrupt_modes(4, len(drop), salt=bi + 1))
    # salt 0 keeps the unbucketed three-word stream
    np.testing.assert_array_equal(
        mine.chaos.corrupt_modes(4, 5),
        ref.chaos.corrupt_modes(4, 5))


# ----------------------------------------------------------------------
# refusals, as the JAX package's
# ----------------------------------------------------------------------
REFUSED = {
    "scaffold_host": _with("scaffold", ("server_config.cohort_bucketing",
                                        BUCKETS)),
    "wantRL_host": _with("fedavg", ("server_config.cohort_bucketing",
                                    BUCKETS), ("server_config.wantRL", True)),
    "clients_per_chunk": _with("fedavg", ("server_config.cohort_bucketing",
                                          BUCKETS),
                               ("server_config.clients_per_chunk", 1)),
    "dump_norm_stats": _with("fedavg", ("server_config.cohort_bucketing",
                                        BUCKETS),
                             ("server_config.dump_norm_stats", True)),
    "fused_rl": _with("fedavg", ("server_config.cohort_bucketing", BUCKETS),
                      ("server_config.fused_carry", True),
                      ("server_config.wantRL", True),
                      ("server_config.RL", {"minibatch_size": 2})),
    "input_staging_off": _with("fedavg", ("server_config.cohort_bucketing",
                                          BUCKETS),
                               ("server_config.input_staging", False)),
    "too_many_boundaries": _with(
        "fedavg", ("server_config.cohort_bucketing",
                   {"max_buckets": 2, "boundaries": [1, 2, 4]})),
    "personalization_host": _with(
        "fedavg", ("server_config.cohort_bucketing", BUCKETS),
        ("server_config.type", "personalization")),
}


def _port_build(raw, tmp_path):
    from test_torch_fused_carry import port_server as small_server
    cfg_raw = copy.deepcopy(raw)
    with mock.patch("msrflute_tpu_torch.config.validate"):
        return small_server(cfg_raw, str(tmp_path / "port"))


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_match_the_jax_package(name, tmp_path):
    """The JAX server refuses each, and so does the port's server past its
    config gate (``ValueError``, the JAX package's message)."""
    raw = REFUSED[name]
    with pytest.raises(ValueError) as jax_err:
        jax_server(raw, tmp_path / "jax")
    with pytest.raises(ValueError) as port_err:
        _port_build(raw, tmp_path)
    if name != "too_many_boundaries":   # the JAX schema words it apart
        assert str(port_err.value) == str(jax_err.value)


def test_shield_with_stale_prob_is_refused(tmp_path, monkeypatch):
    """``robust`` screening beside a staleness coin: the JAX engine's
    refusal on the same (patched-in) condition."""
    from msrflute_tpu.strategies.base import BaseStrategy as JaxBase
    from msrflute_tpu_torch.strategies.base import BaseStrategy
    monkeypatch.setattr(JaxBase, "stale_prob", 0.3, raising=False)
    monkeypatch.setattr(BaseStrategy, "stale_prob", 0.3)
    raw = _with("fedavg", ("server_config.cohort_bucketing", BUCKETS),
                ("server_config.robust", {"norm_multiplier": 3.0}))
    with pytest.raises(ValueError, match="stale_prob") as jax_err:
        jax_server(raw, tmp_path / "jax")
    with pytest.raises(ValueError) as port_err:
        _port_build(raw, tmp_path)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("block", [
    {"max_buckets": 0}, {"slack": 0.5}, {"enable": "yes"},
    {"boundaries": [4, 2]}, {"boundaries": [0, 2]}, {"boundaries": []},
    {"max_buckets": 2, "boundaries": [1, 2, 4]}, {"buckets": 3}],
    ids=["max_buckets0", "slack", "enable", "decreasing", "zero", "empty",
         "over_max", "unknown"])
def test_schema_refusals_match_the_jax_schema(block):
    from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
    raw = _with("fedavg", ("server_config.cohort_bucketing", block))
    with pytest.raises(ValueError) as jax_err:
        JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    with pytest.raises(ValueError) as err:
        FLUTEConfig.from_dict(copy.deepcopy(raw))
    if "buckets" not in block:   # the port's unknown-key error is its own
        assert isinstance(err.value, SchemaError)
        assert err.value.errors == jax_err.value.errors


def test_engine_refuses_max_buckets_below_one(tmp_path):
    """Past the schema (the JAX bench injects blocks), ``max_buckets: 0``
    still raises in the engine, as in ``round.py:483-486``."""
    raw = _with("fedavg", ("server_config.cohort_bucketing",
                           {"max_buckets": 0}))
    with pytest.raises(ValueError, match="max_buckets must be >= 1"):
        _port_build(raw, tmp_path)
