"""The fleet paged carry (``server_config.fleet`` beside ``fused_carry``) in
the port (``msrflute_tpu_torch/engine/paging.py``, the server's pager
calls, the round's slot operand) against the port's resident tables and
the JAX package's pager (``msrflute_tpu/engine/paging.py``), on
``tests/test_fleet.py:255-466``'s setup: LR, 4 classes, ``input_dim`` 8, 4
clients a round, ``conftest.make_synthetic_classification``'s 16 users.

- Serial (an 8-slot pool, so evictions and store reads run) and pipelined
  (depth 3), for SCAFFOLD, EF and personalization: the port's paged params,
  ``c`` and every client's row (``user_row``) bitwise the port's resident
  run; params and ``c`` within ``rtol 1e-5`` of the JAX paged run from the
  same initial weights; the pager's counters and every chunk's slot vector
  equal to the JAX pager's (the allocator is host code fed the same
  cohorts).
- Chaos, cohort bucketing (a slot vector a grid), preempt and resume, and
  the personalized eval from the host rows: bitwise the resident runs.
- The refusals, each with the JAX message, and a 10^6-user
  ``SyntheticFleetDataset`` at depth 3 whose pool stays O(cohort).

Each JAX run is shared across the cases that read it (:data:`_jax_cache`).
"""

import copy

import jax
import numpy as np
import pytest
import torch

from conftest import make_synthetic_classification
from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.engine.server import select_server as jax_select_server
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.engine.paging import CarryPager, _flat
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params
from test_torch_fused_carry import (CHAOS, _port_rows, port_dataset,
                                   port_server, raw_config)

STRATEGIES = ("scaffold", "ef_quant", "personalization")
ROUNDS = 5
#: the counters the JAX pager's must equal, integer for integer
COUNTERS = ("hits", "misses", "evictions", "forced_drains", "page_in_rows",
            "writeback_rows", "spilled_rows")
SERIAL = {"page_pool_slots": 8}
PIPELINED = {"enable": True}


def _raw(leg, depth, fleet=None, rounds=ROUNDS, **over):
    raw = raw_config(leg, depth=depth, rounds=rounds, **over)
    if fleet is not None:
        raw["server_config"]["fleet"] = dict(fleet)
    return raw


def _record_slots(pager):
    """Every chunk's slot vectors, a grid at a time, as the pager set
    them."""
    log, prepare = [], pager.prepare_chunk

    def recording(batches, state):
        out = prepare(batches, state)
        log.append([np.asarray(b.carry_slots).tolist()
                    for b in _flat(batches)])
        return out

    pager.prepare_chunk = recording
    return log


_jax_cache = {}


def jax_paged(key, raw, tmp_path_factory):
    """The JAX server on ``raw`` (one device, so one shard):
    ``(initial params, final params, strategy_state, pager describe(),
    slot vectors)``, once per ``key``."""
    if key not in _jax_cache:
        cfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
        cls = jax_select_server(cfg.server_config.get("type"))
        server = cls(jax_make_task(cfg.model_config), cfg,
                     make_synthetic_classification(),
                     model_dir=str(tmp_path_factory.mktemp("jax")),
                     mesh=make_mesh(num_devices=1), seed=7)
        init = jax.device_get(server.state.params)
        slots = _record_slots(server.fleet_pager)
        server.train()
        _jax_cache[key] = (init, jax.device_get(server.state.params),
                           jax.device_get(server.state.strategy_state),
                           server.fleet_pager.describe(), slots)
    return _jax_cache[key]


def _init(raw, jinit):
    task = make_task(FLUTEConfig.from_dict(copy.deepcopy(raw)).model_config)
    return from_jax_params(task, jinit)


def _port(raw, model_dir, init, val=False):
    server = port_server(raw, model_dir, val=val, init_params=init)
    slots = (_record_slots(server.fleet_pager)
             if server.fleet_pager is not None else None)
    server.train()
    return server, slots


_resident_cache = {}


def port_resident(leg, init_key, init, tmp_path_factory, **over):
    """The port's resident depth-0 run from the JAX run's initial
    weights, once per ``(leg, init_key)``."""
    key = (leg, init_key, tuple(sorted(over)))
    if key not in _resident_cache:
        _resident_cache[key] = _port(
            _raw(leg, 0, **over), str(tmp_path_factory.mktemp("res")),
            init)[0]
    return _resident_cache[key]


def _flat_params(task, jparams):
    return task.layout().flatten(from_jax_params(task, jparams)).numpy()


def assert_paged_is_resident(paged, resident):
    """Params, ``c`` and every client's row of the paged run bitwise the
    resident run's tables (a client never seen: no row, the default
    there)."""
    assert torch.equal(paged.state.params, resident.state.params)
    for k, v in resident.state.strategy_state.items():
        if k not in paged.strategy.carry_tables:
            assert torch.equal(paged.state.strategy_state[k], v), k
    defaults = paged.strategy.carry_row_defaults()
    pager = paged.fleet_pager
    for u in range(len(paged.train_dataset)):
        row = pager.user_row(u)
        for k in paged.strategy.carry_tables:
            want = resident.state.strategy_state[k][u]
            if row is None:
                assert bool((want == defaults[k]).all()), (u, k)
            else:
                assert torch.equal(torch.from_numpy(np.asarray(row[k])),
                                   want), (u, k)


def assert_matches_jax(server, slots, jrun):
    _, jparams, jss, jdesc, jslots = jrun
    desc = server.fleet_pager.describe()
    assert {k: desc[k] for k in COUNTERS} == {k: jdesc[k] for k in COUNTERS}
    assert desc["pool_slots"] == jdesc["pool_slots"]
    assert slots == jslots
    task = server.task
    np.testing.assert_allclose(server.state.params.numpy(),
                               _flat_params(task, jparams),
                               rtol=1e-5, atol=1e-7)
    if "c" in jss:
        np.testing.assert_allclose(
            server.state.strategy_state["c"].numpy(),
            _port_rows(task, jparams, [jss["c"]])[0], rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("leg", STRATEGIES)
@pytest.mark.parametrize("mode", ["serial", "pipelined"])
def test_paged_matches_resident_and_jax(leg, mode, tmp_path,
                                        tmp_path_factory):
    depth, fleet = (0, SERIAL) if mode == "serial" else (3, PIPELINED)
    raw = _raw(leg, depth, fleet=fleet)
    jrun = jax_paged((leg, mode), raw, tmp_path_factory)
    init = _init(raw, jrun[0])
    server, slots = _port(raw, str(tmp_path), init)
    pager = server.fleet_pager
    assert pager is not None and pager.n_slots <= len(server.train_dataset)
    for k in server.strategy.carry_tables:
        assert int(server.state.strategy_state[k].shape[0]) == pager.n_slots
    if mode == "serial":
        assert pager.evictions > 0 and pager.n_slots == 8
    else:
        assert server._pipeline_ok() and server.pipelined_chunks > 0
    assert_matches_jax(server, slots, jrun)
    assert_paged_is_resident(
        server, port_resident(leg, (leg, mode), init, tmp_path_factory))


def test_paged_chaos_bucketed_match_resident_and_jax(tmp_path,
                                                     tmp_path_factory):
    """Chaos at depth 2, then cohort bucketing at depth 2 (one slot vector
    a grid): each bitwise its resident serial run, the pager's counters and
    slots the JAX pager's."""
    for name, over in (("chaos", {"chaos": CHAOS}),
                       ("bucketed",
                        {"cohort_bucketing": {"max_buckets": 2}})):
        raw = _raw("scaffold", 2, fleet=PIPELINED, **over)
        jrun = jax_paged(name, raw, tmp_path_factory)
        init = _init(raw, jrun[0])
        server, slots = _port(raw, str(tmp_path / name), init)
        assert server.pipelined_chunks > 0
        if name == "bucketed":
            assert server.cohort_bucketing is not None
            assert max(len(s) for s in slots) > 1
        assert_matches_jax(server, slots, jrun)
        assert_paged_is_resident(server, port_resident(
            "scaffold", name, init, tmp_path_factory, **over))


def test_paged_preempt_resume_bitwise(tmp_path):
    chaos = dict(CHAOS, preempt_at_round=3)
    ref = port_server(_raw("scaffold", 3, fleet=PIPELINED, rounds=7,
                           chaos=CHAOS), str(tmp_path / "ref"))
    ref.train()
    run_dir = str(tmp_path / "run")
    pre = port_server(_raw("scaffold", 3, fleet=PIPELINED, rounds=7,
                           chaos=chaos), run_dir)
    pre.train()
    assert pre.preempted and 3 <= pre.state.round < 7
    res = port_server(_raw("scaffold", 3, fleet=PIPELINED, rounds=7,
                           chaos=chaos, resume_from_checkpoint=True),
                      run_dir)
    res.train()
    assert res.state.round == 7 and not res.preempted
    assert torch.equal(res.state.params, ref.state.params)
    assert torch.equal(res.state.strategy_state["c"],
                       ref.state.strategy_state["c"])
    for u in range(len(ref.train_dataset)):
        a, b = res.fleet_pager.user_row(u), ref.fleet_pager.user_row(u)
        assert (a is None) == (b is None), u
        if a is not None:
            np.testing.assert_array_equal(a["ci"], b["ci"])


def test_paged_personalized_eval_reads_host_rows(tmp_path):
    ds = port_dataset()
    paged = port_server(_raw("personalization", 2, fleet=PIPELINED),
                        str(tmp_path / "paged"), val=True)
    paged.train()
    assert paged.store is None and paged.fleet_pager.has_rows()
    got = paged.personalized_eval(ds)
    assert got is not None and paged.personalized_eval(ds) == got
    resident = port_server(_raw("personalization", 2),
                           str(tmp_path / "resident"), val=True)
    resident.train()
    assert got == resident.personalized_eval(ds)
    summary = paged.fleet_summary()
    assert summary["fleet"]["pool_slots"] == paged.fleet_pager.n_slots
    assert summary["infra_faults"] is None


# ----------------------------------------------------------------------
def _both_raise(raw, tmp_path):
    """The JAX server's and the port's ``ValueError`` on ``raw``."""
    cfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    with pytest.raises(ValueError) as want:
        jax_select_server(cfg.server_config.get("type"))(
            jax_make_task(cfg.model_config), cfg,
            make_synthetic_classification(), model_dir=str(tmp_path / "j"),
            mesh=make_mesh(num_devices=1), seed=7)
    with pytest.raises(ValueError) as got:
        port_server(raw, str(tmp_path / "p"))
    return str(got.value), str(want.value)


@pytest.mark.parametrize("case", ["floor", "device_tables"])
def test_paged_refusals_match_jax(case, tmp_path):
    if case == "floor":
        raw = _raw("scaffold", 3, fleet={"page_pool_slots": 4})
        needle = "in-flight floor"
    else:
        raw = _raw("scaffold", 0, fleet=PIPELINED,
                   scaffold_device_controls=True)
        needle = "scaffold_device_controls"
    got, want = _both_raise(raw, tmp_path)
    assert got == want and needle in got


def test_pager_refuses_strategy_without_carry_tables(tmp_path):
    from msrflute_tpu.engine.paging import CarryPager as JaxCarryPager
    from msrflute_tpu.strategies.fedavg import FedAvg as JaxFedAvg
    from msrflute_tpu_torch.resilience.integrity import DurableIOLadder
    from msrflute_tpu_torch.strategies.fedavg import FedAvg
    raw = _raw("fedavg", 0)
    with pytest.raises(ValueError, match="carry_tables") as want:
        JaxCarryPager(JaxFedAvg(JaxFLUTEConfig.from_dict(copy.deepcopy(raw))),
                      {}, slots=8, mesh=make_mesh(num_devices=1))
    with pytest.raises(ValueError, match="carry_tables") as got:
        CarryPager(FedAvg(FLUTEConfig.from_dict(copy.deepcopy(raw))), {},
                   slots=8, store_dir=str(tmp_path),
                   ladder=DurableIOLadder())
    assert str(got.value) == str(want.value)


def test_million_users_pool_stays_o_cohort(tmp_path):
    """A 10^6-user population under chaos, bucketing and a depth-3 ring:
    the pool is the default O(cohort) one, never O(N)."""
    from msrflute_tpu_torch.data.fleet import SyntheticFleetDataset
    from msrflute_tpu_torch.engine import OptimizationServer
    ds = SyntheticFleetDataset(1_000_000, cache_users=64)
    raw = _raw("scaffold", 3, fleet=PIPELINED, rounds=3,
               num_clients_per_iteration=16, val_freq=1000,
               cohort_bucketing={"max_buckets": 2},
               chaos={"enable": True, "seed": 5, "dropout_rate": 0.1,
                      "straggler_rate": 0.1})
    cfg = FLUTEConfig.from_dict(raw)
    server = OptimizationServer(make_task(cfg.model_config), cfg, ds,
                                model_dir=str(tmp_path), device="cpu",
                                seed=0)
    slots = server.fleet_pager.n_slots
    assert slots == 128   # pow2_ceil(2 * 16 * (3 + 1))
    server.train()
    assert server.state.round == 3
    for k in server.strategy.carry_tables:
        assert int(server.state.strategy_state[k].shape[0]) == slots
    desc = server.fleet_summary()["fleet"]
    assert desc["misses"] > 0 and desc["writeback_rows"] > 0
    assert desc["hbm_bytes_per_device"] == \
        slots * server.fleet_pager.row_bytes()
    assert ds.cache_stats()["misses"] > 0


def test_paged_dispatch_without_slots_raises_as_jax(tmp_path):
    """A paged round handed a batch the pager did not prepare raises the
    JAX ``_batch_slots`` error instead of gathering by client id."""
    from msrflute_tpu.engine.round import RoundEngine as JaxRoundEngine
    from msrflute_tpu_torch.data.batching import pack_round_batches
    server = port_server(_raw("scaffold", 0, fleet=SERIAL), str(tmp_path))
    batch = pack_round_batches(server.train_dataset, [0, 1, 2, 3], 4, 2,
                               rng=np.random.default_rng(0))
    with pytest.raises(ValueError) as want:
        JaxRoundEngine._batch_slots(batch)
    with pytest.raises(ValueError) as got:
        server.engine.stage_inputs(0, [batch])
    assert str(got.value) == str(want.value)
    server.fleet_pager.prepare_chunk([batch], server.state.strategy_state)
    assert batch.carry_slots.tolist() == [0, 1, 2, 3]
    staged = server.engine.stage_inputs(0, [batch])[0]
    assert staged["carry_ids"].tolist() == [0, 1, 2, 3]
