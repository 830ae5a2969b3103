"""The infrastructure-fault plane in the port (``server_config.chaos.infra``,
``msrflute_tpu_torch/resilience/chaos.py::InfraFaults`` and
``resilience/integrity.py::DurableIOLadder``) against the JAX package's, the
twin of ``tests/test_resilience.py:194-440``:

- each surface's stream is deterministic, independent of the other
  surfaces' rates, and draw for draw the JAX ``InfraFaults``'s;
- the ladder's degradation table (escalate, raise, drop) with the JAX
  messages;
- ``infra`` without the paged carry raises the JAX ``ValueError``, from
  ``config.validate`` and from the server;
- faults on every surface of a paged SCAFFOLD run are absorbed with params
  bitwise the clean run's, each failed attempt one ``store_io_fault``
  record, and the counters the JAX server's on the same config;
- a dying prefetch worker degrades the run to the cold path, bitwise.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from conftest import make_synthetic_classification
from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.engine import OptimizationServer as JaxServer
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu.resilience import chaos as jax_chaos
from msrflute_tpu.resilience import integrity as jax_integrity
from msrflute_tpu_torch.config import INFRA_NEEDS_PAGING, FLUTEConfig
from msrflute_tpu_torch.resilience.chaos import InfraFaults, make_chaos
from msrflute_tpu_torch.resilience.integrity import (
    CheckpointEscalationError, DurableIOError, DurableIOLadder, RetryPolicy)
from test_torch_fused_carry import port_server, raw_config

SURFACES = ("store_write", "store_read", "prefetch", "writer", "writeback")
#: a 2-row host cache: spill-through and store reads at this size
FLEET = {"enable": True, "host_cache_rows": 2, "spill_freq": 1}
INFRA = {"seed": 3, "infra": {
    "store_write_error_rate": 0.25, "store_read_error_rate": 0.15,
    "prefetch_delay_rate": 0.3, "prefetch_delay_s": 0.001,
    "writeback_error_rate": 0.3}}
NO_BACKOFF = {"backoff_base_s": 0.0, "jitter": 0.0}


def _raw(depth=0, chaos=None, fleet=FLEET, rounds=4):
    raw = raw_config("scaffold", depth=depth, rounds=rounds,
                     checkpoint_retry=dict(NO_BACKOFF))
    if fleet is not None:
        raw["server_config"]["fleet"] = dict(fleet)
    if chaos is not None:
        raw["server_config"]["chaos"] = copy.deepcopy(chaos)
    return raw


def _rates(**over):
    rates = {"store_write_error_rate": 0.5, "store_read_error_rate": 0.2,
             "prefetch_error_rate": 0.3, "prefetch_delay_rate": 0.5,
             "prefetch_delay_s": 0.01, "writer_error_rate": 0.4,
             "writeback_error_rate": 0.6}
    rates.update(over)
    return rates


# ----------------------------------------------------------------------
@pytest.mark.parametrize("surface", SURFACES)
def test_infra_stream_is_the_jax_stream(surface):
    got, want = InfraFaults(seed=2, **_rates()), \
        jax_chaos.InfraFaults(seed=2, **_rates())
    seq = [got.fault(surface) for _ in range(64)]
    assert seq == [want.fault(surface) for _ in range(64)]
    assert any(seq) and not all(seq)
    assert got.counters == want.counters
    assert got.counters[f"{surface}_faults"] == float(sum(seq))
    # another surface's rate never moves this one's schedule
    other = InfraFaults(seed=2, **_rates(store_read_error_rate=0.9,
                                         writer_error_rate=0.0))
    if surface in ("store_read", "writer"):
        return
    assert [other.fault(surface) for _ in range(64)] == seq


def test_infra_delay_hooks_and_ranges_match_jax():
    got, want = InfraFaults(seed=2, **_rates()), \
        jax_chaos.InfraFaults(seed=2, **_rates())
    delays = [got.prefetch_delay() for _ in range(32)]
    assert delays == [want.prefetch_delay() for _ in range(32)]
    assert any(d > 0 for d in delays) and not all(d > 0 for d in delays)
    assert got.counters == want.counters
    assert got.describe() == want.describe()
    assert InfraFaults(seed=0).hook("writer") is None
    for cls in (InfraFaults, jax_chaos.InfraFaults):
        with pytest.raises(OSError, match="writer") as info:
            cls(seed=0, writer_error_rate=1.0).hook("writer")()
        assert "injected writer infra fault #1" in str(info.value)
        with pytest.raises(ValueError, match="store_read_error_rate"):
            cls(store_read_error_rate=1.5)


def test_make_chaos_and_validate_read_the_infra_block():
    sched = make_chaos({"chaos": {"seed": 1, "infra": {
        "store_write_error_rate": 0.5}}})
    assert sched.has_infra_faults and sched.describe()["infra"]["enabled"]
    inert = make_chaos({"chaos": {"dropout_rate": 0.1, "infra": {
        "store_write_error_rate": 0.0}}})
    assert not inert.has_infra_faults
    # accepted beside the paged carry; refused at load when malformed
    FLUTEConfig.from_dict(_raw(chaos=INFRA))
    for infra, needle in ((5, "infra"),
                          ({"store_write_error_rate": 2.0},
                           "store_write_error_rate"),
                          ({"store_wirte_error_rate": 0.1}, "unknown")):
        with pytest.raises(ValueError, match=needle):
            FLUTEConfig.from_dict(_raw(chaos={"infra": infra}))


def test_durable_ladder_degradation_table():
    pol = RetryPolicy(retries=2, backoff_base_s=0.0, backoff_max_s=0.0,
                      jitter=0.0, escalation_threshold=2)
    lad = DurableIOLadder(policy=pol)
    events = []
    lad.event = lambda kind, **f: events.append((kind, f))

    def boom():
        raise OSError("disk on fire")

    assert lad.run(lambda: None, surface="store_write") is True
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise OSError("blip")
    assert lad.run(flaky, surface="store_write", what="row 3 spill") is True
    assert [k for k, _ in events] == ["store_io_fault"]
    assert events[0][1]["surface"] == "store_write"
    assert "row 3 spill" in events[0][1]["what"]
    jpol = jax_integrity.RetryPolicy(retries=2, backoff_base_s=0.0,
                                     backoff_max_s=0.0, jitter=0.0,
                                     escalation_threshold=2)
    jlad = jax_integrity.DurableIOLadder(policy=jpol)
    for surface in ("store_read", "writeback"):
        with pytest.raises(DurableIOError, match=surface) as got:
            lad.run(boom, surface=surface, what="x")
        with pytest.raises(jax_integrity.DurableIOError) as want:
            jlad.run(boom, surface=surface, what="x")
        assert str(got.value) == str(want.value)
    before = len(events)
    assert lad.run(boom, surface="writer") is False
    assert len(events) == before
    assert lad.run(boom, surface="marker") is False
    with pytest.raises(CheckpointEscalationError):
        lad.run(boom, surface="marker")
    lad2 = DurableIOLadder(policy=pol)
    assert lad2.run(boom, surface="marker") is False
    assert lad2.run(lambda: None, surface="marker") is True
    assert lad2.escalators["marker"].consecutive == 0
    assert set(DurableIOLadder.MODES.items()) == \
        set(jax_integrity.DurableIOLadder.MODES.items())


def test_infra_refused_without_the_paged_carry(tmp_path):
    raw = _raw(chaos={"infra": {"store_write_error_rate": 0.1}}, fleet=None)
    cfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    with pytest.raises(ValueError) as want:
        JaxServer(jax_make_task(cfg.model_config), cfg,
                  make_synthetic_classification(),
                  model_dir=str(tmp_path / "jax"),
                  mesh=make_mesh(num_devices=1), seed=0)
    assert str(want.value) == INFRA_NEEDS_PAGING
    with pytest.raises(ValueError) as got:
        FLUTEConfig.from_dict(copy.deepcopy(raw))
    assert str(got.value) == INFRA_NEEDS_PAGING
    from unittest import mock
    with mock.patch("msrflute_tpu_torch.config.validate"):
        with pytest.raises(ValueError) as got:
            port_server(raw, str(tmp_path / "port"))
    assert str(got.value) == INFRA_NEEDS_PAGING


def _jax_counters(raw, tmp_path):
    cfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    server = JaxServer(jax_make_task(cfg.model_config), cfg,
                       make_synthetic_classification(),
                       model_dir=str(tmp_path), mesh=make_mesh(num_devices=1),
                       seed=7)
    server.train()
    return dict(server.chaos.infra.counters), server.fleet_pager.describe()


def test_infra_faults_absorbed_bitwise_and_counted_as_jax(tmp_path):
    clean = port_server(_raw(), str(tmp_path / "clean"))
    clean.train()
    faulty = port_server(_raw(chaos=INFRA), str(tmp_path / "faulty"))
    faulty.train()
    counters = faulty.chaos.infra.counters
    for key in ("store_write_faults", "store_read_faults",
                "writeback_faults"):
        assert counters[key] > 0, key
    assert torch.equal(clean.state.params, faulty.state.params)
    assert torch.equal(clean.state.strategy_state["c"],
                       faulty.state.strategy_state["c"])
    records = [e for e in faulty.metrics.events
               if e["event"] == "store_io_fault"]
    assert len(records) == counters["store_write_faults"] + \
        counters["store_read_faults"] + counters["writeback_faults"]
    want, jdesc = _jax_counters(_raw(chaos=INFRA), tmp_path / "jax")
    assert counters == want
    summary = faulty.fleet_summary()
    assert summary["infra_faults"] == {k: float(v) for k, v in
                                       sorted(want.items())}
    assert summary["fleet"]["spilled_rows"] == jdesc["spilled_rows"] > 0


def test_prefetch_death_degrades_to_the_cold_path(tmp_path):
    clean = port_server(_raw(depth=2, fleet={"enable": True}),
                        str(tmp_path / "clean"))
    clean.train()
    faulty = port_server(_raw(depth=2, fleet={"enable": True}, chaos={
        "seed": 1, "infra": {"prefetch_error_rate": 1.0}}),
        str(tmp_path / "faulty"))
    faulty.train()
    pager = faulty.fleet_pager
    assert pager.prefetch_degradations == 1 and not pager.prefetch_enabled
    degraded = [e for e in faulty.metrics.events
                if e["event"] == "prefetch_degraded"]
    assert len(degraded) == 1 and "error" in degraded[0]
    assert degraded[0]["thread"] == "fleet-prefetch"
    assert torch.equal(clean.state.params, faulty.state.params)
    assert clean.fleet_pager.describe()["prefetch_hit_rate"] is not None
