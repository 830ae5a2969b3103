"""Cross-client megabatching in the port (``msrflute_tpu_torch/data/
batching.py::megabatch_lanes`` / ``plan_megabatch``, ``engine/
client_update.py::build_mega_update``, the analytic gate in
``engine/server.py::_pack_bucketed_round``) against the JAX package's
(``data/batching.py:504-663``, ``engine/client_update.py:340-586``,
``engine/server.py:574-603, 2245-2297``):

- the lane and tape planners equal the JAX functions;
- the lane scan equals the vmap arm bitwise at ``num_epochs`` 1, dropout
  included, and on rng-free models at every ``num_epochs``; through the
  server under FedAvg, FedBuff, fused SCAFFOLD / EF / personalization and
  chaos (with and without a ``robust`` block);
- the megabatch CLI run against the JAX package's at ``rtol 1e-5, atol
  1e-7``;
- the analytic gate's fallback (counted ``megabatch_fallback`` events,
  the vmap arm bitwise), the utilization meter, and every refusal of the
  JAX package.
"""

import copy
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from msrflute_tpu.data import batching as jb
from msrflute_tpu_torch.config import FLUTEConfig, SchemaError
from msrflute_tpu_torch.data import batching as pb
from msrflute_tpu_torch.engine.client_update import (ClientHParams,
                                                     build_client_update,
                                                     build_mega_update)
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.config import ModelConfig, OptimizerConfig
from test_torch_cohort_bucketing import (BUCKETS, assert_cli_matches,
                                         cli_config, hetero_blob, jax_server,
                                         port_run, port_server, raw_cfg)

MEGA = {"enable": True}


def _needs(seed, n=12):
    return np.random.default_rng(seed).integers(1, 9, size=n)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kw", [
    {}, {"lanes": 3}, {"slack": 2.0}, {"quantum": 2}, {"epochs": 3},
    {"caps": True}], ids=["auto", "pinned", "slack", "quantum", "epochs",
                          "caps"])
def test_megabatch_lanes_equal_the_jax_function(seed, kw):
    needs = np.random.default_rng(seed).integers(1, 40, size=60)
    bounds = jb.bucket_boundaries(needs, 3, 32)
    caps = jb.bucket_capacities(needs, bounds, 12) if kw.get("caps") \
        else None
    args = (needs, bounds, 12, kw.get("epochs", 1))
    opts = dict(quantum=kw.get("quantum", 1), slack=kw.get("slack", 1.25),
                lanes=kw.get("lanes"), caps=caps)
    assert pb.megabatch_lanes(*args, **opts) == jb.megabatch_lanes(*args,
                                                                   **opts)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("epochs,lanes,shards", [
    (1, 2, 1), (1, 4, 2), (2, 3, 1), (3, 2, 2), (1, 1, 1)])
def test_plan_megabatch_equals_the_jax_function(seed, epochs, lanes,
                                                shards):
    needs = _needs(seed)
    cap = 4 * shards
    got = pb.plan_megabatch(needs, epochs, lanes, 8, shards, cap)
    want = jb.plan_megabatch(needs, epochs, lanes, 8, shards, cap)
    assert len(got) == len(want)
    for (rows, tape), (wrows, wtape) in zip(got, want):
        assert rows == wrows
        np.testing.assert_array_equal(tape.ptr, wtape.ptr)
        np.testing.assert_array_equal(tape.seg, wtape.seg)
        assert (tape.lanes, tape.depth, tape.shards, tape.entries) == \
            (wtape.lanes, wtape.depth, wtape.shards, wtape.entries)


@pytest.mark.parametrize("args", [(3, 1, 8, 2, 4), (2, 1, 2, 1, 2)],
                         ids=["indivisible", "need_beyond_grid"])
def test_plan_refusals_match_the_jax_function(args):
    lanes, epochs, S, shards, cap = args
    needs = [1, 2, 4]
    with pytest.raises(ValueError) as want:
        jb.plan_megabatch(needs, epochs, lanes, S, shards, cap)
    with pytest.raises(ValueError) as got:
        pb.plan_megabatch(needs, epochs, lanes, S, shards, cap)
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------------------
# the lane scan against the vmap arm
# ----------------------------------------------------------------------
CNN = {"model_type": "CNN_FEMNIST", "num_classes": 62}


def _cnn_grid(needs, S=4, B=2, seed=0):
    rng = np.random.default_rng(seed)
    K = len(needs)
    x = rng.integers(0, 255, size=(K, S, B, 28, 28)).astype(np.uint8)
    y = rng.integers(0, 62, size=(K, S, B)).astype(np.int32)
    mask = np.zeros((K, S, B), np.float32)
    for k, n in enumerate(needs):
        mask[k, :n] = 1.0
        mask[k, n - 1, 1:] = 0.0 if k % 2 else 1.0   # a ragged last batch
    return ({"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
            torch.from_numpy(mask))


def _gens(K, seed=5):
    return [torch.Generator().manual_seed(seed + k) for k in range(K)]


@pytest.mark.parametrize("epochs", [1, 2])
def test_lane_scan_equals_the_vmap_arm_with_dropout(epochs):
    """CNN_FEMNIST with its two dropout sites, momentum and a FedProx
    term: every row's pseudo-gradient, loss, sample count and stats bitwise
    at ``num_epochs`` 1; at 2 the dropout streams part, as in the JAX
    package, and only the sample counts stay equal.  As many lanes as grid
    rows (two clients share a lane all the same): the vmapped convolution's
    weight gradient depends on the vmap width on the CPU too
    (``msrflute_tpu_torch/csrc/probes/vmap_width.py``), so only equal
    widths are bitwise."""
    task = make_task(ModelConfig.from_dict(CNN))
    opt = OptimizerConfig.from_dict({"type": "sgd", "lr": 0.05,
                                     "momentum": 0.9})
    hp = ClientHParams(num_epochs=epochs, fedprox_mu=0.01)
    needs = [1, 3, 2, 4, 1]
    arrays, mask = _cnn_grid(needs)
    (rows, tape), = pb.plan_megabatch(needs, epochs, len(needs), 4, 1,
                                      len(needs))
    assert (tape.seg[0] >= 0).sum() > needs[0] * epochs   # lanes shared
    assert rows == list(range(len(needs)))
    flat = task.layout().flatten(task.init_params(0))
    vmap_out = build_client_update(task, opt, hp)(
        flat, arrays, mask, 0.05, _gens(len(needs)))
    mega_out = build_mega_update(task, opt, hp)(
        flat, arrays, mask, 0.05, _gens(len(needs)), tape=tape,
        tape_dev=(torch.from_numpy(tape.ptr), torch.from_numpy(tape.seg)))
    assert torch.equal(mega_out[2], vmap_out[2])
    if epochs > 1:
        assert not torch.equal(mega_out[0], vmap_out[0])
        return
    for a, b in zip(mega_out[:3], vmap_out[:3]):
        assert torch.equal(a, b)
    for key, v in vmap_out[3].items():
        assert torch.equal(mega_out[3][key], v), key


@pytest.mark.parametrize("precision", [None, "bfloat16"])
def test_lane_scan_takes_per_row_starts_and_offsets(precision):
    """A ``[K, P]`` start (FedBuff's stale versions, personalization's
    local models) and a gradient offset (SCAFFOLD's ``c - c_i``) with an
    Adam client optimizer, in float32 and under a 16-bit precision policy
    (params, compute and stats): bitwise the vmap arm."""
    task = make_task(ModelConfig.from_dict(
        {"model_type": "LR", "num_classes": 4, "input_dim": 8}))
    opt = OptimizerConfig.from_dict({"type": "adam", "lr": 0.01})
    hp = ClientHParams(num_epochs=2, param_dtype=precision,
                       compute_dtype=precision, stats_dtype=precision)
    rng = np.random.default_rng(1)
    needs = [2, 1, 3, 1]
    K, S, B = len(needs), 3, 4
    arrays = {"x": torch.from_numpy(rng.normal(size=(K, S, B, 8)).astype(
        np.float32)), "y": torch.from_numpy(rng.integers(
            0, 4, size=(K, S, B)).astype(np.int32))}
    mask = torch.zeros(K, S, B)
    for k, n in enumerate(needs):
        mask[k, :n] = 1.0
    P = task.layout().numel
    start = torch.from_numpy(rng.normal(size=(K, P)).astype(np.float32))
    offset = torch.from_numpy(rng.normal(size=(K, P)).astype(np.float32))
    (_, tape), = pb.plan_megabatch(needs, 2, 3, S, 1, K)
    want = build_client_update(task, opt, hp)(start, arrays, mask, 0.01,
                                              grad_offset=offset)
    got = build_mega_update(task, opt, hp)(
        start, arrays, mask, 0.01, grad_offset=offset, tape=tape,
        tape_dev=(torch.from_numpy(tape.ptr), torch.from_numpy(tape.seg)))
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)


def test_lane_scan_refuses_pallas_apply():
    task = make_task(ModelConfig.from_dict(
        {"model_type": "LR", "num_classes": 4, "input_dim": 8}))
    with pytest.raises(ValueError, match="segment-reset"):
        build_mega_update(task, OptimizerConfig.from_dict({"type": "sgd"}),
                          ClientHParams(pallas_apply=True))


# ----------------------------------------------------------------------
# through the server
# ----------------------------------------------------------------------
def _mega_cfg(mega=MEGA, **kw):
    kw.setdefault("rounds", 6)
    return raw_cfg(BUCKETS, mega=mega, **kw)


@pytest.fixture(scope="module")
def base_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("mgb_base")
    off = port_run(_mega_cfg(None), d / "off")
    on = port_run(_mega_cfg(), d / "on")
    return off, on


def assert_mega_ran(server):
    gate = server.engine.mega_gate
    assert any(arm == "mega" for arm in gate.values()), gate
    util = server.megabatch_utilization
    assert util is not None and 0.0 < util <= 1.0, util


def test_megabatch_matches_vmap_bitwise_e1(base_pair):
    off, on = base_pair
    assert_mega_ran(on)
    assert torch.equal(on.state.params, off.state.params)
    # the meter counts the tape's slots: above the grids' padding
    assert on.padding_efficiency > off.padding_efficiency


def test_megabatch_matches_vmap_bitwise_e2(tmp_path):
    """LR draws no random numbers: bitwise at two epochs too."""
    off = port_run(_mega_cfg(None, epochs=2, rounds=3), tmp_path / "off")
    on = port_run(_mega_cfg(epochs=2, rounds=3), tmp_path / "on")
    assert_mega_ran(on)
    assert torch.equal(on.state.params, off.state.params)


CHAOS = {"enable": True, "seed": 3, "dropout_rate": 0.25,
         "straggler_rate": 0.25}
COMPOSE = {
    "scaffold_fused": dict(strategy="scaffold", fused_carry=True),
    "fedbuff": dict(strategy="fedbuff", fedbuff={"max_staleness": 3}),
    "ef_quant_fused": dict(strategy="ef_quant", fused_carry=True),
    "personalization_fused": dict(strategy="personalization",
                                  fused_carry=True),
    "chaos": dict(chaos=CHAOS),
    "chaos_depth3_shield": dict(pipeline_depth=3, chaos=CHAOS,
                                robust={"enable": True}),
}


@pytest.mark.parametrize("name", sorted(COMPOSE))
def test_megabatch_composes_bitwise(name, tmp_path):
    kw = dict(COMPOSE[name], rounds=4)
    if name == "ef_quant_fused":
        raw_off, raw_on = _mega_cfg(None, **kw), _mega_cfg(**kw)
        for raw in (raw_off, raw_on):
            raw["client_config"].update(quant_bits=4, quant_thresh=0.2)
    else:
        raw_off, raw_on = _mega_cfg(None, **kw), _mega_cfg(**kw)
    off = port_run(raw_off, tmp_path / "off")
    on = port_run(raw_on, tmp_path / "on")
    assert_mega_ran(on)
    assert torch.equal(on.state.params, off.state.params)
    for key, v in off.state.strategy_state.items():
        assert torch.equal(on.state.strategy_state[key], v), key


def test_multigroup_tapes_stay_within_tolerance(base_pair, tmp_path):
    """``lanes: 1`` spills each bucket's cohort into several grids of the
    bucket's shape: the sums reassociate, so the bar is the JAX package's
    ``MEGABATCH_FINAL_LOSS_RTOL`` (``test_megabatch.py:221-234``)."""
    off, _ = base_pair
    on = port_run(_mega_cfg({"enable": True, "lanes": 1}), tmp_path)
    assert_mega_ran(on)
    torch.testing.assert_close(on.state.params, off.state.params,
                               rtol=1e-5, atol=1e-5)


def test_gate_falls_back_to_the_vmap_arm_with_counted_events(base_pair,
                                                             tmp_path):
    """A lane pin above every capacity prices the tape at or above the
    grids: every bucket falls back, each with a ``megabatch_fallback``
    event, and the run is the vmap arm's bit for bit
    (``test_megabatch.py:369-387``)."""
    off, _ = base_pair
    on = port_server(_mega_cfg({"enable": True, "lanes": 999}),
                     tmp_path)
    grids = on._pack_bucketed_round(on._sample())
    events = on.engine.drain_megabatch_events()
    assert events and {ev["kind"] for ev in events} == \
        {"megabatch_fallback"}
    assert {ev["reason"] for ev in events} == {"slots"}
    for ev in events:
        assert ev["tape_groups"] >= ev["grid_groups"] > 0
    assert all(g.mega is None for g in grids)
    on = port_run(_mega_cfg({"enable": True, "lanes": 999}), tmp_path / "r")
    assert torch.equal(on.state.params, off.state.params)
    assert on.megabatch_fallbacks > 0
    assert not any(a == "mega" for a in on.engine.mega_gate.values())
    assert on.megabatch_utilization is None


def test_event_buffer_drains_and_caps(tmp_path):
    server = port_server(_mega_cfg(), tmp_path)
    for i in range(70):
        server.engine.push_megabatch_event({"kind": "megabatch_fallback",
                                            "i": i})
    assert len(server.engine.drain_megabatch_events()) == 64
    assert server.engine.drain_megabatch_events() == []


def test_geometry_equals_the_jax_servers(tmp_path):
    raw = _mega_cfg({"enable": True, "slack": 1.5, "min_gain": 0.2},
                    epochs=2)
    mine = port_server(raw, tmp_path / "p")
    ref = jax_server(raw, tmp_path / "j")
    assert mine.megabatch == ref.megabatch
    for _ in range(2):
        sampled = mine._sample()
        assert sampled == ref._sample()
        got = mine._pack_bucketed_round(sampled)
        want = ref._pack_bucketed_round(sampled)
        assert [g.mega is None for g in got] == [w.mega is None
                                                 for w in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.client_ids, w.client_ids)
            if g.mega is not None:
                np.testing.assert_array_equal(g.mega.ptr, w.mega.ptr)
                np.testing.assert_array_equal(g.mega.seg, w.mega.seg)
    assert mine.megabatch_utilization == pytest.approx(
        ref.megabatch_utilization, rel=1e-12)


@pytest.mark.parametrize("case", ["fedavg", "scaffold_fused"])
def test_megabatch_cli_matches_the_jax_run(case, hetero_blob, tmp_path,
                                           monkeypatch):
    raw = cli_config(**({"fused_carry": True} if case != "fedavg" else {}))
    if case != "fedavg":
        raw["strategy"] = "scaffold"
    raw["server_config"]["megabatch"] = dict(MEGA)
    server, jserver = assert_cli_matches(raw, hetero_blob, tmp_path,
                                         monkeypatch)
    assert_mega_ran(server)
    assert server.megabatch_utilization == pytest.approx(
        jserver.megabatch_utilization, rel=1e-12)


# ----------------------------------------------------------------------
# refusals, as the JAX package's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("raw", [
    raw_cfg(mega=MEGA),
    raw_cfg({"enable": False}, mega=MEGA),
    dict(raw_cfg(BUCKETS, mega=MEGA), strategy="fedlabels"),
    raw_cfg(BUCKETS, mega={"lanes": 0}),
    raw_cfg(BUCKETS, mega={"min_gain": -0.5}),
    raw_cfg(BUCKETS, mega={"autotune": 1}),
], ids=["no_bucketing", "bucketing_off", "fedlabels", "lanes0", "min_gain",
        "autotune"])
def test_schema_refusals_match_the_jax_schema(raw):
    from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
    with pytest.raises(ValueError) as want:
        JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    with pytest.raises(SchemaError) as got:
        FLUTEConfig.from_dict(copy.deepcopy(raw))
    assert got.value.errors == want.value.errors


def _engine_refusal(raw, tmp_path):
    with mock.patch("msrflute_tpu_torch.config.validate"):
        with pytest.raises(ValueError) as got:
            port_server(raw, tmp_path / "port")
    return str(got.value)


def test_engine_refuses_megabatch_without_bucketing(tmp_path):
    raw = raw_cfg(mega=MEGA)
    assert _engine_refusal(raw, tmp_path).startswith(
        "megabatch requires cohort_bucketing")


def test_engine_refuses_megabatch_with_privacy_metrics(tmp_path):
    raw = _mega_cfg()
    raw["privacy_metrics_config"] = {"apply_metrics": True}
    with pytest.raises(ValueError, match="privacy_metrics_") as want:
        jax_server(raw, tmp_path / "j")
    assert _engine_refusal(raw, tmp_path) == str(want.value)


def test_engine_refuses_a_strategy_without_megabatch(tmp_path, monkeypatch):
    from msrflute_tpu.strategies import base as jax_base
    from msrflute_tpu_torch.strategies.base import BaseStrategy
    monkeypatch.setattr(jax_base.BaseStrategy, "supports_megabatch", False)
    monkeypatch.setattr(BaseStrategy, "supports_megabatch", False)
    raw = _mega_cfg()
    with pytest.raises(ValueError, match="does not compose") as want:
        jax_server(raw, tmp_path / "j")
    assert _engine_refusal(raw, tmp_path) == str(want.value)
    from msrflute_tpu_torch.strategies.fedlabels import FedLabels
    assert FedLabels.supports_megabatch is False


def test_engine_refuses_megabatch_with_pallas_apply(tmp_path, monkeypatch):
    # past the JAX package's pallas-needs-a-TPU guard, as its own test does
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    raw = _mega_cfg(megakernel={"pallas_apply": True})
    with pytest.raises(ValueError, match="segment-reset") as want:
        jax_server(raw, tmp_path / "j")
    assert _engine_refusal(raw, tmp_path) == str(want.value)
