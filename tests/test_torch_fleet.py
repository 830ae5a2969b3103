"""Fleet sampling (``server_config.fleet``) in the port
(``msrflute_tpu_torch/data/fleet.py``, ``engine/server.py``) against the
JAX package's ``msrflute_tpu/data/fleet.py`` and server:

- ``floyd_sample``, ``weighted_reservoir_sample`` (over several chunk
  sizes), ``sample_cohort`` in each mode, ``steps_for_array``,
  ``LazyNameList`` and ``SyntheticFleetDataset``'s counts, arrays and
  cache counters: bitwise the JAX package's from the same seeds;
- each sampling mode's server cohorts, draw for draw the JAX server's; a
  ``floyd`` LR run trains;
- ``fleet`` beside ``scaffold_device_controls`` raises the JAX server's
  ``ValueError``; beside a device-carry strategy it is the paged carry
  (``tests/test_torch_paged_carry.py``).
"""

import copy

import numpy as np
import pytest

from msrflute_tpu.data import fleet as jax_fleet
from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.data import fleet
from msrflute_tpu_torch.engine import OptimizationServer
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.tasks import build_task_datasets
from test_torch_default_parity import port_run
from test_torch_strategies import lr_blob, lr_config  # noqa


@pytest.mark.parametrize("population,k", [(10_000, 64), (7, 20), (10**9, 32)])
def test_floyd_sample_matches_jax(population, k):
    got = fleet.floyd_sample(np.random.default_rng(5), population, k)
    want = jax_fleet.floyd_sample(np.random.default_rng(5), population, k)
    assert got == want
    assert len(set(got)) == min(k, population)


@pytest.mark.parametrize("chunk", [3, 64, 65536])
def test_weighted_reservoir_matches_jax(chunk):
    w = np.random.default_rng(1).integers(0, 50, size=500)
    got = fleet.weighted_reservoir_sample(np.random.default_rng(2), w, 40,
                                          chunk=chunk)
    want = jax_fleet.weighted_reservoir_sample(np.random.default_rng(2), w,
                                               40, chunk=chunk)
    assert got == want
    assert all(w[i] > 0 for i in got)


@pytest.mark.parametrize("mode", ["uniform", "floyd", "by_samples"])
def test_sample_cohort_matches_jax(mode):
    ns = np.random.default_rng(0).integers(1, 30, size=300).astype(np.int32)
    rng, jrng = np.random.default_rng(9), np.random.default_rng(9)
    for k in (5, 17, 300, 400):
        got = fleet.sample_cohort(rng, 300, k, mode=mode, num_samples=ns)
        want = jax_fleet.sample_cohort(jrng, 300, k, mode=mode,
                                       num_samples=ns)
        assert [int(i) for i in got] == [int(i) for i in want]
    for mod in (fleet, jax_fleet):
        with pytest.raises(ValueError, match="unknown fleet.sampling"):
            mod.sample_cohort(rng, 10, 2, mode="stratified")
        with pytest.raises(ValueError, match="num_samples"):
            mod.sample_cohort(rng, 10, 2, mode="by_samples")


def test_steps_and_synthetic_population_match_jax():
    ns = np.random.default_rng(3).integers(0, 10**6, size=1000)
    for bs, cap in ((1, None), (20, None), (32, 100)):
        assert np.array_equal(fleet.steps_for_array(ns, bs, cap),
                              jax_fleet.steps_for_array(ns, bs, cap))
    got = fleet.SyntheticFleetDataset(100_000, input_dim=8, cache_users=2)
    want = jax_fleet.SyntheticFleetDataset(100_000, input_dim=8,
                                           cache_users=2)
    assert got.num_samples.dtype == np.int32
    assert np.array_equal(got.num_samples, want.num_samples)
    assert got.user_list[99_999] == want.user_list[99_999] == "u99999"
    assert got.user_list[2:5] == want.user_list[2:5]
    for i in (0, 1, 0, 2, 0, 99_999):
        a, b = got.user_arrays(i), want.user_arrays(i)
        assert np.array_equal(a["x"], b["x"]) and \
            np.array_equal(a["y"], b["y"])
    assert got.cache_stats() == want.cache_stats()


# ----------------------------------------------------------------------
# the server
# ----------------------------------------------------------------------
def _fleet_raw(mode, rounds=3):
    return lr_config("fedavg", rounds=rounds, server={
        "fleet": {"sampling": mode}, "num_clients_per_iteration": 5})


def _jax_server(raw, data_dir, model_dir):
    from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
    from msrflute_tpu.engine import OptimizationServer as JaxServer
    from msrflute_tpu.models import make_task as jax_make_task
    from msrflute_tpu.parallel import make_mesh
    from msrflute_tpu.tasks import build_task_datasets as jax_build_datasets
    cfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    cfg.validate(data_dir)
    task = jax_make_task(cfg.model_config)
    train, _, _ = jax_build_datasets(cfg, task)
    return JaxServer(task, cfg, train, model_dir=model_dir,
                     mesh=make_mesh(num_devices=1), seed=0)


@pytest.mark.parametrize("mode", ["uniform", "floyd", "by_samples"])
def test_server_cohorts_match_jax(mode, lr_blob, tmp_path):
    """Each mode's cohorts, draw for draw the JAX server's from the same
    seed (``uniform`` the numpy trail of a run without the block); a
    ``floyd`` run trains."""
    raw = _fleet_raw(mode)
    jserver = _jax_server(raw, lr_blob, str(tmp_path / "jax"))
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    cfg.validate(lr_blob)
    task = make_task(cfg.model_config)
    train, val, _ = build_task_datasets(cfg, task)
    server = OptimizationServer(task, cfg, train, val_dataset=val,
                                model_dir=str(tmp_path / "port"),
                                device="cpu", seed=0)
    got = [[int(c) for c in server._sample()] for _ in range(6)]
    want = [[int(c) for c in jserver._sample()] for _ in range(6)]
    assert got == want
    plain = np.random.default_rng(0).choice(16, 5, replace=False)
    assert (got[0] == [int(c) for c in plain]) == (mode == "uniform")
    if mode == "floyd":
        run = port_run(raw, lr_blob, tmp_path / "run")
        assert run.state.round == 3
        assert run.history[-1]["loss"] < run.history[0]["loss"]


def _server(raw, tmp_path):
    from test_torch_strategy_config import _dataset
    from msrflute_tpu_torch.data.dataset import ArraysDataset
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    data = _dataset()
    return OptimizationServer(
        make_task(cfg.model_config), cfg,
        ArraysDataset(data.user_list, [data.user_arrays(i)
                                       for i in range(len(data))]),
        model_dir=str(tmp_path), device="cpu", seed=0)


def test_fleet_refusals(tmp_path):
    from test_torch_defense_config import _jax_server
    from test_torch_strategy_config import _with
    raw = _with("scaffold", ("server_config.fleet", {"enable": True}),
                ("server_config.scaffold_device_controls", True))
    with pytest.raises(ValueError) as want:
        _jax_server(raw, tmp_path / "jax")
    with pytest.raises(ValueError) as got:
        _server(raw, tmp_path / "port")
    assert str(got.value) == str(want.value)
    # beside a device-carry strategy it is the paged carry
    # (tests/test_torch_paged_carry.py): accepted, and the pool built
    paged = _with("scaffold", ("server_config.fleet", {"enable": True}),
                  ("server_config.fused_carry", True))
    FLUTEConfig.from_dict(copy.deepcopy(paged))
    server = _server(paged, tmp_path / "paged")
    assert server.fleet_pager is not None
    assert server.strategy.carry_rows == server.fleet_pager.n_slots
    # beside a strategy without carry tables, fused_carry or not, it runs
    for strategy in ("fedavg", "scaffold"):
        server = _server(_with(strategy, (
            "server_config.fleet", {"sampling": "floyd",
                                    "page_pool_slots": 64})), tmp_path)
        assert server._fleet_cfg["sampling"] == "floyd"
