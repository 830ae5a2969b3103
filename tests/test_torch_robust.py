"""fluteshield in the port (``msrflute_tpu_torch/robust/shield.py``,
``strategies/robust.py``) against the JAX package's:

- ``masked_median`` and ``coordinate_median``: bitwise, with NaN and inf
  rows, masked-out clients, all-masked coordinates and even counts;
- ``coordinate_trimmed_mean``: bitwise on the same stacks (the port sums
  the sorted client axis row after row, the order of XLA's reduce, where
  ``torch.sum`` was up to 1.3e-6 relative off);
- ``Shield.screen`` and ``screen_masked``: the same keep masks and
  per-cause counts on stacks whose norms are well separated (the norms'
  reduction order differs by ulps);
- the refusals of ``select_robust_strategy`` and ``RobustFedAvg``;
- trajectories: the port's CLI (``-device cpu``) against the JAX server on
  the LR blob of ``test_torch_strategies.py``, 6 rounds under chaos
  dropout, stragglers and all three corruption modes (K = 4): the
  screened mean, the trimmed mean and the median, val loss ``rel 1e-5``,
  accuracy to one val sample, every chaos and quarantine counter equal
  round for round;
- the firewall: ``robust: {enable: false}`` runs bitwise the rounds of no
  block.
"""

import copy
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.robust.shield import Shield as JaxShield
from msrflute_tpu.robust.shield import masked_median as jax_masked_median
from msrflute_tpu.strategies.fedavg import FedAvg as JaxFedAvg
from msrflute_tpu.strategies.robust import \
    coordinate_median as jax_coordinate_median
from msrflute_tpu.strategies.robust import \
    coordinate_trimmed_mean as jax_trimmed_mean
from msrflute_tpu.strategies.robust import \
    select_robust_strategy as jax_select_robust
from msrflute_tpu.strategies.qffl import QFFL as JaxQFFL
from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.robust import Shield, make_shield, masked_median
from msrflute_tpu_torch.strategies.fedavg import FedAvg
from msrflute_tpu_torch.strategies.qffl import QFFL
from msrflute_tpu_torch.strategies.robust import (RobustFedAvg,
                                                  coordinate_median,
                                                  coordinate_trimmed_mean,
                                                  select_robust_strategy)
from test_torch_chaos import (CHAOS, assert_defense_trajectory,
                              defense_histories, lr_blob, port_cli)  # noqa: F401
from test_torch_strategies import lr_config


def _stack(seed, k, p, nan_rows=(), inf_rows=(), nan_coords=()):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(k, p)).astype(np.float32)
    x[:, : p // 4] = np.round(x[:, : p // 4])     # ties
    for r in nan_rows:
        x[r] = np.nan
    for r in inf_rows:
        x[r, ::2] = np.inf
        x[r, 1::2] = -np.inf
    for r, c in nan_coords:
        x[r, c] = np.nan
    return x


STACKS = {
    "clean_odd": (_stack(0, 7, 33), np.ones(7, np.float32)),
    "clean_even": (_stack(1, 6, 40), np.ones(6, np.float32)),
    "nan_inf_rows": (_stack(2, 8, 24, nan_rows=(1,), inf_rows=(4,)),
                     np.ones(8, np.float32)),
    "masked_and_nan_coords": (
        _stack(3, 9, 20, nan_coords=((0, 3), (2, 3), (5, 7))),
        np.array([1, 0, 1, 1, 0, 1, 1, 0, 1], np.float32)),
    "all_masked": (_stack(4, 5, 12), np.zeros(5, np.float32)),
    "one_kept": (_stack(5, 5, 12, nan_rows=(0,)),
                 np.array([1, 0, 0, 1, 0], np.float32)),
    # every client non-finite at column 0: an empty vote there
    "empty_coordinate": (_stack(6, 4, 10, nan_coords=tuple(
        (r, 0) for r in range(4))), np.ones(4, np.float32)),
}


@pytest.mark.parametrize("name", sorted(STACKS))
def test_coordinate_median_bitwise(name):
    x, keep = STACKS[name]
    want = np.asarray(jax_coordinate_median(jnp.asarray(x),
                                            jnp.asarray(keep)))
    got = coordinate_median(torch.from_numpy(x),
                            torch.from_numpy(keep)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("trim", [0.0, 0.1, 0.25, 0.4])
@pytest.mark.parametrize("name", sorted(STACKS))
def test_coordinate_trimmed_mean_bitwise(name, trim):
    x, keep = STACKS[name]
    want = np.asarray(jax_trimmed_mean(jnp.asarray(x), jnp.asarray(keep),
                                       trim))
    got = coordinate_trimmed_mean(torch.from_numpy(x),
                                  torch.from_numpy(keep), trim).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(STACKS))
def test_masked_median_bitwise(name):
    x, keep = STACKS[name]
    for col in range(min(x.shape[1], 6)):
        v = x[:, col]
        want = np.asarray(jax_masked_median(jnp.asarray(v),
                                            jnp.asarray(keep)))
        got = masked_median(torch.from_numpy(v),
                            torch.from_numpy(keep)).numpy()
        np.testing.assert_array_equal(got, want)


def _screen_inputs(seed):
    """Eight clients whose norms sit far apart: a NaN payload, an inf
    loss, a padding slot, and one 20x outlier among unit-scale rows."""
    rng = np.random.default_rng(seed)
    pg = rng.normal(size=(8, 50)).astype(np.float32)
    pg *= (1.0 + 0.25 * np.arange(8, dtype=np.float32))[:, None]
    pg[2] *= 20.0
    pg[5, 7] = np.nan
    tl = rng.random(8).astype(np.float32)
    tl[6] = np.inf
    w = (1.0 + rng.random(8)).astype(np.float32)
    cm = np.ones(8, np.float32)
    cm[7] = 0.0
    return pg, tl, w, cm


@pytest.mark.parametrize("kw", [
    {}, {"norm_multiplier": 0.0}, {"screen_nonfinite": False},
    {"norm_multiplier": 2.0}], ids=str)
def test_screen_keeps_what_jax_keeps(kw):
    pg, tl, w, cm = _screen_inputs(0)
    ours, theirs = Shield(**kw), JaxShield(**kw)
    t = [torch.from_numpy(a) for a in (pg, tl, w, cm)]
    got = [a.numpy() for a in ours.screen(*t)]
    want = [np.asarray(a) for a in theirs.screen(
        {"w": jnp.asarray(pg)}, jnp.asarray(tl), jnp.asarray(w),
        jnp.asarray(cm), lambda v: v)]
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g, wv)
    norms = np.sqrt(np.sum(pg.astype(np.float64) ** 2, axis=1)).astype(
        np.float32)
    got = [a.numpy() for a in ours.screen_masked(
        torch.from_numpy(norms), *t[1:])]
    want = [np.asarray(a) for a in theirs.screen_masked(
        jnp.asarray(norms), jnp.asarray(tl), jnp.asarray(w),
        jnp.asarray(cm), lambda v: v)]
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g, wv)
    if kw == {}:
        keep, q_nonfinite, q_norm = ours.screen(*t)
        assert keep.tolist() == [1, 1, 0, 1, 1, 0, 0, 1]
        assert q_nonfinite.tolist() == [0, 0, 0, 0, 0, 1, 1, 0]
        assert q_norm.tolist() == [0, 0, 1, 0, 0, 0, 0, 0]


def test_zero_median_turns_the_norm_screen_off():
    zeros = torch.zeros(4, 6)
    zeros[1, 0] = 1.0
    keep, _, q_norm = Shield().screen(zeros, torch.zeros(4), torch.ones(4),
                                      torch.ones(4))
    assert keep.tolist() == [1, 1, 1, 1] and not q_norm.any()


@pytest.mark.parametrize("kw", [
    {"aggregator": "krum"}, {"norm_multiplier": 0.5},
    {"trim_fraction": 0.5}], ids=str)
def test_shield_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError):
        JaxShield(**kw)
    with pytest.raises(ValueError):
        Shield(**kw)


def test_make_shield_reads_the_block():
    assert make_shield({}) is None
    assert make_shield({"robust": {"enable": False}}) is None
    shield = make_shield({"robust": {"aggregator": "median"}})
    assert shield.wants_stack and shield.norm_multiplier == 5.0
    assert shield.describe()["aggregator"] == "median"


def _cfgs(strategy, robust, dp=None):
    raw = lr_config(strategy, server={"robust": robust})
    if dp is not None:
        raw["dp_config"] = dp
    # both unvalidated: the constructors' own refusals are under test
    with mock.patch("msrflute_tpu_torch.config.validate"):
        cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    return cfg, JaxFLUTEConfig.from_dict(copy.deepcopy(raw),
                                         validate_schema=False)


def test_select_robust_strategy_matches_jax():
    for agg, cls, jcls in (("median", RobustFedAvg, "RobustFedAvg"),
                           ("trimmed_mean", RobustFedAvg, "RobustFedAvg"),
                           ("mean", FedAvg, "FedAvg")):
        cfg, jcfg = _cfgs("fedavg", {"aggregator": agg})
        assert type(select_robust_strategy(cfg, FedAvg)) is cls
        assert type(jax_select_robust(jcfg, None, JaxFedAvg)).__name__ \
            == jcls
    cfg, jcfg = _cfgs("qffl", {"aggregator": "median"})
    with pytest.raises(ValueError):
        select_robust_strategy(cfg, QFFL)
    with pytest.raises(ValueError):
        jax_select_robust(jcfg, None, JaxQFFL)
    dp = {"enable_local_dp": True, "eps": -1.0, "max_grad": 1.0,
          "adaptive_clipping": {"target_quantile": 0.5}}
    cfg, jcfg = _cfgs("fedavg", {"aggregator": "median"}, dp)
    with pytest.raises(ValueError):
        select_robust_strategy(cfg, FedAvg)
    with pytest.raises(ValueError):
        jax_select_robust(jcfg, jcfg.dp_config, JaxFedAvg)


# ----------------------------------------------------------------------
TRAJECTORIES = {
    "screened_mean": {"norm_multiplier": 5.0},
    "trimmed_mean": {"aggregator": "trimmed_mean", "trim_fraction": 0.25},
    "median": {"aggregator": "median"},
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_cli_trajectory_under_chaos_matches_jax(name, lr_blob, tmp_path,
                                                monkeypatch):
    raw = lr_config("fedavg", server={"chaos": CHAOS,
                                      "robust": TRAJECTORIES[name]})
    got, want, n_val, port, jax_m, server = defense_histories(
        raw, lr_blob, tmp_path, monkeypatch)
    assert_defense_trajectory(got, want, n_val, port, jax_m)
    assert type(server.strategy) is (FedAvg if name == "screened_mean"
                                     else RobustFedAvg)
    # the schedule hit every kind of fault, and the shield caught some
    assert all(sum(v for _, v in port[m]) > 0 for m in (
        "Chaos dropped clients", "Chaos stragglers",
        "Chaos NaN-injected clients", "Chaos scaled clients",
        "Chaos sign-flipped clients", "Quarantined clients (non-finite)",
        "Quarantined clients (norm outlier)"))
    assert server.shield.counters["quarantined_nonfinite"] == sum(
        v for _, v in port["Chaos NaN-injected clients"])
    assert all(np.isfinite(loss) for _, loss, _ in got)


def test_disabled_robust_block_is_bitwise_no_block(lr_blob, tmp_path):
    runs = {}
    for name, block in (("none", None),
                        ("off", {"enable": False, "aggregator": "median"})):
        raw = lr_config("fedavg", rounds=3)
        if block is not None:
            raw["server_config"]["robust"] = block
        server, records = port_cli(raw, lr_blob, tmp_path / name)
        assert server.shield is None
        runs[name] = (server.state.params.clone(), records)
    assert torch.equal(runs["off"][0], runs["none"][0])
    assert runs["off"][1] == runs["none"][1]
