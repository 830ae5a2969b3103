"""Secure aggregation in the port (``msrflute_tpu_torch/strategies/
secure_agg.py``) against the JAX package's ``strategies/secure_agg.py``:

- the decode: bitwise against JAX's ``combine_parts`` on the same int32
  sums (the whole int32 range, weight sums from 1e-3 to 1e3);
- the fixed-point encoding: bitwise against the JAX expression (clip, then
  weight, then round half to even, then int32; NaN encodes as 0, as XLA
  converts it);
- the mask graph: the port's ``_log_offsets`` equal JAX's;
- telescoping (the port's twin of ``tests/test_secagg_compose.py:98-140``):
  masked rows summed in the int32 group, then ``cancel_masks``, equal the
  plain wrapped sum of the survivors' encodings bitwise, for both graphs,
  for survivor sets with dropout and with quarantine loss, with encodings
  near +-2^31 so that the sums wrap; a round with no loss derives no
  residual mask;
- trajectories: the port's CLI (``-device cpu``) against the JAX server on
  the LR blob of ``test_torch_strategies.py``, 6 rounds, ``graph: full``
  and ``graph: log`` (with ``min_survivors``), under chaos dropout,
  stragglers and corruption screened by the mean shield (so that
  quarantine is a loss cause too): val loss ``rel 1e-5``, accuracy to one
  val sample, the chaos, quarantine and recovery counters and the aborted
  rounds equal round for round.  The JAX secure_agg trajectory compiles in
  a few seconds at K <= 6 on the LR model, so it is run itself;
- a run cut after round 2 and resumed to 4 equals the uninterrupted run
  bit for bit (chaos plus secure_agg, on the CPU).
"""

import copy
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.strategies.secure_agg import SecureAgg as JaxSecureAgg
from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.strategies.secure_agg import SecureAgg, wrap_int32
from test_torch_chaos import (CHAOS, assert_defense_trajectory,
                              defense_histories, lr_blob)  # noqa: F401
from test_torch_strategies import lr_config


def _both(options=None, k=4):
    raw = lr_config("secure_agg", server={"secure_agg": options or {},
                                          "num_clients_per_iteration": k})
    return (SecureAgg(FLUTEConfig.from_dict(copy.deepcopy(raw))),
            JaxSecureAgg(JaxFLUTEConfig.from_dict(copy.deepcopy(raw)), None))


@pytest.mark.parametrize("frac_bits", [1, 12, 24])
def test_decode_matches_jax_bitwise(frac_bits):
    ours, theirs = _both({"frac_bits": frac_bits, "clip": 0.001})
    rng = np.random.default_rng(frac_bits)
    enc = rng.integers(-2 ** 31, 2 ** 31, size=4096, dtype=np.int64)
    enc[:6] = [2 ** 31 - 1, -2 ** 31, 0, -1, 32767, -32768]
    enc = enc.astype(np.int32)
    for w_sum in (1e-3, 0.7, 1.0, 37.5, 1234.5):
        want = theirs.combine_parts(
            {"default": {"grad_sum": {"w": jnp.asarray(enc)},
                         "weight_sum": jnp.float32(w_sum)}},
            None, (), None, 4.0)[0]["w"]
        got, _ = ours.combine_parts(
            {"default": {"grad_sum": torch.from_numpy(enc),
                         "weight_sum": torch.tensor(w_sum,
                                                    dtype=torch.float32)}},
            None, {}, 0, 4.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_encode_matches_the_jax_expression():
    ours, theirs = _both({"clip": 2.5, "frac_bits": 14})
    rng = np.random.default_rng(0)
    pg = (rng.normal(size=(5, 300)) * 2).astype(np.float32)
    pg[0, :4] = [np.nan, np.inf, -np.inf, 0.5 / 2 ** 14]   # ties round even
    w = np.array([1.0, 100.0, 0.0, 3.5, 17.25], np.float32)
    scale = jnp.float32(1 << theirs.frac_bits)
    want = np.stack([np.asarray(jnp.round(
        jnp.clip(jnp.asarray(pg[k]), -theirs.clip, theirs.clip)
        * jnp.float32(w[k]) * scale).astype(jnp.int32)) for k in range(5)])
    got = ours.encode(torch.from_numpy(pg), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 10, 17])
def test_log_offsets_match_jax(k):
    assert SecureAgg._log_offsets(k) == JaxSecureAgg._log_offsets(k)


def _wrapped_sum(rows):
    return wrap_int32(rows.to(torch.int64).sum(0))


LOSSES = {
    # (sampled, live after dropout, survivors after quarantine)
    "none": ([1, 1, 1, 1, 1, 0], [1, 1, 1, 1, 1, 0], [1, 1, 1, 1, 1, 0]),
    "dropout": ([1, 1, 1, 1, 1, 0], [1, 0, 1, 0, 1, 0], [1, 0, 1, 0, 1, 0]),
    "quarantine": ([1, 1, 1, 1, 1, 0], [1, 1, 1, 1, 1, 0],
                   [1, 1, 0, 1, 0, 0]),
    "both": ([1, 1, 1, 1, 1, 0], [0, 1, 1, 1, 1, 0], [0, 1, 1, 0, 1, 0]),
    "one_left": ([1, 1, 1, 1, 1, 0], [0, 0, 1, 1, 0, 0],
                 [0, 0, 1, 0, 0, 0]),
}


@pytest.mark.parametrize("loss", sorted(LOSSES))
@pytest.mark.parametrize("graph", ["full", "log"])
def test_masked_sum_telescopes_to_the_survivors_sum(graph, loss):
    strat, _ = _both({"graph": graph}, k=6)
    ids = np.array([7, 3, 11, 0, 5, -1])
    sampled, live, surv = (np.asarray(m, np.float32) for m in LOSSES[loss])
    rng = np.random.default_rng(1)
    enc = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(6, 257),
                                        dtype=np.int64).astype(np.int32))
    enc[:, :3] = torch.tensor([2 ** 31 - 1, -2 ** 31, 2 ** 31 - 7],
                              dtype=torch.int32)
    enc[5] = 0                                  # the padding slot
    masked = strat.mask_rows(enc, ids, sampled, torch.from_numpy(live), 9)
    assert not torch.equal(masked[0], enc[0]) or live[0] == 0
    # quarantine zeroes the survivor mask's dropouts
    keep = torch.from_numpy(surv)[:, None] > 0
    total = _wrapped_sum(torch.where(keep, masked, torch.zeros_like(masked)))
    got = strat.cancel_masks(total, ids, sampled, surv, 9)
    want = _wrapped_sum(enc * torch.from_numpy(surv).to(torch.int32)[:, None])
    assert torch.equal(got, want)
    if loss == "none":
        assert got is total            # nothing re-derived
        # and the masks did hide the rows
        assert not torch.equal(masked[:5], enc[:5])


def test_wrap_int32_is_the_two_complement_wrap():
    x = torch.tensor([2 ** 31, -2 ** 31 - 1, 2 ** 32 + 5, -5, 3 * 2 ** 31],
                     dtype=torch.int64)
    assert wrap_int32(x).tolist() == [-2 ** 31, 2 ** 31 - 1, 5, -5, -2 ** 31]
    assert (torch.tensor([-5, -2 ** 31, 2 ** 31 - 1], dtype=torch.int32)
            >> 15).tolist() == [-1, -65536, 65535]


# ----------------------------------------------------------------------
TRAJECTORIES = {
    "full": {"graph": "full"},
    "log": {"graph": "log", "min_survivors": 4},
}


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_cli_trajectory_under_chaos_matches_jax(name, lr_blob, tmp_path,
                                                monkeypatch):
    raw = lr_config("secure_agg", server={
        "chaos": CHAOS, "robust": {"norm_multiplier": 5.0},
        "secure_agg": TRAJECTORIES[name],
        "num_clients_per_iteration": 6 if name == "log" else 4})
    got, want, n_val, port, jax_m, server = defense_histories(
        raw, lr_blob, tmp_path, monkeypatch)
    assert_defense_trajectory(got, want, n_val, port, jax_m)
    # every chaos-dropped client was recovered, and quarantine was a
    # loss cause as well
    assert port["SecAgg recovered (dropout)"] == \
        port["Chaos dropped clients"]
    assert sum(v for _, v in port["SecAgg recovered (quarantine)"]) > 0
    counters = server.strategy.counters
    assert counters["recovered_dropout"] == sum(
        v for _, v in port["Chaos dropped clients"])
    if name == "log":
        aborted = [s for s, v in port["SecAgg aborted round"] if v]
        assert 0 < len(aborted) < 6 and \
            counters["aborted_rounds"] == len(aborted)


def _cli(raw, data_dir, out):
    from msrflute_tpu_torch import e2e_trainer
    out.mkdir(exist_ok=True)
    cfg = out / f"cfg{raw['server_config']['max_iteration']}.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    return e2e_trainer.main(["-config", str(cfg), "-dataPath", data_dir,
                             "-outputPath", str(out / "run"), "-device",
                             "cpu"])


def test_resumed_run_is_bitwise_the_uninterrupted_one(lr_blob, tmp_path):
    raw = lr_config("secure_agg", rounds=4, server={
        "chaos": CHAOS, "robust": {"norm_multiplier": 5.0},
        "secure_agg": {"graph": "log"}})
    whole = _cli(raw, lr_blob, tmp_path / "whole")
    cut = copy.deepcopy(raw)
    cut["server_config"]["max_iteration"] = 2
    _cli(cut, lr_blob, tmp_path / "cut")
    raw["server_config"]["resume_from_checkpoint"] = True
    resumed = _cli(raw, lr_blob, tmp_path / "cut")
    assert resumed.state.round == 4
    assert torch.equal(resumed.state.params, whole.state.params)
    with open(tmp_path / "whole" / "run" / "log" / "metrics.jsonl") as fh:
        want = [json.loads(line) for line in fh]
    with open(tmp_path / "cut" / "run" / "log" / "metrics.jsonl") as fh:
        got = [json.loads(line) for line in fh]

    def tail(records):
        return [(r["name"], r["value"]) for r in records
                if r.get("step", -1) >= 2 and r.get("name", "").startswith(
                    ("SecAgg", "Chaos", "Quarantined"))]
    assert tail(got) == tail(want)
