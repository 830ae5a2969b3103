"""``server_config.clients_per_chunk`` and ``dump_norm_stats`` in the port
(``msrflute_tpu_torch/engine/round.py``, ``engine/server.py``) against the
JAX package (``engine/round.py:233-240, 1050-1115``,
``engine/server.py:2411-2427``):

- a chunked round against the unchunked one: params ``rel 1e-6`` (L2)
  under FedAvg with chaos faults and corruption, DGA, FedBuff's drawn
  staleness and FedLabels' two parts; secure aggregation's int32 sums
  bitwise; the per-client stats in client order;
- the chunked CLI run against the JAX package's chunked run: val loss
  ``rel 1e-5``, accuracy to one val sample, params ``rtol 1e-5``;
- a chunk that does not divide K raises the JAX ``ValueError``; a chunk of
  K or more runs the unchunked round, bitwise; the client phase, and with
  it kernel B1's optimizer tail, runs once a chunk a local step;
- the refusals beside ``dump_norm_stats``, a carry path, fused RL and a
  ``robust`` block, each a ``ValueError`` in both packages;
- ``norm_stats.txt`` and ``cosines.txt`` line for line against the JAX
  package's at ``rtol 1e-5``, padding clients dropped.
"""

import copy
import json

import jax
import numpy as np
import pytest
import torch

from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.models.convert import from_jax_params
from test_torch_chaos import lr_blob  # noqa: F401
from test_torch_dp_strategies import _jax_run
from test_torch_fused_carry import port_run, raw_config
from test_torch_strategies import (assert_same_trajectory, lr_config,
                                   port_cli_history)
from test_torch_strategy_config import _jax_server, _with

CHAOS = {"seed": 5, "dropout_rate": 0.2, "straggler_rate": 0.3,
         "corrupt_scale_rate": 0.2, "corrupt_sign_flip_rate": 0.1}


def _raw(strategy="fedavg", chunk=None, **server):
    raw = raw_config(strategy, depth=1, fused=False, rounds=3,
                     num_clients_per_iteration=6, **server)
    raw["client_config"]["num_epochs"] = 2
    raw["server_config"]["megakernel"] = {"pallas_apply": True}
    if chunk is not None:
        raw["server_config"]["clients_per_chunk"] = chunk
    return raw


CASES = {
    "fedavg_chaos": dict(chaos=CHAOS),
    "dga": dict(strategy="dga", stale_prob=0.3),
    "fedbuff": dict(strategy="fedbuff", fedbuff={"max_staleness": 3}),
    "fedlabels": dict(strategy="fedlabels"),
    "secure_agg": dict(strategy="secure_agg", chaos={"seed": 2,
                                                     "dropout_rate": 0.3}),
}


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) /
                 torch.linalg.vector_norm(b))


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_round_matches_the_unchunked_round(case, tmp_path):
    kw = dict(CASES[case])
    strategy = kw.pop("strategy", "fedavg")
    whole = port_run(_raw(strategy, **kw), str(tmp_path / "whole"))
    chunked = port_run(_raw(strategy, chunk=2, **kw),
                       str(tmp_path / "chunked"))
    assert chunked.engine.clients_per_chunk == 2
    # the optimizer tail (kernel B1 on a card) once a chunk a local step
    assert chunked.engine.local_steps == 3 * whole.engine.local_steps
    if case == "secure_agg":
        assert torch.equal(chunked.state.params, whole.state.params)
    else:
        assert _rel(chunked.state.params, whole.state.params) <= 1e-6
    for key, v in whole.state.strategy_state.items():
        assert _rel(chunked.state.strategy_state[key], v) <= 1e-6, key
    if case == "fedavg_chaos":
        assert chunked.chaos.counters == whole.chaos.counters


def test_per_client_stats_come_back_in_client_order(tmp_path, monkeypatch):
    """A per-client ``[K]`` stat (here each payload's norm, put where the
    attack metrics go) of a chunked round equals the unchunked round's,
    client for client."""
    from msrflute_tpu_torch.strategies.base import BaseStrategy

    def norms(self, pg, weight, stats, *args):
        stats["privacy_dropped"] = torch.linalg.vector_norm(pg, dim=1)
        return weight

    monkeypatch.setattr(BaseStrategy, "_apply_privacy_metrics", norms)
    got = {}
    for name, chunk in (("whole", None), ("chunked", 2)):
        from test_torch_fused_carry import port_server
        server = port_server(_raw(chunk=chunk, chaos=CHAOS),
                             str(tmp_path / name))
        batch = server._pack_chunk(1)[0]
        _, stats = server.engine.run_round(
            server.state, batch, 0.2, 1.0,
            chaos=server.chaos_vectors(0, batch))
        got[name] = stats["privacy"]["privacy_dropped"]
    assert got["whole"].shape == (6,)
    np.testing.assert_allclose(got["chunked"], got["whole"], rtol=1e-6)
    assert len(set(got["whole"].tolist())) == 6


def test_chunked_cli_matches_the_jax_chunked_run(lr_blob, tmp_path,
                                                 monkeypatch):
    raw = lr_config("fedavg", server={"clients_per_chunk": 2},
                    client={"num_epochs": 2})
    init, want, n_val, jserver = _jax_run(raw, lr_blob, str(tmp_path / "j"))
    server, got = port_cli_history(raw, lr_blob, tmp_path / "port", init,
                                   monkeypatch)
    assert_same_trajectory(got, want, n_val)
    task = server.task
    np.testing.assert_allclose(
        server.state.params.numpy(),
        task.layout().flatten(from_jax_params(
            task, jax.device_get(jserver.state.params))).numpy(),
        rtol=1e-5, atol=1e-7)


def test_indivisible_chunk_raises_the_jax_error(tmp_path):
    raw = _with("fedavg", ("server_config.clients_per_chunk", 3),
                ("server_config.num_clients_per_iteration", 4))
    port = None
    try:
        from test_torch_fused_carry import port_server
        port_server(raw, str(tmp_path / "port")).train()
    except ValueError as exc:
        port = str(exc)
    with pytest.raises(ValueError) as jax_err:
        _jax_server(raw, tmp_path / "jax").train()
    assert port == str(jax_err.value)
    assert "must divide the per-shard client grid (4)" in port


@pytest.mark.parametrize("chunk", [6, 8])
def test_chunk_of_k_or_more_runs_unchunked(chunk, tmp_path):
    whole = port_run(_raw(chaos=CHAOS), str(tmp_path / "whole"))
    big = port_run(_raw(chunk=chunk, chaos=CHAOS), str(tmp_path / "big"))
    assert torch.equal(big.state.params, whole.state.params)
    assert big.engine.local_steps == whole.engine.local_steps


REFUSED = {
    "dump_norm_stats": _with("fedavg", ("server_config.clients_per_chunk", 2),
                             ("server_config.dump_norm_stats", True)),
    "carry": _with("scaffold", ("server_config.clients_per_chunk", 2),
                   ("server_config.fused_carry", True)),
    "fused_rl": _with("fedavg", ("server_config.clients_per_chunk", 2),
                      ("server_config.fused_carry", True),
                      ("server_config.wantRL", True),
                      ("server_config.RL", {"minibatch_size": 2})),
    "robust": _with("fedavg", ("server_config.clients_per_chunk", 2),
                    ("server_config.robust", {"norm_multiplier": 3.0})),
    "robust_stack": _with("fedavg", ("server_config.clients_per_chunk", 2),
                          ("server_config.robust", {"aggregator": "median"})),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_match_the_jax_package(name, tmp_path):
    raw = REFUSED[name]
    with pytest.raises(ValueError):
        FLUTEConfig.from_dict(copy.deepcopy(raw))
    with pytest.raises(ValueError):
        _jax_server(raw, tmp_path)
    # the engine refuses it too, past the config gate
    from unittest import mock
    from test_torch_fused_carry import port_server
    with mock.patch("msrflute_tpu_torch.config.validate"):
        with pytest.raises(ValueError):
            port_server(raw, str(tmp_path / "port"))


def _lines(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def test_norm_dumps_match_the_jax_package(lr_blob, tmp_path, monkeypatch):
    """A cohort drawn from a range and packed two rounds a chunk (the JAX
    package pads each round to the chunk's largest cohort; its padding
    clients are dropped from the dump), under chaos faults."""
    raw = lr_config("fedavg", server={
        "dump_norm_stats": True, "num_clients_per_iteration": "2:5",
        "rounds_per_step": 2, "val_freq": 2,
        "chaos": {"seed": 4, "dropout_rate": 0.3,
                  "corrupt_sign_flip_rate": 0.2}})
    init, want, n_val, jserver = _jax_run(raw, lr_blob, str(tmp_path / "j"))
    server, got = port_cli_history(raw, lr_blob, tmp_path / "port", init,
                                   monkeypatch)
    model_dir = tmp_path / "port" / "run" / "models"
    for name in ("norm_stats.txt", "cosines.txt"):
        mine = _lines(model_dir / name)
        ref = _lines(tmp_path / "j" / name)
        assert len(mine) == len(ref) == 6
        for r, (a, b) in enumerate(zip(mine, ref)):
            assert len(a) == len(b) and 2 <= len(a) <= 5, (name, r)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} round {r}")
        if name == "cosines.txt":
            assert all(-1 - 1e-6 <= c <= 1 + 1e-6 for line in mine
                       for c in line)
