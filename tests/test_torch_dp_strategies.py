"""Local DP under FedAC, FedBuff, EF quantization (host round and
``fused_carry``) and FedLabels in the port, against the JAX package:

- clip-only local DP (``eps < 0``) through the port's CLI (``-device cpu``)
  against the JAX server on the LR blob of ``test_torch_strategies.py``,
  from the same initial weights, 6 rounds: val loss ``rel 1e-5``,
  accuracy to one val sample, final params ``rtol 1e-5``;
- the noised arm (``eps >= 0``), statistically: each strategy's client
  step adds normals of the Gaussian mechanism's sigma to the normalized
  payload, from each client's own stream; under EF (both paths) the noise
  is added before the residual and the quantizer (``q + residual' -
  residual`` is the noised payload);
- FedLabels' client step reads neither ``dp_config`` nor
  ``privacy_metrics_config``: a run with them is bitwise the run without,
  in the port and in the JAX package;
- the refusals, each a ``ValueError`` in both packages: adaptive clipping
  under FedAC, FedBuff, FedLabels and EF's carry; DP under q-FFL and
  SCAFFOLD.
"""

import copy
import math

import jax
import numpy as np
import pytest
import torch

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.engine import OptimizationServer as JaxServer
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu.tasks import build_task_datasets as jax_build_datasets
from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params
from msrflute_tpu_torch.strategies import select_strategy
from test_torch_chaos import lr_blob, port_cli  # noqa: F401
from test_torch_strategies import (assert_same_trajectory, lr_config,
                                   port_cli_history)
from test_torch_strategy_config import _jax_server, _with

CLIP_ONLY = {"enable_local_dp": True, "eps": -1.0, "max_grad": 0.5,
             "max_weight": 100.0}
NOISED = {"enable_local_dp": True, "eps": 1.0, "delta": 1e-5,
          "max_grad": 2.0, "max_weight": 100.0}
EF_CLIENT = {"quant_bits": 4, "quant_thresh": 0.2}

LEGS = {
    "fedac": lr_config("fedac", server={"fedac_eta": 0.5,
                                        "fedac_gamma": 1.0}),
    # one history slot: no staleness draw, so the streams decide nothing
    "fedbuff": lr_config("fedbuff", server={"fedbuff": {"max_staleness": 1}}),
    "ef_host": lr_config("ef_quant", client=dict(EF_CLIENT,
                                                 quant_anneal=0.95)),
    "ef_carry": lr_config("ef_quant", server={"fused_carry": True},
                          client=EF_CLIENT),
}


def _jax_run(raw, data_dir, model_dir):
    cfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw))
    cfg.validate(data_dir)
    task = jax_make_task(cfg.model_config)
    train, val, _ = jax_build_datasets(cfg, task)
    server = JaxServer(task, cfg, train, val_dataset=val,
                       model_dir=model_dir, mesh=make_mesh(num_devices=1),
                       seed=0)
    init = jax.device_get(server.state.params)
    history, evaluate = [], server._maybe_eval

    def recording_eval(split, round_no, force=False):
        improved = evaluate(split, round_no, force=force)
        history.append((round_no, server._last_val["loss"].value,
                        server._last_val["acc"].value))
        return improved

    server._maybe_eval = recording_eval
    server.train()
    return init, history, sum(val.num_samples), server


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_clip_only_local_dp_matches_jax(leg, lr_blob, tmp_path,
                                        monkeypatch):
    raw = copy.deepcopy(LEGS[leg])
    raw["dp_config"] = dict(CLIP_ONLY)
    init, want, n_val, jserver = _jax_run(raw, lr_blob, str(tmp_path / "j"))
    jparams = jax.device_get(jserver.state.params)
    server, got = port_cli_history(raw, lr_blob, tmp_path / "port", init,
                                   monkeypatch)
    assert_same_trajectory(got, want, n_val)
    task = server.task
    np.testing.assert_allclose(
        server.state.params.numpy(),
        task.layout().flatten(from_jax_params(task, jparams)).numpy(),
        rtol=1e-5, atol=1e-7)
    assert (server.ef_store is not None) == (leg == "ef_host")
    assert ("res" in server.state.strategy_state) == (leg == "ef_carry")


def _strategy(leg, dp):
    raw = copy.deepcopy(LEGS[leg])
    raw["dp_config"] = dp
    cfg = FLUTEConfig.from_dict(raw)
    strat = select_strategy(cfg.strategy)(cfg)
    strat.task = make_task(cfg.model_config)
    if leg == "ef_carry":
        strat.carry_clients = 8
    return strat, cfg


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_noised_local_dp_has_the_mechanism_sigma(leg):
    strat, _ = _strategy(leg, dict(NOISED))
    K, P = 4, 20_000
    pg = torch.randn(K, P, generator=torch.Generator().manual_seed(0))
    ns = torch.tensor([5.0, 6.0, 7.0, 8.0])

    def client_update(global_flat, arrays, sample_mask, lr, gens,
                      grad_offset=None):
        return pg.clone(), torch.ones(K), ns, {}

    def rngs(tag):
        return [torch.Generator().manual_seed(100 * tag + k)
                for k in range(K)]

    state = strat.init_state(torch.zeros(P))
    kw = dict(client_rngs=rngs, round_idx=0)
    if leg == "ef_carry":
        res = torch.randn(8, P, generator=torch.Generator().manual_seed(1))
        state = {"res": res}
        ids = torch.tensor([3, 0, 6, 1])
        parts, _, _, _, carry = strat.client_step_carry(
            client_update, torch.zeros(P), {}, None, 0.1, None,
            client_ids=ids, live_mask=torch.ones(K), strategy_state=state,
            quant_threshold=0.2, **kw)
        q, w = parts["default"]
        noisy = q + carry["row"] - res[ids]
    else:
        if leg == "fedbuff":
            kw["strategy_state"] = state
        parts, _, _, _ = strat.client_step(client_update, torch.zeros(P),
                                           {}, None, 0.1, **kw)
        noisy, w = parts["default"]
        if leg == "ef_host":
            # the host round's EF step runs on the noised payload
            res = torch.randn(K, P, generator=torch.Generator().manual_seed(1))
            q, new_res = strat.ef_step(noisy, res, 0.2)
            torch.testing.assert_close(q + new_res - res, noisy, rtol=0,
                                       atol=1e-4)
    assert torch.equal(w, ns)                     # no weight noise
    sigma = math.sqrt(2 * math.log(1.25 / 1e-5)) * 2.0 / 1.0
    normed = 2.0 * pg / torch.linalg.vector_norm(pg, dim=1, keepdim=True)
    noise = (noisy - normed).double()
    assert abs(float(noise.std()) / sigma - 1) < 0.01
    assert abs(float(noise.mean())) < 4 * sigma / math.sqrt(K * P)
    assert abs(float(torch.corrcoef(noise[:2])[0, 1])) < 0.05


def test_fedlabels_reads_neither_dp_nor_privacy_metrics(lr_blob, tmp_path):
    """FedLabels' client step never reaches the local-DP transform or the
    attack metrics: the runs with and without them are bitwise equal, in
    the port and in the JAX package."""
    runs, jax_runs = {}, {}
    for name in ("plain", "dp"):
        raw = lr_config("fedlabels", rounds=3)
        if name == "dp":
            raw["dp_config"] = dict(NOISED)
            raw["privacy_metrics_config"] = {
                "apply_metrics": True, "apply_leakage_metric": True,
                "max_allowed_leakage": 0.01}
        server, records = port_cli(raw, lr_blob, tmp_path / name)
        runs[name] = (server.state.params.clone(), records)
        jax_runs[name] = jax.device_get(_jax_run(
            raw, lr_blob, str(tmp_path / f"j{name}"))[3].state.params)
    assert torch.equal(runs["dp"][0], runs["plain"][0])
    assert runs["dp"][1] == runs["plain"][1]
    for a, b in zip(jax.tree.leaves(jax_runs["dp"]),
                    jax.tree.leaves(jax_runs["plain"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


ADAPTIVE = dict(CLIP_ONLY, adaptive_clipping={"target_quantile": 0.5})
REFUSED = {
    "fedac_adaptive": _with("fedac", ("dp_config", ADAPTIVE)),
    "fedac_adaptive_without_local_dp": _with("fedac", ("dp_config", {
        "adaptive_clipping": {"target_quantile": 0.5}})),
    "fedbuff_adaptive": _with("fedbuff", ("dp_config", ADAPTIVE)),
    "fedlabels_adaptive": _with("fedlabels", ("dp_config", ADAPTIVE)),
    "ef_carry_adaptive": _with("ef_quant", ("dp_config", ADAPTIVE),
                               ("server_config.fused_carry", True)),
    "qffl_local_dp": _with("qffl", ("dp_config", CLIP_ONLY)),
    "scaffold_local_dp": _with("scaffold", ("dp_config", CLIP_ONLY)),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_match_the_jax_package(name, tmp_path):
    raw = REFUSED[name]
    with pytest.raises(ValueError) as port:
        FLUTEConfig.from_dict(copy.deepcopy(raw))
    with pytest.raises(ValueError) as jax_err:
        _jax_server(raw, tmp_path)
    if name.startswith("fedac"):
        # FedAC answers before FedAvg's checks, in the JAX wording
        assert str(port.value) == str(jax_err.value)


def test_fedac_constructor_refuses_adaptive_clipping_first():
    from unittest import mock
    raw = REFUSED["fedac_adaptive_without_local_dp"]
    with mock.patch("msrflute_tpu_torch.config.validate"):
        cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    with pytest.raises(ValueError, match="strategy-state slot"):
        select_strategy("fedac")(cfg)


def test_ef_host_round_keeps_the_initial_adaptive_clip(lr_blob, tmp_path):
    """EF's host round takes adaptive clipping as the JAX package does:
    the payload program never combines, so the clip stays at its start."""
    raw = lr_config("ef_quant", rounds=3, client=EF_CLIENT)
    raw["dp_config"] = dict(ADAPTIVE)
    raw["dp_config"]["adaptive_clipping"] = {"target_quantile": 0.5,
                                             "initial_clip": 0.1}
    server, _ = port_cli(raw, lr_blob, tmp_path / "port")
    jserver = _jax_run(raw, lr_blob, str(tmp_path / "jax"))[3]
    assert float(server.state.strategy_state["dp_clip"]) == \
        float(jserver.state.strategy_state["dp_clip"]) == pytest.approx(0.1)
