"""Local DP and adaptive clipping under FedAvg, and the RDP accountant, in
the port (``msrflute_tpu_torch/strategies/fedavg.py``,
``privacy/__init__.py``, ``privacy/accountant.py``) against the JAX
package:

- the accountant (``compute_rdp``, ``get_privacy_spent``,
  ``update_privacy_accountant``): to 1e-12 relative;
- ``apply_local_dp`` with the adaptive clip in clip-only mode: rtol 1e-6
  against JAX's ``clip_override`` (the norms' reduction order differs);
- the trajectory: the port's CLI (``-device cpu``) against the JAX server
  on the LR blob of ``test_torch_strategies.py``, 6 rounds of clip-only
  local DP with adaptive clipping at ``count_sigma: 0``: val loss
  ``rel 1e-5``, accuracy to one val sample, the logged ``DP clip norm``
  ``rtol 1e-6`` every round (and it moves);
- a run with adaptive clipping (the count noise on) cut after round 2 and
  resumed to 4: params and ``dp_clip`` bitwise those of the uninterrupted
  run;
- statistical: local DP at ``eps >= 0`` adds normals of the Gaussian
  mechanism's sigma to the normalized payload, and the below-clip count's
  noise at the default ``count_sigma`` has standard deviation m / 20;
- ``enable_global_dp`` under FedAvg is accepted and changes nothing, as in
  the JAX package (only DGA's combine applies global DP).
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msrflute_tpu import privacy as jax_privacy
from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.privacy import accountant as jax_accountant
from msrflute_tpu_torch import privacy
from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.privacy import accountant
from msrflute_tpu_torch.strategies.fedavg import FedAvg
from test_torch_chaos import (assert_defense_trajectory, defense_histories,
                              lr_blob, port_cli)  # noqa: F401
from test_torch_secagg import _cli
from test_torch_strategies import lr_config

ADAPTIVE = {"enable_local_dp": True, "eps": -1.0, "max_grad": 1.0,
            "adaptive_clipping": {"target_quantile": 0.5, "clip_lr": 0.5,
                                  "initial_clip": 0.05, "count_sigma": 0.0}}


@pytest.mark.parametrize("q,sigma,steps", [
    (0.01, 1.1, 100), (0.25, 0.8, 7), (1.0, 2.0, 3), (0.0, 1.0, 5),
    (0.5, 0.0, 2), (0.06, 5.0, 1000)])
def test_accountant_matches_jax(q, sigma, steps):
    orders = accountant.DEFAULT_ORDERS + (1.5, 2.5, 70.2)
    got = accountant.compute_rdp(q, sigma, steps, orders)
    want = jax_accountant.compute_rdp(q, sigma, steps, orders)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    if np.all(np.isfinite(want)):
        for delta in (1e-5, 1e-7):
            g = accountant.get_privacy_spent(orders, got, delta)
            w = jax_accountant.get_privacy_spent(orders, want, delta)
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)


@pytest.mark.parametrize("dp", [
    {"enable_local_dp": True, "eps": 5.0, "max_grad": 0.5,
     "max_weight": 20.0, "delta": 1e-6},
    {"enable_global_dp": True, "global_sigma": 1.3, "max_grad": 2.0},
    {"enable_local_dp": True, "eps": 2.0}], ids=str)
def test_update_privacy_accountant_matches_jax(dp, monkeypatch):
    raw = lr_config("fedavg")
    raw["dp_config"] = dp
    logged = {}
    monkeypatch.setattr("msrflute_tpu.utils.logging.log_metric",
                        lambda k, v, step=None, **kw: None)

    class Log:
        def log(self, name, value, step=None):
            logged[name] = value

    jcfg = JaxFLUTEConfig.from_dict(copy.deepcopy(raw),
                                    validate_schema=False)
    for n, it, b in ((100, 0, 10), (3400, 49, 35), (2, 4, 2)):
        want = jax_privacy.update_privacy_accountant(jcfg, n, it, b)
        got = privacy.update_privacy_accountant(
            FLUTEConfig.from_dict(copy.deepcopy(raw)), n, it, b,
            metrics=Log())
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        assert logged["dp_epsilon_rdp"] == got
    assert privacy.update_privacy_accountant(
        FLUTEConfig.from_dict(lr_config("fedavg")), 10, 0, 2) is None


def test_clip_override_matches_jax():
    dp = {"eps": -1.0, "max_grad": 1.0}
    rng = np.random.default_rng(0)
    pg = (rng.normal(size=(5, 64)) * np.array([[0.01], [0.3], [1], [3],
                                                [30]])).astype(np.float32)
    w = np.arange(1, 6, dtype=np.float32)
    for clip in (0.05, 0.7, 1.0, 4.0):
        got, got_w = privacy.apply_local_dp(
            torch.from_numpy(pg), torch.from_numpy(w), dp, False,
            clip=torch.tensor(clip))
        for k in range(5):
            want, want_w = jax_privacy.apply_local_dp(
                {"a": jnp.asarray(pg[k])}, jnp.float32(w[k]), dp, False,
                jax.random.PRNGKey(0), clip_override=jnp.float32(clip))
            np.testing.assert_allclose(got[k].numpy(), want["a"],
                                       rtol=1e-6, atol=0)
            assert float(got_w[k]) == float(want_w)
        norms = torch.linalg.vector_norm(got, dim=1)
        assert bool((norms <= min(clip, 1.0) * (1 + 1e-6)).all())


def test_cli_trajectory_with_adaptive_clipping_matches_jax(
        lr_blob, tmp_path, monkeypatch):
    raw = lr_config("fedavg")
    raw["dp_config"] = copy.deepcopy(ADAPTIVE)
    got, want, n_val, port, jax_m, server = defense_histories(
        raw, lr_blob, tmp_path, monkeypatch)
    assert_defense_trajectory(got, want, n_val, port, jax_m, clip_rtol=1e-6)
    clips = [v for _, v in port["DP clip norm"]]
    assert len(clips) == 6 and len(set(clips)) == 6 and \
        max(clips) <= 1.0
    assert float(server.state.strategy_state["dp_clip"]) == clips[-1]


def test_resume_with_adaptive_clipping_is_bitwise(lr_blob, tmp_path):
    raw = lr_config("fedavg", rounds=4)
    raw["dp_config"] = copy.deepcopy(ADAPTIVE)
    del raw["dp_config"]["adaptive_clipping"]["count_sigma"]   # m / 20
    whole = _cli(raw, lr_blob, tmp_path / "whole")
    cut = copy.deepcopy(raw)
    cut["server_config"]["max_iteration"] = 2
    _cli(cut, lr_blob, tmp_path / "cut")
    raw["server_config"]["resume_from_checkpoint"] = True
    resumed = _cli(raw, lr_blob, tmp_path / "cut")
    assert resumed.state.round == 4
    assert torch.equal(resumed.state.params, whole.state.params)
    assert torch.equal(resumed.state.strategy_state["dp_clip"],
                       whole.state.strategy_state["dp_clip"])


def _fedavg(dp):
    raw = lr_config("fedavg")
    raw["dp_config"] = dp
    return FedAvg(FLUTEConfig.from_dict(raw))


def test_local_dp_noise_has_the_mechanism_sigma():
    dp = {"enable_local_dp": True, "eps": 1.0, "delta": 1e-5,
          "max_grad": 2.0, "max_weight": 100.0}
    strat = _fedavg(dp)
    K, P = 4, 20_000
    pg = torch.randn(K, P, generator=torch.Generator().manual_seed(0))
    ns = torch.tensor([5.0, 6.0, 7.0, 8.0])

    def client_update(global_flat, arrays, sample_mask, lr, gens,
                      grad_offset=None):
        return pg.clone(), torch.ones(K), ns, {}

    def rngs(tag):
        return [torch.Generator().manual_seed(100 * tag + k)
                for k in range(K)]
    parts, _, _, _ = strat.client_step(client_update, torch.zeros(P), {},
                                       None, 0.1, client_rngs=rngs)
    noisy, w = parts["default"]
    assert torch.equal(w, ns)                      # no weight noise
    sigma = math.sqrt(2 * math.log(1.25 / 1e-5)) * 2.0 / 1.0
    normed = 2.0 * pg / torch.linalg.vector_norm(pg, dim=1, keepdim=True)
    noise = (noisy - normed).double()
    assert abs(float(noise.std()) / sigma - 1) < 0.01
    assert abs(float(noise.mean())) < 4 * sigma / math.sqrt(K * P)
    # the clients' streams differ
    assert abs(float(torch.corrcoef(noise[:2])[0, 1])) < 0.05


def test_count_noise_has_default_sigma_m_over_20():
    dp = {"enable_local_dp": True, "eps": -1.0, "max_grad": 100.0,
          "adaptive_clipping": {"target_quantile": 0.5, "clip_lr": 0.2,
                                "initial_clip": 1.0}}
    strat = _fedavg(dp)
    m = 40.0
    state = strat.init_state(torch.zeros(3))
    sums = {"default": {"grad_sum": torch.zeros(3),
                        "weight_sum": torch.tensor(1.0)},
            "clip_frac": {"grad_sum": torch.tensor([m / 2]),
                          "weight_sum": torch.tensor(m)}}
    b = []
    for seed in range(2000):
        _, new = strat.combine_parts(sums, None, state, seed, 4.0)
        # C' = C exp(-lr (b - 1/2)) with C = 1
        b.append(0.5 - math.log(float(new["dp_clip"])) / 0.2)
    b = np.asarray(b)
    # the noised fraction b = (m/2 + N(0, (m/20)^2)) / m: sd 1/20
    assert abs(b.std() / 0.05 - 1) < 0.06
    assert abs(b.mean() - 0.5) < 4 * 0.05 / math.sqrt(len(b))


def test_global_dp_under_fedavg_is_accepted_and_ignored(lr_blob, tmp_path):
    runs = {}
    for name, dp in (("none", None),
                     ("global", {"enable_global_dp": True,
                                 "global_sigma": 5.0, "max_grad": 1.0})):
        raw = lr_config("fedavg", rounds=3)
        if dp is not None:
            raw["dp_config"] = dp
        server, records = port_cli(raw, lr_blob, tmp_path / name)
        runs[name] = (server.state.params.clone(), records)
    assert torch.equal(runs["global"][0], runs["none"][0])
    assert runs["global"][1] == runs["none"][1]
