"""FedBuff with drawn staleness against the JAX package
(``msrflute_tpu/strategies/fedbuff.py``):

- ``max_staleness: 1`` is the port's FedAvg, bitwise, over 4 rounds;
- with a fixed ``s`` vector fed to both packages' client step (the JAX
  package's ``staleness`` operand), the payloads and weights, then the
  owned server step and the history roll, agree at ``rel 1e-6``;
- the per-client draws of ``s_i`` are uniform over ``0 .. S-1`` (a
  chi-square test over 4,000 client streams, at the 0.001 level).
The draw itself cannot match the JAX package's ``fold_in`` stream bit for
bit; it matches in law.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.config import ModelConfig as JaxModelConfig
from msrflute_tpu.config import OptimizerConfig as JaxOptimizerConfig
from msrflute_tpu.engine.client_update import ClientHParams as JaxHParams
from msrflute_tpu.engine.client_update import \
    build_client_update as jax_build_client_update
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.strategies.fedbuff import FedBuff as JaxFedBuff
from msrflute_tpu_torch.config import FLUTEConfig, ModelConfig, \
    OptimizerConfig
from msrflute_tpu_torch.engine import OptimizationServer, RoundEngine
from msrflute_tpu_torch.engine.client_update import (ClientHParams,
                                                     build_client_update)
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params, to_jax_params
from msrflute_tpu_torch.strategies import FedBuff
from msrflute_tpu_torch.tasks import build_task_datasets

from test_torch_strategies import lr_config, write_lr_blob

MODEL = {"num_classes": 4, "input_dim": 8}
K, S, B, LR = 5, 3, 4, 0.2


@pytest.fixture(scope="module")
def lr_blob(tmp_path_factory):
    d = tmp_path_factory.mktemp("fedbuff_blob")
    write_lr_blob(d / "train.json", 12, 6, 24, seed=4)
    write_lr_blob(d / "val.json", 3, 6, 24, seed=5)
    return str(d)


def _run(raw, data_dir, model_dir):
    cfg = FLUTEConfig.from_dict(copy.deepcopy(raw))
    cfg.validate(data_dir)
    task = make_task(cfg.model_config)
    train, val, _ = build_task_datasets(cfg, task)
    server = OptimizationServer(task, cfg, train, val_dataset=val,
                                model_dir=model_dir, device="cpu", seed=0)
    server.train()
    return server


@pytest.mark.parametrize("pallas", [False, True])
def test_max_staleness_one_is_fedavg_bitwise(pallas, lr_blob, tmp_path):
    mk = {"megakernel": {"pallas_apply": pallas}}
    fedavg = _run(lr_config("fedavg", rounds=4, server=mk), lr_blob,
                  str(tmp_path / "a"))
    fedbuff = _run(lr_config("fedbuff", rounds=4, server={
        **mk, "fedbuff": {"max_staleness": 1}}), lr_blob,
        str(tmp_path / "b"))
    assert torch.equal(fedbuff.state.params, fedavg.state.params)
    assert torch.equal(fedbuff.state.strategy_state["history"][0],
                       fedbuff.state.params)


def test_fixed_staleness_round_matches_jax():
    raw = lr_config("fedbuff", server={"fedbuff": {
        "max_staleness": 4, "staleness_exponent": 0.7}})
    jstrat = JaxFedBuff(JaxFLUTEConfig.from_dict(copy.deepcopy(raw)), None)
    pstrat = FedBuff(FLUTEConfig.from_dict(copy.deepcopy(raw)))
    jt = jax_make_task(JaxModelConfig(model_type="LR", extra=dict(MODEL)))
    pt = make_task(ModelConfig(model_type="LR", extra=dict(MODEL)))
    pstrat.task = pt
    layout = pt.layout()
    rng = np.random.default_rng(6)
    # four distinct versions, index 0 the current one
    versions = [jax.device_get(jt.init_params(jax.random.PRNGKey(i)))
                for i in range(4)]
    jhist = jax.tree.map(lambda *v: jnp.stack(v), *versions)
    phist = torch.stack([layout.flatten(from_jax_params(pt, v))
                         for v in versions])
    x = rng.normal(size=(K, S, B, 8)).astype(np.float32)
    y = rng.integers(0, 4, size=(K, S, B)).astype(np.int32)
    mask = np.ones((K, S, B), np.float32)
    mask[2, 1:] = 0.0
    s = np.asarray([0, 3, 1, 2, 7], np.int32)   # 7 reads the oldest

    jcu = jax_build_client_update(jt, JaxOptimizerConfig(type="sgd", lr=LR),
                                  JaxHParams())
    jpg, jw = [], []
    for k in range(K):
        parts, _, _, _ = jstrat.client_step(
            jcu, versions[0], {"x": jnp.asarray(x[k]),
                               "y": jnp.asarray(y[k])},
            jnp.asarray(mask[k]), jnp.float32(LR), jax.random.PRNGKey(k),
            strategy_state={"history": jhist}, staleness=s[k])
        pg, w = parts["default"]
        jpg.append(layout.flatten(from_jax_params(
            pt, jax.device_get(pg))).numpy())
        jw.append(float(w))
    pcu = build_client_update(pt, OptimizerConfig(type="sgd", lr=LR),
                              ClientHParams())
    parts, _, _, _ = pstrat.client_step(
        pcu, phist[0], {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
        torch.from_numpy(mask), LR, strategy_state={"history": phist},
        staleness=torch.from_numpy(s))
    ppg, pw = parts["default"]
    np.testing.assert_allclose(ppg.numpy(), np.stack(jpg), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(pw.numpy(), np.asarray(jw), rtol=1e-6)

    # the owned server step on the weighted aggregate, and the roll
    agg = (pw @ ppg) / pw.sum()
    jnew, jstate = jstrat.apply_server_update(
        versions[0], to_jax_params(layout.views(agg)), {"history": jhist},
        0.5)
    pnew, pstate = pstrat.apply_server_update(phist[0], agg,
                                              {"history": phist}, 0.5)
    np.testing.assert_allclose(
        pnew.numpy(), layout.flatten(from_jax_params(
            pt, jax.device_get(jnew))).numpy(), rtol=1e-6)
    got_hist = torch.stack([layout.flatten(from_jax_params(
        pt, jax.tree.map(lambda h, i=i: np.asarray(h)[i],
                         jax.device_get(jstate["history"]))))
        for i in range(4)])
    np.testing.assert_allclose(pstate["history"].numpy(), got_hist.numpy(),
                               rtol=1e-6)
    assert torch.equal(pstate["history"][1:], phist[:-1])


def test_drawn_staleness_is_uniform():
    raw = lr_config("fedbuff", server={"fedbuff": {"max_staleness": 4}})
    cfg = FLUTEConfig.from_dict(raw)
    task = make_task(cfg.model_config)
    strat = FedBuff(cfg)
    engine = RoundEngine(task, cfg, strat, torch.device("cpu"), seed=3)
    ids = np.arange(4000)
    draws = torch.cat([strat.draw_staleness(
        lambda tag, r=r: engine.client_generators(r, ids, tag))
        for r in (0, 1)]).numpy()
    assert draws.min() >= 0 and draws.max() <= 3
    counts = np.bincount(draws, minlength=4)
    expected = len(draws) / 4
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 16.27, (counts, chi2)     # df 3, p = 0.001
    # a client's draw is a function of (seed, round, client): replayable
    again = strat.draw_staleness(
        lambda tag: engine.client_generators(0, ids, tag)).numpy()
    np.testing.assert_array_equal(again, draws[:4000])
