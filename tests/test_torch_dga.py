"""DGA in the PyTorch port (``strategies/dga.py`` and the staleness split of
``engine/round.py``) against the JAX package's ``DGA``.

- ``client_weight`` for all four ``weight_train_loss`` metrics and for a
  non-softmax ``aggregate_median``: ``rtol 1e-6`` (one ``exp`` each), and
  ``atol 1e-37`` for a weight that underflows to a subnormal.
- ``combine`` over three rounds of staleness, with one coin vector fed to
  both packages and the now/deferred sums formed as both engines form
  them: the aggregates to ``rtol 1e-6`` (the two packages sum the clients
  in different orders) and the banked state likewise.
- A DGA run with every feature of the slice on (local and global DP,
  annealed quantization, staleness, adam) stopped at round 2 and resumed
  to round 4 equals the uninterrupted 4-round run bit for bit: params,
  adam's moments and count, the staleness sums and the threshold.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.strategies.dga import DGA as JaxDGA
from msrflute_tpu_torch.config import FLUTEConfig
from msrflute_tpu_torch.engine import OptimizationServer
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.ops.quantization import quantize_pytree
from msrflute_tpu_torch.strategies import DGA, select_strategy
from msrflute_tpu_torch.tasks import build_task_datasets

from test_torch_nlp import SMALL, write_reddit_blob


def _raw(**server):
    return {"model_config": {"model_type": "GRU"}, "strategy": "dga",
            "server_config": {"optimizer_config": {"type": "adam",
                                                   "lr": 0.001}, **server},
            "client_config": {"optimizer_config": {"type": "sgd",
                                                   "lr": 1.0}}}


def _both(raw):
    return (DGA(FLUTEConfig.from_dict(raw)),
            JaxDGA(JaxFLUTEConfig.from_dict(raw),
                   JaxFLUTEConfig.from_dict(raw).dp_config))


def _stats(K, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(-0.5, 2.0, size=(K,)).astype(np.float32)
            for k in ("mean", "mag", "var")}


@pytest.mark.parametrize("metric", ["train_loss", "mag_var_loss",
                                    "mag_mean_loss", "mag"])
@pytest.mark.parametrize("median", ["softmax", "mean"])
def test_client_weight_matches_jax(metric, median):
    port, ref = _both(_raw(weight_train_loss=metric, aggregate_median=median,
                           softmax_beta=2.5))
    assert select_strategy("dga") is DGA
    rng = np.random.default_rng(0)
    tl = rng.uniform(0.0, 300.0, size=(6,)).astype(np.float32)
    ns = np.array([0, 1, 50, 200, 400, 7], np.float32)
    stats = _stats(6, 1)
    stats["mag"][0] = -80.0          # exp overflows: the filter caps it
    want = ref.client_weight(
        num_samples=jnp.asarray(ns), train_loss=jnp.asarray(tl),
        stats={k: jnp.asarray(v) for k, v in stats.items()}, rng=None)
    got = port.client_weight(
        num_samples=torch.from_numpy(ns), train_loss=torch.from_numpy(tl),
        stats={k: torch.from_numpy(v) for k, v in stats.items()})
    # atol: XLA's CPU flushes subnormal results to zero, PyTorch keeps them
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-37)
    assert np.all((got.numpy() >= 0) & (got.numpy() <= 100.0))


def test_combine_with_a_staleness_coin_matches_jax():
    """Three rounds: the engines' now/deferred split of the weighted sums
    (``msrflute_tpu/engine/round.py:988-1019``), then each package's
    ``combine`` threading its own state."""
    port, ref = _both(_raw(stale_prob=0.5))
    K, P = 5, 300
    rng = np.random.default_rng(3)
    p_state = port.init_state(torch.zeros(P))
    j_state = ref.init_state(jnp.zeros((P,)))
    for r in range(3):
        pg = rng.normal(size=(K, P)).astype(np.float32)
        w = rng.uniform(0.1, 2.0, size=(K,)).astype(np.float32)
        stale = np.array([r % 2, 1, 0, 0, (r + 1) % 2], np.float32)
        w_now, w_def = w * (1.0 - stale), w * stale
        want, j_state = ref.combine(
            jnp.tensordot(jnp.asarray(w_now), jnp.asarray(pg), axes=1),
            jnp.sum(jnp.asarray(w_now)),
            {"grad_sum": jnp.tensordot(jnp.asarray(w_def), jnp.asarray(pg),
                                       axes=1),
             "weight_sum": jnp.sum(jnp.asarray(w_def))},
            j_state, jax.random.PRNGKey(r), num_clients=jnp.float32(K))
        tw_now, tw_def = torch.from_numpy(w_now), torch.from_numpy(w_def)
        tpg = torch.from_numpy(pg)
        got, p_state = port.combine(
            tw_now @ tpg, tw_now.sum(),
            {"grad_sum": tw_def @ tpg, "weight_sum": tw_def.sum()},
            p_state, seed=r, num_clients=float(K))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        for k in ("stale_grad_sum", "stale_weight_sum"):
            np.testing.assert_allclose(p_state[k].numpy(),
                                       np.asarray(j_state[k]), rtol=1e-6,
                                       atol=1e-6)


def test_no_staleness_keeps_no_state():
    port, ref = _both(_raw())
    assert port.init_state(torch.zeros(3)) == {}
    assert ref.init_state(jnp.zeros(3)) == ()


def _full_config(rounds, resume=False):
    return {
        "model_config": dict(SMALL, vocab_dict="vocab.vocab",
                             quant_threshold=0.7, quant_bits=10),
        "strategy": "dga",
        "dp_config": {"enable_local_dp": True, "eps": 100.0, "delta": 1e-7,
                      "max_grad": 1.0, "max_weight": 10000.0,
                      "min_weight": 0.0, "weight_scaler": 0.0001,
                      "enable_global_dp": True, "global_sigma": 1.0},
        "server_config": {
            "max_iteration": rounds, "num_clients_per_iteration": 4,
            "initial_lr_client": 1.0, "val_freq": 2, "rec_freq": 1000,
            "initial_val": False, "stale_prob": 0.5,
            "resume_from_checkpoint": resume,
            "optimizer_config": {"type": "adam", "lr": 0.001},
            "megakernel": {"pallas_apply": True},
            "data_config": {"val": {"batch_size": 16,
                                    "val_data": "val.json"}}},
        "client_config": {
            "quant_anneal": 0.9, "desired_max_samples": 16,
            "optimizer_config": {"type": "sgd", "lr": 1.0},
            "data_config": {"train": {"batch_size": 4,
                                      "list_of_train_data": "train.json"}}},
    }


@pytest.fixture(scope="module")
def reddit(tmp_path_factory):
    d = tmp_path_factory.mktemp("reddit_dga")
    vocab = ["<unk>"] + [f"w{i}" for i in range(1, 64)]
    (d / "vocab.vocab").write_text("\n".join(vocab) + "\n")
    write_reddit_blob(d / "train.json", vocab[1:], 10, 3, 12, seed=0)
    write_reddit_blob(d / "val.json", vocab[1:], 2, 3, 5, seed=1)
    return str(d)


def _server(raw, data_dir, model_dir):
    cfg = FLUTEConfig.from_dict(raw)
    cfg.validate(data_dir)
    task = make_task(cfg.model_config)
    train, val, _ = build_task_datasets(cfg, task)
    return OptimizationServer(task, cfg, train, val_dataset=val,
                              model_dir=model_dir, device="cpu", seed=0)


def test_dga_resume_is_bit_identical(reddit, tmp_path):
    full = _server(_full_config(4), reddit, str(tmp_path / "a"))
    full.train()
    first = _server(_full_config(2), reddit, str(tmp_path / "b"))
    first.train()
    resumed = _server(_full_config(4, resume=True), reddit,
                      str(tmp_path / "b"))
    assert resumed.state.round == 2
    assert set(resumed.state.strategy_state) == {"stale_grad_sum",
                                                 "stale_weight_sum"}
    resumed.train()
    assert resumed.state.round == full.state.round == 4
    assert torch.equal(resumed.state.params, full.state.params)
    for k in ("mu", "nu", "count"):
        assert torch.equal(resumed.state.opt_state[k],
                           full.state.opt_state[k])
    assert int(full.state.opt_state["count"]) == 4
    for k in ("stale_grad_sum", "stale_weight_sum"):
        assert torch.equal(resumed.state.strategy_state[k],
                           full.state.strategy_state[k])
    assert resumed.quant_thresh == full.quant_thresh == \
        pytest.approx(0.7 * 0.9 ** 4)
    status = json.loads((tmp_path / "b" / "status_log.json").read_text())
    assert status["quant_thresh"] == full.quant_thresh
    assert np.isfinite(full.state.params.numpy()).all()


def test_transform_payload_quantizes_per_leaf_of_the_given_bounds():
    raw = _raw()
    raw["model_config"].update(quant_threshold=0.5, quant_bits=4)
    port = DGA(FLUTEConfig.from_dict(raw))
    rng = np.random.default_rng(4)
    pg = torch.from_numpy(rng.normal(size=(3, 40)).astype(np.float32))
    w = torch.ones(3)
    bounds = [0, 7, 30, 40]
    got, got_w = port.transform_payload(pg, w, bounds=bounds)
    assert torch.equal(got, quantize_pytree(pg, bounds, 0.5, 4))
    assert torch.equal(got_w, w)
    assert not torch.equal(got, quantize_pytree(pg, [0, 40], 0.5, 4))
    with pytest.raises(ValueError, match="leaf bounds"):
        port.transform_payload(pg, w)
