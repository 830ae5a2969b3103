"""The privacy-attack metrics of the port (``privacy/attacks.py``,
``strategies/base.py::_apply_privacy_metrics``, the server's leakage
threshold) against the JAX package's, on numpy inputs made from a seed:

- ``extract_indices_from_embeddings``: overlap and the extracted mask
  exactly, with rows of zero gradient that tie (the stable descending
  order keeps their index order, as ``jnp.argsort(-norms)``);
- ``practical_epsilon_leakage`` on the nlg_gru GRU LM (small widths; it
  has ``token_logprobs``): ``rtol 1e-5``, for the default attacker (SGD
  at 0.01, the JAX config's default), adamax at 0.03
  (``experiments/mlm_bert``) and adam, weighted and not;
- the attack's leaf: the first 2-D leaf whose name holds ``embed``, the
  JAX package's rule (on BERT, ``position_embeddings``);
- the ported GRU DGA path with ``privacy_metrics_config`` on (the leakage
  metric, an adaptive threshold at the 0.5 quantile): the threshold after
  each of 2 rounds and the val losses against the JAX server's,
  ``rel 1e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msrflute_tpu.config import FLUTEConfig as JaxFLUTEConfig
from msrflute_tpu.config import OptimizerConfig as JaxOptimizerConfig
from msrflute_tpu.engine import OptimizationServer as JaxServer
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu.parallel import make_mesh
from msrflute_tpu.privacy import attacks as jax_attacks
from msrflute_tpu.strategies.base import _find_embedding_leaf
from msrflute_tpu.tasks import build_task_datasets as jax_build_datasets
from msrflute_tpu_torch.config import FLUTEConfig, OptimizerConfig
from msrflute_tpu_torch.engine import OptimizationServer
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params, to_jax_params
from msrflute_tpu_torch.privacy import attacks
from msrflute_tpu_torch.strategies.base import find_embedding_leaf
from msrflute_tpu_torch.tasks import build_task_datasets
from test_torch_nlp import _carried, _dga_config, reddit  # noqa: F401


@pytest.mark.parametrize("num_tokens", [None, 5.0, 30.0, 400.0])
def test_extract_indices_matches_jax(num_tokens):
    rng = np.random.default_rng(0)
    K, V, E = 3, 40, 6
    emb = rng.normal(size=(K, V, E)).astype(np.float32)
    emb[:, 10:25] = 0.0                    # rows with no gradient tie at 0
    emb[1, 3] = emb[1, 4]                  # and two equal nonzero rows
    tokens = rng.integers(0, V + 5, size=(K, 4, 7)).astype(np.int32)
    tokens[:, 0, :3] = 0                   # padding
    nt = (None if num_tokens is None
          else torch.full((K,), num_tokens, dtype=torch.float32))
    got_o, got_m = attacks.extract_indices_from_embeddings(
        torch.from_numpy(emb), torch.from_numpy(tokens), nt)
    for k in range(K):
        want_o, want_m = jax_attacks.extract_indices_from_embeddings(
            jnp.asarray(emb[k]), jnp.asarray(tokens[k]),
            None if num_tokens is None else jnp.float32(num_tokens))
        np.testing.assert_array_equal(got_m[k].numpy(), np.asarray(want_m))
        assert float(got_o[k]) == pytest.approx(float(want_o), rel=1e-6)


ATTACKERS = [None, {"type": "adamax", "lr": 0.03},
             {"type": "adam", "lr": 0.01}]


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("attacker", ATTACKERS,
                         ids=["default", "adamax", "adam"])
def test_practical_epsilon_leakage_matches_jax(attacker, weighted):
    jt, pt, jp, tp = _carried()
    rng = np.random.default_rng(1)
    K, S, B, L = 3, 2, 3, 6
    x = rng.integers(0, 64, size=(K, S, B, L)).astype(np.int32)
    tok = (rng.random((K, S, B, L)) < 0.9).astype(np.float32)
    mask = np.ones((K, S, B), np.float32)
    mask[1, 1] = 0.0
    mask[2] = 0.0
    layout = pt.layout()
    flat = layout.flatten(tp)
    pg = (rng.normal(size=(K, layout.numel)) * 1e-2).astype(np.float32)
    cfg = (OptimizerConfig() if attacker is None
           else OptimizerConfig.from_dict(attacker))
    jcfg = (JaxOptimizerConfig() if attacker is None
            else JaxOptimizerConfig.from_dict(attacker))
    got = attacks.practical_epsilon_leakage(
        layout.views(flat), flat, torch.from_numpy(pg), pt, layout,
        {"x": torch.from_numpy(x), "tok_mask": torch.from_numpy(tok)},
        torch.from_numpy(mask), is_weighted=weighted,
        max_ratio=float(np.exp(30.0)), attacker_optimizer_config=cfg)
    for k in range(K):
        pg_tree = jax.tree.map(jnp.asarray, to_jax_params(
            layout.views(torch.from_numpy(pg[k].copy()))))
        want = jax_attacks.practical_epsilon_leakage(
            jp, pg_tree, jt.token_logprobs,
            {"x": jnp.asarray(x[k]), "tok_mask": jnp.asarray(tok[k])},
            jnp.asarray(mask[k]), is_weighted=weighted,
            max_ratio=float(np.exp(30.0)), attacker_optimizer_config=jcfg)
        assert float(got[k]) == pytest.approx(float(want), rel=1e-5,
                                              abs=1e-6), k
    assert float(got[2]) == 0.0            # no tokens, no leakage


def test_attack_leaf_is_the_jax_packages_choice():
    jt, pt, jp, tp = _carried()
    off, size, shape = find_embedding_leaf(pt.layout())
    want = _find_embedding_leaf(jp)
    assert shape == want.shape
    np.testing.assert_array_equal(
        pt.layout().flatten(tp)[off:off + size].numpy(),
        np.asarray(want).reshape(-1))


def _privacy_config():
    raw = _dga_config(2)
    raw["privacy_metrics_config"] = {
        "apply_metrics": True, "apply_indices_extraction": True,
        "allowed_word_rank": 20, "apply_leakage_metric": True,
        "max_leakage": 30.0, "max_allowed_leakage": 3.0,
        "adaptive_leakage_threshold": 0.5, "is_leakage_weighted": True,
        "attacker_optimizer_config": {"type": "adamax", "lr": 0.03}}
    raw["server_config"]["num_clients_per_iteration"] = 5
    return raw


def test_adaptive_leakage_threshold_matches_jax(reddit, tmp_path):  # noqa: F811
    raw = _privacy_config()
    cfg = JaxFLUTEConfig.from_dict(raw)
    cfg.validate(reddit)
    task = jax_make_task(cfg.model_config)
    train, val, _ = jax_build_datasets(cfg, task)
    jserver = JaxServer(task, cfg, train, val_dataset=val,
                        model_dir=str(tmp_path / "jax"),
                        mesh=make_mesh(num_devices=1), seed=0)
    init = jax.device_get(jserver.state.params)
    want, process = [], jserver._process_privacy_stats
    want_losses, evaluate = [], jserver._maybe_eval

    def recording(stats, round_no, client_mask=None):
        process(stats, round_no, client_mask=client_mask)
        want.append(jserver.max_allowed_leakage)

    def recording_eval(split, round_no, force=False):
        improved = evaluate(split, round_no, force=force)
        want_losses.append(jserver._last_val["loss"].value)
        return improved

    jserver._process_privacy_stats = recording
    jserver._maybe_eval = recording_eval
    jserver.train()

    pcfg = FLUTEConfig.from_dict(raw)
    pcfg.validate(reddit)
    ptask = make_task(pcfg.model_config)
    ptrain, pval, _ = build_task_datasets(pcfg, ptask)
    server = OptimizationServer(ptask, pcfg, ptrain, val_dataset=pval,
                                model_dir=str(tmp_path / "port"),
                                device="cpu", seed=0,
                                init_params=from_jax_params(ptask, init))
    got, port_process = [], server._process_privacy_stats

    def port_recording(stats, round_no):
        port_process(stats, round_no)
        got.append(server.max_allowed_leakage)

    server._process_privacy_stats = port_recording
    server.train()
    assert len(got) == len(want) == 2
    assert got[0] != 3.0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    losses = [h["loss"] for h in server.history if h["split"] == "val"]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
