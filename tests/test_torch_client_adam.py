"""The port's Adam family (``adam``, ``adamW``, ``adamax``) against optax
through the JAX package's ``make_optimizer``, and the client Adam tail
(``optim/fused.py::fused_opt_apply``) against the JAX package's
``fused_apply`` with its ``has_data`` pin, on ``[K, P]`` float32 made
with numpy from a seed.

- One ``[P]`` trajectory of ten steps a type: ``rtol 1e-6`` (the bias
  corrections are float32 powers, which XLA and PyTorch may round
  differently in the last place; the rest is optax's order of operations).
- The ``[K, P]`` tail over six steps with a per-client ``has_data``
  pattern: each client's params, ``mu``, ``nu`` and count against the
  same steps of ``fused_apply`` run on that client alone (``rtol 1e-6``;
  counts exactly), and an all-padding step a no-op bitwise for the
  params and the whole optimizer state, count included.
- The tail's column chunks give the bits of one pass.
- A client update with adam: a round of K clients against the JAX
  package's ``build_client_update`` under ``vmap`` (``rtol 1e-5`` on the
  pseudo-gradient; the LR task's matmuls sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msrflute_tpu.config import OptimizerConfig as JaxOptimizerConfig
from msrflute_tpu.optim.factory import make_optimizer as jax_make_optimizer
from msrflute_tpu.optim.fused import fused_apply as jax_fused_apply
from msrflute_tpu_torch.config import OptimizerConfig
from msrflute_tpu_torch.optim import (Adam, Adamax, AdamW, fused,
                                      fused_opt_apply, make_optimizer)

P, K, STEPS = 203, 3, 6
CFGS = [{"type": "adam", "lr": 0.001},
        {"type": "adamW", "lr": 5e-5},
        {"type": "adamW", "lr": 0.01, "eps": 1e-6, "betas": [0.5, 0.6]},
        {"type": "adamax", "lr": 0.03}]
KINDS = {"adam": Adam, "adamw": AdamW, "adamax": Adamax}


def _grads(rng, shape, n):
    return [rng.normal(scale=10.0 ** rng.uniform(-4, 1), size=shape)
            .astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c["type"])
def test_one_vector_trajectory_matches_optax(cfg):
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=P).astype(np.float32)
    jtx = jax_make_optimizer(JaxOptimizerConfig.from_dict(cfg))
    jp, js = jnp.asarray(p0), None
    js = jtx.init(jp)
    opt = make_optimizer(OptimizerConfig.from_dict(cfg))
    assert type(opt) is KINDS[cfg["type"].lower()]
    tp, ts = torch.from_numpy(p0.copy()), opt.init(torch.from_numpy(p0))
    assert ts["count"].shape == ()
    for g in _grads(rng, P, 10):
        upd, js = jtx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = opt.step(tp, torch.from_numpy(g), ts, cfg["lr"])
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    assert int(ts["count"]) == 10


def _jax_moments(state):
    """(mu, nu, count) of an inject_hyperparams(adam*) state."""
    inner = state.inner_state
    inner = inner[0] if isinstance(inner, tuple) else inner
    return inner.mu, inner.nu, inner.count


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c["type"])
def test_client_tail_matches_fused_apply_with_padding(cfg):
    """Client 1 has no data at steps 2 and 3, client 2 none after step 4:
    their state freezes there, as ``fused_apply``'s ``where`` pin does."""
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(K, P)).astype(np.float32)
    grads = _grads(rng, (K, P), STEPS)
    has = np.ones((STEPS, K), np.float32)
    has[2:4, 1] = 0.0
    has[4:, 2] = 0.0
    lr = 0.02
    opt = make_optimizer(OptimizerConfig.from_dict(cfg))
    params = torch.from_numpy(p0.copy())
    state = opt.init(params)
    assert state["count"].shape == (K,)
    for t in range(STEPS):
        before = {k: v.clone() for k, v in state.items()}
        p_before = params.clone()
        state = fused_opt_apply(opt, params, torch.from_numpy(grads[t]),
                                state, lr, torch.from_numpy(has[t]))
        for k in range(K):
            if has[t, k] == 0:
                assert torch.equal(params[k], p_before[k])
                for name in state:
                    assert torch.equal(state[name][k], before[name][k]), name
    jtx = jax_make_optimizer(JaxOptimizerConfig.from_dict(cfg), lr)
    for k in range(K):
        jp = jnp.asarray(p0[k])
        js = jtx.init(jp)
        for t in range(STEPS):
            jp, js = jax_fused_apply(jtx, jnp.asarray(grads[t][k]), js, jp,
                                     has_data=jnp.asarray(has[t, k]))
        mu, nu, count = _jax_moments(js)
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jp),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(state["mu"][k].numpy(), np.asarray(mu),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(state["nu"][k].numpy(), np.asarray(nu),
                                   rtol=1e-6, atol=1e-12)
        assert int(state["count"][k]) == int(count) == int(has[:, k].sum())


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_client_tail_chunks_give_the_bits_of_one_pass(chunk, monkeypatch):
    rng = np.random.default_rng(2)
    p0 = rng.normal(size=(K, P)).astype(np.float32)
    grads = _grads(rng, (K, P), 3)
    has = torch.tensor([1.0, 0.0, 1.0])
    opt = make_optimizer(OptimizerConfig.from_dict({"type": "adam"}))
    runs = []
    for c in (P, chunk):
        monkeypatch.setattr(fused, "OPT_CHUNK", c)
        params = torch.from_numpy(p0.copy())
        state = opt.init(params)
        for g in grads:
            state = fused_opt_apply(opt, params, torch.from_numpy(g), state,
                                    0.01, has)
        runs.append((params, state))
    (p_a, s_a), (p_b, s_b) = runs
    assert torch.equal(p_a, p_b)
    for name in s_a:
        assert torch.equal(s_a[name], s_b[name]), name


@pytest.mark.parametrize("kind", ["adam", "adamW", "adamax"])
def test_client_update_with_adam_matches_jax(kind):
    """A round of 3 clients on the LR task (S = 3 steps of batch 4, one
    client with a padded last step, one with no data at all)."""
    from msrflute_tpu.config import ModelConfig as JaxModelConfig
    from msrflute_tpu.engine.client_update import (
        ClientHParams as JaxHParams, build_client_update as jax_build)
    from msrflute_tpu.models import make_task as jax_make_task
    from msrflute_tpu_torch.config import ModelConfig
    from msrflute_tpu_torch.engine.client_update import (
        ClientHParams, build_client_update)
    from msrflute_tpu_torch.models import make_task
    from msrflute_tpu_torch.models.convert import from_jax_params
    model = {"num_classes": 4, "input_dim": 6}
    opt_cfg = {"type": kind, "lr": 0.5}
    jt = jax_make_task(JaxModelConfig(model_type="LR", extra=dict(model)))
    pt = make_task(ModelConfig(model_type="LR", extra=dict(model)))
    jp = jax.device_get(jt.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(K, 3, 4, 6)).astype(np.float32)
    y = rng.integers(0, 4, size=(K, 3, 4)).astype(np.int32)
    mask = np.ones((K, 3, 4), np.float32)
    mask[1, 2, 1:] = 0.0
    mask[2] = 0.0
    lr = 0.05
    jfn = jax_build(jt, JaxOptimizerConfig.from_dict(opt_cfg), JaxHParams())
    jpg = jax.vmap(lambda a, b, m: jfn(jp, {"x": a, "y": b}, m,
                                        jnp.float32(lr),
                                        jax.random.PRNGKey(0))[0])(
        x, y, mask)
    layout = pt.layout()
    want = torch.stack([layout.flatten(from_jax_params(
        pt, jax.device_get(jax.tree.map(lambda t: t[k], jpg))))
        for k in range(K)]).numpy()
    fn = build_client_update(pt, OptimizerConfig.from_dict(opt_cfg),
                             ClientHParams())
    flat = layout.flatten(from_jax_params(pt, jp))
    got = fn(flat, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
             torch.from_numpy(mask), lr, None)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    assert not got[2].any()
