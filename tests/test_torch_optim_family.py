"""The rest of the optimizer family (``msrflute_tpu_torch/optim/factory.py``)
and the ``rampup-keep-expdecay-keep`` schedule against the JAX package's
``make_optimizer`` (optax 0.2.6) and ``make_lr_schedule``, on a flat layout
of four leaves, one of them all zeros (the trust ratio's guard), inputs
made with numpy from a seed.

- The server's ``[P]`` vector: ``opt.step`` against optax's ``update`` and
  ``apply_updates`` on the same leaves, 8 steps.
- A client stack ``[K, P]``: ``fused_opt_apply`` (with the all-padding
  pin on one client at one step, and an ``update_mask``) against the JAX
  package's ``fused_apply`` vmapped over the K clients, 6 steps.

Tolerances: SGD with nesterov or weight decay and LARS without momentum
bitwise; adamW and yogi within ``ULP_TOL`` (2) float32 ulp of each value
(elementwise, but XLA's CPU code rounds an occasional quotient the other
way: measured 0 to 1 ulp); LAMB and LARS, whose per-leaf norms PyTorch
and XLA sum in other orders, to ``rtol 1e-6``.  The optimizers are built
through each package's ``OptimizerConfig``, whose defaults (momentum 0,
eps 1e-8) are what a config leaves unset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msrflute_tpu.config import OptimizerConfig as JaxOptimizerConfig
from msrflute_tpu.engine.client_update import \
    ClientHParams as JaxClientHParams
from msrflute_tpu.engine.client_update import \
    build_client_update as jax_build_client_update
from msrflute_tpu.optim.factory import make_lr_schedule as jax_schedule
from msrflute_tpu.optim.factory import make_optimizer as jax_make_optimizer
from msrflute_tpu.optim.fused import fused_apply as jax_fused_apply
from msrflute_tpu_torch.config import AnnealingConfig, ModelConfig
from msrflute_tpu_torch.config import OptimizerConfig
from msrflute_tpu_torch.engine.client_update import (ClientHParams,
                                                     build_client_update)
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.optim import (Lamb, Lars, Yogi, fused_opt_apply,
                                      make_optimizer, segment_norms,
                                      trust_ratio)
from msrflute_tpu_torch.optim.schedulers import make_lr_schedule

SHAPES = [(3, 5), (7,), (4, 2, 3), (6,)]
SIZES = [int(np.prod(s)) for s in SHAPES]
BOUNDS = [0] + list(np.cumsum(SIZES))
P = BOUNDS[-1]
ZERO_LEAF = 3          # all zeros at the start: its trust ratio is 1
ULP_TOL = 2
LR = 0.05

CASES = {
    "sgd_nesterov_wd": ({"type": "sgd", "momentum": 0.9, "nesterov": True,
                         "weight_decay": 0.01}, "bitwise"),
    "sgd_nesterov": ({"type": "sgd", "momentum": 0.5, "nesterov": True},
                     "bitwise"),
    "sgd_wd": ({"type": "sgd", "weight_decay": 0.1}, "bitwise"),
    "adamw_wd": ({"type": "adamW", "weight_decay": 0.01}, "ulp"),
    "yogi": ({"type": "yogi"}, "ulp"),
    "yogi_wd_eps": ({"type": "yogi", "weight_decay": 0.01, "eps": 1e-3,
                     "betas": [0.8, 0.99]}, "ulp"),
    "lamb": ({"type": "lamb", "weight_decay": 0.01}, "rtol"),
    "lars": ({"type": "lars", "weight_decay": 0.01}, "rtol"),
    "larssgd_momentum": ({"type": "LarsSGD", "momentum": 0.9}, "rtol"),
}


def _leaves(flat):
    """``[..., P]`` -> ``{"l0": [..., *shape], ...}`` (numpy or jax)."""
    return {f"l{i}": flat[..., a:b].reshape(flat.shape[:-1] + s)
            for i, (a, b, s) in enumerate(zip(BOUNDS[:-1], BOUNDS[1:],
                                               SHAPES))}


def _flat(tree, batch=()):
    return np.concatenate([np.asarray(tree[f"l{i}"]).reshape(batch + (-1,))
                           for i in range(len(SHAPES))], axis=-1)


def _ulps(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max())


def _check(got, want, how):
    if how == "bitwise":
        np.testing.assert_array_equal(got, want)
    elif how == "ulp":
        assert _ulps(got, want) <= ULP_TOL, _ulps(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _inputs(seed, batch=()):
    rng = np.random.default_rng(seed)
    p0 = rng.normal(size=batch + (P,)).astype(np.float32)
    p0[..., BOUNDS[ZERO_LEAF]:BOUNDS[ZERO_LEAF + 1]] = 0.0
    grads = [rng.normal(scale=10.0 ** rng.uniform(-3, 0),
                        size=batch + (P,)).astype(np.float32)
             for _ in range(8)]
    return p0, grads


@pytest.mark.parametrize("name", sorted(CASES))
def test_server_step_matches_optax(name):
    cfg, how = CASES[name]
    cfg = dict(cfg, lr=LR)
    p0, grads = _inputs(0)
    tx = jax_make_optimizer(JaxOptimizerConfig.from_dict(cfg))
    jp = _leaves(jnp.asarray(p0))
    js = tx.init(jp)
    opt = make_optimizer(OptimizerConfig.from_dict(cfg))
    tp = torch.from_numpy(p0.copy())
    ts = opt.init(tp)
    for g in grads:
        upd, js = tx.update(_leaves(jnp.asarray(g)), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = opt.step(tp, torch.from_numpy(g), ts, LR, BOUNDS)
    _check(tp.numpy(), _flat(jp), how)


@pytest.mark.parametrize("name", sorted(CASES))
def test_client_stack_matches_jax_fused_apply(name):
    """``[K, P]`` in one pass, a padding step pinned (params and state),
    the last leaf frozen by an update mask."""
    cfg, how = CASES[name]
    cfg = dict(cfg, lr=LR)
    K = 3
    p0, grads = _inputs(1, (K,))
    keep = [True, True, True, False]
    tx = jax_make_optimizer(JaxOptimizerConfig.from_dict(cfg))
    jp = _leaves(jnp.asarray(p0))
    js = jax.vmap(tx.init)(jp)
    mask = {f"l{i}": k for i, k in enumerate(keep)}

    def jstep(g, s, p, h):
        return jax_fused_apply(tx, g, s, p, update_mask=mask, has_data=h)

    opt = make_optimizer(OptimizerConfig.from_dict(cfg))
    tp = torch.from_numpy(p0.copy())
    ts = opt.init(tp)
    cols = torch.zeros(P, dtype=torch.bool)
    for i, k in enumerate(keep):
        cols[BOUNDS[i]:BOUNDS[i + 1]] = k
    bounds = list(BOUNDS) if isinstance(opt, (Lamb, Lars)) else None
    for t, g in enumerate(grads[:6]):
        has = np.ones((K,), np.float32)
        if t == 2:
            has[1] = 0.0                  # an all-padding step of client 1
        jp, js = jax.vmap(jstep)(_leaves(jnp.asarray(g)), js, jp,
                                 jnp.asarray(has))
        ts = fused_opt_apply(opt, tp, torch.from_numpy(g), ts, LR,
                             torch.from_numpy(has), bounds, cols)
    got = tp.numpy()
    _check(got, _flat(jp, (K,)), how)
    # the frozen leaf never moved; its state did
    np.testing.assert_array_equal(got[:, BOUNDS[3]:], p0[:, BOUNDS[3]:])


def test_yogi_starts_its_moments_at_1e6():
    state = Yogi().init(torch.zeros((2, 5)))
    assert float(state["mu"].max()) == float(state["nu"].min()) == \
        np.float32(1e-6)


def test_trust_ratio_is_per_leaf_with_optax_guard():
    rng = np.random.default_rng(3)
    p = rng.normal(size=(2, P)).astype(np.float32)
    u = rng.normal(size=(2, P)).astype(np.float32)
    p[0, BOUNDS[1]:BOUNDS[2]] = 0.0      # zero params: ratio 1
    u[1, BOUNDS[2]:BOUNDS[3]] = 0.0      # zero update: ratio 1
    got = trust_ratio(torch.from_numpy(p), torch.from_numpy(u),
                      BOUNDS, 0.001).numpy()
    norms = segment_norms(torch.from_numpy(p), BOUNDS).numpy()
    assert norms.shape == (2, len(SHAPES))
    for k in range(2):
        for i, (a, b) in enumerate(zip(BOUNDS[:-1], BOUNDS[1:])):
            pn, un = np.linalg.norm(p[k, a:b]), np.linalg.norm(u[k, a:b])
            want = 1.0 if pn == 0 or un == 0 else 0.001 * pn / un
            np.testing.assert_allclose(got[k, a:b], want, rtol=1e-6)
            np.testing.assert_allclose(norms[k, i], pn, rtol=1e-6)


@pytest.mark.parametrize("cfg", [
    {"type": "sgd", "nesterov": True, "momentum": 0.9},
    {"type": "sgd", "weight_decay": 1e-4},
    {"type": "lamb"},
    {"type": "yogi"},
])
def test_pallas_apply_refuses_what_kernel_b1_does_not_run(cfg):
    """``sgd_pallas_fusable`` in both packages: plain SGD only."""
    model = {"model_type": "LR", "num_classes": 4, "input_dim": 8}
    task = make_task(ModelConfig.from_dict(model))
    with pytest.raises(ValueError, match="plain SGD"):
        build_client_update(task, OptimizerConfig.from_dict(cfg),
                            ClientHParams(pallas_apply=True))
    from msrflute_tpu.config import ModelConfig as JaxModelConfig
    from msrflute_tpu.models import make_task as jax_make_task
    with pytest.raises(ValueError, match="plain SGD"):
        jax_build_client_update(
            jax_make_task(JaxModelConfig.from_dict(model)),
            JaxOptimizerConfig.from_dict(cfg),
            JaxClientHParams(pallas_apply=True))


def test_pallas_apply_refuses_updatable_layers():
    task = make_task(ModelConfig.from_dict({"model_type": "LR"}))
    with pytest.raises(ValueError, match="updatable_layers"):
        build_client_update(task, OptimizerConfig(),
                            ClientHParams(pallas_apply=True,
                                          updatable_layers=("Dense_0.*",)))


RAMPUP = [
    {"peak_lr": 1.0, "floor_lr": 0.01, "rampup_steps": 4, "hold_steps": 3,
     "decay_steps": 10},
    {"peak_lr": 0.5, "floor_lr": 0.05, "rampup_steps": 0, "hold_steps": 0,
     "decay_steps": 7},
    {"peak_lr": 0.3, "floor_lr": 0.3, "rampup_steps": 2, "hold_steps": 5,
     "decay_steps": 1},
    {},                                  # every default from the base LR
]


@pytest.mark.parametrize("keys", RAMPUP)
def test_rampup_schedule_equals_jax_at_every_step(keys):
    from msrflute_tpu.config import AnnealingConfig as JaxAnnealingConfig
    raw = {"type": "rampup-keep-expdecay-keep", **keys}
    base = 0.2
    mine = make_lr_schedule(AnnealingConfig.from_dict(raw), base)
    want = jax_schedule(JaxAnnealingConfig.from_dict(raw), base)
    r, h, d = (int(keys.get(k, 0)) for k in ("rampup_steps", "hold_steps",
                                              "decay_steps"))
    for step in range(r + h + max(d, 1) + 5 + 1):
        assert mine(step) == want(step), step
