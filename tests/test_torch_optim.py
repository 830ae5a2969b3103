"""The port's server optimizers (``msrflute_tpu_torch/optim/factory.py``)
against the JAX package's ``make_optimizer`` (optax) on the same flat
float32 vectors, made with numpy from a seed.

- ``adam``: ten steps, bias correction, ``eps`` outside the square root;
  ``rtol 1e-6`` (the bias corrections are float32 powers, which XLA and
  PyTorch may round differently in the last place).  ``amsgrad: true`` is
  accepted and changes nothing in either package.
- ``sgd`` with and without momentum: bitwise, as slice 1 pinned it.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msrflute_tpu.config import OptimizerConfig as JaxOptimizerConfig
from msrflute_tpu.optim.factory import make_optimizer as jax_make_optimizer
from msrflute_tpu_torch.config import OptimizerConfig
from msrflute_tpu_torch.optim import SGD, Adam, make_optimizer

P, STEPS = 257, 10


def _trajectory(cfg_dict, lr, seed=0):
    """(port params, JAX params) after STEPS steps on the same grads."""
    rng = np.random.default_rng(seed)
    p0 = rng.normal(size=P).astype(np.float32)
    grads = [rng.normal(scale=10.0 ** rng.uniform(-4, 1), size=P)
             .astype(np.float32) for _ in range(STEPS)]
    jtx = jax_make_optimizer(JaxOptimizerConfig.from_dict(cfg_dict), lr)
    jp = jnp.asarray(p0)
    js = jtx.init(jp)
    opt = make_optimizer(OptimizerConfig.from_dict(cfg_dict))
    tp = torch.from_numpy(p0.copy())
    ts = opt.init(tp)
    for g in grads:
        upd, js = jtx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = opt.step(tp, torch.from_numpy(g), ts, lr)
    return opt, ts, tp.numpy(), np.asarray(jp)


@pytest.mark.parametrize("cfg", [
    {"type": "adam", "lr": 0.001},
    {"type": "adam", "lr": 0.001, "amsgrad": True},
    {"type": "adam", "lr": 0.01, "betas": [0.8, 0.99], "eps": 1e-6},
])
def test_adam_matches_optax(cfg):
    opt, state, got, want = _trajectory(cfg, cfg["lr"])
    assert isinstance(opt, Adam)
    assert int(state["count"]) == STEPS
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_optax_bitwise(momentum):
    cfg = {"type": "sgd", "lr": 0.5, "momentum": momentum}
    opt, _, got, want = _trajectory(cfg, 0.5)
    assert isinstance(opt, SGD)
    np.testing.assert_array_equal(got, want)


def test_adam_state_round_trips_through_a_dict():
    opt = make_optimizer(OptimizerConfig.from_dict({"type": "adam",
                                                    "lr": 0.001}))
    state = opt.init(torch.zeros(3))
    assert set(state) == {"mu", "nu", "count"}
    assert state["count"].dtype == torch.int32


@pytest.mark.parametrize("cfg", [{"type": "rmsprop", "lr": 0.1},
                                 {"type": "adagrad"}])
def test_other_optimizers_raise(cfg):
    """Every type of the JAX package's factory is ported (the optimizer
    family's tests are ``tests/test_torch_optim_family.py``); any other
    raises, as there."""
    with pytest.raises(ValueError, match="unknown optimizer type"):
        make_optimizer(OptimizerConfig.from_dict(cfg))
