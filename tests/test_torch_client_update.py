"""The port's K-client update (``msrflute_tpu_torch/engine/client_update.py``)
against ``jax.vmap(build_client_update(...))`` of the JAX package, both
arms on both sides (``pallas_apply`` on: JAX's kernel in interpret mode,
the port's kernel wrapper; off: optax, the port's plain ``fused_apply``),
with one and two local epochs, gradient clipping and FedProx.

The K = 4 cohort is ragged: client 1's last step is all padding, client 2
trains on one sample, client 3 on none — so the no-op gate pins steps and
whole clients.  Tolerance ``rtol 1e-5`` (``atol 1e-6`` where a value is
near 0): the two frameworks reduce in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msrflute_tpu.config import ModelConfig as JaxModelConfig
from msrflute_tpu.config import OptimizerConfig as JaxOptimizerConfig
from msrflute_tpu.engine.client_update import ClientHParams as JaxHParams
from msrflute_tpu.engine.client_update import \
    build_client_update as jax_build_client_update
from msrflute_tpu.models import make_task as jax_make_task
from msrflute_tpu_torch.config import ModelConfig, OptimizerConfig
from msrflute_tpu_torch.engine.client_update import (ClientHParams,
                                                     build_client_update)
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.models.convert import from_jax_params

K, S, B, DIM, CLASSES, LR = 4, 3, 4, 8, 4, 0.2
MODEL = {"num_classes": CLASSES, "input_dim": DIM}


def _grid(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(K, S, B, DIM)).astype(np.float32)
    y = rng.integers(0, CLASSES, size=(K, S, B)).astype(np.int32)
    mask = np.ones((K, S, B), np.float32)
    mask[1, S - 1] = 0.0                 # all-padding final step
    mask[2] = 0.0
    mask[2, 0, 0] = 1.0                  # one sample
    mask[3] = 0.0                        # no data at all
    return x * mask[..., None], y, mask


@pytest.mark.parametrize("clip,prox", [(None, 0.0), (0.5, 0.01)])
@pytest.mark.parametrize("epochs", [1, 2])
@pytest.mark.parametrize("pallas", [False, True])
def test_client_update_matches_jax(pallas, epochs, clip, prox):
    jt = jax_make_task(JaxModelConfig(model_type="LR", extra=dict(MODEL)))
    pt = make_task(ModelConfig(model_type="LR", extra=dict(MODEL)))
    jp = jax.device_get(jt.init_params(jax.random.PRNGKey(0)))
    layout = pt.layout()
    g0 = layout.flatten(from_jax_params(pt, jp))
    x, y, mask = _grid()

    jcu = jax_build_client_update(
        jt, JaxOptimizerConfig(type="sgd", lr=LR, momentum=0.9),
        JaxHParams(max_grad_norm=clip, fedprox_mu=prox, num_epochs=epochs,
                   pallas_apply=pallas))
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(1), i))(
        jnp.arange(K))
    jpg, jtl, jns, jstats = jax.jit(jax.vmap(
        jcu, in_axes=(None, 0, 0, None, 0)))(
        jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jnp.asarray(mask),
        jnp.float32(LR), keys)

    pcu = build_client_update(
        pt, OptimizerConfig(type="sgd", lr=LR, momentum=0.9),
        ClientHParams(max_grad_norm=clip, fedprox_mu=prox, num_epochs=epochs,
                      pallas_apply=pallas))
    ppg, ptl, pns, pstats = pcu(
        g0, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
        torch.from_numpy(mask), LR, None)

    want_pg = np.stack([
        layout.flatten(from_jax_params(
            pt, jax.tree.map(lambda a, k=k: np.asarray(a)[k],
                             jax.device_get(jpg)))).numpy()
        for k in range(K)])
    np.testing.assert_allclose(ppg.numpy(), want_pg, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ppg[3].numpy(), 0.0)   # pinned client
    np.testing.assert_allclose(ptl.numpy(), np.asarray(jtl), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(pns.numpy(), np.asarray(jns))
    for key in ("mean", "mag", "norm", "var", "var_corrected", "n",
                "mean_sample_loss"):
        np.testing.assert_allclose(pstats[key].numpy(),
                                   np.asarray(jstats[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_both_port_arms_are_bitwise_equal():
    """The kernel arm and the plain arm share one arithmetic: on the CPU the
    kernel wrapper runs the plain version, and its association equals
    ``fused_apply``'s (``p - lr*m`` is ``p + (-lr)*m`` in IEEE)."""
    pt = make_task(ModelConfig(model_type="LR", extra=dict(MODEL)))
    g0 = pt.layout().flatten(pt.init_params(0))
    x, y, mask = _grid(seed=3)
    outs = []
    for pallas in (False, True):
        cu = build_client_update(
            pt, OptimizerConfig(type="sgd", lr=LR, momentum=0.9),
            ClientHParams(num_epochs=2, max_grad_norm=1.0,
                          pallas_apply=pallas))
        outs.append(cu(g0, {"x": torch.from_numpy(x),
                            "y": torch.from_numpy(y)},
                       torch.from_numpy(mask), LR, None))
    for a, b in zip(outs[0][:3], outs[1][:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_pallas_apply_refuses_unfusable_optimizer():
    pt = make_task(ModelConfig(model_type="LR", extra=dict(MODEL)))
    with pytest.raises(ValueError, match="plain SGD"):
        build_client_update(pt, OptimizerConfig(type="adam", lr=0.1),
                            ClientHParams(pallas_apply=True))
