"""The port's switch MoE FFN (``msrflute_tpu_torch/ops/moe.py``, the local
mode of ``msrflute_tpu/ops/moe.py::MoEFFN``) against the JAX module, from
the same numpy-seeded tokens and the JAX module's own parameters:

- the routing ids equal (the argmax of float32 logits; the first maximum
  on a tie in both);
- the outputs within 1e-6 relative L2 in float32 (the two packages sum
  the products in other orders), forward and gradient;
- the initial draw in law: flax's ``lecun_normal`` with a 3-D kernel's
  fan-in taken over every axis but the last.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call, grad

from msrflute_tpu.ops.moe import MoEFFN as JaxMoEFFN
from msrflute_tpu_torch.models import make_task
from msrflute_tpu_torch.ops.moe import MoEFFN, moe_fan_in

D, E, H = 16, 4, 24


def _pair(seed=0, lead=(3, 7)):
    x = np.random.default_rng(seed).normal(size=lead + (D,)).astype(
        np.float32)
    jm = JaxMoEFFN(num_experts=E, hidden=H)
    jp = jax.device_get(jm.init(jax.random.PRNGKey(seed),
                                jnp.asarray(x))["params"])
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jm, jp, MoEFFN(D, E, H), tp, x


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_routing_ids_and_outputs_match_jax(seed):
    jm, jp, tm, tp, x = _pair(seed)
    want = np.asarray(jm.apply({"params": jp}, jnp.asarray(x)))
    got = functional_call(tm, tp, (torch.from_numpy(x),)).numpy()
    assert got.shape == x.shape
    assert _rel(got, want) <= 1e-6
    t = x.reshape(-1, D)
    jax_ids = np.asarray(jnp.argmax(
        (jnp.asarray(t) @ jp["router"]).astype(jnp.float32), axis=-1))
    tm.load_state_dict(tp)
    with torch.no_grad():
        ids, _ = tm.route(torch.from_numpy(t))
    np.testing.assert_array_equal(ids.numpy(), jax_ids)
    assert len(set(jax_ids.tolist())) > 1      # the tokens spread out


def test_gradients_match_jax():
    jm, jp, tm, tp, x = _pair(3)
    w = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    jg = jax.grad(lambda p, x: jnp.sum(jm.apply({"params": p}, x) * w),
                  argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x)
    tg = grad(lambda p, x: torch.sum(functional_call(tm, p, (x,))
                                     * torch.from_numpy(w)),
              argnums=(0, 1))(tp, tx)
    for k in ("router", "w_in", "w_out"):
        assert _rel(tg[0][k].numpy(), np.asarray(jg[0][k])) <= 1e-6, k
    assert _rel(tg[1].numpy(), np.asarray(jg[1])) <= 1e-6


def test_init_follows_flax_lecun_normal_fan_in():
    """At RingLM's published widths (embed 128, mlp 512) with 4 experts:
    the fan-ins are D, E * D and E * H, the draw truncated at two
    standard deviations."""
    assert moe_fan_in((D, E)) == D
    assert moe_fan_in((E, D, H)) == E * D
    assert moe_fan_in((E, H, D)) == E * H
    task = make_task({"model_type": "RINGLM", "embed_dim": 128,
                      "mlp_dim": 512, "num_layers": 1, "moe_experts": 4,
                      "vocab_size": 90, "seq_len": 33})
    p = task.init_params(0)
    for leaf, fan in (("router", 128), ("w_in", 4 * 128),
                      ("w_out", 4 * 512)):
        t = p[f"block_0.moe_ffn.{leaf}"]
        std = fan ** -0.5
        # the truncated normal's std is the target; its bound 2 / 0.8796
        assert abs(float(t.std()) / std - 1.0) < 0.05, leaf
        assert float(t.abs().max()) <= 2 * std / 0.87962566 + 1e-6
    jp = JaxMoEFFN(num_experts=4, hidden=512).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 128)))["params"]
    for leaf in ("router", "w_in", "w_out"):
        ratio = float(np.std(np.asarray(jp[leaf]))) / float(
            p[f"block_0.moe_ffn.{leaf}"].std())
        assert abs(ratio - 1.0) < 0.05, leaf
