"""The bfloat16 and float16 storage arms of kernels B1 and B4-B6 on the CPU,
where the wrappers run the plain versions, against the JAX package's Pallas
kernels in interpret mode on the same 16-bit inputs (made with numpy from
a seed and rounded to the type by both packages alike):

- B1 (``fused_sgd_plain``): both widen p, g and m to float32, run the
  same float32 ops and round ``p'`` and ``m'`` to nearest even.  It is
  bitwise equal to separately rounded float32 arithmetic (numpy) rounded
  to the type, which the CUDA kernel is held to on the card; against
  ``fused_sgd_apply(..., interpret=True)`` under ``jax.vmap`` it is
  bitwise but where XLA contracts ``g + mu * m`` into a fused
  multiply-add (the float32 test's 4.8e-7, ``tests/test_torch_kernels.py``)
  and the rounding then falls the other way: at most ``B1_MISMATCH``
  (0.1 %) of the elements, each within one ulp of the type at its value or
  ``1e-6`` where ``m'`` cancels to near 0 (measured: 1 element of 4,000,
  4.3e-10);
- B4 (``attention_lse_plain``) against ``_fwd``, B5 and B6
  (``attention_dq_plain``, ``attention_dkv_plain``) against ``_bwd``, on
  ``tests/test_torch_attention.py``'s cases: ``out``, ``dq``, ``dk`` and
  ``dv`` in the storage type within one ulp of it at the tensor's largest
  magnitude (``2^(e - 7)`` for bfloat16, ``2^(e - 10)`` for float16, with
  ``2^e <= max |x| < 2^(e + 1)``: the two sum the same float32 products in
  other orders, then round once), ``lse`` to ``2e-5`` (float32);
- the autograd ``Function``s and their ``vmap`` rule carry the type: the
  gradients of a 16-bit ``flash_attention_lse`` come back in that type,
  one forward and one backward call for all K clients, equal to the plain
  backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from msrflute_tpu.ops import pallas_attention as jax_pa
from msrflute_tpu.ops.pallas_kernels import fused_sgd_apply as jax_fused_sgd
from msrflute_tpu_torch.ops import flash_attention as fa
from msrflute_tpu_torch.ops.fused_sgd import fused_sgd_apply
from test_torch_attention import CASES, NEG

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16, 7),
          "float16": (torch.float16, jnp.float16, 10)}
LR = 0.05
B1_MISMATCH = 1e-3


def _to_numpy(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("mu", [0.0, 0.9])
@pytest.mark.parametrize("P", [1, 127, 1000])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_b1_plain_matches_jax_kernel(dtype, P, mu):
    tdt, jdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(P)
    K = 4
    p, g, m = (rng.normal(size=(K, P)).astype(np.float32) for _ in range(3))
    gate = np.array([1.0, 0.0, -1.0, 2.0], np.float32)
    jp, jg, jm = (jnp.asarray(x).astype(jdt) for x in (p, g, m))
    want_p, want_m = jax.vmap(
        lambda a, b, c, d: jax_fused_sgd(a, b, c, LR, mu, d, interpret=True)
    )(jp, jg, jm, jnp.asarray(gate))
    assert want_p.dtype == jdt
    tp, tg, tm = (torch.from_numpy(x).to(tdt) for x in (p, g, m))
    before = [t.float().numpy() for t in (tp, tg, tm)]
    fused_sgd_apply(tp, tg, tm, LR, mu, torch.from_numpy(gate))
    assert tp.dtype == tm.dtype == tdt
    # bitwise: separately rounded float32 arithmetic, then the type
    f_p, f_g, f_m = before
    m_new = f_g + np.float32(mu) * f_m
    p_new = f_p - np.float32(LR) * m_new
    live = (gate > 0)[:, None]
    narrow = lambda x: torch.from_numpy(x).to(tdt).float().numpy()  # noqa
    np.testing.assert_array_equal(tm.float().numpy(),
                                  np.where(live, narrow(m_new), f_m))
    np.testing.assert_array_equal(tp.float().numpy(),
                                  np.where(live, narrow(p_new), f_p))
    # the JAX kernel, bitwise but where XLA's contraction rounds otherwise
    bits = DTYPES[dtype][2]
    for got, want in ((tp, want_p), (tm, want_m)):
        got, want = got.float().numpy(), _to_numpy(want)
        diff = got != want
        assert diff.mean() <= B1_MISMATCH, diff.sum()
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - bits)
        assert np.all(np.abs(got - want)[diff] <=
                      np.maximum(ulp, 1e-6)[diff])
    np.testing.assert_array_equal(tp[1:3].float().numpy(), f_p[1:3])


def _ulp_at_max(x, bits):
    top = float(np.abs(x).max())
    return 0.0 if top == 0 else 2.0 ** (np.floor(np.log2(top)) - bits)


def _inputs16(case, dtype, seed):
    tdt, jdt, _ = DTYPES[dtype]
    B, Lq, Lk, H, D = case[:5]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Lq, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Lk, H, D)).astype(np.float32)
            for _ in range(2))
    g = rng.normal(size=(B, Lq, H, D)).astype(np.float32)
    g_lse = rng.normal(size=(B, H, Lq)).astype(np.float32)
    jax_in = [jnp.asarray(x).astype(jdt) for x in (q, k, v, g)]
    torch_in = [torch.from_numpy(x).to(tdt) for x in (q, k, v, g)]
    return jax_in, torch_in, g_lse


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_b4_b6_plain_match_jax_interpret_kernels(name, dtype):
    case = CASES[name]
    B, Lq, Lk, H, D, causal, qo, ko = case
    bits = DTYPES[dtype][2]
    (jq, jk, jv, jg), (tq, tk, tv, tg), g_lse = _inputs16(case, dtype,
                                                          len(name))
    scale = 1.0 / np.sqrt(D)
    j_out, j_lse = jax_pa._fwd(jq, jk, jv, qo, ko, causal, scale, 16, 16,
                               True)
    out, lse = fa.attention_lse_plain(tq, tk, tv, causal, qo, ko)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    dead = np.asarray(j_lse) == NEG
    np.testing.assert_array_equal(lse.numpy() == NEG, dead)
    want = np.array(_to_numpy(j_out))
    assert float(np.abs(out.float().numpy() - want).max()) <= \
        _ulp_at_max(want, bits)
    np.testing.assert_allclose(lse.numpy()[~dead],
                               np.asarray(j_lse)[~dead], rtol=2e-5,
                               atol=2e-5)
    # the backward on the JAX forward's out and lse, a nonzero lse
    # cotangent on the live rows
    glse = np.where(dead, 0.0, g_lse).astype(np.float32)
    j_dq, j_dk, j_dv = jax_pa._bwd(jq, jk, jv, j_out, j_lse, qo, ko, jg,
                                   jnp.asarray(glse), causal, scale, 16, 16,
                                   True)
    t_out = torch.from_numpy(want).to(tq.dtype)
    t_lse = torch.from_numpy(np.array(j_lse))
    delta = fa.attention_delta(t_out, tg)
    args = (tq, tk, tv, tg, t_lse, delta, torch.from_numpy(glse), causal,
            qo, ko)
    dq = fa.attention_dq_plain(*args)
    dk, dv = fa.attention_dkv_plain(*args)
    for got, ref, n in ((dq, j_dq, "dq"), (dk, j_dk, "dk"), (dv, j_dv, "dv")):
        assert got.dtype == tq.dtype, n
        ref = _to_numpy(ref)
        err = float(np.abs(got.float().numpy() - ref).max())
        assert err <= _ulp_at_max(ref, bits), (n, err)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_vmap_grad_carries_the_storage_type(dtype, monkeypatch):
    tdt = DTYPES[dtype][0]
    calls = {"fwd": 0, "dq": 0, "dkv": 0}

    def counting(key, wrapper):
        def call(*args, **kw):
            calls[key] += 1
            assert args[0].dtype == tdt
            return wrapper(*args, **kw)
        return call

    for key, name in (("fwd", "flash_fwd"), ("dq", "flash_dq"),
                      ("dkv", "flash_dkv")):
        monkeypatch.setattr(fa, name, counting(key, getattr(fa, name)))
    K, B, L, H, D = 3, 2, 21, 2, 8
    rng = np.random.default_rng(7)
    p = {n: torch.from_numpy(rng.normal(size=(K, B, L, H, D)).astype(
        np.float32)).to(tdt) for n in "qkv"}
    w = torch.from_numpy(rng.normal(size=(K, B, L, H, D)).astype(
        np.float32)).to(tdt)

    def loss(p, w):
        out, lse = fa.flash_attention_lse(p["q"], p["k"], p["v"], True)
        return torch.sum((out * w).float()) + torch.sum(torch.sin(lse))

    grads, _ = vmap(grad_and_value(loss))(p, w)
    assert calls == {"fwd": 1, "dq": 1, "dkv": 1}
    for i in range(K):
        q, k, v = (p[n][i] for n in "qkv")
        out, lse = fa.attention_lse_plain(q, k, v, True)
        g_out = w[i]
        g_lse = torch.cos(lse)
        want = fa.attention_bwd_plain(q, k, v, out, lse, g_out, g_lse, True)
        for n, ref in zip("qkv", want):
            assert grads[n][i].dtype == tdt
            assert torch.equal(grads[n][i], ref), n
