"""Kernels B4-B6 of the PyTorch port (``msrflute_tpu_torch/ops/
flash_attention.py``) on the CPU, where their wrappers run the plain
versions, against the JAX package's Pallas kernels in interpret mode
(``flash_attention_lse(..., interpret=True)`` at 16-row blocks), inputs
made with numpy from a seed:

- ``out`` and ``lse`` to ``rtol = atol = 2e-5`` (float32; the interpret-mode
  kernels sum 16-wide tiles with an online softmax, the plain version in
  one pass), fully masked rows exactly 0 with ``lse == -1e30`` on both;
- the VJP with a nonzero lse cotangent to ``rtol = atol = 5e-5`` (the JAX
  package's own kernel tests allow 3e-5 against a dense reference; the
  port's plain backward is a second dense computation, so the two gaps
  add);
- ``attention_bwd_plain`` against torch autograd of the plain forward to
  ``rtol = atol = 1e-5`` (the same float32 ops in another order);
- ``vmap(grad_and_value)`` over K clients through the two
  ``autograd.Function``s against a loop over the clients, to ``1e-6``, with
  one forward and one backward call for all K.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value, vmap

from msrflute_tpu.ops.pallas_attention import flash_attention_lse as jax_lse
from msrflute_tpu_torch.ops import flash_attention as fa

NEG = -1e30

# (B, Lq, Lk, H, D, causal, q_offset, k_offset)
CASES = {
    "causal": (2, 40, 40, 2, 16, True, 0, 0),
    "full": (1, 24, 56, 2, 16, False, 0, 0),
    "offsets": (1, 24, 40, 2, 16, True, 40, 8),
    "masked_rows": (2, 33, 20, 2, 8, True, 0, 12),
    "masked_tile": (1, 40, 24, 1, 8, True, 0, 20),
    "d8": (1, 37, 37, 3, 8, True, 0, 0),
    "d32": (1, 50, 50, 2, 32, True, 0, 0),
}


def _inputs(case, seed=0):
    B, Lq, Lk, H, D = case[:5]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Lq, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Lk, H, D)).astype(np.float32)
            for _ in range(2))
    w = rng.normal(size=(B, Lq, H, D)).astype(np.float32)
    w_lse = rng.normal(size=(B, H, Lq)).astype(np.float32)
    return q, k, v, w, w_lse


def _jax(case, q, k, v, w, w_lse):
    causal, qo, ko = case[5:]

    def obj(q, k, v):
        out, lse = jax_lse(q, k, v, causal, q_offset=qo, k_offset=ko,
                           block_q=16, block_k=16, interpret=True)
        live = jnp.where(lse > NEG / 2, lse, 0.0)
        return jnp.sum(out * w) + jnp.sum(live * w_lse), (out, lse)

    (_, (out, lse)), grads = jax.value_and_grad(obj, argnums=(0, 1, 2),
                                                has_aux=True)(q, k, v)
    return out, lse, grads


def _port(case, q, k, v, w, w_lse):
    causal, qo, ko = case[5:]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = fa.flash_attention_lse(tq, tk, tv, causal, q_offset=qo,
                                      k_offset=ko)
    live = torch.where(lse > NEG / 2, lse, 0.0)
    (torch.sum(out * torch.from_numpy(w))
     + torch.sum(live * torch.from_numpy(w_lse))).backward()
    return out.detach(), lse.detach(), (tq.grad, tk.grad, tv.grad)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_interpret_kernels(name):
    case = CASES[name]
    args = _inputs(case, seed=len(name))
    want_out, want_lse, want_g = _jax(case, *args)
    got_out, got_lse, got_g = _port(case, *args)
    dead = np.asarray(want_lse) == NEG
    np.testing.assert_array_equal(got_lse.numpy() == NEG, dead)
    if name.startswith("masked"):
        assert dead.any()
        rows = got_out.numpy().transpose(0, 2, 1, 3)[dead]
        np.testing.assert_array_equal(rows, 0.0)
        np.testing.assert_array_equal(
            np.asarray(want_out).transpose(0, 2, 1, 3)[dead], 0.0)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_lse.numpy()[~dead],
                               np.asarray(want_lse)[~dead], rtol=2e-5,
                               atol=2e-5)
    for got, want, n in zip(got_g, want_g, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-5,
                                   atol=5e-5, err_msg=f"d{n}")


@pytest.mark.parametrize("name", ["offsets", "masked_rows", "full"])
def test_explicit_backward_matches_autograd(name):
    case = CASES[name]
    causal, qo, ko = case[5:]
    q, k, v, w, w_lse = (torch.from_numpy(x) for x in _inputs(case, 3))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out, lse = fa.attention_lse_plain(q, k, v, causal, qo, ko)
    live = torch.where(lse > NEG / 2, lse, 0.0)
    (torch.sum(out * w) + torch.sum(live * w_lse)).backward()
    g_lse = torch.where(lse > NEG / 2, w_lse, 0.0)
    got = fa.attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                 out.detach(), lse.detach(), w, g_lse,
                                 causal, qo, ko)
    for g, t, n in zip(got, (q, k, v), "qkv"):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"d{n}")


def test_vmap_grad_runs_one_forward_and_one_backward_for_all_clients(
        monkeypatch):
    calls = {"fwd": 0, "dq": 0, "dkv": 0}

    def counting(key, wrapper):
        def call(*args, **kw):
            calls[key] += 1
            assert not isinstance(args[0], torch.Tensor) or \
                args[0].shape[0] == K * B          # folded clients
            return wrapper(*args, **kw)
        return call

    for key, name in (("fwd", "flash_fwd"), ("dq", "flash_dq"),
                      ("dkv", "flash_dkv")):
        monkeypatch.setattr(fa, name, counting(key, getattr(fa, name)))
    K, B, L, H, D = 3, 2, 29, 2, 8
    rng = np.random.default_rng(5)
    p = {n: torch.from_numpy(rng.normal(size=(K, B, L, H, D)).astype(
        np.float32)) for n in "qkv"}
    w = torch.from_numpy(rng.normal(size=(K, B, L, H, D)).astype(np.float32))

    def loss(p, w):
        out, lse = fa.flash_attention_lse(p["q"], p["k"], p["v"], True)
        return torch.sum(out * w) + torch.sum(torch.sin(lse))

    grads, values = vmap(grad_and_value(loss))(p, w)
    assert calls == {"fwd": 1, "dq": 1, "dkv": 1}
    for i in range(K):
        leaves = {n: t[i].clone().requires_grad_() for n, t in p.items()}
        out, lse = fa.attention_lse_plain(leaves["q"], leaves["k"],
                                          leaves["v"], True)
        value = torch.sum(out * w[i]) + torch.sum(torch.sin(lse))
        value.backward()
        np.testing.assert_allclose(float(values[i]), float(value.detach()),
                                   rtol=1e-6)
        for n in "qkv":
            np.testing.assert_allclose(grads[n][i].numpy(),
                                       leaves[n].grad.numpy(), rtol=1e-6,
                                       atol=1e-6)


def test_flash_attention_is_the_first_output():
    q, k, v, _, _ = (torch.from_numpy(x) for x in _inputs(CASES["d8"]))
    out = fa.flash_attention(q, k, v, True)
    np.testing.assert_array_equal(out.numpy(),
                                  fa.flash_attention_lse(q, k, v, True)[0]
                                  .numpy())


def test_refusals():
    x = torch.zeros((1, 4, 2, 8))
    with pytest.raises(TypeError, match="ROADMAP.md"):
        fa.flash_attention(x.bfloat16(), x.bfloat16(), x.bfloat16())
    with pytest.raises(ValueError):
        fa.flash_attention(x[0], x, x)
    with pytest.raises(ValueError):
        fa.flash_attention(x, x, torch.zeros((1, 5, 2, 8)))
    with pytest.raises(ValueError, match="head_dim"):
        wide = torch.zeros((1, 4, 1, 129))
        fa.flash_fwd(wide, wide, wide)
    with pytest.raises(ValueError, match="device"):
        meta = torch.zeros((1, 4, 2, 8), device="meta")
        fa.flash_fwd(meta, meta, meta)
    assert fa.flash_fwd.launches == fa.flash_dq.launches == \
        fa.flash_dkv.launches == 0          # the CPU runs no kernel
