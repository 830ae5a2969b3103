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
  one forward and one backward call for all K;
- a numpy model of B4's tiled recurrence (64-key tiles, an online softmax
  in the log2 domain with per-lane partial row sums, masks only on edge
  tiles) against the interpret-mode kernel on every case, to ``2e-5``, and
  against the plain version where whole tiles are skipped;
- the C interface of ``csrc/flash_attention.cu`` read from the source
  against what the wrappers declare to ``ctypes`` (no compiler is needed),
  and the compiler-report parser of ``chip_smoke.py`` on a sample log.
"""

import ctypes
import os
import re
import sys

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
    # the shapes of the chip smoke test's cases for the kernels' copy paths
    # and edge tiles, at lengths the 16-row interpret-mode blocks keep small
    "d4": (2, 38, 38, 2, 4, True, 0, 0),
    "d5": (1, 38, 44, 2, 5, True, 10, 0),
    "d20": (2, 52, 46, 2, 20, True, 5, 0),
    "ragged_diag_edge": (2, 54, 58, 2, 32, True, 37, 11),
    "full_ragged": (1, 50, 75, 3, 32, False, 0, 0),
    "one_head": (1, 70, 70, 1, 32, True, 0, 0),
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
    _jax_fwds[name] = (np.asarray(want_out), np.asarray(want_lse))
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


# ----------------------------------------------------------------------
# B4's recurrence, modelled in numpy
# ----------------------------------------------------------------------
TILE = 64


def _b4_model(q, k, v, causal, q_off, k_off):
    """The recurrence of ``csrc/flash_attention.cu::flash_fwd_kernel`` in
    float32 numpy: 64-row query tiles, each over its visited 64-key tiles
    (the TPU kernel's skip condition); scores pre-scaled into the log2
    domain for the row max ``m2``; ``p = 2^(s * scale * log2 e - m2)``; the
    16 lanes that share a row each keep a partial row sum over keys
    ``j, j + 16, j + 32, j + 48`` of a tile, rescaled by
    ``corr = 2^(m2_old - m2_new)`` and added across the lanes at the end;
    the output summed by two halves over keys 0-31 and 32-63 of each tile,
    added at the end; masked entries set to the -1e30 score and to p = 0
    only on tiles the mask can touch (edge tiles); interior tiles take no
    mask.  ``(out [B, Lq, H, D], lse [B, H, Lq])``."""
    f32 = np.float32
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    scale2 = f32(1.0 / np.sqrt(D)) * f32(np.log2(np.e))
    out = np.zeros((B, Lq, H, D), f32)
    lse = np.zeros((B, H, Lq), f32)
    qt, kt, vt = (np.swapaxes(x, 1, 2) for x in (q, k, v))   # [B, H, L, D]
    for q0 in range(0, Lq, TILE):
        rows = np.zeros((B, H, TILE, D), f32)
        rows[:, :, :min(TILE, Lq - q0)] = qt[:, :, q0:q0 + TILE]
        n = -(-Lk // TILE)
        if causal:
            last = q_off + q0 + TILE - 1 - k_off
            n = 0 if last < 0 else min(n, last // TILE + 1)
        m2 = np.full((B, H, TILE), NEG, f32)
        lanes = np.zeros((B, H, TILE, 16), f32)
        halves = np.zeros((2, B, H, TILE, D), f32)
        for kj in range(n):
            k0 = kj * TILE
            keys, vals = (np.zeros((B, H, TILE, D), f32) for _ in range(2))
            keys[:, :, :min(TILE, Lk - k0)] = kt[:, :, k0:k0 + TILE]
            vals[:, :, :min(TILE, Lk - k0)] = vt[:, :, k0:k0 + TILE]
            s = np.einsum("bhqd,bhkd->bhqk", rows, keys).astype(f32)
            edge = k0 + TILE > Lk or (causal and
                                      k_off + k0 + TILE - 1 > q_off + q0)
            if edge:
                q_pos = q_off + q0 + np.arange(TILE)[:, None]
                k_loc = k0 + np.arange(TILE)[None, :]
                vis = k_loc < Lk
                if causal:
                    vis = vis & (q_pos >= k_off + k_loc)
                s = np.where(vis, s, f32(NEG))
            m_new = np.maximum(m2, s.max(axis=-1) * scale2)
            corr = np.exp2(m2 - m_new)
            p = np.exp2(s * scale2 - m_new[..., None]).astype(f32)
            if edge:
                p = np.where(vis, p, f32(0.0))
            lanes = lanes * corr[..., None] + p.reshape(
                B, H, TILE, 4, 16).sum(axis=3)
            for half in range(2):
                keys_of = slice(32 * half, 32 * half + 32)
                halves[half] = halves[half] * corr[..., None] + np.einsum(
                    "bhqk,bhkd->bhqd", p[..., keys_of], vals[:, :, keys_of])
            m2 = m_new
        l = lanes.sum(axis=-1)
        lc = np.maximum(l, f32(1e-30))
        o = (halves[0] + halves[1]) / lc[..., None]
        stat = np.where(l > 0, m2 * f32(np.log(2.0)) + np.log(lc), f32(NEG))
        m = min(TILE, Lq - q0)
        out[:, q0:q0 + m] = np.swapaxes(o[:, :, :m], 1, 2)
        lse[:, :, q0:q0 + m] = stat[:, :, :m]
    return out, lse


#: each case's JAX forward from :func:`_jax` (its primal, bitwise the
#: forward alone on the same inputs), read again by the B4 model's test
_jax_fwds = {}


def _jax_fwd(case, q, k, v):
    causal, qo, ko = case[5:]
    out, lse = jax_lse(q, k, v, causal, q_offset=qo, k_offset=ko,
                       block_q=16, block_k=16, interpret=True)
    return np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize("name", sorted(CASES))
def test_b4_recurrence_matches_jax_interpret_kernel(name):
    case = CASES[name]
    q, k, v, _, _ = _inputs(case, seed=len(name))
    want_out, want_lse = (_jax_fwds[name] if name in _jax_fwds
                          else _jax_fwd(case, q, k, v))
    got_out, got_lse = _b4_model(q, k, v, *case[5:])
    dead = want_lse == NEG
    np.testing.assert_array_equal(got_lse == NEG, dead)
    if name.startswith("masked"):
        assert dead.any()
        np.testing.assert_array_equal(got_out.transpose(0, 2, 1, 3)[dead],
                                      0.0)
    np.testing.assert_allclose(got_out, want_out, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_lse[~dead], want_lse[~dead], rtol=2e-5,
                               atol=2e-5)


def test_b4_recurrence_over_skipped_edge_and_interior_tiles():
    """Three 64-row query tiles against four key tiles under offsets: rows
    0-69 see no key, so the first query tile visits no key tile and the
    second has six fully masked rows in a visited one; later rows rescale
    across interior tiles and a ragged edge tile.  Against the plain
    version, to the same 2e-5."""
    case = (2, 150, 230, 2, 16, True, 20, 90)
    q, k, v, _, _ = _inputs(case, seed=11)
    got_out, got_lse = _b4_model(q, k, v, *case[5:])
    want_out, want_lse = (x.numpy() for x in fa.attention_lse_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), *case[5:]))
    dead = want_lse == NEG
    assert dead[:, :, :70].all() and not dead[:, :, 70:].any()
    np.testing.assert_array_equal(got_lse == NEG, dead)
    np.testing.assert_array_equal(got_out.transpose(0, 2, 1, 3)[dead], 0.0)
    np.testing.assert_allclose(got_out, want_out, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_lse[~dead], want_lse[~dead], rtol=2e-5,
                               atol=2e-5)


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
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        fa.flash_attention(x.double(), x.double(), x.double())
    with pytest.raises(TypeError, match="must be torch.bfloat16"):
        fa.flash_attention(x.bfloat16(), x, x.bfloat16())
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


# ----------------------------------------------------------------------
# the C interface, read from the source
# ----------------------------------------------------------------------
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CU = os.path.join(REPO, "msrflute_tpu_torch", "csrc", "flash_attention.cu")

#: how each ctypes type the wrappers declare is spelled in the source
C_SPELLING = {ctypes.c_void_p: {"const void*", "void*"},
              ctypes.c_int: {"int"}, ctypes.c_float: {"float"},
              ctypes.c_longlong: {"long long"},
              ctypes.c_char_p: {"const char*"},
              ctypes.POINTER(ctypes.c_int): {"int*"}}


def _c_entry_points():
    """``{name: (return type, [argument types])}`` of every ``extern "C"``
    function of the source."""
    with open(CU) as fh:
        src = fh.read()
    found = {}
    for ret, name, args in re.findall(
            r'extern "C"\s+([\w\s]+?[\w*])\s*(\w+)\(([^)]*)\)\s*{', src):
        types = []
        for arg in args.split(","):
            words = arg.split()
            types.append(" ".join(words[:-1]) if words else "")
        found[name] = (" ".join(ret.split()), types)
    return found


def _declared():
    """``{name: (restype, argtypes)}`` as the wrappers bind them."""
    out = {k.symbol: (ctypes.c_int, [ctypes.c_void_p] * k.n_ptr + k.TAIL)
           for k in (fa.flash_fwd, fa.flash_dq, fa.flash_dkv)}
    out.update({name: (res, list(args))
                for name, (res, args) in fa.ENTRY_POINTS.items()})
    return out


@pytest.mark.parametrize("name", [
    "flash_fwd_launch", "flash_dq_launch", "flash_dkv_launch",
    "flash_smem_bytes", "flash_kernel_info", "flash_attention_error_string"])
def test_c_entry_point_matches_its_ctypes_declaration(name):
    source, declared = _c_entry_points(), _declared()
    assert set(source) == set(declared)     # nothing unbound, nothing missing
    ret, args = source[name]
    restype, argtypes = declared[name]
    assert ret in C_SPELLING[restype], (name, ret)
    assert len(args) == len(argtypes), (name, args)
    for i, (arg, want) in enumerate(zip(args, argtypes)):
        assert arg in C_SPELLING[want], (name, i, arg)


def test_launchers_take_their_pointers_then_eight_ints_float_stream():
    source = _c_entry_points()
    for kernel, n_ptr in ((fa.flash_fwd, 5), (fa.flash_dq, 8),
                          (fa.flash_dkv, 9)):
        assert kernel.n_ptr == n_ptr
        args = source[kernel.symbol][1]
        assert all(a.endswith("void*") for a in args[:n_ptr])
        assert args[n_ptr:] == ["int"] * 8 + ["float", "void*"]


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN57_GLOBAL__N__c9e4e474_18_flash_attention_cu_5326155215flash_dq_kernelILi32EEEvPKfS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN57_GLOBAL__N__c9e4e474_18_flash_attention_cu_5326155215flash_dq_kernelILi32EEEvPKfS2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 416 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN57_GLOBAL__N__c9e4e474_18_flash_attention_cu_5326155216flash_dkv_kernelILi8EEEvPKfS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN57_GLOBAL__N__c9e4e474_18_flash_attention_cu_5326155216flash_dkv_kernelILi8EEEvPKfS2_
    8 bytes stack frame, 8 bytes spill stores, 128 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function 'fused_sgd_kernel' for 'sm_90a'
ptxas info    : Function properties for fused_sgd_kernel
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 24 registers, used 0 barriers, 416 bytes cmem[0]
"""


def test_chip_smoke_reads_the_compiler_report_by_entry_function():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    reports = chip_smoke.ptxas_reports(PTXAS_LOG)
    assert reports == {
        "flash_dq_kernel<32>": {"registers": 128, "spill_store_bytes": 0,
                                "spill_load_bytes": 0},
        "flash_dkv_kernel<8>": {"registers": 64, "spill_store_bytes": 8,
                                "spill_load_bytes": 128},
        "fused_sgd_kernel": {"registers": 24, "spill_store_bytes": 0,
                             "spill_load_bytes": 0}}
    assert chip_smoke.ptxas_reports("cached") == {}
    assert chip_smoke._flash_entry("dq", 32) == "flash_dq_kernel<32>"
    assert chip_smoke._flash_entry("dkv", 20) == "flash_dkv_kernel<32>"
    assert chip_smoke._flash_entry("fwd", 32) == "flash_fwd_kernel<32>"
