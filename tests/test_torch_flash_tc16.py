"""The rounding of the tensor-core arms of kernels B4, B5 and B6 (bfloat16
and float16 storage), emulated on the CPU.

The 16-bit arms of ``csrc/flash_attention.cu`` (``flash_fwd_tc_kernel``,
``flash_dq_tc_kernel`` and ``flash_dkv_tc_kernel``) run their products on
the tensor cores: ``mma.sync`` on 16-bit operands with float32
accumulators.  S = Q K^T and dP = dO V^T take the 16-bit inputs as they
are, so their products are exact and summed in float32, as the plain
versions do.  The probabilities P (into O += P V and dV += P^T dO) and
dS = P (dP - delta + glse) (into dQ += dS K and dK += dS^T Q) are float32
values, which the TPU kernel multiplies in float32
(``msrflute_tpu/ops/pallas_attention.py:133-134``, ``:191-198``,
``:246-257``); the card's kernels round each once, to nearest even, to
the storage type.  The row sum l and the lse come from the float32 P,
before any rounding, and the scale multiplies dQ and dK once, at the end.

:func:`fwd_tc`, :func:`dq_tc` and :func:`dkv_tc` compute B4, B5 and B6
that way, B4 over 64-key tiles with the online softmax's running max, as
the kernel rounds P before the max is final.  They are held to the JAX
package's ``_fwd`` and ``_bwd`` in interpret mode and to the port's plain
versions, on the same 16-bit inputs made with numpy from a seed, on small
versions of ``chip_smoke.py``'s ``phase_kernel_flash16`` cases: ``max
|emulation - reference| / max |reference|`` within ``FLASH16_TOL`` (one
ulp of the type at the largest magnitude, 2^-7 bfloat16 and 2^-10
float16, the bound the kernels are held to on the card) for out, dq, dk
and dv, and the lse within ``FLASH_FWD_TOL`` (1e-5) on the rows that see
a key.  This is the evidence that rounding P and dS once holds that
bound, in both types, before the kernels run.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msrflute_tpu.ops import pallas_attention as jax_pa
from msrflute_tpu_torch.ops import flash_attention as fa

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
#: chip_smoke.py's bounds: out, dk, dv relative to their largest value
FLASH16_TOL = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
FLASH_FWD_TOL = 1e-5
#: the kernels' tile of keys (B4) and of queries (B6)
TILE = 64
NEG = fa.NEG
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: small versions of phase_kernel_flash16's eleven cases: (B, Lq, Lk, H,
#: D, causal, q_offset, k_offset)
CASES = {
    "main": (2, 200, 200, 2, 32, True, 0, 0),
    "L17": (3, 17, 17, 2, 32, True, 0, 0),
    "offsets_masked_rows": (2, 100, 150, 2, 32, True, 0, 30),
    "non_causal": (2, 77, 130, 2, 32, False, 0, 0),
    "D8": (2, 65, 65, 2, 8, True, 0, 0),
    "D64": (2, 130, 130, 2, 64, True, 0, 0),
    "D128": (1, 129, 129, 2, 128, True, 0, 0),
    "ragged_diag_edge": (2, 150, 170, 2, 32, True, 37, 11),
    "D20": (2, 100, 90, 2, 20, True, 5, 0),
    "D5": (1, 70, 80, 2, 5, True, 10, 0),
    "BH1": (1, 300, 300, 1, 32, True, 0, 0),
}


def _mask(Lq, Lk, causal, qo, ko):
    q_pos = qo + torch.arange(Lq)[:, None]
    k_pos = ko + torch.arange(Lk)[None, :]
    return (q_pos >= k_pos) if causal else torch.ones(Lq, Lk,
                                                      dtype=torch.bool)


def _f32(x):
    return x.to(torch.float32)


def fwd_tc(q, k, v, causal, qo, ko):
    """B4's tensor-core arm: S in float32 from the 16-bit q and k, the
    online softmax over 64-key tiles in float32, each tile's P rounded to
    the storage type for P V, l from the float32 P; out rounded once."""
    st = q.dtype
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    s_all = torch.einsum("blhd,bmhd->bhlm", _f32(q), _f32(k)) / np.sqrt(D)
    mask = _mask(Lq, Lk, causal, qo, ko)
    m = torch.full((B, H, Lq), NEG)
    l = torch.zeros((B, H, Lq))
    acc = torch.zeros((B, H, Lq, D))
    for k0 in range(0, Lk, TILE):
        vis = mask[:, k0:k0 + TILE]
        s = torch.where(vis, s_all[..., k0:k0 + TILE], NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(vis, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        p16 = _f32(p.to(st))
        acc = acc * corr[..., None] + torch.einsum(
            "bhlm,bmhd->bhld", p16, _f32(v[:, k0:k0 + TILE]))
        m = m_new
    lc = torch.clamp(l, min=1e-30)
    out = (acc / lc[..., None]).transpose(1, 2).to(st)
    lse = torch.where(l > 0, m + torch.log(lc), NEG)
    return out, lse


def dkv_tc(q, k, v, g, lse, delta, g_lse, causal, qo, ko):
    """B6's tensor-core arm: S^T and dP^T in float32 from the 16-bit
    inputs, p from the saved lse, P and dS / scale = p (dP - delta +
    glse) rounded to the storage type for dV += P^T dO and dK += dS^T Q,
    float32 sums, the scale on dK at the end; dk, dv rounded once."""
    st = q.dtype
    D = q.shape[3]
    scale = 1.0 / np.sqrt(D)
    mask = _mask(q.shape[1], k.shape[1], causal, qo, ko)
    s = torch.einsum("blhd,bmhd->bhlm", _f32(q), _f32(k)) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("blhd,bmhd->bhlm", _f32(g), _f32(v))
    ds = p * (dp + (g_lse - delta)[..., None])
    dv = torch.einsum("bhlm,blhd->bmhd", _f32(p.to(st)), _f32(g))
    dk = torch.einsum("bhlm,blhd->bmhd", _f32(ds.to(st)), _f32(q)) * scale
    return dk.to(st), dv.to(st)


def dq_tc(q, k, v, g, lse, delta, g_lse, causal, qo, ko):
    """B5's tensor-core arm: S and dP in float32 from the 16-bit inputs, p
    from the saved lse, dS / scale = p (dP - delta + glse) rounded to the
    storage type for dQ += dS K, a float32 sum, the scale on dQ at the
    end; dq rounded once."""
    st = q.dtype
    D = q.shape[3]
    scale = 1.0 / np.sqrt(D)
    mask = _mask(q.shape[1], k.shape[1], causal, qo, ko)
    s = torch.einsum("blhd,bmhd->bhlm", _f32(q), _f32(k)) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("blhd,bmhd->bhlm", _f32(g), _f32(v))
    ds = p * (dp + (g_lse - delta)[..., None])
    dq = torch.einsum("bhlm,bmhd->blhd", _f32(ds.to(st)), _f32(k)) * scale
    return dq.to(st)


def _np32(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _rel(got, want):
    """``max |got - want| / max |want|``, as chip_smoke.py measures."""
    got, want = _np32(got), _np32(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _inputs(case, dtype, seed):
    tdt, jdt = DTYPES[dtype]
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


def _jax_f32(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


#: each case's JAX ``_fwd`` and ``_bwd`` in interpret mode, on the inputs
#: both tests draw for it (the same seed, the same lse cotangent): run
#: once, read by both
_jax_refs = {}


def _jax_ref(name, dtype, jq, jk, jv, jg, g_lse):
    """``(out, lse, dead rows, lse cotangent, (dq, dk, dv))`` of JAX's
    kernels for the case."""
    if (name, dtype) not in _jax_refs:
        B, Lq, Lk, H, D, causal, qo, ko = CASES[name]
        scale = 1.0 / np.sqrt(D)
        j_out, j_lse = jax_pa._fwd(jq, jk, jv, qo, ko, causal, scale, TILE,
                                   TILE, True)
        j_lse = np.asarray(j_lse)
        dead = j_lse == NEG
        glse = np.where(dead, 0.0, g_lse).astype(np.float32)
        grads = jax_pa._bwd(jq, jk, jv, j_out, jnp.asarray(j_lse), qo, ko,
                            jg, jnp.asarray(glse), causal, scale, TILE,
                            TILE, True)
        _jax_refs[(name, dtype)] = (j_out, j_lse, dead, glse, grads)
    return _jax_refs[(name, dtype)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_core_rounding_holds_flash16_tol(name, dtype):
    B, Lq, Lk, H, D, causal, qo, ko = CASES[name]
    tol = FLASH16_TOL[dtype]
    (jq, jk, jv, jg), (q, k, v, g), g_lse = _inputs(CASES[name], dtype,
                                                    len(name))

    # B4 against JAX's _fwd and the port's plain version
    out, lse = fwd_tc(q, k, v, causal, qo, ko)
    assert out.dtype == q.dtype
    j_out, j_lse, dead, glse, (_, j_dk, j_dv) = _jax_ref(
        name, dtype, jq, jk, jv, jg, g_lse)
    p_out, p_lse = fa.attention_lse_plain(q, k, v, causal, qo, ko)
    np.testing.assert_array_equal(lse.numpy() == NEG, dead)
    np.testing.assert_array_equal(p_lse.numpy() == NEG, dead)
    assert bool((out.transpose(1, 2)[torch.from_numpy(dead)] == 0).all())
    live = ~dead
    for ref_out, ref_lse, who in ((_jax_f32(j_out), j_lse, "jax"),
                                  (p_out, p_lse.numpy(), "plain")):
        e_out = _rel(out, ref_out)
        assert e_out <= tol, (who, "out", e_out)
        if live.any():
            e_lse = _rel(lse.numpy()[live], ref_lse[live])
            assert e_lse <= FLASH_FWD_TOL, (who, "lse", e_lse)

    # B6 on JAX's out and lse, a nonzero lse cotangent on the live rows
    t_out = torch.from_numpy(_jax_f32(j_out)).to(q.dtype)
    t_lse = torch.from_numpy(j_lse)
    delta = fa.attention_delta(t_out, g)
    args = (q, k, v, g, t_lse, delta, torch.from_numpy(glse), causal, qo,
            ko)
    dk, dv = dkv_tc(*args)
    assert dk.dtype == dv.dtype == q.dtype
    p_dk, p_dv = fa.attention_dkv_plain(*args)
    for (ref_dk, ref_dv), who in (((_jax_f32(j_dk), _jax_f32(j_dv)), "jax"),
                                  ((p_dk, p_dv), "plain")):
        e_dk, e_dv = _rel(dk, ref_dk), _rel(dv, ref_dv)
        assert e_dk <= tol and e_dv <= tol, (who, e_dk, e_dv)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_dq_tensor_core_rounding_holds_flash16_tol(name, dtype):
    """B5 on JAX's out and lse, a nonzero lse cotangent on the live rows:
    within ``FLASH16_TOL`` of ``_bwd``'s dq and of the plain version, and
    the rows that see no key exactly 0."""
    B, Lq, Lk, H, D, causal, qo, ko = CASES[name]
    tol = FLASH16_TOL[dtype]
    (jq, jk, jv, jg), (q, k, v, g), g_lse = _inputs(CASES[name], dtype,
                                                    len(name))
    j_out, j_lse, dead, glse, (j_dq, _, _) = _jax_ref(
        name, dtype, jq, jk, jv, jg, g_lse)
    t_out = torch.from_numpy(_jax_f32(j_out)).to(q.dtype)
    delta = fa.attention_delta(t_out, g)
    args = (q, k, v, g, torch.from_numpy(j_lse), delta,
            torch.from_numpy(glse), causal, qo, ko)
    dq = dq_tc(*args)
    assert dq.dtype == q.dtype
    assert bool((dq.transpose(1, 2)[torch.from_numpy(dead)] == 0).all())
    for ref, who in ((_jax_f32(j_dq), "jax"),
                     (fa.attention_dq_plain(*args), "plain")):
        e_dq = _rel(dq, ref)
        assert e_dq <= tol, (who, "dq", e_dq)


#: two functions as ``cuobjdump -sass`` prints them: a tensor-core product
#: (ldmatrix, mma.sync in bf16 and f16, a predicated one) and a CUDA-core
#: loop
SASS_TWO = """
        Function : _Z19flash_fwd_tc_kernelILi32E13__nv_bfloat16EvPKT0_
        /*0000*/                   LDSM.16.M88.4 R4, [R2] ;
        /*0010*/                   LDSM.16.MT88.4 R8, [R3] ;
        /*0020*/                   HMMA.16816.F32.BF16 R12, R4, R8, R12 ;
        /*0030*/                   HMMA.16816.F32.BF16 R16, R4, R10, R16 ;
        /*0040*/               @P0 HMMA.16816.F32 R20, R4, R8, R20 ;
        /*0050*/                   MUFU.EX2 R1, R1 ;
        /*0060*/                   EXIT ;
        Function : _Z16flash_dq_kernelILi32E13__nv_bfloat16EvPKT0_
        /*0000*/                   LDS.128 R4, [R2] ;
        /*0010*/                   FFMA R8, R4, R5, R8 ;
        /*0020*/                   EXIT ;
"""


def test_sass_tensor_core_count():
    """``chip_smoke.py`` fails B4's and B6's 16-bit arms unless their SASS
    holds tensor-core instructions: HMMA (and HGMMA) counted, predicated
    ones too, nothing else."""
    from msrflute_tpu_torch.ops import sass
    bodies = sass.functions(SASS_TWO)
    counts = {name.split("ILi")[0][4:]: sass.tensor_core_count(body)
              for name, body in bodies.items()}
    assert counts == {"flash_fwd_tc_kernel": 3, "flash_dq_kernel": 0}


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def test_chip_smoke_names_the_dq_tensor_core_instance():
    """B5's 16-bit instance is ``flash_dq_tc_kernel``, at D padded to 16 at
    least, as B4's and B6's are."""
    cs = _chip_smoke()
    assert cs._flash_entry("dq", 32, "bfloat16") == \
        "flash_dq_tc_kernel<32, bfloat16>"
    assert cs._flash_entry("dq", 8, "float16") == \
        "flash_dq_tc_kernel<16, float16>"


#: the built library's SASS as ``cuobjdump -sass`` prints it, mangled names
#: in the anonymous namespace (each split by a line continuation): B5's
#: 16-bit instance on the tensor cores beside its float32 instance on the
#: CUDA cores
SASS_DQ = """
        Function : _ZN57_GLOBAL__N__c9e4e474_18_flash_attention_cu_53261552\
18flash_dq_tc_kernelILi32E13__nv_bfloat16EEvPKT0_S4_S4_S4_PKfS6_S6_
        /*0000*/                   LDSM.16.M88.4 R4, [R2] ;
        /*0010*/                   HMMA.16816.F32.BF16 R12, R4, R8, R12 ;
        /*0020*/                   LDSM.16.MT88.4 R8, [R3] ;
        /*0030*/                   HMMA.16816.F32.BF16 R16, R4, R10, R16 ;
        /*0040*/                   EXIT ;
        Function : _ZN57_GLOBAL__N__c9e4e474_18_flash_attention_cu_53261552\
15flash_dq_kernelILi32EfEEvPKT0_S3_S3_S3_PKfS5_S5_
        /*0000*/                   LDS.128 R4, [R2] ;
        /*0010*/                   FFMA R8, R4, R5, R8 ;
        /*0020*/                   EXIT ;
"""


def test_chip_smoke_counts_the_dq_tensor_core_instructions(monkeypatch):
    """``phase_kernel_flash16`` fails B5's 16-bit arm unless the SASS of
    ``flash_dq_tc_kernel`` holds HMMA: :func:`chip_smoke._tensor_core_sass`
    finds it by its source name and counts it; the float32 kernel is no
    tensor-core instance."""
    from msrflute_tpu_torch.ops import _build, sass
    cs = _chip_smoke()
    monkeypatch.setattr(_build, "library_path", lambda name: name + ".so")
    monkeypatch.setattr(sass, "disassemble", lambda path: SASS_DQ)
    assert cs._tensor_core_sass() == {"flash_dq_tc_kernel<32, bfloat16>": 2}
