"""Gradient quantization of the PyTorch port (``ops/quantization.py`` and
kernel B3's plain version, ``ops/quant_bin.py``) against the JAX package's
jnp path (``msrflute_tpu/ops/quantization.py``, what it runs off a TPU),
on the same ``[K, P]`` payloads made with numpy.

Tolerances: the quantile thresholds to ``rtol 1e-6``; the quantized
payloads bitwise.  Both sort, index and interpolate in the same float32
operations, and B3's arithmetic is IEEE division, rounding half to even
and separately rounded products and sums on both sides.  The CUDA kernel
is held bitwise to the plain version on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msrflute_tpu.ops import quantization as jq
from msrflute_tpu_torch.ops import quantization as tq
from msrflute_tpu_torch.ops.quant_bin import quant_bin_plain

#: the small GRU's leaf sizes (vocab 64, embed 8, hidden 16), plus a leaf
#: of one element and a larger leaf
SIZES = [48, 768, 48, 384, 512, 128, 64, 1, 20_000]


def _payload(K=4, seed=0, sizes=SIZES):
    rng = np.random.default_rng(seed)
    leaves = [rng.normal(scale=rng.uniform(0.01, 2.0), size=(K, n))
              .astype(np.float32) for n in sizes]
    leaves[1][:, :5] = 0.0                 # ties at zero
    leaves[3][2] = 0.25                    # a constant leaf: hi == lo
    return leaves


def _bounds(sizes):
    return list(np.concatenate([[0], np.cumsum(sizes)]).astype(int))


def _jax_quantize(leaves, thr, bits, approx):
    tree = {f"l{i}": jnp.asarray(v) for i, v in enumerate(leaves)}
    out = jax.vmap(lambda t: jq.quantize_pytree(
        t, quant_threshold=jnp.float32(thr), quant_bits=bits,
        approx=approx))(tree)
    return np.concatenate([np.asarray(out[f"l{i}"])
                           for i in range(len(leaves))], axis=1)


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("thr,bits", [(0.7, 10), (0.0, 10), (0.95, 4),
                                      (0.5, 1)])
def test_quantize_pytree_matches_jax(thr, bits, approx):
    leaves = _payload(seed=bits)
    want = _jax_quantize(leaves, thr, bits, approx)
    flat = torch.from_numpy(np.concatenate(leaves, axis=1))
    got = tq.quantize_pytree(flat, _bounds(SIZES), thr, bits, approx=approx)
    np.testing.assert_array_equal(got.numpy(), want)
    # the constant leaf keeps its value where it is above the threshold
    a, b = _bounds(SIZES)[3:5]
    assert set(np.unique(got.numpy()[2, a:b])) <= {0.0, 0.25}


@pytest.mark.parametrize("q", [0.0, 0.3, 0.7, 0.999, 1.0])
def test_exact_quantile_matches_jnp(q):
    rng = np.random.default_rng(1)
    a = np.abs(rng.normal(size=(3, 12_345))).astype(np.float32)
    want = np.stack([np.asarray(jnp.quantile(jnp.asarray(r),
                                             jnp.float32(q))) for r in a])
    got = tq.exact_quantile_abs(torch.from_numpy(a), q).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_exact_quantile_of_a_row_with_nan_is_nan():
    a = torch.ones((2, 10))
    a[1, 3] = float("nan")
    got = tq.exact_quantile_abs(a, 0.5)
    assert got[0] == 1.0 and torch.isnan(got[1])


@pytest.mark.parametrize("q", [0.1, 0.7, 0.99])
def test_approx_quantile_matches_jax(q):
    rng = np.random.default_rng(2)
    a = np.abs(rng.standard_t(3, size=(3, 50_000))).astype(np.float32)
    want = np.stack([np.asarray(jq.approx_quantile_abs(jnp.asarray(r),
                                                       jnp.float32(q)))
                     for r in a])
    got = tq.approx_quantile_abs(torch.from_numpy(a), q).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # within one bin width of the exact quantile
    exact = tq.exact_quantile_abs(torch.from_numpy(a), q).numpy()
    assert np.all(np.abs(got - exact) <= a.max(axis=1) / 2048 + 1e-6)


def test_quantize_array_matches_jax():
    rng = np.random.default_rng(3)
    g = rng.normal(size=(4, 999)).astype(np.float32)
    want = jax.vmap(lambda x: jq.quantize_array(x, 256, jnp.float32(0.6)))(
        jnp.asarray(g))
    got = tq.quantize_pytree(torch.from_numpy(g), [0, 999], 0.6, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_half_bin_values_round_to_even():
    """Values exactly halfway between two levels go to the even level, as
    jnp.round does: lo = 0, hi = 3 with 4 bins gives width 1."""
    x = torch.tensor([[0.0, 0.5, 1.5, 2.5, 3.0, 1.0]])
    off = torch.tensor([0, 6])
    lo, hi = torch.zeros((1, 1)), torch.full((1, 1), 3.0)
    out = quant_bin_plain(x, off, lo, hi, torch.full((1, 1), -1.0), 4)
    assert out.tolist() == [[0.0, 0.0, 2.0, 2.0, 3.0, 1.0]]
    want = jq.quantize_array(jnp.asarray(x.numpy()[0]), 4, -1.0,
                             min_grad=jnp.float32(0.0),
                             max_grad=jnp.float32(3.0))
    np.testing.assert_array_equal(out.numpy()[0], np.asarray(want))


def test_no_threshold_is_the_identity():
    flat = torch.randn(2, 10)
    assert tq.quantize_pytree(flat, [0, 10], None, 8) is flat
