"""Differential privacy of the PyTorch port (``privacy/__init__.py``) and kernel
B2's plain version (``ops/gaussian_noise.py``) against the JAX package.

- Local DP, clip-only (``eps < 0``) and ``eps >= 0``, on a ``[K, P]``
  payload, with the JAX package's own ``jax.random.normal`` draws handed to
  the port: ``rtol 1e-5`` (the two packages sum the row norms in different
  orders); the weight exactly where it is not noised.
- Global DP's plain path with JAX's CPU normals handed in: ``rtol 1e-6``.
- ``bits_to_normal`` against JAX's on the same 32-bit words: ``rtol 1e-6``
  and ``atol 1e-6`` (XLA's and PyTorch's CPU ``log``/``cos`` may differ
  in the last place).
- The port's Philox-4x32-10 against the Random123 known-answer vectors,
  bitwise.
- The moments and 3-sigma tail of the port's own stream, with the bounds of
  ``tests/test_pallas_kernels.py::test_bits_to_normal_statistics``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msrflute_tpu import privacy as jp
from msrflute_tpu.ops.pallas_kernels import bits_to_normal as jax_b2n
from msrflute_tpu_torch import privacy as tp
from msrflute_tpu_torch.ops import gaussian_noise as gn

DP = {"eps": 100.0, "delta": 1e-7, "max_grad": 1.0, "max_weight": 10000.0,
      "min_weight": 0.0, "weight_scaler": 0.0001}


def _payload(K=4, P=1000, seed=0):
    rng = np.random.default_rng(seed)
    flat = (rng.normal(size=(K, P)) * rng.uniform(0.01, 3.0, size=(K, 1))
            ).astype(np.float32)
    weight = rng.uniform(0.1, 2.0, size=(K,)).astype(np.float32)
    return flat, weight


@pytest.mark.parametrize("eps,add_weight_noise", [(-1.0, True),
                                                  (100.0, True),
                                                  (100.0, False),
                                                  (0.5, True)])
def test_local_dp_matches_jax_with_its_noise(eps, add_weight_noise):
    cfg = dict(DP, eps=eps)
    flat, weight = _payload()
    K, P = flat.shape
    keys = jax.random.split(jax.random.PRNGKey(7), K)
    want_flat, want_w = jax.vmap(
        lambda g, w, k: jp.apply_local_dp(g, w, cfg, add_weight_noise, k))(
        jnp.asarray(flat), jnp.asarray(weight), keys)
    z = jax.vmap(lambda k: jax.random.normal(k, (P + 1,), jnp.float32))(keys)
    got_flat, got_w = tp.apply_local_dp(
        torch.from_numpy(flat), torch.from_numpy(weight), cfg,
        add_weight_noise, torch.from_numpy(np.array(z)))
    np.testing.assert_allclose(got_flat.numpy(), np.asarray(want_flat),
                               rtol=1e-5, atol=1e-7)
    if eps < 0 or not add_weight_noise:
        np.testing.assert_array_equal(got_w.numpy(), weight)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-5)
    if eps < 0:   # clip-only: every row's norm is at most max_grad
        assert np.all(np.linalg.norm(got_flat.numpy(), axis=1) <= 1.0 + 1e-6)


def test_local_dp_refuses_missing_noise():
    flat, weight = _payload()
    with pytest.raises(ValueError, match="z must be"):
        tp.apply_local_dp(torch.from_numpy(flat), torch.from_numpy(weight),
                          DP, True, None)


def test_ldp_noise_std_matches_jax():
    assert tp.compute_ldp_noise_std(100.0, 10000.00005, 1e-7) == \
        jp.compute_ldp_noise_std(100.0, 10000.00005, 1e-7)


@pytest.mark.parametrize("num_clients", [1.0, 10.0, 3.0])
def test_global_dp_plain_path_matches_jax_with_its_noise(num_clients):
    cfg = dict(DP, enable_global_dp=True, global_sigma=1.0)
    agg = np.random.default_rng(4).normal(size=(4097,)).astype(np.float32)
    rng = jax.random.PRNGKey(11)
    want = jp.apply_global_dp(jnp.asarray(agg), cfg, rng=rng,
                              num_clients=jnp.float32(num_clients))
    z = np.asarray(jax.random.normal(rng, agg.shape, jnp.float32))
    got = gn.noise_apply(torch.from_numpy(agg), 1.0,
                         tp.global_dp_sigma(cfg, num_clients),
                         torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_apply_global_dp_on_cpu_is_the_plain_philox_noise():
    cfg = {"global_sigma": 2.0, "max_grad": 0.5}
    agg = torch.linspace(-1.0, 1.0, 1001)
    got = tp.apply_global_dp(agg, cfg, seed=1234, num_clients=10.0)
    want = gn.gaussian_noise_plain(agg, 1.0, np.float32(0.1), 1234)
    assert torch.equal(got, want)
    assert gn.fused_gaussian_noise.launches == 0    # CPU: no kernel


def test_bits_to_normal_matches_jax():
    rng = np.random.default_rng(5)
    b1 = rng.integers(0, 2**32, size=200_000, dtype=np.uint64)
    b2 = rng.integers(0, 2**32, size=200_000, dtype=np.uint64)
    b1[:4] = [0, 0xFFFFFFFF, 0, 0xFFFFFFFF]
    b2[:4] = [0, 0, 0xFFFFFFFF, 0xFFFFFFFF]
    want = np.asarray(jax_b2n(jnp.asarray(b1.astype(np.uint32)),
                              jnp.asarray(b2.astype(np.uint32))))
    got = gn.bits_to_normal(torch.from_numpy(b1.astype(np.int64)),
                            torch.from_numpy(b2.astype(np.int64))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(got).max() < 7.5


#: Random123's kat_vectors for philox4x32 with 10 rounds:
#: (counter words, key words) -> output words
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    words = gn.philox4x32_10(
        tuple(torch.tensor([c], dtype=torch.int64) for c in ctr), key)
    assert tuple(int(w[0]) for w in words) == want


def test_philox_stream_layout():
    """Element 2j takes words (0, 1) and element 2j + 1 words (2, 3) of the
    call on counter j; the key is the seed's (low, high) words."""
    seed = (0xA4093822 << 32) | 0x299F31D0
    assert gn.seed_key(seed) == (0x299F31D0, 0xA4093822)
    b1, b2 = gn.philox_pair_bits(seed, 7, "cpu")
    for j in range(4):
        w = gn.philox4x32_10(tuple(torch.tensor([v]) for v in (j, 0, 0, 0)),
                             gn.seed_key(seed))
        assert (int(b1[2 * j]), int(b2[2 * j])) == (int(w[0]), int(w[1]))
        if 2 * j + 1 < 7:
            assert (int(b1[2 * j + 1]), int(b2[2 * j + 1])) == \
                (int(w[2]), int(w[3]))


def test_port_stream_statistics():
    """The moments and tail bounds of the JAX package's Box-Muller test,
    on the port's own Philox stream; two seeds differ, and neighbouring
    elements (one Philox call) do not correlate."""
    n = 1 << 21
    z = gn.gaussian_noise_plain(torch.zeros(n), 1.0, 1.0, 2024).double()
    z = z.numpy()
    assert np.isfinite(z).all()
    assert abs(z.mean()) < 5e-3, z.mean()
    assert abs(z.std() - 1.0) < 5e-3, z.std()
    zc = z - z.mean()
    assert abs((zc ** 3).mean()) < 2e-2
    assert abs((zc ** 4).mean() - 3.0) < 5e-2
    tail = float((np.abs(z) > 3.0).mean())
    assert abs(tail - 0.0027) < 5e-4, tail
    assert abs(np.corrcoef(z[0::2], z[1::2])[0, 1]) < 5e-3
    other = gn.gaussian_noise_plain(torch.zeros(1024), 1.0, 1.0, 2025)
    assert not torch.equal(other, torch.from_numpy(z[:1024]).float())
    # sigma and scale enter as x * scale + sigma * z
    x = torch.linspace(-3, 3, 1024)
    np.testing.assert_allclose(
        gn.gaussian_noise_plain(x, 2.0, 0.5, 2024).numpy(),
        (x * 2.0 + 0.5 * torch.from_numpy(z[:1024]).float()).numpy(),
        rtol=0, atol=0)
