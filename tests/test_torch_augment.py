"""The port's RandAugment (``msrflute_tpu_torch/data/augment.py``) against
the JAX package's (``msrflute_tpu/data/augment.py``): bitwise equal, draw
for draw, from one ``np.random.default_rng`` seed — uint8 and float
images, ``[B, H, W]`` and ``[B, H, W, C]``, the flat-vector branch, and
each of the 14 ops alone."""

import numpy as np
import pytest

from msrflute_tpu.data import augment as jax_aug
from msrflute_tpu_torch.data import augment as port_aug


def _images(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return (rng.normal(size=shape) * 3.0 + 1.0).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape", [(6, 12, 12), (6, 12, 12, 3),
                                   (4, 32, 32, 3)])
@pytest.mark.parametrize("num_ops,magnitude", [(2, 9), (3, 27)])
def test_rand_augment_is_bitwise_equal(dtype, shape, num_ops, magnitude):
    x = _images(shape, dtype, seed=sum(shape))
    want = jax_aug.rand_augment(x, num_ops=num_ops, magnitude=magnitude,
                                rng=np.random.default_rng(7))
    got = port_aug.rand_augment(x, num_ops=num_ops, magnitude=magnitude,
                                rng=np.random.default_rng(7))
    assert got.dtype == want.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_flat_vectors_take_the_noise_view(dtype):
    x = _images((5, 784), dtype, seed=3)
    want = jax_aug.rand_augment(x, rng=np.random.default_rng(1))
    got = port_aug.rand_augment(x, rng=np.random.default_rng(1))
    assert got.dtype == x.dtype
    np.testing.assert_array_equal(got, want)


def test_the_op_lists_match():
    assert [n for n, _ in port_aug.AUGMENT_OPS] == \
        [n for n, _ in jax_aug.AUGMENT_OPS]
    assert len(port_aug.AUGMENT_OPS) == 14


@pytest.mark.parametrize("index", range(14))
@pytest.mark.parametrize("shape", [(10, 10), (10, 10, 3)])
def test_each_op_alone_is_bitwise_equal(index, shape):
    name, port_fn = port_aug.AUGMENT_OPS[index]
    jax_fn = dict(jax_aug.AUGMENT_OPS)[name]
    img = np.random.default_rng(index).random(shape).astype(np.float32)
    for m in (0.0, 0.3, 1.0):
        want = jax_fn(img.copy(), m, np.random.default_rng(11))
        got = port_fn(img.copy(), m, np.random.default_rng(11))
        np.testing.assert_array_equal(got, want, err_msg=f"{name} m={m}")
