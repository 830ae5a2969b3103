"""The library functions off every path, held bitwise to the JAX package's
(each port module is its own copy at the same relative path, numpy and
scipy only):

- ``privacy/prv.py``: ``PRVAccountant`` and ``compute_dp_epsilon``;
- ``privacy/dp_kmeans.py``: the sphere-packing start and ``dp_kmeans``;
- ``data/partition.py``: the Dirichlet label-skew partition, its label
  counts, the rotation wedges, ``rotate_images`` and ``dirichlet_blob``;
- ``data/samplers.py``: ``AverageMeter``, ``BatchSampler`` and
  ``DynamicBatchSampler``, on the same ``random.Random`` draws;
- ``utils/nbest.py``: ``softmax`` and ``write_nbest_jsonl`` (byte-equal
  files).
"""

import random

import numpy as np
import pytest

from msrflute_tpu.data import partition as j_part
from msrflute_tpu.data import samplers as j_samp
from msrflute_tpu.privacy import dp_kmeans as j_km
from msrflute_tpu.privacy import prv as j_prv
from msrflute_tpu.utils import nbest as j_nbest
from msrflute_tpu_torch.data import partition as p_part
from msrflute_tpu_torch.data import samplers as p_samp
from msrflute_tpu_torch.privacy import dp_kmeans as p_km
from msrflute_tpu_torch.privacy import prv as p_prv
from msrflute_tpu_torch.utils import nbest as p_nbest


def _same(a, b):
    """Equal structure and bitwise-equal arrays and floats."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and a.shape == b.shape
        assert a.tobytes() == np.asarray(b).tobytes()
    elif isinstance(a, float):
        assert np.float64(a).tobytes() == np.float64(b).tobytes(), (a, b)
    else:
        assert a == b


@pytest.mark.parametrize("q, sigma, steps, delta", [
    (0.01, 1.0, 100, 1e-5), (0.1, 2.0, 50, 1e-6), (0.002, 0.8, 1000, 1e-5)])
def test_prv_accountant_equals_the_jax_function(q, sigma, steps, delta):
    _same(p_prv.compute_dp_epsilon(q, sigma, steps, delta),
          j_prv.compute_dp_epsilon(q, sigma, steps, delta))
    mine = p_prv.PRVAccountant(sigma, q, steps)
    ref = j_prv.PRVAccountant(sigma, q, steps)
    _same(mine.compute_epsilon(delta, steps // 2),
          ref.compute_epsilon(delta, steps // 2))
    _same(mine.compute_delta(1.0, steps), ref.compute_delta(1.0, steps))
    with pytest.raises(ValueError):
        mine.compute_delta(1.0, steps + 1)


def test_prv_is_not_reexported_from_privacy():
    import msrflute_tpu_torch.privacy as pp
    assert not hasattr(pp, "PRVAccountant")
    assert not hasattr(pp, "compute_dp_epsilon")


@pytest.mark.parametrize("ratio", [-1.0, 2.0])
def test_dp_kmeans_equals_the_jax_function(ratio):
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(c, 0.05, size=(40, 3))
                        for c in (-0.5, 0.0, 0.5)])
    kw = dict(n_clusters=3, eps=5.0, max_iter=20, seed=4,
              cluster_to_weight_ratio=ratio)
    _same(p_km.dp_kmeans(x, **kw), j_km.dp_kmeans(x, **kw))
    _same(p_km.sphere_packing_initialization(
        4, 3, 0.2, 1.0, rng=np.random.default_rng(1)),
        j_km.sphere_packing_initialization(
            4, 3, 0.2, 1.0, rng=np.random.default_rng(1)))


def test_partition_functions_equal_the_jax_functions():
    labels = np.random.default_rng(0).integers(0, 5, size=300)
    for alpha in (0.1, 1.0):
        parts = p_part.dirichlet_partition(labels, 6, alpha,
                                           np.random.default_rng(7))
        _same(parts, j_part.dirichlet_partition(labels, 6, alpha,
                                                np.random.default_rng(7)))
        _same(p_part.partition_label_counts(labels, parts),
              j_part.partition_label_counts(labels, parts))
    for c in range(4):
        assert p_part.client_rotation_range(c, 4) == \
            j_part.client_rotation_range(c, 4)
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, size=(3, 8, 8, 1)).astype(np.uint8)
    for angle in (0.0, 33.0, -90.0):
        _same(p_part.rotate_images(imgs, angle),
              j_part.rotate_images(imgs, angle))
    x = rng.integers(0, 256, size=(120, 6, 6, 1)).astype(np.uint8)
    y = rng.integers(0, 3, size=120)
    for rotate, train in ((False, True), (True, True), (True, False)):
        _same(p_part.dirichlet_blob(x, y, 4, 1.0, np.random.default_rng(5),
                                    rotate=rotate, is_train=train),
              j_part.dirichlet_blob(x, y, 4, 1.0, np.random.default_rng(5),
                                    rotate=rotate, is_train=train))


@pytest.mark.parametrize("seeded", [False, True])
def test_samplers_equal_the_jax_samplers(seeded):
    def rng():
        return random.Random(11) if seeded else None

    for kw in (dict(randomize=True), dict(randomize=False),
               dict(randomize=True, drop_last=True)):
        mine = p_samp.BatchSampler(23, 4, rng=rng(), **kw)
        ref = j_samp.BatchSampler(23, 4, rng=rng(), **kw)
        assert len(mine) == len(ref)
        assert [list(mine) for _ in range(3)] == [list(ref) for _ in range(3)]
    durations = np.random.default_rng(1).uniform(0.5, 9.0, 40).tolist()
    for kw in (dict(), dict(max_batch_size=3), dict(unsorted_batch=True)):
        mine = p_samp.DynamicBatchSampler(durations, 600.0, rng=rng(), **kw)
        ref = j_samp.DynamicBatchSampler(durations, 600.0, rng=rng(), **kw)
        assert len(mine) == len(ref)
        assert [list(mine) for _ in range(3)] == [list(ref) for _ in range(3)]
    meters = (p_samp.AverageMeter("pad"), j_samp.AverageMeter("pad"))
    for m in meters:
        m.add(3.0, 4.0)
        m.add(1.0, 6.0)
    assert meters[0].value == meters[1].value == 0.4


def test_samplers_are_reexported_from_data():
    from msrflute_tpu_torch.data import BatchSampler, DynamicBatchSampler
    assert BatchSampler is p_samp.BatchSampler
    assert DynamicBatchSampler is p_samp.DynamicBatchSampler


def test_nbest_files_are_byte_equal(tmp_path):
    x = np.random.default_rng(0).normal(size=(3, 1, 5))
    for axis in (None, 0, 2):
        _same(p_nbest.softmax(x, axis), j_nbest.softmax(x, axis))
    _same(p_nbest.softmax(x[0]), j_nbest.softmax(x[0]))
    utts = {f"u{i}": {"wav": f"/org/u{i}.wav", "dur": float(i)}
            for i in range(4)}
    hypos = {"u0": [["hello", "world"], ["hallo", "world"], ["a"]],
             "u1": [["good", "day"]], "u3": [["x"], ["y", "z"]]}
    scores = {"u0": np.array([0.1, -0.5, 2.0]), "u1": np.array([0.2]),
              "u3": np.array([-1.0, 1.0])}
    outs = []
    for mod, name in ((p_nbest, "port"), (j_nbest, "jax")):
        path = tmp_path / f"{name}.jsonl"
        assert mod.write_nbest_jsonl(utts, hypos, scores, str(path), nbest=3,
                                     orgpath="/org", newpath="/new")
        outs.append(path.read_bytes())
    assert outs[0] == outs[1] and outs[0]
