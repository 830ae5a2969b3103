"""The port's dtype-grouped packer (``msrflute_tpu_torch/utils/flatpack.py``)
against the JAX package's (``msrflute_tpu/utils/flatpack.py``), and the
async ``latest`` writer's single-slot contract (the twins of
``tests/test_flatpack.py``'s last two tests).

- a round trip is bit-exact for float32, int32, int64, uint32, uint8 and
  bool, with one buffer per dtype group;
- the slot table (group, offset, size, shape per leaf) of ``FlatPacker``,
  ``AxisPacker`` and ``ScalarStager`` is the JAX packer's on the same
  numpy tree;
- a mismatched shape, dtype or structure raises;
- a second ``latest`` submit waits for the save in flight; the snapshot
  handed to the writer is a copy, not an alias of the live state.
"""

import threading

import numpy as np
import pytest
import torch

from msrflute_tpu.utils import flatpack as jax_flatpack
from msrflute_tpu_torch.engine.checkpoint import CheckpointManager
from msrflute_tpu_torch.engine.round import ServerState
from msrflute_tpu_torch.models.base import ParamLayout
from msrflute_tpu_torch.utils.flatpack import (AxisPacker, FlatPacker,
                                               ScalarStager, canonical_np)


def _np_tree():
    rng = np.random.default_rng(0)
    return {
        "w": rng.normal(size=(3, 4)).astype(np.float32),
        "b": np.full((4,), 0.5, np.float32),
        "count": np.asarray(2 ** 30 + 7, np.int32),   # > 2^24
        "big": np.asarray([2 ** 40 + 3, -5], np.int64),
        "key": np.asarray([42, 2 ** 32 - 1], np.uint32),
        "pix": rng.integers(0, 256, (2, 5)).astype(np.uint8),
        "nested": {"m": np.full((2, 2), -3.25, np.float32),
                   "flag": np.asarray([True, False, True])},
        "pair": [np.arange(3, dtype=np.int32), np.float32(7.5)],
    }


def _torch_tree():
    return {k: ({a: torch.from_numpy(np.asarray(b)) for a, b in v.items()}
                if isinstance(v, dict) else
                [torch.from_numpy(np.asarray(x)) for x in v]
                if isinstance(v, list) else torch.from_numpy(v))
            for k, v in _np_tree().items()}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_round_trip_bit_exact_one_buffer_per_dtype():
    tree = _torch_tree()
    p = FlatPacker(tree)
    vecs = p.pack(tree)
    assert set(vecs) == {"float32", "int32", "int64", "uint32", "uint8",
                         "bool"}
    assert all(v.ndim == 1 for v in vecs.values())
    back = p.unpack(vecs)
    for a, b in zip(_leaves(tree), _leaves(back)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    host = p.unpack_np({dt: v.numpy() for dt, v in vecs.items()})
    for a, b in zip(_leaves(tree), _leaves(host)):
        np.testing.assert_array_equal(a.numpy(), b)
        assert a.numpy().dtype == b.dtype


def test_a_chunk_of_rounds_packs_into_one_buffer_per_dtype():
    """A chunk's stats (a list of per-round trees) in one buffer per
    dtype, round after round, decoded back to each round's values."""
    rounds = [{"a": torch.arange(3, dtype=torch.float32) + r,
               "n": torch.tensor(5 + r, dtype=torch.int32)}
              for r in range(4)]
    p = FlatPacker(rounds)
    vecs = p.pack(rounds)
    assert {dt: tuple(v.shape) for dt, v in vecs.items()} == \
        {"float32": (12,), "int32": (4,)}
    out = p.unpack_np({dt: v.numpy() for dt, v in vecs.items()})
    assert [int(r["n"]) for r in out] == [5, 6, 7, 8]
    np.testing.assert_array_equal(out[2]["a"], [2.0, 3.0, 4.0])


def test_flat_slot_table_is_the_jax_packers():
    tree = _np_tree()
    mine = FlatPacker(tree)
    theirs = jax_flatpack.FlatPacker(tree)
    assert mine.slots == theirs._slots
    assert mine.sizes == theirs.sizes
    vecs = mine.pack_np(tree)
    for dt, v in theirs.pack(tree).items():
        if dt != "int64":   # jnp narrows 64-bit values, torch keeps them
            np.testing.assert_array_equal(vecs[dt], np.asarray(v))
    assert vecs["int64"].tolist() == [2 ** 40 + 3, -5]


def test_axis_and_scalar_slot_tables_are_the_jax_packers():
    rng = np.random.default_rng(1)
    tree = {"x": rng.normal(size=(3, 5, 2, 4)).astype(np.float32),
            "mask": np.ones((3, 5, 2), np.float32),
            "ids": np.arange(15, dtype=np.int32).reshape(3, 5),
            "pix": rng.integers(0, 256, (3, 5, 7)).astype(np.uint8)}
    for lead in (0, 1, 2):
        mine = AxisPacker(tree, lead_ndim=lead)
        theirs = jax_flatpack.AxisPacker(tree, lead_ndim=lead)
        assert mine.slots == theirs._slots
        assert mine.lead_shape == theirs.lead_shape
        got, want = mine.pack_np(tree), theirs.pack_np(tree)
        assert set(got) == set(want) == {"float32", "int32", "uint8"}
        for dt in want:
            np.testing.assert_array_equal(got[dt], want[dt])
        back = mine.unpack({dt: torch.from_numpy(v) for dt, v in got.items()})
        for k in tree:
            np.testing.assert_array_equal(back[k].numpy(), tree[k])
    scalars = {"lr": np.float32(0.1), "rounds": np.arange(3, dtype=np.int32),
               "thresh": np.asarray([0.5, -1.0], np.float32)}
    mine, theirs = ScalarStager(scalars), jax_flatpack.ScalarStager(scalars)
    assert mine.packer.slots == theirs.packer._slots
    for dt, v in theirs.pack_np(scalars).items():
        np.testing.assert_array_equal(mine.pack_np(scalars)[dt], v)


def test_aligned_axis_packer_starts_each_leaf_on_the_boundary():
    tree = [{"a": np.ones((3,), np.float32), "b": np.ones((5,), np.uint8)},
            {"a": np.full((7,), 2.0, np.float32),
             "b": np.zeros((1,), np.uint8)}]
    p = AxisPacker(tree, lead_ndim=0, align_bytes=512)
    for dt, off, size, _ in p.slots:
        assert (off * np.dtype(dt).itemsize) % 512 == 0
    got = p.unpack({dt: torch.from_numpy(v)
                    for dt, v in p.pack_np(tree).items()})
    for want, have in zip(tree, got):
        for k in want:
            np.testing.assert_array_equal(have[k].numpy(), want[k])


def test_canonical_dtypes_are_torchs():
    assert canonical_np(0.5).dtype == np.float32
    assert canonical_np(3).dtype == np.int64
    assert canonical_np(True).dtype == np.bool_
    assert canonical_np(np.arange(2, dtype=np.int64)).dtype == np.int64
    assert canonical_np(torch.zeros(2, dtype=torch.int32)).dtype == np.int32
    for v in (0.5, 3, True):
        assert canonical_np(v).dtype == torch.as_tensor(v).numpy().dtype


def test_mismatch_is_loud():
    tree = _torch_tree()
    p = FlatPacker(tree)
    with pytest.raises(ValueError, match="shape"):
        p.pack(dict(tree, w=torch.zeros(4, 3)))
    with pytest.raises(ValueError, match="leaves"):
        p.pack({"only": torch.zeros(3)})
    with pytest.raises(ValueError, match="dtype"):
        p.pack(dict(tree, count=torch.tensor(5.0)))
    t2 = dict(tree)
    t2["zz_extra"] = t2.pop("b")
    with pytest.raises(ValueError, match="structure"):
        p.pack(t2)
    ax = AxisPacker({"a": np.zeros((2, 3), np.float32)}, lead_ndim=1)
    with pytest.raises(ValueError, match="shape"):
        ax.pack_np({"a": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="dtype"):
        ax.pack_np({"a": np.zeros((2, 3), np.float64)})
    with pytest.raises(ValueError, match="leading axes"):
        AxisPacker({"a": np.zeros((2, 3)), "b": np.zeros((3,))}, lead_ndim=1)


# ---------------------------------------------------------------------
# the async ``latest`` writer's single slot

def _layout():
    return ParamLayout([("w", (4,))])


def _state(r, extra=None):
    return ServerState(torch.full((4,), float(r)), {}, r, extra or {})


def test_async_latest_single_slot_bounds_skew(tmp_path, monkeypatch):
    """A second submit waits for the save in flight, so the on-disk
    ``latest`` lags by at most one snapshot; the writes run on the writer
    thread.  Ordered by events, never by wall-clock time."""
    mgr = CheckpointManager(str(tmp_path), _layout(), async_latest=True)
    gate, entered = threading.Event(), threading.Event()
    writes = []
    real = CheckpointManager._write_latest

    def gated(self, payload):
        entered.set()
        assert gate.wait(timeout=30), "test gate never opened"
        writes.append((payload["round"], threading.current_thread().name))
        return real(self, payload)

    monkeypatch.setattr(CheckpointManager, "_write_latest", gated)
    mgr.save_latest(_state(1))
    assert entered.wait(timeout=30), "writer thread never started the save"
    assert not writes
    second_done = threading.Event()
    second = threading.Thread(
        target=lambda: (mgr.save_latest(_state(2)), second_done.set()),
        daemon=True)
    second.start()
    assert not second_done.wait(timeout=0.2), \
        "second submit returned while the first save was in flight"
    gate.set()
    assert second_done.wait(timeout=30), "second submit never unblocked"
    mgr.wait()
    second.join(timeout=30)
    assert not second.is_alive()
    assert writes == [(1, "ckpt-latest-writer"), (2, "ckpt-latest-writer")]
    restored = mgr.load(torch.device("cpu"))
    assert restored.round == 2
    assert torch.equal(restored.params, torch.full((4,), 2.0))


def test_async_latest_snapshot_is_not_an_alias(tmp_path):
    """The state handed to the writer is already a copy: an in-place
    change of the live tensors after the submit cannot reach the file."""
    mgr = CheckpointManager(str(tmp_path), _layout(), async_latest=True)
    # no writer thread: the submit parks the snapshot in the mailbox
    mgr._worker = threading.current_thread()
    live = _state(1, {"residual": torch.full((8,), 5.0)})
    mgr.save_latest(live)
    snap = mgr._mailbox.state
    assert snap.params is not live.params
    live.params.fill_(-1.0)
    live.strategy_state["residual"].fill_(-1.0)
    assert torch.equal(snap.params, torch.full((4,), 1.0))
    assert torch.equal(snap.strategy_state["residual"],
                       torch.full((8,), 5.0))


def test_async_writer_failure_is_raised_on_the_training_thread(
        tmp_path, monkeypatch):
    """The writer thread only counts a failed save; below
    ``escalation_threshold`` the run goes on, at it the training thread
    raises :class:`CheckpointEscalationError` at its next wait."""
    from msrflute_tpu_torch.resilience.integrity import (
        CheckpointEscalationError, RetryPolicy)
    mgr = CheckpointManager(str(tmp_path), _layout(), async_latest=True,
                            retry=RetryPolicy(escalation_threshold=2))

    def broken(self, payload):
        raise OSError("disk full")

    monkeypatch.setattr(CheckpointManager, "_write_latest", broken)
    mgr.save_latest(_state(1))
    mgr.wait()                              # one failure: warned, not fatal
    assert mgr.escalator.consecutive == 1
    mgr.save_latest(_state(2))
    with pytest.raises(CheckpointEscalationError):
        mgr.wait()
