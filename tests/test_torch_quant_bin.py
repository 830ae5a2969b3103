"""Kernel B3's schedule (``msrflute_tpu_torch/ops/quant_bin.py``), on the
CPU: the tile table the wrapper builds from ``offsets``, read with the
kernel's own arithmetic, puts every element of every (row, leaf) segment in
exactly one block, at every row alignment, and the grid the wrapper
launches, sized from the shapes alone, holds every tile.  The kernel itself
is held bitwise to the plain version on the card by ``chip_smoke.py``;
here its odd layouts are held to the cases the kernel's arithmetic tells
apart.  Its C interface is checked in ``test_torch_kernels.py``."""

import os
import sys

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from msrflute_tpu_torch.ops import quant_bin as qb
from msrflute_tpu_torch.ops.quant_bin import TILE, grid_size, schedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def _bounds(sizes):
    return np.concatenate([[0], np.cumsum(sizes, dtype=np.int64)])


def spans(table, offsets, K, P, shift, tile=TILE):
    """The elements each block of the grid covers, as
    ``csrc/quant_bin.cu::quant_bin_kernel`` computes them from its tile
    table entry, for x at an address ``shift`` floats past a 16-byte
    boundary: ``(start, stop, seg, seg_end)`` of every (row, tile) block
    whose range is not empty, in indices of the flat ``[K, P]`` payload."""
    L = len(offsets) - 1
    leaf, j = table[:, 0].astype(np.int64), table[:, 1].astype(np.int64)
    live = leaf < L
    leaf, j = leaf[live], j[live]
    row = np.arange(K, dtype=np.int64)[:, None] * P
    seg = row + offsets[leaf][None, :]
    seg_end = row + offsets[leaf + 1][None, :]
    base = seg - (shift + seg) % 4 + j[None, :] * tile
    start = np.maximum(base, seg)
    stop = np.minimum(base + tile, seg_end)
    keep = start < stop
    return start[keep], stop[keep], seg[keep], seg_end[keep]


def check_schedule(sizes, K, shift, tile=TILE):
    """Every element of the ``[K, P]`` payload lies in exactly one block,
    inside its own (row, leaf) segment; a block holds at most a tile; only
    a segment's first block starts, and only its last stops, off a 16-byte
    address; the table has ``grid_size`` rows, the tiles first and then
    entries past the last leaf.  Returns the blocks' head and tail lengths
    (the scalars before the first and after the last 16-byte address)."""
    offsets = _bounds(sizes)
    L, P = len(sizes), int(offsets[-1])
    table = schedule(torch.from_numpy(offsets), P, tile).numpy()
    assert table.dtype == np.int32
    assert table.shape == (grid_size(P, L, tile), 2)
    n_tiles = int(sum(-(-(n + 3) // tile) for n in sizes if n > 0))
    assert n_tiles <= table.shape[0]
    assert (table[:n_tiles, 0] < L).all() and (table[n_tiles:, 0] == L).all()
    start, stop, seg, seg_end = spans(table, offsets, K, P, shift, tile)
    order = np.argsort(start, kind="stable")
    start, stop, seg, seg_end = (a[order] for a in (start, stop, seg,
                                                    seg_end))
    if K * P:
        assert start[0] == 0 and stop[-1] == K * P
        assert (start[1:] == stop[:-1]).all()
    else:
        assert len(start) == 0
    assert (start >= seg).all() and (stop <= seg_end).all()
    assert (stop - start <= tile).all()
    assert (((shift + start) % 4 == 0) | (start == seg)).all()
    assert (((shift + stop) % 4 == 0) | (stop == seg_end)).all()
    head = np.minimum((4 - (shift + start) % 4) % 4, stop - start)
    tail = (stop - start - head) % 4
    return set(head.tolist()), set(tail.tolist())


sizes_st = st.lists(st.one_of(st.just(0), st.integers(1, 3),
                              st.integers(4, 70),
                              st.integers(TILE - 5, 3 * TILE + 5)),
                    min_size=1, max_size=40)


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(sizes=sizes_st, K=st.integers(4, 6), shift=st.integers(0, 3))
def test_every_element_lies_in_exactly_one_block(sizes, K, shift):
    check_schedule(sizes, K, shift)


@pytest.mark.parametrize("p_mod_4", [0, 1, 2, 3])
def test_every_row_alignment_and_every_head_and_tail(p_mod_4):
    """P = 0-3 mod 4 at K = 4 rows and x at every alignment: empty
    leaves, leaves of 1-3 elements and leaves of several tiles, whose
    blocks take heads and tails of every length."""
    sizes = [0, 1, 2, 3, 0, TILE + 1, 3 * TILE - 2, 5, 2 * TILE, 1, 0]
    sizes.append(4 + (p_mod_4 - sum(sizes) - 4) % 4)
    assert sum(sizes) % 4 == p_mod_4
    heads, tails = set(), set()
    for shift in range(4):
        h, t = check_schedule(sizes, 4, shift)
        heads |= h
        tails |= t
    assert heads == tails == {0, 1, 2, 3}


def test_a_thousand_leaves():
    sizes = np.random.default_rng(0).integers(0, 50, 1000)
    sizes[::7] = np.random.default_rng(1).integers(1, 4, len(sizes[::7]))
    for shift in range(4):
        check_schedule(sizes.tolist(), 5, shift)


@pytest.mark.parametrize("model", ["gru", "bert"])
def test_the_paths_layouts(model):
    """The nlg_gru GRU LM's 7 leaves and BERT-base's 202 (the layouts the
    DGA and mlm_bert paths quantize), at K = 10 as the paths run them."""
    cs = _chip_smoke()
    bounds = cs._gru_bounds() if model == "gru" else cs._bert_bounds(torch)
    sizes = np.diff(np.asarray(bounds, dtype=np.int64)).tolist()
    assert len(sizes) == (7 if model == "gru" else cs.BERT_LEAVES)
    for shift in (0, 1):
        heads, tails = check_schedule(sizes, 10, shift)
        assert heads <= {0, 1, 2, 3} and tails <= {0, 1, 2, 3}


@pytest.mark.parametrize("tile", [2048, 4096, 8192])
def test_tile_sizes_of_the_probe(tile):
    check_schedule([3, 5000, 0, 20000, 7, 1], 5, 2, tile)


def test_the_table_is_built_without_a_host_read():
    """``schedule`` runs on the meta device, which holds no data: it
    reads nothing of ``offsets`` on the host, and the grid it gives comes
    from the shapes alone."""
    offsets = torch.tensor(_bounds([5, 0, 9000, 3]), device="meta")
    table = schedule(offsets, 9008)
    assert table.device.type == "meta" and table.dtype == torch.int32
    assert table.shape == (grid_size(9008, 4), 2)


def test_the_wrapper_builds_a_table_once_a_layout():
    wrapper = qb.QuantBinSparsify()
    offsets = torch.tensor(_bounds([5, 0, 9000, 3]))
    first = wrapper.table(offsets, 9008)
    assert wrapper.table(offsets, 9008) is first
    assert torch.equal(first, schedule(offsets, 9008))
    offsets[2] = 6                       # written in place: built again
    again = wrapper.table(offsets, 9008)
    assert again is not first and torch.equal(again,
                                              schedule(offsets, 9008))
    del offsets, first, again
    assert len(wrapper._tables) == 0     # dropped with the offsets tensor


def test_the_output_shares_the_inputs_alignment():
    buf = torch.zeros(64)
    for shift in range(4):
        x = buf[shift:shift + 40].view(4, 10)
        out = qb._aligned_like(x)
        assert out.shape == x.shape and out.is_contiguous()
        assert (out.data_ptr() - x.data_ptr()) % 16 == 0


def test_chip_smoke_b3_cases_reach_every_branch_of_the_kernel():
    """The card's bitwise checks of B3 reach every head and tail length of
    a block, rows at every alignment of P = 1, 2 and 3 mod 4 at K = 5,
    empty leaves, leaves of 1-3 elements, 1,000 leaves and x off a 16-byte
    boundary, each at n_bins 1024, 16 and 2."""
    cs = _chip_smoke()
    assert cs.QUANT_BINS == (1024, 16, 2)
    heads, tails, sizes_seen, p_mods, shifts = (set() for _ in range(5))
    for name, K, sizes, shift in cs.QUANT_CASES:
        h, t = check_schedule(list(sizes), K, shift)
        heads |= h
        tails |= t
        sizes_seen |= set(sizes)
        if K == 5:                   # rows at every alignment of P mod 4
            p_mods.add(sum(sizes) % 4)
        shifts.add(shift)
    assert heads == tails == {0, 1, 2, 3}
    assert {0, 1, 2, 3} <= sizes_seen
    assert {1, 2, 3} <= p_mods
    assert any(len(s) == 1000 for _, _, s, _ in cs.QUANT_CASES)
    assert shifts - {0}
