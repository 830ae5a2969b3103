"""Static-shape round batching — the port's own copy of ``steps_for``,
``pack_round_batches`` and ``pack_eval_batches`` from
``msrflute_tpu/data/batching.py``, of its host planning for cohort
bucketing and cross-client megabatching (``batching.py:362-683``,
``data/fleet.py::steps_for_array``), of the device-resident sample pool
(``build_sample_pool``, ``pack_round_indices``, ``batching.py:191-296``)
and of length bucketing (``seq_length_bucket``, ``batching.py:685-744``).

The numpy code is the JAX package's, draw for draw: the same cohort and the
same ``np.random.Generator`` state give the same ``[K, S, B]`` grids and
masks in both packages, which is what makes trajectory parity possible.
A round's clients become arrays of static shape ``[K, S, B, ...]`` with a
``[K, S, B]`` sample mask; ragged client sizes are absorbed by masking.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from .dataset import BaseDataset


@dataclass
class RoundBatch:
    """One round's client data.

    arrays:       each ``[K, S, B, *feat]``
    sample_mask:  ``[K, S, B]`` — 1.0 for real samples
    num_samples:  ``[K]`` — real (capped) per-client sample counts
    client_mask:  ``[K]`` — 1.0 for real clients, 0.0 for padding
    client_ids:   ``[K]`` — dataset user indices (-1 for padding)
    mega:         the bucket's super-batch tape (:class:`MegaTape`) when
                  the server planned one for this grid, else None
    carry_slots:  ``[K]`` int32 page-pool slot of each client under the
                  fleet paged carry (-1 for padding), set by
                  :meth:`..engine.paging.CarryPager.prepare_chunk`
    """

    arrays: Dict[str, np.ndarray]
    sample_mask: np.ndarray
    num_samples: np.ndarray
    client_mask: np.ndarray
    client_ids: np.ndarray
    mega: Optional["MegaTape"] = None
    carry_slots: Optional[np.ndarray] = None


def ceil_div(n: int, d: int) -> int:
    return -(-int(n) // int(d))


def pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (min 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def steps_for(max_samples: int, batch_size: int,
              desired_max_samples: Optional[int] = None) -> int:
    """Local-step count S: ``ceil(min(max, desired) / B)`` (reference
    ``desired_max_samples`` early stop, ``core/trainer.py:363-364``)."""
    cap = max_samples if desired_max_samples is None else min(
        max_samples, desired_max_samples)
    return max(1, ceil_div(cap, batch_size))


def _sample_cap(S: int, B: int, desired_max_samples: Optional[int]) -> int:
    """Batch-granular cap: the batch that crosses ``desired_max_samples``
    still trains in full, as in the reference."""
    if desired_max_samples is None:
        return S * B
    return min(S * B, ceil_div(desired_max_samples, B) * B)


def pack_round_batches(
    dataset: BaseDataset,
    client_indices: Sequence[int],
    batch_size: int,
    max_steps: int,
    rng: Optional[np.random.Generator] = None,
    desired_max_samples: Optional[int] = None,
    shuffle: bool = True,
    pad_clients_to: Optional[int] = None,
    orders: Optional[Dict[int, np.ndarray]] = None,
) -> RoundBatch:
    """Assemble ``[K, S, B, ...]`` arrays for the sampled clients: per
    client, shuffle its samples with ``rng`` (one ``permutation`` draw per
    client, in cohort order; in order and with no draw when ``shuffle`` is
    false, as an eval packs them), truncate to the cap, and zero-pad.

    ``pad_clients_to`` pads K with all-padding rows (mask 0, id -1); a
    ``-1`` in ``client_indices`` is such a row in place (megabatch's
    planned row order).  ``orders`` (client id -> permutation) replaces the
    shuffle draw: cohort bucketing draws every sampled client's
    permutation in cohort order before it packs the bucket grids, so each
    client trains on the samples, and every later round samples from the
    ``rng`` state, of the monolithic pack."""
    rng = rng or np.random.default_rng(0)
    K = max(pad_clients_to or len(client_indices), len(client_indices))
    S, B = max_steps, batch_size
    spec = dataset.element_spec
    # an empty or all-hole list still packs a valid all-padding grid
    first = next((int(c) for c in client_indices if int(c) >= 0), 0)
    ref = dataset.user_arrays(first)
    arrays = {k: np.zeros((K, S, B) + shape, dtype=ref[k].dtype)
              for k, shape in spec.items()}
    sample_mask = np.zeros((K, S, B), dtype=np.float32)
    num_samples = np.zeros((K,), dtype=np.float32)
    client_mask = np.zeros((K,), dtype=np.float32)
    client_ids = np.full((K,), -1, dtype=np.int32)

    cap = _sample_cap(S, B, desired_max_samples)
    for j, ci in enumerate(client_indices):
        ci = int(ci)
        if ci < 0:
            continue
        user = dataset.user_arrays(ci)
        n = len(next(iter(user.values())))
        if orders is not None:
            order = orders[ci]
        else:
            order = rng.permutation(n) if shuffle else np.arange(n)
        take = order[:cap]
        t = len(take)
        for k in spec:
            arrays[k][j].reshape((S * B,) + spec[k])[:t] = user[k][take]
        sample_mask[j].reshape(-1)[:t] = 1.0
        num_samples[j] = t
        client_mask[j] = 1.0
        client_ids[j] = ci
    return RoundBatch(arrays, sample_mask, num_samples, client_mask,
                      client_ids)


@dataclass
class IndexRoundBatch:
    """One round's client data as indices into the flat sample pool (the
    device-resident mode, ``data_config.train.device_resident``).

    ``indices``: ``[K, S, B]`` int32 rows of the pool that
    :func:`build_sample_pool` builds (0 on padding slots, which the round
    zeroes).  The masks and counts are :class:`RoundBatch`'s; there is no
    ``arrays`` field: the feature rows exist on the device alone, gathered
    by the round engine."""

    indices: np.ndarray
    sample_mask: np.ndarray
    num_samples: np.ndarray
    client_mask: np.ndarray
    client_ids: np.ndarray
    mega: Optional["MegaTape"] = None
    #: see :class:`RoundBatch`
    carry_slots: Optional[np.ndarray] = None


def build_sample_pool(dataset: BaseDataset):
    """Every user's samples concatenated into flat per-key arrays:
    ``(pool, offsets)``, ``pool[k]`` ``[total_samples, *feat]`` in user
    order with its dtype kept (uint8 pixels stay uint8, so the one upload
    is as small as the dataset), ``offsets`` ``[N + 1]`` int64 with user
    ``i``'s rows at ``offsets[i]:offsets[i + 1]``."""
    spec = dataset.element_spec
    n_users = len(dataset)
    counts = [int(dataset.num_samples[i]) for i in range(n_users)]
    offsets = np.zeros((n_users + 1,), np.int64)
    np.cumsum(counts, out=offsets[1:])
    total = int(offsets[-1])
    first = dataset.user_arrays(0)
    pool = {k: np.empty((total,) + shape, dtype=np.asarray(first[k]).dtype)
            for k, shape in spec.items()}
    for i in range(n_users):
        user = dataset.user_arrays(i)
        lo, hi = int(offsets[i]), int(offsets[i + 1])
        for k in pool:
            pool[k][lo:hi] = np.asarray(user[k])
    return pool, offsets


def pack_round_indices(
    dataset: BaseDataset,
    offsets: np.ndarray,
    client_indices: Sequence[int],
    batch_size: int,
    max_steps: int,
    rng: Optional[np.random.Generator] = None,
    shuffle: bool = True,
    pad_clients_to: Optional[int] = None,
    desired_max_samples: Optional[int] = None,
    orders: Optional[Dict[int, np.ndarray]] = None,
) -> IndexRoundBatch:
    """:func:`pack_round_batches` with the row gather left to the device:
    the same draws (one ``permutation`` a real client, in cohort order,
    none for a ``-1`` hole), cap and masks, so a pool-mode round trains
    on the samples of the host-packed one; the output is ``[K, S, B]``
    int32 indices into the :func:`build_sample_pool` pool."""
    rng = rng or np.random.default_rng(0)
    K = len(client_indices)
    K_pad = max(pad_clients_to or K, K)
    S, B = max_steps, batch_size

    indices = np.zeros((K_pad, S, B), dtype=np.int32)
    sample_mask = np.zeros((K_pad, S, B), dtype=np.float32)
    num_samples = np.zeros((K_pad,), dtype=np.float32)
    client_mask = np.zeros((K_pad,), dtype=np.float32)
    client_ids = np.full((K_pad,), -1, dtype=np.int32)

    cap = _sample_cap(S, B, desired_max_samples)
    for j, ci in enumerate(client_indices):
        if int(ci) < 0:
            continue
        n = int(dataset.num_samples[ci])
        if orders is not None:
            order = orders[ci]
        else:
            order = rng.permutation(n) if shuffle else np.arange(n)
        take = order[:cap]
        t = len(take)
        indices[j].reshape(-1)[:t] = offsets[ci] + take
        sample_mask[j].reshape(-1)[:t] = 1.0
        num_samples[j] = t
        client_mask[j] = 1.0
        client_ids[j] = ci
    return IndexRoundBatch(indices, sample_mask, num_samples, client_mask,
                           client_ids)


def pack_eval_batches(dataset: BaseDataset,
                      batch_size: int) -> Dict[str, np.ndarray]:
    """Flatten eval users into ``[T, B, ...]`` batches with a
    ``sample_mask`` and a ``user_idx`` grid."""
    idxs = list(range(len(dataset)))
    spec = dataset.element_spec
    total = sum(int(dataset.num_samples[i]) for i in idxs)
    T = max(1, math.ceil(total / batch_size))
    B = batch_size
    first = dataset.user_arrays(idxs[0]) if idxs else {}
    out = {k: np.zeros((T * B,) + shape, dtype=first[k].dtype)
           for k, shape in spec.items()}
    mask = np.zeros((T * B,), dtype=np.float32)
    user_idx = np.full((T * B,), -1, dtype=np.int32)
    pos = 0
    for i in idxs:
        user = dataset.user_arrays(i)
        n = len(next(iter(user.values())))
        for k, arr in user.items():
            out[k][pos:pos + n] = arr
        mask[pos:pos + n] = 1.0
        user_idx[pos:pos + n] = i
        pos += n
    batched = {k: v.reshape((T, B) + v.shape[1:]) for k, v in out.items()}
    batched["sample_mask"] = mask.reshape(T, B)
    batched["user_idx"] = user_idx.reshape(T, B)
    return batched


def steps_for_array(num_samples, batch_size: int,
                    desired_max_samples: Optional[int] = None
                    ) -> np.ndarray:
    """:func:`steps_for` over a whole population's ``num_samples``, in
    int64 (``msrflute_tpu/data/fleet.py::steps_for_array``)."""
    ns = np.asarray(num_samples, dtype=np.int64)
    if desired_max_samples is not None:
        ns = np.minimum(ns, np.int64(desired_max_samples))
    b = np.int64(max(int(batch_size), 1))
    return np.maximum(-(-ns // b), 1)


# ----------------------------------------------------------------------
# cohort bucketing (``server_config.cohort_bucketing``): a round's cohort
# split into power-of-two step buckets, each packed on its own compact
# ``[K_b, S_b, B]`` grid
# ----------------------------------------------------------------------
def bucket_boundaries(needs: Sequence[int], max_buckets: int,
                      max_steps: int) -> list:
    """The step buckets of a population: the distinct power-of-two
    ceilings of its step needs (capped at ``max_steps``), greedily merged
    down to ``max_buckets`` by the smallest added padded-step cost.
    Strictly increasing; the last covers every need."""
    if max_buckets < 1:
        raise ValueError("cohort_bucketing.max_buckets must be >= 1")
    arr = np.maximum(np.asarray(needs, dtype=np.int64), 1)
    pow_table = np.int64(1) << np.arange(63, dtype=np.int64)
    ceils = np.minimum(pow_table[np.searchsorted(pow_table, arr)],
                       np.int64(max_steps))
    uniq, counts = np.unique(ceils, return_counts=True)
    pops = {int(s): int(c) for s, c in zip(uniq, counts)}
    bounds = sorted(pops)
    while len(bounds) > max_buckets:
        costs = [(pops[bounds[i]] * (bounds[i + 1] - bounds[i]), i)
                 for i in range(len(bounds) - 1)]
        _, i = min(costs)
        pops[bounds[i + 1]] += pops.pop(bounds[i])
        del bounds[i]
    return bounds


def assign_step_buckets(needs: Sequence[int], boundaries: Sequence[int],
                        capacities: Optional[Sequence[int]] = None
                        ) -> Dict[int, list]:
    """``{S: [cohort positions]}``, keys ascending, positions in cohort
    order: each client in the smallest bucket that covers its step need.
    With ``capacities`` every bucket appears (maybe empty) and a full
    bucket spills its overflow up; the top bucket takes all that is left.
    A pure function of its arguments."""
    bounds = list(boundaries)
    if any(b <= a for a, b in zip(bounds, bounds[1:])):
        raise ValueError(
            f"bucket boundaries must be strictly increasing, got {bounds}")
    arr = np.maximum(np.asarray(needs, dtype=np.int64), 1)
    b_arr = np.asarray(bounds, dtype=np.int64)
    if arr.size and int(arr.max()) > int(b_arr[-1]):
        raise ValueError(
            f"client step need {int(arr.max())} exceeds the largest bucket "
            f"boundary {bounds[-1]} — boundaries must cover max_steps")
    first_fit = np.searchsorted(b_arr, arr)
    out: Dict[int, list] = ({s: [] for s in bounds}
                            if capacities is not None else {})
    placed = np.zeros(arr.shape, dtype=bool)
    for i, s in enumerate(bounds):
        elig = np.flatnonzero((first_fit <= i) & ~placed)
        if capacities is not None and i < len(bounds) - 1:
            elig = elig[:int(capacities[i])]
        if elig.size:
            out.setdefault(s, []).extend(int(j) for j in elig)
            placed[elig] = True
    return {s: out[s] for s in sorted(out)}


def bucket_capacities(needs: Sequence[int], boundaries: Sequence[int],
                      cohort_size: int, quantum: int = 1,
                      slack: float = 1.5) -> list:
    """Each bucket's client capacity ``K_b``: the expected occupancy of a
    ``cohort_size`` draw from the population, times ``slack``, clamped to
    the cohort and the bucket's population, rounded up to ``quantum``."""
    bounds = list(boundaries)
    arr = np.maximum(np.asarray(needs, dtype=np.int64), 1)
    b_arr = np.asarray(bounds, dtype=np.int64)
    fit = np.searchsorted(b_arr, arr)
    fit = fit[fit < len(bounds)]
    hist = np.bincount(fit, minlength=len(bounds))
    total = max(int(hist.sum()), 1)
    caps = []
    for i in range(len(bounds)):
        pop_b = int(hist[i])
        want = ceil_div(int(math.ceil(slack * cohort_size * pop_b)), total) \
            if pop_b else 1
        cap = max(min(want, int(cohort_size), max(pop_b, 1)), 1)
        caps.append(ceil_div(cap, quantum) * quantum)
    return caps


# ----------------------------------------------------------------------
# cross-client megabatching (``server_config.megabatch``): inside a
# bucket, a ``[lanes, depth]`` pointer tape strings many small clients'
# steps back to back, so one step of the lane scan trains ``lanes``
# clients at once
# ----------------------------------------------------------------------
@dataclass
class MegaTape:
    """The super-batch tape of one bucket grid.

    ``ptr``: ``[lanes, depth]`` int32, the flat grid step ``row * S +
    step`` each slot trains on (0 on idle slots); ``seg``: ``[lanes,
    depth]`` int32, the grid row owning the slot, -1 on idle slots.  A
    client holds ``num_epochs * need`` consecutive slots of one lane."""

    ptr: np.ndarray
    seg: np.ndarray
    lanes: int
    depth: int
    shards: int
    #: real (non-idle) slots: the utilization meter's numerator
    entries: int


def megabatch_lanes(needs: Sequence[int], boundaries: Sequence[int],
                    cohort_size: int, num_epochs: int, quantum: int = 1,
                    slack: float = 1.25, lanes: Optional[int] = None,
                    caps: Optional[Sequence[int]] = None) -> list:
    """Each bucket's lane count: the expected tape entries of a
    ``cohort_size`` draw landing in it, times ``slack``, over its depth
    ``num_epochs * S_b``, rounded up to ``quantum``; an explicit ``lanes``
    sets every bucket; ``caps`` (the client capacities) bound it."""
    bounds = list(boundaries)
    E = max(int(num_epochs), 1)
    quantum = max(int(quantum), 1)
    if lanes is not None:
        out = [ceil_div(int(lanes), quantum) * quantum for _ in bounds]
    else:
        arr = np.maximum(np.asarray(needs, dtype=np.int64), 1)
        b_arr = np.asarray(bounds, dtype=np.int64)
        fit = np.searchsorted(b_arr, arr)
        keep = fit < len(bounds)
        fit_k, arr_k = fit[keep], arr[keep]
        total = max(int(keep.sum()), 1)
        out = []
        for i, s in enumerate(bounds):
            need_sum = float(arr_k[fit_k == i].sum())
            exp_entries = slack * cohort_size * need_sum * E / total
            want = max(int(math.ceil(exp_entries / float(E * int(s)))), 1)
            out.append(ceil_div(want, quantum) * quantum)
    if caps is not None:
        out = [min(n, ceil_div(int(c), quantum) * quantum)
               for n, c in zip(out, caps)]
    return [max(n, quantum) for n in out]


def plan_megabatch(needs: Sequence[int], num_epochs: int, lanes: int,
                   step_grid: int, shards: int, capacity: int) -> list:
    """First-fit tape planning for one bucket's cohort (positions in
    cohort order): a list of ``(rows, tape)`` groups, ``rows`` the
    ``capacity`` grid rows as cohort positions with ``-1`` holes, ``tape``
    their :class:`MegaTape`.  Row block ``m`` and lane block ``m`` belong
    to shard ``m`` (one shard on one card); a cohort that fills a group
    spills into more groups of the same shape."""
    M = max(int(shards), 1)
    L, S, E = int(lanes), int(step_grid), max(int(num_epochs), 1)
    cap = int(capacity)
    if L % M or cap % M:
        raise ValueError(
            f"megabatch geometry must be mesh-divisible: lanes={L}, "
            f"capacity={cap}, shards={M}")
    depth = E * S
    L_loc, K_loc = L // M, cap // M
    groups: list = []

    def new_group():
        groups.append({"rows": [[] for _ in range(M)],
                       "fill": np.zeros((L,), dtype=np.int64),
                       "ptr": np.zeros((L, depth), dtype=np.int32),
                       "seg": np.full((L, depth), -1, dtype=np.int32),
                       "entries": 0})

    for pos, need in enumerate(needs):
        need = max(int(need), 1)
        e = E * need
        if e > depth:
            raise ValueError(
                f"megabatch: client step need {need} exceeds the bucket "
                f"grid S={S} — bucket assignment must cover every need")
        placed = False
        for g in groups:
            for m in range(M):
                if len(g["rows"][m]) >= K_loc:
                    continue
                lane = next((n for n in range(m * L_loc, (m + 1) * L_loc)
                             if int(g["fill"][n]) + e <= depth), None)
                if lane is None:
                    continue
                r = len(g["rows"][m])
                o = int(g["fill"][lane])
                g["ptr"][lane, o:o + e] = r * S + (np.arange(e) % need)
                g["seg"][lane, o:o + e] = r
                g["fill"][lane] += e
                g["rows"][m].append(pos)
                g["entries"] += e
                placed = True
                break
            if placed:
                break
        if not placed:
            new_group()
            g = groups[-1]
            g["ptr"][0, :e] = np.arange(e) % need
            g["seg"][0, :e] = 0
            g["fill"][0] = e
            g["rows"][0].append(pos)
            g["entries"] = e
    if not groups:
        new_group()
    out = []
    for g in groups:
        rows: list = []
        for block in g["rows"]:
            rows.extend(list(block) + [-1] * (K_loc - len(block)))
        out.append((rows, MegaTape(g["ptr"], g["seg"], L, depth, M,
                                   int(g["entries"]))))
    return out


def grid_slots(batches: Sequence[RoundBatch]) -> int:
    """Padded sample slots of a chunk's grids, ``K*S*B`` summed."""
    return sum(int(np.prod(b.sample_mask.shape)) for b in batches)


def padding_efficiency(batches: Sequence[RoundBatch]) -> float:
    """Real (capped) samples over padded grid slots (1.0: no padding)."""
    slots = grid_slots(batches)
    real = sum(float(np.sum(b.num_samples)) for b in batches)
    return real / slots if slots else 0.0


def seq_length_bucket(batches: Sequence[RoundBatch],
                      seq_keys: Sequence[str],
                      min_len: int = 8) -> Optional[dict]:
    """Crop a chunk's token grids to the power-of-two bucket of its longest
    real sequence (floored at ``min_len``): the JAX package's answer to the
    reference ``DynamicBatchSampler``'s padding packing
    (``utils/data_utils.py:42-119``).

    ``seq_keys`` name 0-padded ``[K, S, B, L]`` arrays (the task's
    ``seq_pad_keys``).  Every grid of the chunk, across its rounds and
    bucket grids, is cropped to one bucket; a crop removes all-zero tail
    columns only, and the models derive their position masks from the ids,
    so the math is the uncropped grid's up to the order of the sums.
    Returns the stats (``bucket``, ``full_len``, ``tokens_real``,
    ``tokens_grid_before`` / ``_after``, ``cropped``) when the grids hold a
    sequence key, else None."""
    keys = [k for k in seq_keys if batches and k in batches[0].arrays]
    if not keys:
        return None
    L = max(b.arrays[k].shape[-1] for b in batches for k in keys)
    # real tokens are counted once, from one key: tok_mask when present
    # (it marks real positions where x holds the unk id 0), else the first
    canon = "tok_mask" if "tok_mask" in keys else keys[0]
    # the longest real extent over every key: the crop must cover each
    need = 1
    tokens_real = 0
    for b in batches:
        for k in keys:
            arr = b.arrays[k]
            nz = arr.reshape(-1, arr.shape[-1]) != 0
            if k == canon:
                tokens_real += int(nz.sum())
            cols = nz.any(axis=0)
            if cols.any():
                need = max(need, int(np.max(np.nonzero(cols)[0])) + 1)
    bucket = max(min_len, 1 << max(need - 1, 0).bit_length())
    stats = {
        "bucket": int(min(bucket, L)),
        "full_len": int(L),
        "tokens_real": int(tokens_real),
        "tokens_grid_before": int(sum(
            b.arrays[canon].reshape(-1, b.arrays[canon].shape[-1]).shape[0]
            * L for b in batches)),
    }
    stats["cropped"] = bucket < L
    if bucket < L:
        for b in batches:
            for k in keys:
                b.arrays[k] = np.ascontiguousarray(b.arrays[k][..., :bucket])
    stats["tokens_grid_after"] = int(sum(
        b.arrays[canon].reshape(-1, b.arrays[canon].shape[-1]).shape[0]
        * b.arrays[canon].shape[-1] for b in batches))
    return stats
