"""Non-IID dataset partitioners.

The port's copy of ``msrflute_tpu/data/partition.py``, numpy and scipy
only, equal to it on the same inputs and generator state.

Parity target: reference ``experiments/cv/data.py`` ``DataPartitioner`` —
the balanced Dirichlet label-skew partition (``__getDirichletData__``,
``data.py:118-149``, the standard FedML/Hsu-et-al. algorithm) plus the
per-client rotation ranges the cv personalization task uses to make client
distributions *transform*-skewed as well (``return_partition``,
``data.py:39-64``: client ``j`` of ``n`` draws rotations from the 360°/n
wedge ``[-180 + j*360/n, -180 + (j+1)*360/n)``).

Difference from the reference: partitioning happens once, host-side, at data-prep
time (``tools/create_data.py``) and lands in the standard user-blob format —
the round path then stays a fixed-shape jitted program.  The reference
re-applies torchvision transforms per __getitem__; here rotations are baked
into the blob (eval uses the wedge midpoint, the deterministic analogue of
the reference's test-time fixed rotation).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def dirichlet_partition(labels: Sequence[int], num_clients: int,
                        alpha: float, rng: np.random.Generator,
                        num_classes: Optional[int] = None,
                        max_tries: int = 1000) -> List[np.ndarray]:
    """Split sample indices into ``num_clients`` label-skewed shards.

    For every class, client shares are drawn from ``Dirichlet(alpha)``;
    clients already holding >= N/num_clients samples are excluded from
    further draws (the "balance" rule), and the whole draw repeats until
    every client has at least ``num_classes`` samples — same acceptance
    loop as the reference (``experiments/cv/data.py:124-140``), but
    bounded: the target min size caps at N/num_clients (tiny synthetic
    sets can't satisfy the class-count bar at all) and after
    ``max_tries`` draws the best-so-far partition is accepted.

    Smaller ``alpha`` -> more skew; ``alpha -> inf`` approaches IID.
    """
    labels = np.asarray(labels)
    n_total = len(labels)
    k_classes = int(num_classes if num_classes is not None
                    else labels.max() + 1)
    if num_clients <= 0:
        raise ValueError("num_clients must be positive")

    target = min(k_classes, n_total // num_clients)
    min_size, best, best_min = -1, None, -1
    for _ in range(max_tries):
        shards: List[List[int]] = [[] for _ in range(num_clients)]
        for k in range(k_classes):
            idx_k = np.flatnonzero(labels == k)
            if idx_k.size == 0:
                continue
            rng.shuffle(idx_k)
            props = rng.dirichlet(np.full(num_clients, float(alpha)))
            # balance: stop feeding clients that already hold their quota
            open_lane = np.array([len(s) < n_total / num_clients
                                  for s in shards], dtype=np.float64)
            props = props * open_lane
            total = props.sum()
            if total <= 0:  # everyone full for this class draw
                props = np.full(num_clients, 1.0 / num_clients)
            else:
                props = props / total
            cuts = (np.cumsum(props) * idx_k.size).astype(int)[:-1]
            for shard, part in zip(shards, np.split(idx_k, cuts)):
                shard.extend(part.tolist())
        min_size = min(len(s) for s in shards)
        if min_size > best_min:
            best, best_min = shards, min_size
        if min_size >= target:
            break
    shards = best

    out = []
    for shard in shards:
        arr = np.asarray(shard, dtype=np.int64)
        rng.shuffle(arr)
        out.append(arr)
    return out


def partition_label_counts(labels: Sequence[int],
                           partitions: Sequence[np.ndarray]) -> List[Dict[int, int]]:
    """Per-client class histograms (the reference's ``net_cls_counts``
    debug statistic, ``experiments/cv/data.py:142-146``)."""
    labels = np.asarray(labels)
    stats = []
    for part in partitions:
        unq, cnt = np.unique(labels[np.asarray(part, dtype=np.int64)],
                             return_counts=True)
        stats.append({int(u): int(c) for u, c in zip(unq, cnt)})
    return stats


def client_rotation_range(client: int, num_clients: int) -> tuple:
    """The 360°/n wedge of rotation angles assigned to ``client``
    (reference ``experiments/cv/data.py:50-52``)."""
    lo = -180 + 2 * int(client * 180 / num_clients)
    hi = -180 + 2 * int((client + 1) * 180 / num_clients)
    return lo, hi


def rotate_images(x: np.ndarray, angle_deg: float) -> np.ndarray:
    """Rotate a batch of HWC (or HW) images about their center.

    scipy.ndimage backs the interpolation (order-1, like torchvision's
    bilinear default); dtype and value range are preserved.
    """
    from scipy import ndimage

    x = np.asarray(x)
    out = np.empty_like(x)
    for i in range(len(x)):
        img = x[i].astype(np.float32)
        # per-image spatial dims are leading: HW or HWC -> rotate in (0, 1)
        rot = ndimage.rotate(img, angle_deg, axes=(1, 0),
                             reshape=False, order=1, mode="nearest")
        if np.issubdtype(x.dtype, np.integer):
            info = np.iinfo(x.dtype)
            rot = np.clip(np.rint(rot), info.min, info.max)
        out[i] = rot.astype(x.dtype)
    return out


def dirichlet_blob(x: np.ndarray, y: np.ndarray, num_clients: int,
                   alpha: float, rng: np.random.Generator,
                   rotate: bool = False, is_train: bool = True) -> dict:
    """Build a user-blob dict from flat arrays via Dirichlet partitioning.

    ``rotate=True`` additionally applies each client's rotation wedge
    (random angle per train sample, wedge midpoint at eval — reference
    ``experiments/cv/data.py:50-52``), producing the transform-skew the cv
    personalization benchmark relies on.
    """
    parts = dirichlet_partition(y, num_clients, alpha, rng)
    users, data, labels, counts = [], {}, {}, []
    for j, idx in enumerate(parts):
        uid = f"{j:04d}"
        xs = np.asarray(x)[idx]
        if rotate and xs.ndim >= 3:
            lo, hi = client_rotation_range(j, num_clients)
            if is_train:
                angles = rng.uniform(lo, hi, size=len(xs))
                xs = np.stack([rotate_images(xs[i:i + 1], a)[0]
                               for i, a in enumerate(angles)])
            else:
                xs = rotate_images(xs, (lo + hi) / 2.0)
        users.append(uid)
        data[uid] = {"x": xs.tolist()}
        labels[uid] = np.asarray(y)[idx].astype(int).tolist()
        counts.append(int(len(idx)))
    return {"users": users, "num_samples": counts, "user_data": data,
            "user_data_label": labels}
