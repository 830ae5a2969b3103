"""Host-side batch-order samplers.

The port's copy of ``msrflute_tpu/data/samplers.py``: the same
``random.Random`` draws (``Random(0)`` unless an rng is given), so both
packages give the same batches.

Parity target: reference ``utils/data_utils.py``:

- :class:`BatchSampler` (``data_utils.py:9-39``): contiguous index batches
  (keeps neighbors together so padding stays low), shuffled at the batch
  level, optional drop-last.
- :class:`DynamicBatchSampler` (``data_utils.py:42-119``): duration-sorted,
  frames-budgeted batch packing with a padding-efficiency meter.

Status in the round pipeline: these are the host-side *iteration* parity API
(plugin dataloaders that want the reference's sampler semantics).  The round
engine itself does not consume them — its static ``[K, S, B, L]`` grids get
the same padding-efficiency win from per-chunk bucketing instead: step
bucketing (``engine/server.py::_chunk_steps``) sizes S to the chunk, and
length bucketing (``data.batching.seq_length_bucket``) crops token grids to
the chunk's real-length power-of-two bucket — the static-shape translation
of :class:`DynamicBatchSampler`'s frames budget (measured in ``bench.py``
``varlen_bucketing``).
"""

from __future__ import annotations

import logging
import random
from typing import Callable, List, Optional, Sequence

from ..utils.logging import print_rank


class AverageMeter:
    """Ratio meter (reference ``utils.AverageMeter`` as used for padding
    efficiency)."""

    def __init__(self, name: str):
        self.name = name
        self.numerator = 0.0
        self.denominator = 0.0

    def add(self, num: float, den: float) -> None:
        self.numerator += num
        self.denominator += den

    @property
    def value(self) -> float:
        return self.numerator / max(self.denominator, 1e-12)

    def display_results(self, loglevel: int = logging.DEBUG) -> None:
        print_rank(f"{self.name}: {self.value:.4f}", loglevel=loglevel)


class BatchSampler:
    """Contiguous batches, shuffled at batch level."""

    def __init__(self, dataset_len: int, batch_size: int,
                 randomize: bool = True, drop_last: bool = False,
                 rng: Optional[random.Random] = None):
        self.randomize = randomize
        self._rng = rng or random.Random(0)
        batches = [list(range(b, min(b + batch_size, dataset_len)))
                   for b in range(0, dataset_len, batch_size)]
        if drop_last and batches and len(batches[-1]) < batch_size:
            del batches[-1]
        self.batches = batches

    def __iter__(self):
        batches = list(self.batches)
        if self.randomize:
            self._rng.shuffle(batches)
        return iter(batches)

    def __len__(self) -> int:
        return len(self.batches)


class DynamicBatchSampler:
    """Frames-budgeted batches over variable-duration samples.

    ``durations[i]`` is each sample's duration; batches are built so
    ``sum(frames) <= frames_threshold`` (frames = duration * fps), sorted by
    duration first unless ``unsorted_batch`` — exactly the reference's
    packing rule, including the padding-efficiency meter
    (batch_frames / (max_frames_in_batch * len(batch)))."""

    def __init__(self, durations: Sequence[float], frames_threshold: float,
                 max_batch_size: int = 0, unsorted_batch: bool = False,
                 fps: float = 1000 / 30,
                 rng: Optional[random.Random] = None):
        self._rng = rng or random.Random(0)
        indices = [(i, d) for i, d in enumerate(durations)]
        if not unsorted_batch:
            indices.sort(key=lambda e: e[1])

        batches: List[List[int]] = []
        batch: List[int] = []
        batch_frames = 0.0
        batch_area = 0.0  # snapshot of this batch's max_frames * size
        max_frames_in_batch = 0.0
        meter = AverageMeter("Padding Efficiency")
        for idx, duration in indices:
            if duration <= 0:
                continue
            frames = duration * fps
            fits = ((unsorted_batch and len(batch) < max_batch_size) or
                    (not unsorted_batch and
                     batch_frames + frames <= frames_threshold and
                     (max_batch_size == 0 or len(batch) < max_batch_size)))
            if fits:
                batch.append(idx)
                batch_frames += frames
                max_frames_in_batch = max(max_frames_in_batch, frames)
                # area snapshotted inside the fits branch so a later
                # overflowing item cannot contaminate this batch's max
                # (reference data_utils.py:89-94)
                batch_area = max_frames_in_batch * len(batch)
            else:
                if batch and batch_area > 0:
                    meter.add(batch_frames, batch_area)
                    batches.append(batch)
                batch = [idx]
                batch_frames = frames
                max_frames_in_batch = frames
                batch_area = frames
        if batch and batch_area > 0:
            meter.add(batch_frames, batch_area)
            batches.append(batch)
        self.batches = batches
        self.padding_efficiency = meter.value
        meter.display_results()

    def __iter__(self):
        batches = list(self.batches)
        self._rng.shuffle(batches)
        return iter(batches)

    def __len__(self) -> int:
        return len(self.batches)
