"""The fleet paged carry (``server_config.fleet`` beside a ``fused_carry``
device-carry strategy) on one device — the port's counterpart of
``msrflute_tpu/engine/paging.py`` (``:88-1131``).

A device-carry strategy keeps its per-client tables (SCAFFOLD's ``ci``,
EF's ``res``, personalization's ``local``, ``alpha`` and ``seen``) in
``strategy_state`` as ``[N, ...]`` tensors: at fleet size the tables, not
the model, own the card's memory, and every ``latest`` writes them whole.
Here they shrink to a page pool of ``[slots, ...]`` rows
(``strategy.carry_rows``) backed by a host row store:

- :meth:`CarryPager.prepare_chunk`, before each dispatch, maps the
  chunk's cohorts onto slots (``batch.carry_slots``; the round indexes the
  tables by slot, the clients' generators keep their true ids).  A hit
  reuses its row; a miss pages in from the store, every miss of the chunk
  in one staged copy: a pinned host buffer ``[W, row]`` (``W`` a power of
  two, :func:`_pow2_width`, so PyTorch's caching host allocator hands the
  same blocks out again once their copies have passed), one
  ``non_blocking`` copy and an ``index_copy_`` into the pool's tables on
  the compute stream, ahead of the dispatch.  A client never seen takes
  :meth:`~..strategies.base.BaseStrategy.carry_row_defaults`.  The chunk's
  slots are pinned until it drains.
- :meth:`CarryPager.queue_writeback`, right after the dispatch, gathers the
  chunk's slot rows from the post-chunk tables into a device buffer and
  starts their ``non_blocking`` copy into pinned host memory behind an
  event: no host read in the dispatch half.  The tables are written in
  place only by a later page-in, which the stream orders after this
  gather (and after the ``latest`` snapshot the loop takes before it).
- :meth:`CarryPager.complete_writeback`, in the drain before the host
  tail, waits on that event once (the ladder's ``writeback`` surface),
  writes the rows through to the store and unpins the slots.
- Eviction is LRU over unpinned slots; when every slot is pinned the
  oldest outstanding writeback completes early (``forced_drains``), and a
  pool too small for the in-flight chunks raises.  The allocator is
  single-threaded host code, so it makes the JAX pager's decisions on the
  same cohorts, slot for slot.
- **Prefetch** (``fleet.prefetch``, default on): while the card runs a
  chunk, a ``fleet-prefetch`` thread stages the next chunk's missing rows
  from the store as host numpy, read-only (it makes no CUDA call).  A
  staged value cannot be stale: a client missing from the pool is in no
  in-flight chunk, so no writeback can update its row before the next
  ``prepare_chunk`` consumes it.  A worker error degrades the pager to
  the cold path for good, with one ``prefetch_degraded`` record.

:class:`FleetRowStore` is the host store: a RAM LRU of ``host_cache_rows``
rows, dirty evictees spilled as generation-versioned ``.npz`` files
(``row_{cid}.g{gen}.npz``) under ``<model_dir>/fleet_carry``, and the
round marker ``fleet_round.npy``, which the server commits after the
paired checkpoint is durable; every disk write and read goes through the
:class:`~..resilience.integrity.DurableIOLadder`.

Not here (ROADMAP.md §A, multi-GPU): the sharded pool, its shard-aware
allocator and migrations (always 0 on one device), and mesh-elastic
resume.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..resilience.integrity import DurableIOLadder


def _pow2_width(n: int, floor: int = 8) -> int:
    """The staging width for ``n`` rows: a power of two, at least
    ``floor``."""
    n = max(int(n), int(floor))
    return 1 << max(n - 1, 0).bit_length()


def read_marker(store_dir: str) -> Optional[int]:
    """The durable round marker under ``store_dir`` (None when none was
    committed): the server reads it before choosing the checkpoint slot to
    resume from."""
    path = os.path.join(store_dir, "fleet_round.npy")
    if not os.path.exists(path):
        return None
    return int(np.load(path)[0])


def _parse_row_name(name: str) -> Optional[tuple]:
    """``row_{cid}.g{gen}.npz`` -> ``(cid, gen)``; anything else
    (temporary files, the marker) -> None."""
    if not name.startswith("row_") or not name.endswith(".npz") \
            or ".tmp" in name:
        return None
    cid_s, _, gen_s = name[len("row_"):-len(".npz")].partition(".g")
    try:
        return int(cid_s), int(gen_s)
    except ValueError:
        return None


class FleetRowStore:
    """The host store of paged carry rows, one ``{table key: array}`` row a
    client (``paging.py:127-464``).

    RAM holds at most ``cache_rows`` rows in LRU order; evicting a dirty
    row writes it to disk first (a temporary file renamed into place), so
    RAM and disk together always hold the current rows.  Each spill lands
    at ``row_{cid}.g{round}.npz``, ``round`` the round whose writeback
    produced the row (:attr:`put_round`), and an older generation stays on
    disk until :meth:`mark_durable` says a checkpoint at or past a newer
    one is durable: a kill at any byte of the spill, marker and checkpoint
    sequence leaves a resume that reads every row as of its anchor
    (:meth:`adopt_round` deletes the dead trajectory's newer generations).

    The round loop's thread mutates; the prefetch worker reads through
    :meth:`peek` and :meth:`_read_file` only.  A dirty evictee sits in
    ``_spilling`` until its file lands, so a concurrent peek always finds
    the row somewhere."""

    def __init__(self, store_dir: str, ladder: DurableIOLadder,
                 cache_rows: int = 8192, resume: bool = False):
        self.store_dir = store_dir
        self.cache_rows = max(int(cache_rows), 1)
        #: the DurableIOLadder of spills, reads and the marker
        self.ladder = ladder
        self._rows: "OrderedDict[int, Dict[str, np.ndarray]]" = \
            OrderedDict()
        self._dirty: set = set()
        self._spilling: Dict[int, Dict[str, np.ndarray]] = {}
        self._ram_lock = threading.Lock()
        self.spilled_rows = 0
        #: each RAM row's content round (the generation a spill writes)
        self._tags: Dict[int, int] = {}
        #: each row's generations on disk, ascending
        self._gens: Dict[int, List[int]] = {}
        #: the newest round whose checkpoint is durable
        self._safe_round = -1
        #: the generation of incoming :meth:`put` rows (the pager sets it a
        #: writeback)
        self.put_round = 0
        os.makedirs(store_dir, exist_ok=True)
        if resume:
            self._scan_gens()
        else:
            self._wipe_files()

    def _path(self, cid: int, gen: int = 0) -> str:
        return os.path.join(self.store_dir,
                            f"row_{int(cid)}.g{int(gen)}.npz")

    def _marker_path(self) -> str:
        return os.path.join(self.store_dir, "fleet_round.npy")

    def _wipe_files(self) -> None:
        for name in os.listdir(self.store_dir):
            if name.startswith("row_") or name == "fleet_round.npy":
                os.remove(os.path.join(self.store_dir, name))

    def _scan_gens(self) -> None:
        """The resume's inventory: one listing gives every row's
        generations."""
        gens: Dict[int, List[int]] = {}
        for name in os.listdir(self.store_dir):
            parsed = _parse_row_name(name)
            if parsed is not None:
                gens.setdefault(parsed[0], []).append(parsed[1])
        for lst in gens.values():
            lst.sort()
        with self._ram_lock:
            self._gens = gens

    def _newest_gen(self, cid: int) -> Optional[int]:
        with self._ram_lock:
            gens = self._gens.get(cid)
            return gens[-1] if gens else None

    def adopt_round(self, round_no: int) -> None:
        """The resume's adoption: every generation newer than
        ``round_no`` (the dead trajectory's future) is deleted."""
        round_no = int(round_no)
        doomed: List[tuple] = []
        with self._ram_lock:
            for cid, gens in list(self._gens.items()):
                for g in [g for g in gens if g > round_no]:
                    gens.remove(g)
                    doomed.append((cid, g))
                if not gens:
                    del self._gens[cid]
        for cid, g in doomed:
            try:
                os.remove(self._path(cid, g))
            except OSError:
                pass

    def mark_durable(self, round_no: int) -> None:
        """A checkpoint at or past ``round_no`` is durable: generations
        superseded at or below it may go (at each row's next spill)."""
        self._safe_round = max(self._safe_round, int(round_no))

    def _register_gen(self, cid: int, gen: int) -> None:
        """Record a landed spill and delete the row's generations older
        than its newest one at or below the durable round."""
        doomed: List[int] = []
        with self._ram_lock:
            gens = self._gens.setdefault(cid, [])
            if gen not in gens:
                gens.append(gen)
                gens.sort()
            covered = [g for g in gens if g <= self._safe_round]
            if covered:
                doomed = [g for g in gens if g < covered[-1]]
                for g in doomed:
                    gens.remove(g)
        for g in doomed:
            try:
                os.remove(self._path(cid, g))
            except OSError:
                pass

    # -- rows -----------------------------------------------------------
    def _read_file(self, cid: int) -> Optional[Dict[str, np.ndarray]]:
        """The row's newest generation from disk, without touching RAM
        (the prefetch worker's read)."""
        gen = self._newest_gen(cid)
        if gen is None:
            return None
        path = self._path(cid, gen)
        if not os.path.exists(path):
            return None
        with np.load(path) as zf:
            return {k: zf[k] for k in zf.files}

    def peek(self, cid: int) -> Optional[Dict[str, np.ndarray]]:
        """The RAM (or in-spill) row without moving the LRU; rows are
        replaced, never changed in place, so the mapping stays valid."""
        cid = int(cid)
        with self._ram_lock:
            row = self._rows.get(cid)
            if row is None:
                row = self._spilling.get(cid)
        return row

    def _read_durable(self, cid: int) -> Optional[Dict[str, np.ndarray]]:
        """The round loop's disk read, under the ladder's ``store_read``
        surface: exhausted retries raise (a lost row corrupts training)."""
        box: Dict[str, Any] = {}

        def _do() -> None:
            box["row"] = self._read_file(cid)
        self.ladder.run(_do, surface="store_read",
                        what=f"fleet row {int(cid)} read")
        return box.get("row")

    def get(self, cid: int) -> Optional[Dict[str, np.ndarray]]:
        cid = int(cid)
        with self._ram_lock:
            row = self._rows.get(cid)
            if row is not None:
                self._rows.move_to_end(cid)
                return row
            row = self._spilling.get(cid)
            if row is not None:
                return row
        row = self._read_durable(cid)
        if row is not None:
            # the RAM copy keeps its disk generation: a later clean
            # re-spill rewrites the same file
            gen = self._newest_gen(cid)
            with self._ram_lock:
                self._tags[cid] = int(gen or 0)
            self._insert(cid, row, dirty=False)
        return row

    def put(self, cid: int, row: Dict[str, np.ndarray]) -> None:
        cid = int(cid)
        with self._ram_lock:
            self._tags[cid] = int(self.put_round)
        self._insert(cid, row, dirty=True)

    def _insert(self, cid: int, row: Dict[str, np.ndarray],
                dirty: bool) -> None:
        to_spill: List[tuple] = []
        with self._ram_lock:
            self._rows.pop(cid, None)
            self._rows[cid] = row
            if dirty:
                self._dirty.add(cid)
            while len(self._rows) > self.cache_rows:
                old_cid, old_row = self._rows.popitem(last=False)
                if old_cid in self._dirty:
                    # the only copy of its newest value: spill it (the
                    # write happens outside the lock)
                    self._dirty.discard(old_cid)
                    self._spilling[old_cid] = old_row
                    to_spill.append((old_cid, old_row))
        for old_cid, old_row in to_spill:
            if self._write(old_cid, old_row):
                with self._ram_lock:
                    self._spilling.pop(old_cid, None)
                self.spilled_rows += 1
            # an exhausted write leaves the row in _spilling, still
            # served, and the next flush() tries again

    def _write(self, cid: int, row: Dict[str, np.ndarray]) -> bool:
        with self._ram_lock:
            gen = int(self._tags.get(cid, 0))
        path = self._path(cid, gen)
        tmp = path + ".tmp.npz"   # the .npz suffix: savez appends none

        def _do() -> None:
            np.savez(tmp, **row)
            os.replace(tmp, path)
        ok = self.ladder.run(_do, surface="store_write",
                             what=f"fleet row {int(cid)} spill")
        if ok:
            self._register_gen(cid, gen)
        return ok

    def has_rows(self) -> bool:
        """Whether any client has a stored row (RAM or disk); the listing
        stops at the first row file."""
        if self._rows:
            return True
        with os.scandir(self.store_dir) as it:
            return any(entry.name.startswith("row_")
                       and ".tmp" not in entry.name for entry in it)

    # -- durability -----------------------------------------------------
    def flush(self) -> int:
        """Write every dirty RAM row (and every stuck evictee) to disk;
        the rows written.  A row whose write exhausts its retries stays
        dirty."""
        n = 0
        with self._ram_lock:
            pending = [(cid, self._rows.get(cid))
                       for cid in sorted(self._dirty)]
            self._dirty.clear()
            stuck = sorted(self._spilling.items())
        for cid, row in pending:
            if row is None:
                continue
            if self._write(cid, row):
                n += 1
            else:
                with self._ram_lock:
                    if cid in self._rows:
                        self._dirty.add(cid)
        for cid, row in stuck:
            if self._write(cid, row):
                with self._ram_lock:
                    self._spilling.pop(cid, None)
                self.spilled_rows += 1
                n += 1
        return n

    def set_round(self, round_no: int) -> None:
        """Commit the round marker (the ladder's ``marker`` surface)."""
        path = self._marker_path()
        tmp = path + ".tmp.npy"

        def _do() -> None:
            np.save(tmp, np.asarray([int(round_no)], np.int64))
            os.replace(tmp, path)
        self.ladder.run(_do, surface="marker",
                        what=f"fleet round marker {int(round_no)}")

    def round(self) -> Optional[int]:
        return read_marker(self.store_dir)

    def reset(self) -> None:
        """Drop every row and the marker (a trajectory mismatch)."""
        with self._ram_lock:
            self._rows.clear()
            self._dirty.clear()
            self._spilling.clear()
            self._tags.clear()
            self._gens.clear()
        self._wipe_files()


def _pinned(shape: tuple, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """A host buffer for a copy to or from ``device``: pinned for a card
    (from PyTorch's caching host allocator, which hands a block out again
    only once the copies recorded on it have passed)."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=device.type == "cuda")


class CarryPager:
    """The slot allocator, page-in and writeback of one run's carry tables
    on one device (``paging.py:466-1131``, ``mesh_shards`` 1).  Every
    mutating method runs on the round loop's thread, in the order
    prefetch, prepare, dispatch, queue, drain; the prefetch worker only
    stages row values."""

    def __init__(self, strategy, state_tables: Dict[str, Any], slots: int,
                 store_dir: str, ladder: DurableIOLadder,
                 host_cache_rows: int = 8192, resume: bool = False,
                 prefetch: bool = True, faults=None,
                 events: Optional[Callable[..., None]] = None):
        self.keys = tuple(strategy.carry_tables)
        if not self.keys:
            raise ValueError(
                f"{type(strategy).__name__} declares no carry_tables — "
                "fleet paging has nothing to page; drop the fleet block "
                "or use a device-carry strategy")
        self.n_slots = int(slots)
        self.mesh_shards = 1
        self.shard_slots = self.n_slots
        self._row_shape: Dict[str, tuple] = {}
        self._dtype: Dict[str, torch.dtype] = {}
        for k in self.keys:
            leaf = state_tables[k]
            if int(leaf.shape[0]) != self.n_slots:
                raise ValueError(
                    f"fleet paging: strategy_state[{k!r}] has "
                    f"{int(leaf.shape[0])} rows but the page pool is "
                    f"{self.n_slots} slots — carry_rows was not applied "
                    "before init_state")
            self._row_shape[k] = tuple(int(d) for d in leaf.shape[1:])
            self._dtype[k] = leaf.dtype
        self.device = state_tables[self.keys[0]].device
        self._defaults = dict(strategy.carry_row_defaults())
        #: the ladder of the store's IO and of the writeback wait; chaos's
        #: InfraFaults (if any) gives the prefetch surface's probe and
        #: delay
        self.ladder = ladder
        self._infra = faults
        self._prefetch_fault = (faults.hook("prefetch")
                                if faults is not None else None)
        #: ``event(kind, **fields)``: the server's record sink
        self.events = events
        #: ``span(name, **args)``: the telemetry scope's span (the worker's
        #: ``fleet_prefetch`` lands on its own thread's track), or None
        self.span = None
        self.store = FleetRowStore(store_dir, ladder,
                                   cache_rows=host_cache_rows, resume=resume)

        # ---- slot state ---------------------------------------------
        self._free: List[int] = list(range(self.n_slots - 1, -1, -1))
        self._slot_client = np.full((self.n_slots,), -1, np.int64)
        self._client_slot: Dict[int, int] = {}
        self._pins = np.zeros((self.n_slots,), np.int64)
        #: unpinned slots in LRU order (front: evicted first)
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._ticket: Optional[Dict[str, Any]] = None
        #: queued, uncompleted writebacks, oldest first
        self._outstanding: deque = deque()

        # ---- prefetch ------------------------------------------------
        self.prefetch_enabled = bool(prefetch)
        #: set by the first prefetch_chunk: only then do staging hits and
        #: misses count
        self._prefetch_engaged = False
        self._staging: Dict[int, Optional[Dict[str, np.ndarray]]] = {}
        self._staging_lock = threading.Lock()
        self._prefetch_thread: Optional[threading.Thread] = None

        # ---- counters ------------------------------------------------
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.migrations = 0
        self.forced_drains = 0
        self.page_in_rows = 0
        self.writeback_rows = 0
        self.page_in_bytes = 0
        self.writeback_bytes = 0
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.prefetch_degradations = 0

    # ------------------------------------------------------------------
    def describe(self) -> Dict[str, Any]:
        """The pager's record, with the JAX pager's keys
        (``paging.py:582-617``)."""
        total_pf = self.prefetch_hits + self.prefetch_misses
        return {
            "pool_slots": self.n_slots,
            "mesh_shards": self.mesh_shards,
            "shard_slots": self.shard_slots,
            "resident": len(self._client_slot),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "migrations": self.migrations,
            "forced_drains": self.forced_drains,
            "page_in_rows": self.page_in_rows,
            "writeback_rows": self.writeback_rows,
            "page_in_bytes": self.page_in_bytes,
            "page_in_bytes_per_device": self.page_in_bytes,
            "writeback_bytes": self.writeback_bytes,
            "writeback_bytes_per_device": self.writeback_bytes,
            "prefetch_hits": self.prefetch_hits,
            "prefetch_misses": self.prefetch_misses,
            "prefetch_degradations": self.prefetch_degradations,
            # None when prefetch never engaged (a serial run)
            "prefetch_hit_rate": (float(self.prefetch_hits) / total_pf
                                  if total_pf else
                                  (0.0 if self._prefetch_engaged
                                   else None)),
            "spilled_rows": int(self.store.spilled_rows),
            "hbm_bytes_per_device": self.shard_slots * self.row_bytes(),
            "tables": list(self.keys),
        }

    def row_bytes(self) -> int:
        """One pool row's bytes over every table: the pool is
        ``n_slots * row_bytes()``, whatever the population."""
        return int(sum(
            int(np.prod(self._row_shape[k], dtype=np.int64))
            * torch.empty((), dtype=self._dtype[k]).element_size()
            for k in self.keys))

    # ------------------------------------------------------------------
    # slot allocation
    # ------------------------------------------------------------------
    def _pin(self, slot: int) -> None:
        if self._pins[slot] == 0:
            self._lru.pop(slot, None)
        self._pins[slot] += 1

    def _unpin(self, slot: int) -> None:
        self._pins[slot] -= 1
        if self._pins[slot] <= 0:
            self._pins[slot] = 0
            if self._slot_client[slot] >= 0:
                self._lru[slot] = None   # most recently used

    def _force_drain_oldest(self) -> bool:
        """Complete the oldest outstanding writeback early; False when
        none is outstanding."""
        if not self._outstanding:
            return False
        self.forced_drains += 1
        self.complete_writeback(self._outstanding[0])
        return True

    def _alloc(self, cid: int) -> int:
        while True:
            if self._free:
                slot = self._free.pop()
                break
            if self._lru:
                slot, _ = self._lru.popitem(last=False)
                # unpinned: every chunk that touched the evictee drained,
                # so the store holds its row already
                self._client_slot.pop(int(self._slot_client[slot]), None)
                self.evictions += 1
                break
            if not self._force_drain_oldest():
                raise ValueError(
                    f"fleet.page_pool_slots={self.n_slots} cannot hold "
                    f"the in-flight cohorts: every slot of shard 0 "
                    f"({self.shard_slots} of {self.n_slots}) is pinned "
                    "by a dispatched chunk — raise page_pool_slots (it "
                    "must cover (pipeline_depth + 1) x cohort x "
                    "rounds_per_step rows per shard)")
        self._slot_client[slot] = cid
        self._client_slot[cid] = slot
        return slot

    # ------------------------------------------------------------------
    # prefetch
    # ------------------------------------------------------------------
    def prefetch_chunk(self, batches: list) -> int:
        """Stage the next chunk's missing rows on the ``fleet-prefetch``
        thread while the card runs the current one; the rows queued."""
        if not self.prefetch_enabled:
            return 0
        self._prefetch_engaged = True
        self._join_prefetch()
        if not self.prefetch_enabled:
            # the worker just joined died: the cold path from here on
            return 0
        want: List[int] = []
        seen: set = set()
        for b in _flat(batches):
            for cid in np.asarray(b.client_ids).ravel():
                cid = int(cid)
                if cid < 0 or cid in seen or cid in self._client_slot:
                    continue
                seen.add(cid)
                want.append(cid)
        with self._staging_lock:
            self._staging = {}
            staging = self._staging
        if not want:
            return 0
        t = threading.Thread(target=self._prefetch_worker,
                             args=(want, staging), name="fleet-prefetch",
                             daemon=True)
        self._prefetch_thread = t
        t.start()
        return len(want)

    def _prefetch_worker(self, cids: List[int], staging: dict) -> None:
        try:
            span = self.span
            if span is not None:
                with span("fleet_prefetch", rows=len(cids)):
                    self._prefetch_rows(cids, staging)
            else:
                self._prefetch_rows(cids, staging)
        except Exception as exc:  # noqa: BLE001 - any death degrades
            self._degrade_prefetch(exc)

    def _degrade_prefetch(self, exc: BaseException) -> None:
        """The worker died: every later miss takes the cold path
        (``store.get``, the same values on the critical path), with one
        ``prefetch_degraded`` record."""
        self.prefetch_enabled = False
        self.prefetch_degradations += 1
        with self._staging_lock:
            self._staging = {}
        if self.events is not None:
            self.events("prefetch_degraded", error=repr(exc),
                        degradations=int(self.prefetch_degradations))

    def _prefetch_rows(self, cids: List[int], staging: dict) -> None:
        infra = self._infra
        if infra is not None:
            # a seeded stall: prepare_chunk may supersede a half-filled
            # staging, which the loop below notices
            delay = infra.prefetch_delay()
            if delay > 0.0:
                time.sleep(delay)
        for cid in cids:
            if self._prefetch_fault is not None:
                self._prefetch_fault()
            row = self.store.peek(cid)
            if row is None:
                row = self.store._read_file(cid)
            with self._staging_lock:
                if staging is not self._staging:
                    return   # superseded
                staging[cid] = row

    def _join_prefetch(self) -> None:
        t = self._prefetch_thread
        if t is not None and t.is_alive():
            t.join()
        self._prefetch_thread = None

    def _load_row(self, cid: int) -> Optional[Dict[str, np.ndarray]]:
        """A miss's row: staged by the worker (a prefetch hit), else read
        from the store (the cold path, the same values)."""
        if self._prefetch_engaged:
            with self._staging_lock:
                if cid in self._staging:
                    self.prefetch_hits += 1
                    return self._staging.pop(cid)
            self.prefetch_misses += 1
        return self.store.get(cid)

    # ------------------------------------------------------------------
    # per-chunk flow
    # ------------------------------------------------------------------
    def prepare_chunk(self, batches: list, strategy_state: Dict[str, Any]
                      ) -> Dict[str, Any]:
        """Map the chunk's cohorts onto slots (``batch.carry_slots`` on
        every grid, -1 for padding), page the misses in and pin the
        chunk's slots until it drains; returns ``strategy_state`` (its
        tables written in place)."""
        if self._ticket is not None:
            raise RuntimeError(
                "fleet pager: prepare_chunk called with an unconsumed "
                "ticket — queue_writeback must run after each dispatch")
        chunk_slots: "OrderedDict[int, int]" = OrderedDict()  # slot->cid
        miss: List[tuple] = []
        for b in _flat(batches):
            ids = np.asarray(b.client_ids)
            slots = np.full(ids.shape, -1, np.int32)
            for j, cid in enumerate(ids):
                cid = int(cid)
                if cid < 0:
                    continue
                slot = self._client_slot.get(cid)
                if slot is None:
                    slot = self._alloc(cid)
                    miss.append((cid, slot))
                    self.misses += 1
                else:
                    self.hits += 1
                    if self._pins[slot] == 0 and slot in self._lru:
                        self._lru.move_to_end(slot)
                slots[j] = slot
                if slot not in chunk_slots:
                    chunk_slots[slot] = cid
                    self._pin(slot)
            b.carry_slots = slots
        page_in_bytes = self._page_in(strategy_state, miss) if miss else 0
        self._ticket = {
            "slots": np.asarray(list(chunk_slots), np.int64),
            "ids": np.asarray(list(chunk_slots.values()), np.int64),
            "page_in_bytes": int(page_in_bytes),
        }
        if self.prefetch_enabled:
            # what the worker staged and nobody took is dead now
            with self._staging_lock:
                self._staging = {}
        return strategy_state

    def _page_in(self, strategy_state: Dict[str, Any],
                 miss: List[tuple]) -> int:
        """The misses' rows into their slots: staged in pinned host
        buffers of ``W`` rows, one copy a table and an ``index_copy_`` on
        the current stream; the bytes copied."""
        n, dev = len(miss), self.device
        W = _pow2_width(n)
        idx = _pinned((W,), torch.int64, dev)
        idx[:n] = torch.as_tensor([slot for _, slot in miss],
                                  dtype=torch.int64)
        rows = {k: _pinned((W,) + self._row_shape[k], self._dtype[k], dev)
                for k in self.keys}
        host = {k: v.numpy() for k, v in rows.items()}
        for i, (cid, _) in enumerate(miss):
            stored = self._load_row(cid)
            for k in self.keys:
                if stored is not None:
                    host[k][i] = stored[k]
                else:
                    host[k][i] = self._defaults.get(k, 0.0)
        idx_dev = idx[:n].to(dev, non_blocking=True)
        nbytes = idx_dev.numel() * idx_dev.element_size()
        for k in self.keys:
            src = rows[k][:n].to(dev, non_blocking=True)
            strategy_state[k].index_copy_(0, idx_dev, src)
            nbytes += src.numel() * src.element_size()
        self.page_in_rows += n
        self.page_in_bytes += nbytes
        return nbytes

    def queue_writeback(self, strategy_state: Dict[str, Any],
                        round_no: int = 0) -> Dict[str, Any]:
        """Start the copy of this chunk's slot rows from the post-chunk
        tables to pinned host memory, behind an event (no host wait).
        ``round_no`` is the chunk's last round: the rows' generation.
        Returns the handle :meth:`complete_writeback` takes."""
        ticket = self._ticket
        self._ticket = None
        if ticket is None or ticket["slots"].size == 0:
            return {"ids": np.empty((0,), np.int64), "rows": None,
                    "slots": np.empty((0,), np.int64), "done": True,
                    "round": int(round_no), "event": None,
                    "page_in_bytes": int((ticket or {}).get(
                        "page_in_bytes", 0)),
                    "writeback_bytes": 0}
        n, dev = int(ticket["slots"].size), self.device
        idx = _pinned((_pow2_width(n),), torch.int64, dev)
        idx[:n] = torch.from_numpy(ticket["slots"])
        idx_dev = idx[:n].to(dev, non_blocking=True)
        rows, wb_bytes = {}, 0
        for k in self.keys:
            gathered = strategy_state[k].index_select(0, idx_dev)
            if dev.type == "cuda":
                rows[k] = _pinned(tuple(gathered.shape), gathered.dtype,
                                  dev).copy_(gathered, non_blocking=True)
            else:
                rows[k] = gathered
            wb_bytes += gathered.numel() * gathered.element_size()
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self.writeback_bytes += wb_bytes
        handle = {"ids": ticket["ids"], "slots": ticket["slots"],
                  "rows": rows, "event": event, "done": False,
                  "round": int(round_no),
                  "page_in_bytes": int(ticket["page_in_bytes"]),
                  "writeback_bytes": wb_bytes}
        self._outstanding.append(handle)
        return handle

    def complete_writeback(self, handle: Dict[str, Any]) -> None:
        """The drain's half: wait on the handle's event once (the ladder's
        ``writeback`` surface), write the rows through to the store and
        unpin the chunk's slots.  Idempotent: an allocation under
        contention may have completed it first."""
        if handle.get("done"):
            return
        handle["done"] = True
        for i, h in enumerate(self._outstanding):
            if h is handle:
                del self._outstanding[i]
                break
        ids = handle["ids"]
        if handle["rows"] is None or ids.size == 0:
            return
        event = handle["event"]

        def _fetch() -> None:
            if event is not None:
                event.synchronize()
        self.ladder.run(_fetch, surface="writeback",
                        what=f"fleet writeback of {int(ids.size)} rows")
        host = {k: v.numpy() for k, v in handle["rows"].items()}
        handle["rows"] = None
        # the rows' generation: the chunk's last round
        self.store.put_round = int(handle["round"])
        for i, cid in enumerate(ids):
            # a copy: a view would keep the whole host buffer alive in
            # the row cache
            self.store.put(int(cid), {k: np.array(host[k][i])
                                      for k in self.keys})
        self.writeback_rows += int(ids.size)
        for slot in handle["slots"]:
            self._unpin(int(slot))

    # ------------------------------------------------------------------
    # host reads and durability
    # ------------------------------------------------------------------
    def user_row(self, uid: int) -> Optional[Dict[str, np.ndarray]]:
        """The client's current row from the store (at a drained
        boundary), or None for a client never seen."""
        return self.store.get(int(uid))

    def has_rows(self) -> bool:
        return self.store.has_rows()

    def flush(self) -> int:
        return self.store.flush()

    def set_round(self, round_no: int) -> None:
        self.store.set_round(round_no)

    def round(self) -> Optional[int]:
        return self.store.round()

    def adopt_round(self, round_no: int) -> None:
        self.store.adopt_round(round_no)

    def mark_durable(self, round_no: int) -> None:
        self.store.mark_durable(round_no)

    def reset(self) -> None:
        """A trajectory mismatch on resume: the rows and the slot map go;
        every next touch starts from the defaults."""
        self._join_prefetch()
        self.store.reset()
        self._free = list(range(self.n_slots - 1, -1, -1))
        self._slot_client[:] = -1
        self._client_slot.clear()
        self._pins[:] = 0
        self._lru.clear()
        self._ticket = None
        self._outstanding.clear()
        with self._staging_lock:
            self._staging = {}


def _flat(batches: list) -> list:
    """A chunk's grids: a round's batch, or a bucketed round's list."""
    return [b for entry in batches
            for b in (entry if isinstance(entry, list) else [entry])]
