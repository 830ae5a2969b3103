"""Checkpoint / resume — the port's counterpart of
``msrflute_tpu/engine/checkpoint.py`` (its msgpack backend, with the
async ``latest`` writer).

Files under the model directory, named as the JAX package names them with
``.pt`` for ``.msgpack``:

- ``latest_model.pt`` every round chunk, ``epoch<N>.pt`` and
  ``best_val_<metric>_model_epoch<N>.pt`` copies every
  ``model_backup_freq`` rounds, ``best_val_<metric>_model.pt`` on each
  improvement;
- ``status_log.json``: round ``i``, client-LR ``weight``, the numpy
  sampling state ``np_rng_state``, ``best_val_*``, ``plateau`` and the
  annealed quantization threshold ``quant_thresh``, and ``status_ring``,
  those fields for each of the last few chunks by round, which a resume
  pairs with the round of the slot it loaded.

Each checkpoint is ``torch.save`` of ``{"params": {name: tensor},
"opt_state": {...}, "strategy_state": {...}, "round": int}`` (CPU
tensors: the server optimizer's state, Adam's moments and count included,
and the strategy's cross-round state, DGA's staleness sums), written to a
temporary file and renamed into place, with a crc32 sidecar verified at
load.

``latest`` keeps two slots, as the JAX package's msgpack backend does
(``checkpoint.py:41-44, 485-580``): every save first rotates the previous
file and its sidecar to ``latest_model.pt.prev`` (by hard link, so the
committed file never disappears), and a load whose ``latest`` fails its
crc or cannot be read (a torn write) falls back to ``.prev``, one round
back, recording a recovery event.  A load of ``latest`` raises
:class:`CheckpointCorruptionError` when both of its slots that exist are
bad; a single-slot file (a best model) that is bad is skipped with a
recovery event and reads as None, as in the JAX package.

A ``latest`` save starts from a :class:`Snapshot` of the state, taken in
stream order: a ``non_blocking`` copy into pinned host memory behind an
event on a card, a clone on the CPU.  The pipelined round loop takes a
chunk's snapshot before it dispatches the next chunk and saves it when
the chunk drains, so ``latest`` and its epoch copies always hold the
drained chunk's state, at any ``pipeline_depth``.  The server's state is
never written in place (the optimizers are functional), so a snapshot is
all a save needs.  With ``async_latest`` (``checkpoint_async``; on by
default when the loop is pipelined) the save goes to a single-slot writer
thread (``checkpoint.py:177-190, 337-435``): :meth:`CheckpointManager.
save_latest` waits for the save in flight, if any, and hands the snapshot
over; the thread waits for the event, serializes and writes with the same
verified blob and two-slot rotation.  At most one save is in flight, so
the on-disk ``latest`` lags the status log by at most one chunk (two
when ``latest`` is torn and ``.prev`` loads); the status ring pairs them
again at resume.  A failed
write is raised on the training thread at its next save or :meth:`wait`;
:meth:`load` and :meth:`backup` wait for the save in flight first.
"""

from __future__ import annotations

import io
import json
import logging
import os
import shutil
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..resilience.integrity import (SIDECAR_SUFFIX, CheckpointCorruptionError,
                                    blob_checksum, verify_blob, write_sidecar)
from .round import ServerState

LATEST = "latest_model.pt"
#: the previous generation of ``latest``, rotated into place on every save
LATEST_PREV = LATEST + ".prev"
STATUS_LOG = "status_log.json"

_LOGGER = logging.getLogger("msrflute_tpu_torch")


def write_verified(path: str, payload: Dict[str, Any]) -> None:
    """``torch.save`` of ``payload`` to a temporary file renamed into
    place, then its crc32 sidecar."""
    buf = io.BytesIO()
    torch.save(payload, buf)
    blob = buf.getvalue()
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(blob)
    os.replace(tmp, path)
    write_sidecar(path, blob_checksum(blob), len(blob))


def read_verified(path: str) -> Dict[str, Any]:
    """The payload at ``path`` (CPU tensors) after its crc check; raises
    :class:`CheckpointCorruptionError` on a mismatch."""
    with open(path, "rb") as fh:
        blob = fh.read()
    verify_blob(path, blob)
    return torch.load(io.BytesIO(blob), map_location="cpu",
                      weights_only=True)


def update_json_log(path: str, update: Dict[str, Any]) -> Dict[str, Any]:
    """Merge ``update`` into a JSON file, written atomically."""
    data: Dict[str, Any] = {}
    if os.path.exists(path):
        try:
            with open(path) as fh:
                data = json.load(fh)
        except (json.JSONDecodeError, OSError):
            data = {}
    data.update(update)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(data, fh, indent=2)
    os.replace(tmp, path)
    return data


@dataclass
class Snapshot:
    """A state copied to the host: valid once ``event`` (None on the CPU)
    has passed."""

    state: ServerState
    event: Optional[Any] = None

    def wait(self) -> ServerState:
        if self.event is not None:
            self.event.synchronize()
        return self.state


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A snapshot of ``t`` on the host: from a card a ``non_blocking``
    copy into pinned memory (valid once the event recorded after it has
    passed), else a clone."""
    t = t.detach()
    if t.device.type != "cuda":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t, non_blocking=True)


class CheckpointManager:
    def __init__(self, model_dir: str, layout, backup_freq: int = 100,
                 async_latest: bool = False):
        self.model_dir = model_dir
        self.layout = layout
        self.backup_freq = max(int(backup_freq), 1)
        #: ``{"event", "path"}`` of each slot a load skipped or fell back to
        self.recovery_events = []
        #: ``latest`` through the single-slot writer thread
        self.async_latest = bool(async_latest)
        self._cond = threading.Condition()
        self._mailbox: Optional[Snapshot] = None
        self._busy = False
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(model_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.model_dir, name)

    def _rotate(self, src: str, dst: str) -> None:
        """Move ``src``'s content to ``dst`` while ``src`` stays readable:
        hard-link it beside ``dst`` (a copy where links are refused), then
        rename the link over ``dst``."""
        link = dst + ".lnk"
        if os.path.exists(link):
            os.remove(link)
        try:
            os.link(src, link)
        except OSError:
            shutil.copyfile(src, link)
        os.replace(link, dst)

    def _payload(self, state: ServerState) -> Dict[str, Any]:
        """What a checkpoint file holds, from a state on the host."""
        return {
            "params": {k: v.clone() for k, v in
                       self.layout.views(state.params).items()},
            "opt_state": dict(state.opt_state),
            "strategy_state": dict(state.strategy_state),
            "round": int(state.round),
        }

    def _to_host(self, state: ServerState) -> ServerState:
        return ServerState(
            state.params.detach().cpu(),
            {k: v.detach().cpu() for k, v in state.opt_state.items()},
            state.round,
            {k: v.detach().cpu() for k, v in state.strategy_state.items()})

    def _write(self, name: str, state: ServerState) -> None:
        write_verified(self._path(name), self._payload(self._to_host(state)))

    def _write_latest(self, payload: Dict[str, Any]) -> None:
        path, prev = self._path(LATEST), self._path(LATEST_PREV)
        if os.path.exists(path):
            # blob, then sidecar: a crash between the two leaves a sidecar
            # one generation stale, which the load's check refuses, and
            # ``latest`` stays the loadable slot until it is replaced
            self._rotate(path, prev)
            if os.path.exists(path + SIDECAR_SUFFIX):
                self._rotate(path + SIDECAR_SUFFIX, prev + SIDECAR_SUFFIX)
        write_verified(path, payload)

    @staticmethod
    def snapshot(state: ServerState) -> Snapshot:
        """The state copied to the host in stream order (see
        :class:`Snapshot`)."""
        snap = ServerState(
            _host_copy(state.params),
            {k: _host_copy(v) for k, v in state.opt_state.items()},
            state.round,
            {k: _host_copy(v) for k, v in state.strategy_state.items()})
        event = None
        if state.params.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return Snapshot(snap, event)

    def save_latest(self, state: Union[ServerState, Snapshot]) -> None:
        """Save ``state`` (or a snapshot taken earlier) as ``latest``: on
        this thread, or through the writer thread with ``async_latest``."""
        snap = state if isinstance(state, Snapshot) else \
            self.snapshot(state)
        if not self.async_latest:
            self._write_latest(self._payload(snap.wait()))
            return
        # single slot, not latest-wins: wait for the save in flight
        self._raise_error()
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._loop, name="ckpt-latest-writer", daemon=True)
            self._worker.start()
        with self._cond:
            while self._mailbox is not None or self._busy:
                self._cond.wait()
            self._mailbox = snap
            self._cond.notify_all()

    # -- the async ``latest`` writer (``checkpoint.py:337-435``) ---------
    def _loop(self) -> None:
        while True:
            with self._cond:
                while self._mailbox is None:
                    self._cond.wait()
                snap = self._mailbox
                self._mailbox = None
                self._busy = True
            try:
                self._write_latest(self._payload(snap.wait()))
            except Exception as exc:  # raised on the training thread
                self._error = exc
            finally:
                del snap
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def _raise_error(self) -> None:
        if self._error is not None:
            exc, self._error = self._error, None
            raise RuntimeError(f"async latest save failed: {exc!r}") from exc

    def wait(self) -> None:
        """Block until the save in flight is on disk; raise its failure,
        if it failed."""
        if self._worker is not None:
            with self._cond:
                while self._mailbox is not None or self._busy:
                    self._cond.wait()
        self._raise_error()

    def save_best(self, state: ServerState, metric_name: str) -> None:
        self._write(f"best_val_{metric_name}_model.pt", state)

    def backup(self, round_no: int, best_names: Tuple[str, ...] = ()) -> None:
        """Every ``backup_freq`` rounds: ``epoch<N>.pt`` plus snapshots of
        the best-model files."""
        if round_no % self.backup_freq:
            return
        self.wait()   # the epoch copy must see the newest latest file
        pairs = [(LATEST, f"epoch{round_no}.pt")] + [
            (f"best_val_{n}_model.pt", f"best_val_{n}_model_epoch{round_no}.pt")
            for n in best_names]
        for src, dst in pairs:
            if os.path.exists(self._path(src)):
                shutil.copyfile(self._path(src), self._path(dst))

    def _recover(self, event: str, path: str) -> None:
        self.recovery_events.append({"event": event, "path": path})
        _LOGGER.warning("checkpoint recovery: %s (%s)", event, path)

    def load(self, device: torch.device,
             name: str = LATEST) -> Optional[ServerState]:
        """The checkpoint ``name`` on ``device``; for ``latest``, its
        ``.prev`` slot where ``latest`` is corrupt or torn.  None when no
        slot exists or when a single-slot ``name`` is bad; raises
        :class:`CheckpointCorruptionError` when both slots of ``latest``
        that exist are bad."""
        self.wait()
        path = self._path(name)
        slots = [path] + ([self._path(LATEST_PREV)] if name == LATEST
                          else [])
        tried = []
        for slot in slots:
            if not os.path.exists(slot):
                continue
            tried.append(slot)
            try:
                payload = read_verified(slot)
            except CheckpointCorruptionError as exc:
                self._recover(f"integrity check failed: {exc}", slot)
                continue
            except Exception as exc:  # a torn or truncated file
                self._recover(f"unreadable checkpoint: {exc!r}", slot)
                continue
            if slot != path:
                self._recover("restored from backup slot", slot)
            params = self.layout.flatten(payload["params"]).to(device)
            opt_state = {k: v.to(device)
                         for k, v in payload["opt_state"].items()}
            strategy_state = {k: v.to(device) for k, v in
                              payload.get("strategy_state", {}).items()}
            return ServerState(params, opt_state, int(payload["round"]),
                               strategy_state)
        if tried and name == LATEST:
            raise CheckpointCorruptionError(
                f"no loadable checkpoint among {tried}")
        return None

    def update_status(self, update: Dict[str, Any]) -> Dict[str, Any]:
        return update_json_log(self._path(STATUS_LOG), update)

    def read_status(self) -> Dict[str, Any]:
        path = self._path(STATUS_LOG)
        if not os.path.exists(path):
            return {}
        with open(path) as fh:
            return json.load(fh)
