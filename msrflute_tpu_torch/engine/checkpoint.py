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
again at resume.  :meth:`load` and :meth:`backup` wait for the save in
flight first.

Every blob goes through one write recipe, :meth:`CheckpointManager.
_write_blob` (``checkpoint.py:484-530``): under the bounded retry of
``server_config.checkpoint_retry`` (:class:`..resilience.integrity.
RetryPolicy`), each physical attempt runs the chaos IO probe first (one
draw of ``chaos.ckpt_io_error_rate``'s stream), then writes the temporary
file, rotates ``latest`` to ``.prev`` by link, renames the file into
place and writes its sidecar.  The logical writes are those of the JAX
package's msgpack backend: ``latest`` once a chunk and a best model on
each improvement (epoch copies are plain file copies, with no probe), so
the fault stream advances alike in both packages.  A save whose attempts
all fail warns and the run goes on; ``escalation_threshold`` consecutive
failed saves raise :class:`..resilience.integrity.
CheckpointEscalationError` on the training thread: at a save, at the
async submit or at :meth:`wait` (``checkpoint.py:337-392``).  The writer
thread never raises: a failure there is counted, and a
``BaseException`` that is not an ``Exception`` (an interrupt, a kill) is
handed to the training thread, which raises it at its next submit or
wait.
"""

from __future__ import annotations

import io
import json
import logging
import os
import shutil
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from ..resilience.integrity import (SIDECAR_SUFFIX, CheckpointCorruptionError,
                                    FailureEscalator, RetryPolicy,
                                    blob_checksum, run_with_retry,
                                    verify_blob, write_sidecar)
from ..telemetry import NULL_SPAN
from ..utils.logging import print_rank
from .round import ServerState

LATEST = "latest_model.pt"
#: the previous generation of ``latest``, rotated into place on every save
LATEST_PREV = LATEST + ".prev"
STATUS_LOG = "status_log.json"

_LOGGER = logging.getLogger("msrflute_tpu_torch")


def serialize(payload: Dict[str, Any]) -> bytes:
    """``torch.save`` of ``payload`` into bytes."""
    buf = io.BytesIO()
    torch.save(payload, buf)
    return buf.getvalue()


def write_verified(path: str, payload: Dict[str, Any]) -> None:
    """``torch.save`` of ``payload`` to a temporary file renamed into
    place, then its crc32 sidecar."""
    blob = serialize(payload)
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


#: the first bytes of a ``torch.save`` file (a zip archive)
_TORCH_MAGIC = b"PK\x03\x04"


def load_pretrained_params(path: str, layout,
                           data_path: Optional[str] = None
                           ) -> Dict[str, torch.Tensor]:
    """``model_config.pretrained_model_path`` -> ``{name: float32 CPU
    tensor}`` for a warm start (``msrflute_tpu/engine/checkpoint.py:81-106``).
    A relative path that does not exist as given resolves against
    ``data_path``.  Any checkpoint the port's manager writes (``latest``,
    ``epoch<N>``, ``best_val_*``; its crc sidecar is checked when present)
    or a bare ``{name: tensor}`` ``.pt``; only the params are taken, and
    their names and shapes must be ``layout``'s.  The JAX package's flax
    msgpack files and orbax directories raise ``ValueError`` naming the
    format: the port reads torch files only (carry JAX weights across with
    :func:`..models.convert.from_jax_params`)."""
    if not os.path.isabs(path) and not os.path.exists(path) and data_path:
        path = os.path.join(data_path, path)
    if os.path.isdir(path):
        raise ValueError(
            f"pretrained_model_path {path!r} is a directory, as an orbax "
            "checkpoint is: the port reads torch .pt files only")
    with open(path, "rb") as fh:
        head = fh.read(len(_TORCH_MAGIC))
    if head != _TORCH_MAGIC:
        raise ValueError(
            f"pretrained_model_path {path!r} is not a torch .pt file (a flax "
            "msgpack checkpoint of the JAX package, for one): the port "
            "reads torch .pt files only")
    if os.path.exists(path + SIDECAR_SUFFIX):
        payload = read_verified(path)
    else:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and isinstance(payload.get("params"), dict):
        payload = payload["params"]
    want = dict(zip(layout.names, layout.shapes))
    got = {k: tuple(v.shape) for k, v in payload.items()}
    if got != want:
        raise ValueError(f"pretrained params {path!r}: shapes {got} do not "
                         f"match the model's {want}")
    return {n: payload[n].to(torch.float32) for n in layout.names}


class CheckpointManager:
    def __init__(self, model_dir: str, layout, backup_freq: int = 100,
                 async_latest: bool = False,
                 retry: Optional[RetryPolicy] = None,
                 io_fault: Optional[Callable[[], None]] = None,
                 events: Optional[Callable[..., None]] = None):
        self.model_dir = model_dir
        self.layout = layout
        self.backup_freq = max(int(backup_freq), 1)
        #: bounded retry of each write, and the consecutive-failure count
        #: that aborts the run at its threshold
        self.retry = retry or RetryPolicy()
        self.escalator = FailureEscalator(self.retry.escalation_threshold)
        #: the structured-event sink (``MetricsLog.event``; a no-op when
        #: None): ``ckpt_io_fault``, ``checkpoint_recovery`` and
        #: ``checkpoint_save_failed`` (``checkpoint.py:163, 207, 533``)
        self._event = events or (lambda kind, **fields: None)
        base_fault = io_fault or (lambda: None)

        def fault_probe() -> None:
            # run before each physical write attempt (the chaos IO probe);
            # raises to fail the attempt, and every fault leaves a record
            try:
                base_fault()
            except Exception:
                self._event("ckpt_io_fault")
                raise

        self._io_fault = fault_probe
        #: ``{"event", "path"}`` of each slot a load skipped or fell back
        #: to, each also a ``checkpoint_recovery`` record
        self.recovery_events = []
        #: ``latest`` through the single-slot writer thread
        self.async_latest = bool(async_latest)
        self._cond = threading.Condition()
        self._mailbox: Optional[Snapshot] = None
        self._busy = False
        self._worker: Optional[threading.Thread] = None
        #: a kill or interrupt on the writer thread, raised on the training
        #: thread
        self._fatal: Optional[BaseException] = None
        #: ``span(name)``: the telemetry scope's span, or None
        self.span: Optional[Callable[..., Any]] = None
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

    def _write_blob(self, path: str, blob: bytes,
                    keep_prev: bool = False) -> bool:
        """The write recipe under the retry policy: the IO probe, the
        temporary file, for ``latest`` (``keep_prev``) the link rotation
        to ``.prev``, the rename into place, the sidecar.  True on
        success; a failed save is counted toward escalation, which the
        caller checks on the training thread."""
        checksum = blob_checksum(blob)
        prev = path + ".prev"

        def save() -> None:
            self._io_fault()
            tmp = path + ".tmp"
            with open(tmp, "wb") as fh:
                fh.write(blob)
            if keep_prev and os.path.exists(path):
                # blob, then sidecar: a crash between the two leaves a
                # sidecar one generation stale, which the load's check
                # refuses, and ``latest`` stays loadable until replaced
                self._rotate(path, prev)
                if os.path.exists(path + SIDECAR_SUFFIX):
                    self._rotate(path + SIDECAR_SUFFIX,
                                 prev + SIDECAR_SUFFIX)
            os.replace(tmp, path)
            write_sidecar(path, checksum, len(blob))

        if run_with_retry(save, self.retry, what="checkpoint save "
                          f"{os.path.basename(path)}"):
            self.escalator.record_success()
            return True
        self.escalator.record_failure(f"save {path}")
        self._event("checkpoint_save_failed", path=os.path.basename(path),
                    consecutive=self.escalator.consecutive)
        return False

    def _write(self, name: str, state: ServerState) -> None:
        self._write_blob(self._path(name),
                         serialize(self._payload(self._to_host(state))))
        self.escalator.check()

    def _write_latest(self, payload: Dict[str, Any]) -> bool:
        return self._write_blob(self._path(LATEST), serialize(payload),
                                keep_prev=True)

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
            self.escalator.check()
            return
        # single slot, not latest-wins: wait for the save in flight; the
        # writer's failures surface here, on the training thread
        self._raise_fatal()
        self.escalator.check()
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._loop, name="ckpt-latest-writer", daemon=True)
            self._worker.start()
        with self._cond:
            while self._mailbox is not None or self._busy:
                self._cond.wait()
            self._raise_fatal()
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
            fatal = None
            try:
                # the writer's wait, serialize and write on its own thread's
                # track of the trace (``checkpoint.py:358-371``)
                with (self.span("ckpt_async_write") if self.span is not None
                      else NULL_SPAN):
                    # a failed save is already counted by the write recipe
                    self._write_latest(self._payload(snap.wait()))
            except Exception as exc:  # never ends the run from here
                print_rank(f"async latest save failed: {exc!r}",
                           loglevel=logging.WARNING)
                self.escalator.record_failure("async latest serialize")
            except BaseException as exc:  # a kill: the training thread's
                fatal = exc
            finally:
                del snap
                with self._cond:
                    self._busy = False
                    if fatal is not None:
                        self._fatal, self._worker = fatal, None
                    self._cond.notify_all()
            if fatal is not None:
                return

    def _raise_fatal(self) -> None:
        if self._fatal is not None:
            exc, self._fatal = self._fatal, None
            raise exc

    def wait(self) -> None:
        """Block until the save in flight is on disk; raise escalation
        when the consecutive failures reached the threshold, and a kill
        that ended the writer thread."""
        if self._worker is not None:
            with self._cond:
                while self._mailbox is not None or self._busy:
                    self._cond.wait()
        self._raise_fatal()
        self.escalator.check()

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
        self._event("checkpoint_recovery", detail=event, path=path)
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
