"""Checkpoint integrity and bounded retry — the port's own copy of
``msrflute_tpu/resilience/integrity.py`` (its checksums, ``RetryPolicy``,
``run_with_retry`` and ``FailureEscalator``).

- **Checksums.** A crc32 of each serialized checkpoint is written next to
  it (``<path>.sum``) after the blob lands, and verified at load: a
  mismatch means a torn write or bit rot.  crc32, not a cryptographic
  hash: the threat model is torn writes, not an adversary.
- **RetryPolicy** (``server_config.checkpoint_retry``): each physical
  write is retried with exponential backoff and jitter.
- **FailureEscalator**: counts consecutive fully failed saves; at
  ``escalation_threshold`` the training thread raises
  :class:`CheckpointEscalationError` instead of training on
  uncheckpointed behind warnings.

- **DurableIOLadder** (``integrity.py:184-278``): the same retry policy
  over every durable host IO surface of the fleet paged carry (the row
  store's spills and reads, its round marker, the writeback fetch, and
  the rollup writer), each surface with its own exhaustion mode.

Not copied: ``tree_checksum`` (orbax slots, which the port does not
write).
"""

from __future__ import annotations

import json
import logging
import os
import random
import time
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from ..utils.logging import print_rank

SIDECAR_SUFFIX = ".sum"


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed its integrity check."""


class CheckpointEscalationError(RuntimeError):
    """Too many consecutive checkpoint-save failures: the run is no longer
    resumable and stops instead of training on uncheckpointed."""


def blob_checksum(blob: bytes) -> str:
    return f"{zlib.crc32(blob) & 0xFFFFFFFF:08x}"


def write_sidecar(path: str, checksum: str, size: int) -> None:
    sidecar = path + SIDECAR_SUFFIX
    tmp = sidecar + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"crc32": checksum, "size": size}, fh)
    os.replace(tmp, sidecar)


def read_sidecar(path: str) -> Optional[dict]:
    sidecar = path + SIDECAR_SUFFIX
    if not os.path.exists(sidecar):
        return None
    try:
        with open(sidecar) as fh:
            return json.load(fh)
    except (json.JSONDecodeError, OSError):
        return None   # a torn sidecar must not make a good blob unloadable


def verify_blob(path: str, blob: bytes) -> None:
    """Raise :class:`CheckpointCorruptionError` if ``blob`` does not match
    the sidecar recorded for ``path`` (no sidecar verifies vacuously)."""
    meta = read_sidecar(path)
    if meta is None:
        return
    if meta.get("size") is not None and meta["size"] != len(blob):
        raise CheckpointCorruptionError(
            f"{path}: size {len(blob)} != recorded {meta['size']}")
    actual = blob_checksum(blob)
    if meta.get("crc32") and actual != meta["crc32"]:
        raise CheckpointCorruptionError(
            f"{path}: crc32 {actual} != recorded {meta['crc32']}")


# ----------------------------------------------------------------------
# retry + escalation
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff and jitter
    (``server_config.checkpoint_retry``); ``escalation_threshold``
    consecutive fully failed saves (each retried ``retries`` times) abort
    the run with :class:`CheckpointEscalationError`."""

    retries: int = 3
    backoff_base_s: float = 0.5
    backoff_max_s: float = 30.0
    jitter: float = 0.25          # +- fraction of the computed delay
    escalation_threshold: int = 10

    @classmethod
    def from_config(cls, raw: Optional[dict]) -> "RetryPolicy":
        if not raw:
            return cls()
        return cls(
            retries=int(raw.get("retries", cls.retries)),
            backoff_base_s=float(raw.get("backoff_base_s",
                                         cls.backoff_base_s)),
            backoff_max_s=float(raw.get("backoff_max_s", cls.backoff_max_s)),
            jitter=float(raw.get("jitter", cls.jitter)),
            escalation_threshold=int(raw.get("escalation_threshold",
                                             cls.escalation_threshold)),
        )

    def delay(self, attempt: int) -> float:
        """Seconds before retry ``attempt`` (0-based): exponential, capped,
        jittered.  The jitter comes from no seeded stream: the chaos
        schedule decides which writes fail, never how long IO sleeps."""
        base = min(self.backoff_max_s, self.backoff_base_s * (2.0 ** attempt))
        if self.jitter <= 0.0:
            return base
        return base * (1.0 + self.jitter * (2.0 * random.random() - 1.0))


def run_with_retry(fn: Callable[[], None], policy: RetryPolicy,
                   what: str = "save",
                   sleep: Callable[[float], None] = time.sleep) -> bool:
    """Run ``fn`` under ``policy``; True on success.  An ``Exception`` is
    retried after the policy's delay; a ``BaseException`` that is not one
    (``KeyboardInterrupt``, ``SystemExit``, a test's kill switch) always
    propagates: an interrupt in the middle of a save ends the run."""
    attempts = max(policy.retries, 1)
    for attempt in range(attempts):
        try:
            fn()
            return True
        except Exception as exc:  # noqa: BLE001 - best-effort IO
            last = attempt == attempts - 1
            print_rank(f"{what} attempt {attempt + 1}/{policy.retries} "
                       f"failed: {exc!r}" + ("" if last else "; backing off"),
                       loglevel=logging.WARNING)
            if not last:
                sleep(policy.delay(attempt))
    return False


class FailureEscalator:
    """Consecutive fully failed saves.  The writer thread records, the
    training thread checks (int updates under the GIL)."""

    def __init__(self, threshold: int):
        self.threshold = max(int(threshold), 1)
        self.consecutive = 0
        self.total = 0

    def record_failure(self, what: str) -> None:
        self.consecutive += 1
        self.total += 1
        print_rank(f"checkpoint failure #{self.consecutive} (consecutive) "
                   f"in {what}; run aborts at {self.threshold}",
                   loglevel=logging.WARNING)

    def record_success(self) -> None:
        self.consecutive = 0

    def check(self) -> None:
        """Raise once the consecutive-failure budget is spent; called on
        the training thread only (an exception on the writer thread would
        vanish)."""
        if self.consecutive >= self.threshold:
            raise CheckpointEscalationError(
                f"{self.consecutive} consecutive checkpoint-save failures "
                f"(threshold {self.threshold}): training is no longer "
                "resumable — aborting instead of running uncheckpointed. "
                "Fix the storage path or raise "
                "server_config.checkpoint_retry.escalation_threshold.")


class DurableIOError(RuntimeError):
    """A durable IO operation whose loss would corrupt training state (a
    row-store read, the writeback fetch) exhausted its retries; raised on
    the training thread."""


class DurableIOLadder:
    """One retry policy (``server_config.checkpoint_retry``) over every
    durable host IO surface, each with its own exhaustion mode
    (:attr:`MODES`):

    - ``escalate`` (row-store spill, round marker): the caller keeps the
      data host-visible, so a lost write costs capacity, not correctness;
      ``escalation_threshold`` consecutive exhausted writes on the surface
      raise :class:`CheckpointEscalationError`;
    - ``raise`` (row-store read, writeback fetch): exhaustion raises
      :class:`DurableIOError`, since losing a carry row corrupts training;
    - ``drop`` (the rollup writer): exhaustion returns False.

    ``fault_hooks`` maps a surface to chaos's probe
    (:meth:`..chaos.InfraFaults.hook`), run before every attempt so a
    retry draws afresh.  Every failed attempt on a surface but ``writer``
    goes to :attr:`event` as a ``store_io_fault`` record.  A
    ``BaseException`` that is not an ``Exception`` (a kill) passes
    through untouched."""

    MODES = {
        "store_write": "escalate",
        "store_read": "raise",
        "marker": "escalate",
        "writeback": "raise",
        "writer": "drop",
    }

    def __init__(self, policy: Optional[RetryPolicy] = None,
                 fault_hooks: Optional[Dict[str, Callable[[], None]]] = None):
        self.policy = policy if policy is not None else RetryPolicy()
        self.fault_hooks = dict(fault_hooks or {})
        #: ``event(kind, **fields)``: the server's record sink
        self.event: Optional[Callable[..., None]] = None
        self.escalators = {
            name: FailureEscalator(self.policy.escalation_threshold)
            for name, mode in self.MODES.items() if mode == "escalate"}

    def run(self, fn: Callable[[], None], surface: str,
            what: str = "") -> bool:
        """``fn`` on ``surface`` under the ladder: True on success, else
        the surface's exhaustion mode."""
        mode = self.MODES[surface]
        hook = self.fault_hooks.get(surface)

        def attempt() -> None:
            try:
                if hook is not None:
                    hook()
                fn()
            except Exception as exc:
                if self.event is not None and surface != "writer":
                    self.event("store_io_fault", surface=surface,
                               what=what, error=repr(exc))
                raise

        if run_with_retry(attempt, self.policy, what=what or f"{surface} io"):
            if mode == "escalate":
                self.escalators[surface].record_success()
            return True
        if mode == "raise":
            raise DurableIOError(
                f"{surface} IO exhausted its retry budget "
                f"({self.policy.retries} attempts)"
                f"{': ' + what if what else ''}"
                " — losing this data would corrupt training state")
        if mode == "escalate":
            esc = self.escalators[surface]
            esc.record_failure(what or surface)
            esc.check()
        return False
