"""Checkpoint checksums — the port's own copy of the sidecar half of
``msrflute_tpu/resilience/integrity.py``.

A crc32 of each serialized checkpoint is written next to it
(``<path>.sum``) after the blob lands, and verified at load: a mismatch
means a torn write or bit rot.  crc32, not a cryptographic hash: the
threat model is torn writes, not an adversary.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Optional

SIDECAR_SUFFIX = ".sum"


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed its integrity check."""


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
