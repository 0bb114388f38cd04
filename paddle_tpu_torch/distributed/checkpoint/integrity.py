"""Checkpoint integrity: CRC'd shard writes and the COMMITTED manifest (a
copy of `paddle_tpu/distributed/checkpoint/integrity.py`, the same format
string and manifest).

The commit protocol makes a snapshot directory's arrival atomic on POSIX:

    write shards + metadata into `<final>.tmp[.<nonce>]`   (staging)
      -> fsync every file                                   (durable bytes)
      -> fsync the staging dir                              (durable entries)
      -> os.replace(staging, final)                         (atomic rename)
      -> fsync the parent dir                               (durable rename)
      -> atomic-write + fsync the COMMITTED manifest        (commit point)

A kill -9 at any point leaves the previous committed snapshot, a staging
dir (skipped by readers, swept by GC), or a renamed final dir without the
manifest (also skipped): never a torn snapshot that a reader would load.
The manifest records the step, the world size, the write session's nonce
and a shard inventory with byte sizes and CRC32s, so `verify_snapshot` can
reject bit rot or truncation without trusting the directory.
"""

from __future__ import annotations

import glob
import json
import os
import time
import zlib

from paddle_tpu_torch.distributed.checkpoint.metadata import (Metadata,
                                                              atomic_write)

__all__ = [
    "COMMIT_MARKER", "STAGING_SUFFIX", "CheckpointCorruptError", "CrcWriter",
    "fsync_dir", "write_commit_marker", "read_commit_marker", "is_committed",
    "list_metadata_files", "verify_shard_file",
    "verify_snapshot", "chaos_point",
]

COMMIT_MARKER = "COMMITTED"
STAGING_SUFFIX = ".tmp"
_FORMAT = "paddle_tpu-ckpt-v3"


class CheckpointCorruptError(RuntimeError):
    """A snapshot failed verification (a missing, truncated or bit-rotted
    shard, a bad manifest). Loaders raise it before placing anything, and
    `CheckpointManager.restore` falls back to the previous committed step."""


class CrcWriter:
    """File-like write proxy that sums CRC32 and the byte count as the
    bytes go out, so the recorded checksum is of the bytes the writer
    meant: later disk corruption can never agree with it."""

    def __init__(self, f):
        self._f = f
        self.nbytes = 0
        self.crc32 = 0

    def write(self, b):
        self.crc32 = zlib.crc32(b, self.crc32)
        self.nbytes += len(b)
        return self._f.write(b)


def fsync_dir(path):
    """Durably persist a directory's entries (the rename or create)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_commit_marker(ckpt_dir, payload=None):
    """Write the fsync'd COMMITTED manifest: the single commit point."""
    doc = {"format": _FORMAT, "committed_at": time.time()}
    if payload:
        doc.update(payload)
    atomic_write(os.path.join(ckpt_dir, COMMIT_MARKER),
                 lambda f: json.dump(doc, f, indent=1), mode="w")
    fsync_dir(ckpt_dir)
    return doc


def read_commit_marker(ckpt_dir):
    """The parsed manifest, or None when absent or unparseable (torn)."""
    try:
        with open(os.path.join(ckpt_dir, COMMIT_MARKER)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if doc.get("format") == _FORMAT else None


def is_committed(ckpt_dir):
    return read_commit_marker(ckpt_dir) is not None


def list_metadata_files(ckpt_dir):
    return sorted(glob.glob(os.path.join(ckpt_dir, "metadata*.json")))


def verify_shard_file(ckpt_dir, sm, deep=True):
    """Verify one shard file against its recorded size and CRC32; raises
    CheckpointCorruptError naming the file. `deep=False` checks existence
    and byte size only; `deep=True` re-reads the bytes for the CRC."""
    fpath = os.path.join(ckpt_dir, sm.file)
    if not os.path.isfile(fpath):
        raise CheckpointCorruptError(
            f"checkpoint {ckpt_dir}: shard file {sm.file!r} is missing")
    nbytes = getattr(sm, "nbytes", None)
    if nbytes is not None:
        actual = os.path.getsize(fpath)
        if actual != nbytes:
            raise CheckpointCorruptError(
                f"checkpoint {ckpt_dir}: shard file {sm.file!r} is "
                f"{actual} bytes, expected {nbytes} (truncated or torn "
                "write)")
    crc = getattr(sm, "crc32", None)
    if deep and crc is not None:
        got = 0
        with open(fpath, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                got = zlib.crc32(chunk, got)
        if got != crc:
            raise CheckpointCorruptError(
                f"checkpoint {ckpt_dir}: shard file {sm.file!r} CRC32 "
                f"mismatch (recorded {crc:#010x}, on disk {got:#010x}): "
                "bit rot or a torn write")


def verify_snapshot(ckpt_dir, deep=False):
    """Verify a snapshot end to end; returns the manifest. Checks: the
    COMMITTED manifest parses; the metadata files exist (as many as the
    manifest's world size); every shard of the merged metadata passes
    `verify_shard_file`; every file of the manifest's inventory exists
    with its recorded size."""
    marker = read_commit_marker(ckpt_dir)
    if marker is None:
        raise CheckpointCorruptError(
            f"checkpoint {ckpt_dir}: no valid {COMMIT_MARKER} manifest "
            "(uncommitted or torn snapshot)")
    meta_files = list_metadata_files(ckpt_dir)
    if not meta_files:
        raise CheckpointCorruptError(
            f"checkpoint {ckpt_dir}: committed but has no metadata*.json")
    world = marker.get("world_size")
    if world is not None and len(meta_files) != world:
        raise CheckpointCorruptError(
            f"checkpoint {ckpt_dir}: manifest says world_size={world} but "
            f"{len(meta_files)} metadata files are present (a rank's "
            "metadata is missing)")
    for fname, rec in (marker.get("inventory") or {}).items():
        fpath = os.path.join(ckpt_dir, fname)
        if not os.path.isfile(fpath):
            raise CheckpointCorruptError(
                f"checkpoint {ckpt_dir}: inventory file {fname!r} is "
                "missing")
        want = rec.get("nbytes")
        if want is not None and os.path.getsize(fpath) != want:
            raise CheckpointCorruptError(
                f"checkpoint {ckpt_dir}: inventory file {fname!r} is "
                f"{os.path.getsize(fpath)} bytes, expected {want}")
    md = Metadata.load_dir(ckpt_dir)
    for tm in md.tensors.values():
        for sm in tm.shards or []:
            verify_shard_file(ckpt_dir, sm, deep=deep)
    return marker


def chaos_point(name, **ctx):
    """A named fault point: a no-op unless PADDLE_CHAOS is set; then the
    injector (`checkpoint/chaos.py`) may raise or hard-exit here."""
    if not os.environ.get("PADDLE_CHAOS"):
        return
    from paddle_tpu_torch.distributed.checkpoint.chaos import get_injector

    get_injector().point(name, **ctx)
