"""Checkpoint save on one process, in the JAX package's on-disk format
(port of `paddle_tpu/distributed/checkpoint/save_state_dict.py`).

Each leaf of the state tree (dotted names, `_flatten_state`) becomes one
shard file `<name>.0.0.npy` covering the whole tensor. The device-to-host
snapshot of every leaf is taken before `save_state_dict` returns, so the
caller may go on updating its tensors at once; the files are then written,
on a thread when `async_save`. A bf16 leaf travels as its raw 2-byte words
(`tensor.view(torch.int16)`) under the descr '<V2', byte for byte what
numpy writes for `ml_dtypes.bfloat16`, which the port does not need.

Metrics (the registry's checkpoint/* family): the snapshot's seconds
(`snapshot_seconds`, before the call returns), the writes' and commit's
(`write_seconds`), the whole save's (`save_seconds`), `bytes_written`, and
`saves{result}` / `write_retries` counters.

Crash safety (`integrity.py`): every write lands in a staging dir, each
shard with its CRC32 and byte length in the metadata; shard writes retry
with backoff on IO errors; then fsync, rename staging -> final and the
fsync'd COMMITTED manifest. A kill at any point leaves the previous
snapshot the latest, never a torn newest one.
"""

from __future__ import annotations

import os
import pickle
import shutil
import threading
import time
import zlib

import numpy as np
import torch

from paddle_tpu_torch.distributed.checkpoint.integrity import (
    STAGING_SUFFIX, CrcWriter, chaos_point, fsync_dir, is_committed,
    list_metadata_files, write_commit_marker)
from paddle_tpu_torch.distributed.checkpoint.metadata import (
    META_FILE, Metadata, ShardMetadata, TensorMetadata, atomic_write)

__all__ = ["save_state_dict", "AsyncSaveHandle", "EXTRAS_FILE"]

EXTRAS_FILE = "extras.pkl"

# snapshot paths with a live writer in this process: a second save to the
# same path would remove the first's staging dir mid-write
_ACTIVE_SAVES = set()
_ACTIVE_LOCK = threading.Lock()


def _flatten_state(state_dict, prefix=""):
    """{dotted name: leaf} of a nested dict (None leaves dropped), the
    names the JAX package gives its leaves."""
    flat = {}
    for k, v in state_dict.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten_state(v, prefix=name + "."))
        elif v is not None:
            flat[name] = v
    return flat


def _snapshot(name, leaf):
    """(host ndarray, dtype name) of a tensor leaf, copied from its device
    now (a bf16 one as its raw int16 words)."""
    if not torch.is_tensor(leaf):
        raise TypeError(f"checkpoint leaf {name!r} is a {type(leaf).__name__},"
                        " not a torch tensor")
    host = leaf.detach().to("cpu", copy=True).contiguous()
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy(), "bfloat16"
    return host.numpy(), str(host.dtype).replace("torch.", "")


def _write_npy(fpath, host, dtype):
    """Write one shard file; returns (nbytes, crc32) of the bytes as
    written (summed in-stream). The `shard_write` fault point."""
    chaos_point("shard_write", path=fpath)
    with open(fpath, "wb") as f:
        w = CrcWriter(f)
        if dtype == "bfloat16":
            np.lib.format.write_array_header_1_0(w, {
                "descr": "<V2", "fortran_order": False,
                "shape": host.shape})
            w.write(host.tobytes())
        else:
            np.save(w, host)
        f.flush()
        os.fsync(f.fileno())
    return w.nbytes, w.crc32


def _write_npy_retry(fpath, host, dtype, registry, base_delay=0.05):
    """Retry IO errors with exponential backoff (PADDLE_CKPT_IO_RETRIES
    attempts, 3 by default); the last failure propagates."""
    attempts = max(1, int(os.environ.get("PADDLE_CKPT_IO_RETRIES", "3")))
    for i in range(attempts):
        try:
            return _write_npy(fpath, host, dtype)
        except OSError:
            if i == attempts - 1:
                raise
            registry.inc("checkpoint/write_retries")
            time.sleep(base_delay * (2 ** i))


def _to_saveable(obj):
    """Extras for pickling: a tensor as ("__tensor__", ndarray), as the
    JAX package's `framework.io` writes its Tensor."""
    if torch.is_tensor(obj):
        return ("__tensor__", obj.detach().cpu().numpy())
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_saveable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


class AsyncSaveHandle:
    """Joinable handle of a save: `.result()` blocks until the writer
    finishes and re-raises anything it raised; `.done()` polls."""

    def __init__(self, path):
        self.path = path
        self._thread = None
        self._error = None

    def _run(self, fn):
        try:
            fn()
        except BaseException as e:  # surfaced by .result(), never swallowed
            self._error = e

    def _start(self, fn):
        self._thread = threading.Thread(target=self._run, args=(fn,),
                                        daemon=True)
        self._thread.start()

    def done(self):
        return self._thread is None or not self._thread.is_alive()

    def result(self, timeout=None):
        """Wait for the save; re-raise the writer's exception if it died.
        Returns the final snapshot path."""
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"async checkpoint save to {self.path} still running "
                    f"after {timeout}s")
        if self._error is not None:
            raise self._error
        return self.path


def save_state_dict(state_dict, path, async_save=False, extras=None,
                    staging=None, commit_payload=None, post_commit=None,
                    registry=None):
    """Snapshot `state_dict` (a nested dict of torch tensors) to the host
    and commit it atomically at `path`. Returns an AsyncSaveHandle when `async_save` (the files written
    on a thread), else None once committed.

    `extras`: a picklable dict (step, learning rate, ...) written as
    `extras.pkl`, its CRC in the manifest. `staging`, `commit_payload`,
    `post_commit` and `registry` are `CheckpointManager`'s hooks: the
    staging dir, what rides the COMMITTED manifest, what runs after the
    commit (retention GC) and the registry of the checkpoint/* metrics
    (the global one by default)."""
    if registry is None:
        from paddle_tpu_torch.observability.registry import global_registry

        registry = global_registry()
    path = os.path.normpath(os.fspath(path))
    staging = os.path.normpath(staging) if staging else path + STAGING_SUFFIX
    t_begin = time.monotonic()
    with _ACTIVE_LOCK:
        if path in _ACTIVE_SAVES:
            raise RuntimeError(
                f"a save to {path} is already in flight in this process: "
                "wait on its handle (.result()) before saving the same "
                "snapshot again")
        _ACTIVE_SAVES.add(path)

    def unregister():
        with _ACTIVE_LOCK:
            _ACTIVE_SAVES.discard(path)

    try:
        if os.path.isdir(staging):
            # the leftover of a crashed attempt at this snapshot
            shutil.rmtree(staging, ignore_errors=True)
        os.makedirs(staging, exist_ok=True)
        md = Metadata()
        writes = []   # (file path, host ndarray, dtype, ShardMetadata)
        for name, leaf in _flatten_state(state_dict).items():
            host, dtype = _snapshot(name, leaf)
            fname = f"{name.replace('/', '_')}.0.0.npy"
            sm = ShardMetadata(file=fname, offsets=[0] * host.ndim,
                               lengths=list(host.shape))
            md.tensors[name] = TensorMetadata(
                name=name, shape=list(host.shape), dtype=dtype, shards=[sm])
            writes.append((os.path.join(staging, fname), host, dtype, sm))
        extras_sig, extras_blob = {}, None
        if extras is not None:
            # pickled now: the caller may move on the moment this returns
            extras_blob = pickle.dumps(_to_saveable(extras), protocol=4)
            extras_sig = {"extras_crc32": zlib.crc32(extras_blob),
                          "extras_nbytes": len(extras_blob)}
        registry.observe("checkpoint/snapshot_seconds",
                         time.monotonic() - t_begin)
    except BaseException:
        unregister()
        raise

    def commit():
        old = None
        if os.path.isdir(path):
            if is_committed(path) or list_metadata_files(path):
                # a step saved again (after a fall back), or a torn dir of
                # an earlier attempt: move it aside, delete it only once
                # the new one is committed
                old = path + ".replaced"
                if is_committed(old) and not is_committed(path):
                    shutil.rmtree(path)
                else:
                    shutil.rmtree(old, ignore_errors=True)
                    os.replace(path, old)
            else:
                try:
                    os.rmdir(path)
                except OSError:
                    raise FileExistsError(
                        f"checkpoint target {path} is an existing "
                        "non-empty directory that does not look like a "
                        "snapshot (no metadata*.json); refusing to "
                        "overwrite it") from None
        fsync_dir(staging)
        chaos_point("before_rename")
        os.replace(staging, path)
        chaos_point("after_rename")
        fsync_dir(os.path.dirname(os.path.abspath(path)))
        payload = {"coordinator": 0, **extras_sig, **(commit_payload or {})}
        merged = Metadata.load_dir(path)
        payload["inventory"] = {
            sm.file: {"nbytes": sm.nbytes, "crc32": sm.crc32}
            for tm in merged.tensors.values() for sm in tm.shards or []}
        write_commit_marker(path, payload)
        chaos_point("after_commit")
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)

    def write():
        t_write = time.monotonic()
        try:
            try:
                for fpath, host, dtype, sm in writes:
                    sm.nbytes, sm.crc32 = _write_npy_retry(fpath, host,
                                                           dtype, registry)
                chaos_point("after_shards")
                md.dump(os.path.join(staging, META_FILE))
                if extras_blob is not None:
                    atomic_write(os.path.join(staging, EXTRAS_FILE),
                                 lambda f: f.write(extras_blob))
                chaos_point("after_metadata")
                commit()
            except BaseException:
                registry.inc("checkpoint/saves", labels={"result": "failed"})
                raise
            registry.inc("checkpoint/saves", labels={"result": "committed"})
            registry.inc("checkpoint/bytes_written",
                         sum(sm.nbytes or 0 for *_, sm in writes))
            registry.observe("checkpoint/write_seconds",
                             time.monotonic() - t_write)
            registry.observe("checkpoint/save_seconds",
                             time.monotonic() - t_begin)
            if post_commit is not None:
                post_commit()
        finally:
            unregister()

    if async_save:
        handle = AsyncSaveHandle(path)
        try:
            handle._start(write)
        except BaseException:
            unregister()
            raise
        return handle
    write()
    return None
