"""CheckpointManager: atomic step checkpoints with retention GC (port of
`paddle_tpu/distributed/checkpoint/manager.py`, one process).

  - `save(state, step)` stages into `step_N.tmp.<nonce>` and commits by
    fsync(files) -> fsync(dir) -> rename to `step_N` -> the fsync'd
    COMMITTED manifest (step, world size 1, the session's nonce, the shard
    inventory with byte sizes): the single commit point;
  - the device-to-host snapshot is taken inside `save`, so training may
    update its tensors the moment it returns; the files are written on a
    background thread (`async_save`);
  - write-once: a committed step is never rewritten;
  - `latest_committed()` / `restore()` skip torn or partial dirs and fall
    back to the previous committed snapshot, quarantining a corrupt one;
  - retention GC keeps the newest `keep_last_k` committed steps and sweeps
    orphaned staging dirs;
  - writer errors surface on the returned handle (`.result()`), and the
    checkpoint/* counters and gauges go to the registry.

`CheckpointManager()` without a root reads `PADDLE_CHECKPOINT_DIR`.
"""

from __future__ import annotations

import os
import pickle
import re
import secrets
import shutil
import sys
import time
import warnings
import zlib

import torch

from paddle_tpu_torch.distributed.checkpoint.integrity import (
    CheckpointCorruptError, chaos_point, is_committed, read_commit_marker,
    verify_snapshot)
from paddle_tpu_torch.distributed.checkpoint.load_state_dict import (
    load_state_dict)
from paddle_tpu_torch.distributed.checkpoint.save_state_dict import (
    EXTRAS_FILE, AsyncSaveHandle, save_state_dict)

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")
_STAGING_RE = re.compile(r"^step_(\d+)\.tmp\.[0-9a-f]+$")


def _from_saveable(obj):
    """Extras back from their pickle: ("__tensor__", ndarray) as a tensor."""
    if isinstance(obj, tuple) and len(obj) == 2 and obj[0] == "__tensor__":
        return torch.from_numpy(obj[1])
    if isinstance(obj, dict):
        return {k: _from_saveable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_saveable(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_from_saveable(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, root=None, keep_last_k=3, async_save=True,
                 registry=None):
        if root is None:
            root = os.environ.get("PADDLE_CHECKPOINT_DIR")
        if not root:
            raise ValueError(
                "CheckpointManager needs a root directory: pass root= or "
                "set PADDLE_CHECKPOINT_DIR")
        self.root = os.path.normpath(os.fspath(root))
        os.makedirs(self.root, exist_ok=True)
        self.keep_last_k = int(keep_last_k) if keep_last_k else 0
        self.async_save = bool(async_save)
        if registry is None:
            from paddle_tpu_torch.observability.registry import (
                global_registry)

            registry = global_registry()
        self.registry = registry
        self._handle = None       # the last save's handle
        self._last_error = None   # the last failed save's error

    # -- paths ---------------------------------------------------------------
    def step_dir(self, step):
        return os.path.join(self.root, f"step_{int(step)}")

    def _list(self):
        try:
            return os.listdir(self.root)
        except OSError:
            return []

    def committed_steps(self):
        """Sorted steps whose dir carries a valid COMMITTED manifest that
        agrees with the dir's name; torn dirs are skipped (counted)."""
        steps = []
        for name in self._list():
            m = _STEP_RE.match(name)
            if not m:
                continue
            step = int(m.group(1))
            marker = read_commit_marker(os.path.join(self.root, name))
            if marker is None or int(marker.get("step", step)) != step:
                self.registry.inc("checkpoint/torn_dirs_skipped")
                continue
            steps.append(step)
        return sorted(steps)

    def latest_committed(self):
        """(step, path) of the newest committed snapshot, or None."""
        steps = self.committed_steps()
        if not steps:
            return None
        return steps[-1], self.step_dir(steps[-1])

    # -- save ----------------------------------------------------------------
    def save(self, state_dict, step, extras=None, async_save=None):
        """Stage and commit `state_dict` as `step_N`; returns an
        AsyncSaveHandle whose `.result()` re-raises writer errors. The
        device-to-host snapshot happens before this returns; the writes
        and the commit run on the background writer (async) or inline.
        Write-once: a committed `step` raises."""
        step = int(step)
        self.wait(swallow=True)  # one writer at a time, commits in order
        final = self.step_dir(step)
        if is_committed(final):
            raise RuntimeError(
                f"checkpoint step {step} at {final} is already committed: "
                "committed steps are write-once (use a new step number)")
        use_async = self.async_save if async_save is None else bool(async_save)
        nonce = secrets.randbits(63)
        payload = {"step": step, "world_size": 1,
                   "nonces": {"0": f"{nonce:016x}"}}
        mgr_extras = {"step": step, **(extras or {})}

        def post_commit():
            # after the manifest landed (on the writer thread when async)
            self.registry.set_gauge("checkpoint/last_committed_step", step)
            self._gc(current=step)

        handle = save_state_dict(
            state_dict, final, async_save=use_async, extras=mgr_extras,
            staging=f"{final}.tmp.{nonce:016x}", commit_payload=payload,
            post_commit=post_commit, registry=self.registry)
        if handle is None:
            handle = AsyncSaveHandle(final)  # sync: already complete
        self._handle = handle
        return handle

    def wait(self, swallow=False):
        """Block until the in-flight save (if any) finishes. Re-raises its
        error unless `swallow=True` (then it is recorded and warned: it
        has already surfaced on that save's own handle)."""
        h, self._handle = self._handle, None
        if h is None:
            return
        try:
            h.result()
        except BaseException as e:
            self._last_error = e
            if not swallow:
                raise
            warnings.warn(
                f"previous async checkpoint save to {h.path} failed: {e!r} "
                "(the previous committed snapshot remains the latest)",
                RuntimeWarning, stacklevel=3)

    # -- restore -------------------------------------------------------------
    def restore(self, state_dict, step=None, verify=True):
        """Fill `state_dict` in place from the newest committed snapshot
        (or an explicit `step`). A torn or corrupt snapshot is quarantined
        (renamed `step_N.corrupt`) and the previous committed one tried;
        returns the extras dict (always with 'step'). Raises
        FileNotFoundError when no committed snapshot is left,
        CheckpointCorruptError when an explicit `step` is bad."""
        t0 = time.monotonic()
        explicit = step is not None
        candidates = ([int(step)] if explicit
                      else list(reversed(self.committed_steps())))
        if not candidates:
            raise FileNotFoundError(
                f"no committed checkpoint under {self.root}")
        last_exc = None
        for i, s in enumerate(candidates):
            path = self.step_dir(s)
            try:
                marker = verify_snapshot(path, deep=False)
                load_state_dict(state_dict, path, verify=verify)
                extras = self._read_extras(path, marker)
                self.registry.inc("checkpoint/restores", labels={
                    "result": "ok" if i == 0 else "fallback"})
                self.registry.observe("checkpoint/restore_seconds",
                                      time.monotonic() - t0)
                extras.setdefault("step", s)
                return extras
            except (CheckpointCorruptError, OSError, ValueError) as e:
                last_exc = e
                if explicit:
                    self.registry.inc("checkpoint/restores",
                                      labels={"result": "failed"})
                    raise
                print(f"[checkpoint] snapshot step_{s} failed verification "
                      f"({e}); falling back to the previous committed step",
                      file=sys.stderr, flush=True)
                # quarantine: no longer the latest, its step writable again
                try:
                    os.replace(path, f"{path}.corrupt")
                except OSError:
                    pass
                self.registry.inc("checkpoint/quarantined")
        self.registry.inc("checkpoint/restores", labels={"result": "failed"})
        raise CheckpointCorruptError(
            f"every committed snapshot under {self.root} failed "
            f"verification; last error: {last_exc}")

    def resume(self, state_dict):
        """`restore` when a committed snapshot exists, else None."""
        if self.latest_committed() is None:
            return None
        return self.restore(state_dict)

    def _read_extras(self, path, marker):
        fpath = os.path.join(path, EXTRAS_FILE)
        if not os.path.isfile(fpath):
            return {}
        with open(fpath, "rb") as f:
            blob = f.read()
        want_crc = marker.get("extras_crc32")
        if want_crc is not None and zlib.crc32(blob) != want_crc:
            raise CheckpointCorruptError(
                f"checkpoint {path}: extras.pkl CRC32 mismatch (bit rot in "
                "the step/LR/RNG payload)")
        out = _from_saveable(pickle.loads(blob))
        return out if isinstance(out, dict) else {"extras": out}

    # -- retention GC --------------------------------------------------------
    def _gc(self, current=None):
        """After a commit: drop committed steps beyond keep_last_k (never
        `current`) and orphaned staging dirs of other attempts."""
        if self.keep_last_k > 0:
            for s in self.committed_steps()[:-self.keep_last_k]:
                if s == current:
                    continue
                shutil.rmtree(self.step_dir(s), ignore_errors=True)
                self.registry.inc("checkpoint/gc_removed",
                                  labels={"kind": "step"})
        for name in self._list():
            if _STAGING_RE.match(name) or name.endswith(".replaced"):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)
                self.registry.inc("checkpoint/gc_removed",
                                  labels={"kind": "staging"})
        chaos_point("after_gc")
