"""Env-gated fault injector for the checkpoint fault paths (a copy of
`tools/chaos_inject.py`: the same `PADDLE_CHAOS` / `PADDLE_CHAOS_SEED`
spec, ops, fault points and exit codes).

    PADDLE_CHAOS=io_error:0.1,kill_after:step3
    PADDLE_CHAOS=crash_at:after_rename          # hard-exit at a fault point
    PADDLE_CHAOS=fail_at:shard_write#2          # raise at the 2nd hit

Ops:
  io_error:<p>         at every `shard_write` point, raise OSError with
                       probability p (deterministic under PADDLE_CHAOS_SEED)
  fail_at:<point>[#k]  raise ChaosError at the k-th hit (default the 1st)
  crash_at:<point>[#k] os._exit(13) at the k-th hit: no cleanup, no atexit
  kill_after:step<N>   os._exit(9) at the `step_end` point of step N

Fault points (`integrity.chaos_point`): shard_write, after_shards,
after_metadata, before_rename, after_rename, after_commit, after_gc, and
step_end (end of `HybridParallelEngine.train_batch`, ctx: step).
"""

from __future__ import annotations

import os
import random
import sys
import threading

__all__ = ["ChaosError", "ChaosInjector", "get_injector", "CRASH_EXIT_CODE",
           "KILL_EXIT_CODE"]

CRASH_EXIT_CODE = 13
KILL_EXIT_CODE = 9


class ChaosError(RuntimeError):
    """Raised by fail_at/io_error injections (never by real code paths)."""


def _parse_hits(spec):
    """'name' -> (name, 1); 'name#3' -> (name, 3)."""
    if "#" in spec:
        name, k = spec.rsplit("#", 1)
        return name, int(k)
    return spec, 1


class ChaosInjector:
    def __init__(self, spec, seed=None):
        self.spec = spec
        self.io_error_p = 0.0
        self.fail_at = {}    # point -> hit number that raises
        self.crash_at = {}   # point -> hit number that hard-exits
        self.kill_after_step = None
        self._hits = {}      # point -> count so far
        self._lock = threading.Lock()
        self._rng = random.Random(
            int(os.environ.get("PADDLE_CHAOS_SEED", "0")) if seed is None
            else seed)
        for op in filter(None, (s.strip() for s in spec.split(","))):
            kind, _, arg = op.partition(":")
            if kind == "io_error":
                self.io_error_p = float(arg)
            elif kind == "fail_at":
                name, k = _parse_hits(arg)
                self.fail_at[name] = k
            elif kind == "crash_at":
                name, k = _parse_hits(arg)
                self.crash_at[name] = k
            elif kind == "kill_after":
                if not arg.startswith("step"):
                    raise ValueError(f"kill_after wants 'step<N>', got {arg!r}")
                self.kill_after_step = int(arg[4:])
            else:
                raise ValueError(f"unknown PADDLE_CHAOS op {op!r}")

    def _crash(self, point, code):
        sys.stderr.write(f"[chaos] hard-exit({code}) at fault point "
                         f"{point!r} (PADDLE_CHAOS={self.spec})\n")
        sys.stderr.flush()
        os._exit(code)

    def point(self, name, **ctx):
        with self._lock:
            hit = self._hits[name] = self._hits.get(name, 0) + 1
            roll = (self._rng.random() if name == "shard_write"
                    and self.io_error_p > 0 else None)
        if name == "step_end" and self.kill_after_step is not None:
            if int(ctx.get("step", -1)) >= self.kill_after_step:
                self._crash(name, KILL_EXIT_CODE)
        if self.crash_at.get(name) == hit:
            self._crash(name, CRASH_EXIT_CODE)
        if self.fail_at.get(name) == hit:
            raise ChaosError(f"injected failure at fault point {name!r} "
                             f"(hit {hit}, ctx {ctx})")
        if roll is not None and roll < self.io_error_p:
            raise OSError(f"injected IO error at {ctx.get('path', name)} "
                          f"(p={self.io_error_p})")


_injector = None
_injector_lock = threading.Lock()


def get_injector():
    """Process-wide injector for the current PADDLE_CHAOS value (rebuilt
    when the env var changes)."""
    global _injector
    spec = os.environ.get("PADDLE_CHAOS", "")
    with _injector_lock:
        if _injector is None or _injector.spec != spec:
            _injector = ChaosInjector(spec)
        return _injector
