"""Kernel block-size tuner: measure-and-cache tile picks per shape (port of
`paddle_tpu/kernels/tuning.py`, `get_blocks` and its lookup chain, with
the same environment names).

Resolution order for a `get_blocks(kernel, shape, dtype, defaults)` call:

  1. env override `PADDLE_TUNE_BLOCKS`: a JSON dict {kernel: {param: int}}
     applied last, so a sweep can pin any pick without touching the cache
     (and a bad cache entry can be escaped);
  2. the on-disk JSON cache (`PADDLE_TUNING_CACHE`, by default
     `build/paddle_tpu_torch/kernel_tuning.json` in the checkout), keyed by
     (kernel, power-of-two shape bucket, dtype, `torch.cuda.get_device_name`),
     written by `measure_and_cache`;
  3. a measurement of every candidate, only with PADDLE_KERNEL_AUTOTUNE=1
     and a CUDA device (the caller's `measure`, through `kernels/timing.py`);
  4. the call site's fallback rule (`fallback`: B8's tile is
     `quantized_matmul.tile`'s wave-cost rule over its H100 sweep table);
  5. the call's `defaults`.

The reference's fallback table was measured on a TPU and is not carried
over: a call site brings its own rule. Every resolved pick goes to the
global registry as `kernel_block{kernel=...,param=...}` gauges, with a
`kernel_tuning_lookups{kernel=...,source=...}` counter.

Shape keys are bucketed to the floor power of two (seq 1536 shares seq
1024's entry), so the cache does not fragment across every length a
serving mix produces.
"""

from __future__ import annotations

import json
import os
import threading
import warnings
from pathlib import Path

import torch

__all__ = ["bucket", "cache_path", "clear_memory_cache", "get_blocks",
           "measure_and_cache", "autotune_enabled"]

_CACHE_ENV = "PADDLE_TUNING_CACHE"
_OVERRIDE_ENV = "PADDLE_TUNE_BLOCKS"
_AUTOTUNE_ENV = "PADDLE_KERNEL_AUTOTUNE"
_DEFAULT_CACHE = (Path(__file__).resolve().parents[2] / "build"
                  / "paddle_tpu_torch" / "kernel_tuning.json")

_lock = threading.Lock()
_mem_cache = None  # {key_str: {param: int}} mirror of the on-disk file
_measured_this_process = set()  # keys measured in this process


def bucket(n):
    """Floor power-of-two shape bucket (1024 for 1024..2047); 0 for n<=0."""
    n = int(n)
    if n <= 0:
        return 0
    b = 1
    while b * 2 <= n:
        b *= 2
    return b


def _card(device):
    """The cache's device key: the CUDA device's name, spaces as '_'; "cpu"
    for a CPU device or without a card."""
    if device is not None and torch.device(device).type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(device).replace(" ", "_")


def cache_path():
    return os.environ.get(_CACHE_ENV) or str(_DEFAULT_CACHE)


def _load_cache():
    global _mem_cache
    with _lock:
        if _mem_cache is not None:
            return _mem_cache
        try:
            with open(cache_path()) as f:
                _mem_cache = json.load(f)
        except (OSError, ValueError):
            _mem_cache = {}
        return _mem_cache


def _store_cache(key, blocks):
    global _mem_cache
    path = cache_path()
    with _lock:
        cache = dict(_mem_cache or {})
        cache[key] = blocks
        try:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(cache, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
        except OSError:
            pass  # read-only FS: keep the in-memory copy only
        _mem_cache = cache


def clear_memory_cache():
    """Drop the in-process mirror, so that the next `get_blocks` reads the
    on-disk file (and the env) again."""
    global _mem_cache
    with _lock:
        _mem_cache = None
    _measured_this_process.clear()


def _dtype_name(dtype):
    """'bfloat16' from torch.bfloat16 or a string alike."""
    return str(dtype).replace("torch.", "")


def _cache_key(kernel, shape, dtype, device):
    skey = ",".join(f"{k}={bucket(v)}" for k, v in sorted(shape.items()))
    return f"{kernel}|{skey}|{_dtype_name(dtype)}|{_card(device)}"


def _env_override(kernel):
    raw = os.environ.get(_OVERRIDE_ENV)
    if not raw:
        return {}
    try:
        table = json.loads(raw)
    except ValueError:
        warnings.warn(f"{_OVERRIDE_ENV} is not valid JSON; ignoring")
        return {}
    out = table.get(kernel, {})
    return {k: int(v) for k, v in out.items()} if isinstance(out, dict) else {}


def _record(kernel, blocks, source):
    """The resolved blocks -> registry gauges, so a run's telemetry shows
    what every kernel ran with."""
    from paddle_tpu_torch.observability.registry import global_registry

    try:
        reg = global_registry()
        for param, val in blocks.items():
            reg.set_gauge("kernel_block", int(val),
                          labels={"kernel": kernel, "param": param})
        reg.inc("kernel_tuning_lookups", labels={"kernel": kernel,
                                                 "source": source})
    except Exception:
        pass  # telemetry must never break a kernel call


def _candidate_label(blocks):
    return ",".join(f"{k}={v}" for k, v in sorted(blocks.items()))


def autotune_enabled(device):
    """Measurement is opt-in (PADDLE_KERNEL_AUTOTUNE=1) and needs a card:
    a CPU time says nothing of a kernel's."""
    return (os.environ.get(_AUTOTUNE_ENV, "0") not in ("", "0")
            and device is not None and torch.device(device).type == "cuda")


def measure_and_cache(kernel, shape, dtype, candidates, measure,
                      fallback=None, device=None):
    """Time every candidate dict with `measure(blocks) -> seconds` and cache
    the winner under (kernel, shape bucket, dtype, card). Candidates that
    raise are skipped; if all fail the fallback wins (and is cached, so a
    dead grid is not timed again). Returns the winning blocks dict."""
    from paddle_tpu_torch.observability.registry import global_registry

    key = _cache_key(kernel, shape, dtype, device)
    best, best_t = None, float("inf")
    for cand in candidates:
        try:
            t = measure(dict(cand))
        except Exception:
            continue
        # each candidate's time, by shape bucket: `kernel_tuning_seconds`
        global_registry().set_gauge(
            "kernel_tuning_seconds", t, labels={
                "kernel": kernel, "shape": key.split("|")[1],
                "candidate": _candidate_label(cand)})
        if t < best_t:
            best, best_t = dict(cand), t
    if best is None:
        best = dict(fallback or {})
    _store_cache(key, best)
    _measured_this_process.add(key)
    return best


def get_blocks(kernel, shape, dtype, defaults, measure=None, candidates=None,
               fallback=None, device=None):
    """Resolve the tile sizes of one kernel call site.

    kernel: the site's name ('b8_tile', ...). shape: the dims that decide
    the pick (bucketed for the cache key). dtype: the operands' dtype.
    defaults: the call's own tiles, the last resort. measure / candidates:
    the measurement hook, used only under `autotune_enabled(device)`.
    fallback: the call site's rule when nothing else answers. device: the
    tensors' device (the cache key's card, and whether to measure). A
    measurement leaves each candidate's seconds in the registry
    (`kernel_tuning_seconds{kernel,shape,candidate}`).

    Returns a dict with every key of `defaults`."""
    key = _cache_key(kernel, shape, dtype, device)
    cache = _load_cache()
    source = "fallback"
    if key in cache:
        blocks, source = dict(cache[key]), "cache"
    elif (measure is not None and candidates and autotune_enabled(device)
          and key not in _measured_this_process):
        blocks = measure_and_cache(kernel, shape, dtype, candidates, measure,
                                   fallback, device)
        source = "measured"
    else:
        blocks = dict(fallback or {})
    out = dict(defaults)
    out.update({k: int(v) for k, v in blocks.items() if k in defaults})
    env = _env_override(kernel)
    if env:
        out.update({k: v for k, v in env.items() if k in defaults})
        source = "env"
    _record(kernel, out, source)
    return out
