"""Numerical sanitizers and accuracy-alignment tooling of the port
(`paddle_tpu/amp/debugging.py`; reference `FLAGS_check_nan_inf`,
`paddle/fluid/eager/nan_inf_utils.cc`, `python/paddle/amp/debugging.py`
and `python/paddle/amp/accuracy_compare.py` with the `accuracy_check` op).

The eager path hooks the dispatch waist (`core.tensor.apply`): while the
checker is on, `_sanitizer` counts the non-finite values of every float
output of every op, one host read an output (the reference checks every
kernel's output the same way). While it and the operator stats are off the
hook is None and an op pays one None check. Code that runs outside the
waist (a kernel wrapper called directly, an engine's fused step) is
checked after the step with `assert_finite` on its outputs.
"""

from __future__ import annotations

import contextlib
from enum import Enum

import numpy as np
import torch

from paddle_tpu_torch.core import tensor as _tensor_mod
from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.framework import dtypes as _dtypes
from paddle_tpu_torch.framework import flags as _flags

__all__ = [
    "DebugMode", "TensorCheckerConfig", "enable_tensor_checker",
    "disable_tensor_checker", "check_numerics", "assert_finite",
    "enable_operator_stats_collection", "disable_operator_stats_collection",
    "collect_operator_stats", "compare_accuracy", "tensor_stats",
]


class DebugMode(Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 2


class TensorCheckerConfig:
    """Reference `amp/debugging.py` TensorCheckerConfig (the meaningful
    subset: enable, debug_mode and the op skip list)."""

    def __init__(self, enable=True, debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 skipped_op_list=None, **kwargs):
        self.enable = enable
        self.debug_mode = debug_mode
        self.skipped_op_list = set(skipped_op_list or ())


_checker_config = TensorCheckerConfig(enable=False)
_op_stats = None  # live per-(op, dtype) counters while stats collection is on


def _is_concrete(a):
    """A tensor with values to read (not a fake tensor of a trace)."""
    return isinstance(a, torch.Tensor) and not torch.compiler.is_compiling()


def _is_float(a):
    return a.is_floating_point() or a.is_complex()


def _name(dtype):
    try:
        return _dtypes.dtype_name(dtype)
    except (KeyError, TypeError, ValueError):
        return str(dtype)


_nan_inf_level = 0  # follows FLAGS_check_nan_inf_level (watch_flag)


def _sanitize_hook(op_name, arrays):
    """On the waist while the checker is on. FLAGS_check_nan_inf_level > 0
    downgrades abort to log-only (the reference's check_nan_inf_level)."""
    cfg = _checker_config
    if op_name in cfg.skipped_op_list:
        return
    level = _nan_inf_level
    for a in arrays:
        if not _is_concrete(a) or not _is_float(a):
            continue
        bad = int((~torch.isfinite(a)).sum())
        if bad:
            msg = (f"[check_nan_inf] op '{op_name}' produced {bad} "
                   f"non-finite value(s) in output shape {tuple(a.shape)} "
                   f"dtype {_name(a.dtype)}")
            if (cfg.debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT
                    and int(level) == 0):
                raise FloatingPointError(msg)
            print(msg)


def _install_hook():
    """The one place that sets the waist's hook from the (checker, stats)
    state, so flag flips and stats on/off compose."""
    checker_on = _checker_config.enable
    stats_on = _op_stats is not None
    if checker_on and stats_on:
        def both(op_name, arrays):
            _stats_hook(op_name, arrays)
            _sanitize_hook(op_name, arrays)

        _tensor_mod._sanitizer = both
    elif stats_on:
        _tensor_mod._sanitizer = _stats_hook
    elif checker_on:
        _tensor_mod._sanitizer = _sanitize_hook
    else:
        _tensor_mod._sanitizer = None


def _sync_from_flag():
    on = bool(_flags.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"])
    _checker_config.enable = on
    _install_hook()


def enable_tensor_checker(checker_config=None):
    """Reference `amp/debugging.py` enable_tensor_checker: turns on the
    per-op nan/inf check (FLAGS_check_nan_inf)."""
    global _checker_config
    if checker_config is not None:
        _checker_config = checker_config
    _checker_config.enable = True
    _flags.set_flags({"FLAGS_check_nan_inf": True})


def disable_tensor_checker():
    _flags.set_flags({"FLAGS_check_nan_inf": False})


def _set_level(v):
    global _nan_inf_level
    _nan_inf_level = int(v or 0)


# set_flags drives the hook, so FLAGS_check_nan_inf works however it is set
# (the environment at import, paddle.set_flags, or the functions above)
_flags.watch_flag("FLAGS_check_nan_inf", lambda v: _sync_from_flag())
_flags.watch_flag("FLAGS_check_nan_inf_level", _set_level)
_sync_from_flag()
_set_level(_flags.get_flags("FLAGS_check_nan_inf_level")[
    "FLAGS_check_nan_inf_level"])


def check_numerics(x, op_type="", var_name="",
                   debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT, name=None):
    """Count nan/inf in a tensor; abort mode raises (reference
    check_numerics op, with its (tensor, op_type, var_name) signature).
    Returns (num_nan, num_inf) tensors."""
    a = x._data if isinstance(x, Tensor) else torch.as_tensor(x)
    num_nan = torch.isnan(a).sum()
    num_inf = torch.isinf(a).sum()
    if _is_concrete(a):
        n, i = int(num_nan), int(num_inf)
        if (n or i) and debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
            where = f"{op_type}:{var_name}" if var_name else op_type
            raise FloatingPointError(
                f"[check_numerics] '{where}': {n} nan, {i} inf")
    return Tensor(num_nan), Tensor(num_inf)


def _flatten(tree, path=""):
    """[(key string, leaf)] of a nest of dicts, lists and tuples, dict keys
    sorted and keys spelled as `jax.tree_util.keystr` spells them; a
    Tensor leaf becomes its torch tensor; None holds no leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{path}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{path}[{i}]")
        return out
    if tree is None:
        return []
    return [(path, tree._data if isinstance(tree, Tensor) else tree)]


def _host(a, dtype=None):
    """A leaf as a numpy array (a bf16 tensor widened to f32)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.cpu().numpy()
    return np.asarray(a)


def assert_finite(tree, where="step"):
    """Post-step scan for code outside the waist: raise if any leaf of a
    nest (loss, grads, params) holds nan/inf."""
    for idx, (_, a) in enumerate(_flatten(tree)):
        if isinstance(a, torch.Tensor):
            if not _is_float(a):
                continue
            bad = int((~torch.isfinite(a)).sum())
        else:
            arr = np.asarray(a)
            if not np.issubdtype(arr.dtype, np.floating):
                continue
            bad = int((~np.isfinite(arr)).sum())
        if bad:
            raise FloatingPointError(
                f"[check_nan_inf] {where}: leaf {idx} has {bad} "
                f"non-finite value(s)")


def checking_enabled():
    return _checker_config.enable


# -- operator stats (reference enable_operator_stats_collection) ------------


def _stats_hook(op_name, arrays):
    if _op_stats is None:
        return
    for a in arrays:
        dt = _name(a.dtype) if hasattr(a, "dtype") else "?"
        st = _op_stats.setdefault((op_name, dt), [0, 0, 0])  # calls, nan, inf
        st[0] += 1
        if _is_concrete(a) and _is_float(a):
            st[1] += int(torch.isnan(a).sum())
            st[2] += int(torch.isinf(a).sum())


def enable_operator_stats_collection():
    """Track per-(op, dtype) call and nan/inf counts through the dispatch
    waist (reference amp/debugging.py:enable_operator_stats_collection)."""
    global _op_stats
    _op_stats = {}
    _install_hook()


def disable_operator_stats_collection():
    """Stop collecting and print the summary table (the reference prints
    op_name | dtype | calls | nan | inf)."""
    global _op_stats
    stats, _op_stats = _op_stats, None
    _install_hook()  # back to the plain checker hook, or None
    if stats:
        print(f"{'op':30} {'dtype':10} {'calls':>8} {'nan':>6} {'inf':>6}")
        for (op, dt), (c, n, i) in sorted(stats.items()):
            print(f"{op:30} {dt:10} {c:8d} {n:6d} {i:6d}")
    return stats


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


# -- accuracy align (reference amp/accuracy_compare.py + accuracy_check) ----


def tensor_stats(tree):
    """Summarize a nest of tensors -> {path: (shape, mean, std, absmax)}
    for dumping and later comparison."""
    out = {}
    for path, a in _flatten(tree):
        a = _host(a).astype("float64")
        out[path] = (tuple(a.shape), float(a.mean()), float(a.std()),
                     float(np.abs(a).max() if a.size else 0.0))
    return out


def compare_accuracy(run_a, run_b, rtol=1e-5, atol=1e-8, equal_nan=False,
                     raise_on_mismatch=False):
    """Cross-run tensor comparison (the reference's `accuracy_check` op and
    amp/accuracy_compare workflow): run_a/run_b are nests (two runs'
    state_dicts or grad trees). Returns a list of mismatch records; with
    raise_on_mismatch the first divergence aborts, like accuracy_check."""
    fb = dict(_flatten(run_b))
    mismatches = []
    for key, a in _flatten(run_a):
        b = fb.get(key)
        if b is None:
            mismatches.append({"tensor": key, "error": "missing in run_b"})
            continue
        a, b = _host(a), _host(b)
        if a.shape != b.shape:
            mismatches.append({"tensor": key, "error":
                               f"shape {a.shape} vs {b.shape}"})
            continue
        if not np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan):
            diff = np.abs(a.astype("float64") - b.astype("float64"))
            denom = np.maximum(np.abs(b.astype("float64")), 1e-12)
            rec = {"tensor": key, "max_abs_diff": float(diff.max()),
                   "max_rel_diff": float((diff / denom).max()),
                   "num_diff": int((diff > atol + rtol *
                                    np.abs(b)).sum())}
            mismatches.append(rec)
            if raise_on_mismatch:
                raise AssertionError(f"accuracy_check failed: {rec}")
    return mismatches
