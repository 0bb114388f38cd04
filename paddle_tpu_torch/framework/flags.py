"""Global flag registry (`paddle_tpu/framework/flags.py`; reference
`paddle/common/flags.cc`, surfaced through paddle.get_flags/set_flags and the
FLAGS_* environment import at bootstrap, `python/paddle/base/__init__.py`
:167-186).

Pure Python. The flags are the JAX package's set, recorded and read back so
that reference scripts run unchanged. Two act: `FLAGS_check_nan_inf` turns
on the nan/inf checker of `amp.debugging` on the dispatch waist and
`FLAGS_check_nan_inf_level` > 0 makes it log instead of raise (its
`watch_flag` callbacks follow every `set_flags`). Setting one of the
other flags whose reference effect a user would rely on
(`EFFECT_PENDING`: determinism, per-op sync and tracing, bf16 matmul) to
another value than its default warns that nothing changed. Once the native core
(`core/native`) has loaded its library, every `set_flags` is mirrored into
its C++ registry, as the JAX package's is, so native components read the
same values; the library takes this registry's values when it loads.
Setting a flag never builds or loads the library.
"""

import os
import sys
import warnings

# the JAX package's subset of the reference's 184 flags (`paddle/common/
# flags.cc`), with their defaults
_DEFAULTS = {
    # numerics / debugging
    "FLAGS_check_nan_inf": False,
    "FLAGS_check_nan_inf_level": 0,
    "FLAGS_cudnn_deterministic": False,
    "FLAGS_embedding_deterministic": 0,
    "FLAGS_low_precision_op_list": 0,
    "FLAGS_benchmark": False,
    "FLAGS_api_tracer_enabled": False,
    # memory
    "FLAGS_allocator_strategy": "auto_growth",
    "FLAGS_eager_delete_tensor_gb": 0.0,
    "FLAGS_fraction_of_gpu_memory_to_use": 0.92,
    "FLAGS_initial_gpu_memory_in_mb": 0,
    "FLAGS_reallocate_gpu_memory_in_mb": 0,
    "FLAGS_gpu_memory_limit_mb": 0,
    "FLAGS_use_pinned_memory": True,
    "FLAGS_fast_eager_deletion_mode": True,
    "FLAGS_memory_fraction_of_eager_deletion": 1.0,
    "FLAGS_use_stream_safe_cuda_allocator": True,
    "FLAGS_allocator_strategy_init_mb": 0,
    # compute / matmul
    "FLAGS_use_bf16_matmul": True,
    "FLAGS_gemm_use_half_precision_compute_type": False,
    "FLAGS_cublaslt_exhaustive_search_times": 0,
    "FLAGS_conv_workspace_size_limit": 512,
    "FLAGS_cudnn_exhaustive_search": False,
    "FLAGS_enable_cublas_tensor_op_math": True,
    "FLAGS_embedding_fuse": True,
    # execution / scheduling
    "FLAGS_new_executor_serial_run": False,
    "FLAGS_new_executor_use_local_scope": True,
    "FLAGS_use_mkldnn": False,
    "FLAGS_inner_op_parallelism": 0,
    "FLAGS_max_inplace_grad_add": 0,
    "FLAGS_sync_nccl_allreduce": False,
    # distributed
    "FLAGS_distributed_timeout_seconds": 300,
    "FLAGS_nccl_blocking_wait": False,
    "FLAGS_use_stride_kernel": True,
    "FLAGS_enable_pir_api": True,
    "FLAGS_enable_auto_parallel": True,
    "FLAGS_heartbeat_interval_seconds": 1.0,
    # logging / glog compat
    "FLAGS_v": 0,
    "FLAGS_vmodule": "",
    "FLAGS_logtostderr": True,
    "FLAGS_log_dir": "",
    "FLAGS_print_ir": False,
    # rng
    "FLAGS_use_curand": False,
    "FLAGS_seed": 0,
}

# flags whose reference effect the port does not have yet
EFFECT_PENDING = frozenset({
    "FLAGS_cudnn_deterministic", "FLAGS_embedding_deterministic",
    "FLAGS_benchmark", "FLAGS_api_tracer_enabled", "FLAGS_use_bf16_matmul",
})

_flags = dict(_DEFAULTS)
_watchers = {}


def watch_flag(name, callback):
    """Call `callback(value)` whenever `name` is set: how a subsystem (the
    nan/inf checker) follows a flag without reading the registry on every
    op."""
    _watchers.setdefault(name, []).append(callback)


def set_flags(flags_dict):
    for k, v in flags_dict.items():
        if k in EFFECT_PENDING and v != _DEFAULTS[k]:
            warnings.warn(f"{k}={v!r} is recorded but has no effect in "
                          "paddle_tpu_torch yet", stacklevel=2)
        _flags[k] = v
        for cb in _watchers.get(k, ()):
            cb(v)
    # the one registry both languages read (reference `paddle/common/
    # flags.cc`), if the library is loaded; `native._load` seeds it
    native = sys.modules.get("paddle_tpu_torch.core.native")
    lib = native._lib if native is not None else None
    if lib is not None:
        for k, v in flags_dict.items():
            lib.pt_flags_set(k.encode(), str(v).encode())


def get_flags(flags):
    if isinstance(flags, str):
        flags = [flags]
    return {k: _flags.get(k) for k in flags}


def _from_env(name, text):
    """A FLAGS_* environment value parsed as its flag's default's type."""
    cur = _DEFAULTS.get(name)
    if isinstance(cur, bool):
        return text.lower() in ("1", "true", "yes")
    if isinstance(cur, (int, float)):
        return type(cur)(text)
    return text


# import FLAGS_* environment variables, as the reference does at
# `python/paddle/base/__init__.py:167-186`
set_flags({k: _from_env(k, v) for k, v in os.environ.items()
           if k.startswith("FLAGS_")})
