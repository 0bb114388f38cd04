"""Build and load the CUDA kernels of `kernels/csrc/`.

Each source is compiled by `nvcc` into a shared library with a plain C
interface, at first use, into `build/paddle_tpu_torch/` at the root of the
checkout (listed in `.gitignore`), under a name keyed by a hash of the
source, the headers beside it (`csrc/*.cuh`) and the flags: an edited
source or header builds anew, an unchanged one loads the library already
built. `build_all` starts one `nvcc` per source, all at once, and waits
for them together. A library is loaded with `ctypes`;
every pointer and the stream travel as `c_void_p`.

`launch` is how every wrapper calls a kernel: under a guard of its tensors'
device, so that the first call's build and load, the launch and the
shared-memory opt-in all happen on that device and not on the CUDA
runtime's current one, with that device's current stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "SOURCES", "build", "build_all", "lib", "launch"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"attention": _CSRC / "attention.cu",
           "quantized_matmul": _CSRC / "quantized_matmul.cu",
           "flash_attention": _CSRC / "flash_attention.cu",
           "rms_norm": _CSRC / "rms_norm.cu"}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures (kernels/csrc/*.cu)
_SIGNATURES = {
    "attention": {
        "pt_decode_attention": [_P] * 5 + [_I] * 8 + [_F, _P],
        "pt_window_attention": [_P] * 5 + [_I] * 9 + [_F, _P],
        "pt_paged_decode_attention": [_P] * 6 + [_I] * 9 + [_F, _P],
        "pt_paged_decode_attention_q8": [_P] * 8 + [_I] * 9 + [_F, _P],
    },
    "quantized_matmul": {
        "pt_weight_only_matmul": [_P] * 5 + [_I] * 9 + [_P],
    },
    "flash_attention": {
        "pt_flash_fwd": [_P] * 5 + [_I] * 8 + [_F, _P],
        "pt_flash_bwd_dq": [_P] * 7 + [_I] * 8 + [_F, _P],
        "pt_flash_bwd_dkv": [_P] * 8 + [_I] * 8 + [_F, _P],
    },
    "rms_norm": {
        "pt_rms_norm_fwd": [_P] * 4 + [_I] * 4 + [_F, _P],
        "pt_rms_norm_bwd": [_P] * 8 + [_I] * 7 + [_P],
    },
}

_loaded = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or /usr/local/cuda/bin)")


def _target(name):
    src = SOURCES[name]
    # the headers of csrc/ too: an edited header builds every source anew
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def _start(name):
    """(target, tmp, running nvcc) for source `name`, or (target, None,
    None) when its library is already built."""
    out = _target(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)


def _finish(name, out, tmp, proc):
    if proc is None:
        return out, ""
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{SOURCES[name]}:\n{err}")
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    return out, err


def build(name="attention"):
    """Compile source `name` unless its library is already built. Returns
    (path, compiler log); the log carries ptxas' register and shared-memory
    report, empty when the library was already there."""
    return _finish(name, *_start(name))


def build_all():
    """Build every source with one nvcc each, started together. Returns
    {name: (path, compiler log)}; raises once every compiler has exited
    if any failed."""
    started = {n: _start(n) for n in SOURCES}
    done, errors = {}, []
    for n, job in started.items():
        try:
            done[n] = _finish(n, *job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def lib(name="attention"):
    """The loaded library of source `name`, built first if needed."""
    if name not in _loaded:
        path, _ = build(name)
        so = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(so, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _loaded[name] = so
    return _loaded[name]


def launch(name, fn, device, *args):
    """Call C entry point `fn` of library `name` with `args` and the current
    stream of `device`, under a guard of `device` (the tensors' device);
    returns the entry point's CUDA error code."""
    with torch.cuda.device(device):
        return getattr(lib(name), fn)(
            *args, torch.cuda.current_stream(device).cuda_stream)
