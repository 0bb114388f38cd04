"""ctypes bridge to the native runtime core (`paddle_tpu/core/native.py`;
reference `libpaddle`, `paddle/fluid/pybind/pybind.cc`): the TCPStore
rendezvous (`paddle/phi/core/distributed/store/tcp_store.h`), the flag
registry (`paddle/common/flags.cc`) and the comm watchdog
(`paddle/phi/core/distributed/comm_task_manager.cc`).

The C++ sources are the port's own copy (`core/csrc/`, a plain C ABI, the
JAX package's wire format byte for byte, so either package's TCPStore
talks to the other's). They are built at first use with g++ into
`build/paddle_tpu_torch/` at the root of the checkout, under a name keyed
by a hash of the sources and flags, and loaded with ctypes. `available()`
says whether the library is there or could be built; without it
`TCPStore` and `Watchdog` raise, and nothing falls back to Python. A
compiler that fails on the sources raises. When the library loads, it
takes the values of `framework.flags`; from then on `set_flags` writes
into it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["available", "last_error", "TCPStore", "Watchdog", "flags_set",
           "flags_get", "library_path"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("store.cc", "flags.cc", "watchdog.cc", "enforce.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall")

_lib = None
_lib_lock = threading.Lock()


def library_path():
    """Where the library of the current sources is (or will be) built."""
    digest = hashlib.sha256(b"".join(
        (_CSRC / f).read_bytes() for f in _SOURCES + ("export.h",))
        + " ".join(_FLAGS).encode())
    return BUILD_DIR / f"native_core_{digest.hexdigest()[:16]}.so"


def _build(out):
    cxx = shutil.which("g++")
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp),
                           *(str(_CSRC / f) for f in _SOURCES)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({proc.returncode}) building the "
                           f"native core:\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    return True


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            out = library_path()
            if out.exists() or _build(out):
                lib = ctypes.CDLL(str(out))
                _configure(lib)
                # the registry starts from the Python one, which has the
                # FLAGS_* environment and every earlier set_flags
                from paddle_tpu_torch.framework import flags

                for k, v in flags._flags.items():
                    lib.pt_flags_set(k.encode(), str(v).encode())
                _lib = lib
        return _lib


def _configure(lib):
    P, I, I64, S = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_char_p)
    sigs = {
        "pt_last_error": (S, []),
        "pt_store_create": (P, [S, I, I, I, I]),
        "pt_store_destroy": (None, [P]),
        "pt_store_set": (I, [P, S, S, I64]),
        "pt_store_get": (I64, [P, S, S, I64, I]),
        "pt_store_add": (I64, [P, S, I64]),
        "pt_store_wait": (I, [P, S, I]),
        "pt_store_barrier": (I, [P, S, I, I, I]),
        "pt_flags_set": (I, [S, S]),
        "pt_flags_get": (S, [S]),
        "pt_watchdog_start": (P, [I, P]),
        "pt_watchdog_stop": (None, [P]),
        "pt_watchdog_begin": (I, [P, S, I]),
        "pt_watchdog_end": (I, [P, S]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def available():
    """True when the native library is built or could be built here."""
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("the native core is not built and no g++ was "
                           f"found to build {_CSRC}")
    return lib


def last_error():
    lib = _load()
    return lib.pt_last_error().decode() if lib else "native core not built"


class TCPStore:
    """The reference's TCPStore surface: set/get/add/wait/barrier on a
    store whose master runs the socket server."""

    def __init__(self, host, port, is_master=False, world_size=1,
                 timeout=30.0):
        lib = self._lib = _require()
        self._h = lib.pt_store_create(host.encode(), int(port),
                                      1 if is_master else 0, world_size,
                                      int(timeout * 1000))
        if not self._h:
            raise RuntimeError(f"TCPStore create failed: {last_error()}")
        self.host, self.port, self.world_size = host, port, world_size

    def set(self, key, value):
        if isinstance(value, str):
            value = value.encode()
        if self._lib.pt_store_set(self._h, key.encode(), value,
                                  len(value)) != 0:
            raise RuntimeError(f"store set failed: {last_error()}")

    def get(self, key, timeout=30.0):
        cap = 1 << 20
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.pt_store_get(self._h, key.encode(), buf, cap,
                                       int(timeout * 1000))
            if n < 0:
                raise RuntimeError(f"store get({key!r}) timed out")
            if n <= cap:
                return buf.raw[:n]
            cap = n   # longer than the buffer: fetch again at its size

    def add(self, key, delta):
        v = self._lib.pt_store_add(self._h, key.encode(), int(delta))
        if v == -(2 ** 63):
            raise RuntimeError(f"store add failed: {last_error()}")
        return v

    def wait(self, key, timeout=30.0):
        if self._lib.pt_store_wait(self._h, key.encode(),
                                   int(timeout * 1000)) != 0:
            raise RuntimeError(f"store wait({key!r}) timed out")

    def barrier(self, prefix, rank, world_size=None, timeout=30.0):
        if self._lib.pt_store_barrier(self._h, prefix.encode(), rank,
                                      world_size or self.world_size,
                                      int(timeout * 1000)) != 0:
            raise RuntimeError(f"store barrier timed out: {last_error()}")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pt_store_destroy(self._h)
            self._h = None


class Watchdog:
    """Deadline monitor for barriers and collectives (the reference's
    CommTaskManager, `comm_task_manager.cc:152`): a task that outlives its
    deadline is reported and `on_timeout(name, elapsed_ms)` is called."""

    def __init__(self, poll_interval=1.0, on_timeout=None):
        lib = self._lib = _require()
        cb_type = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_int64)
        self._cb = (cb_type(lambda name, ms: on_timeout(name.decode(), ms))
                    if on_timeout else None)
        self._h = lib.pt_watchdog_start(
            int(poll_interval * 1000),
            ctypes.cast(self._cb, ctypes.c_void_p) if self._cb else None)

    def begin(self, task, timeout=60.0):
        self._lib.pt_watchdog_begin(self._h, task.encode(),
                                    int(timeout * 1000))

    def end(self, task):
        self._lib.pt_watchdog_end(self._h, task.encode())

    def stop(self):
        if getattr(self, "_h", None):
            self._lib.pt_watchdog_stop(self._h)
            self._h = None

    def __del__(self):
        self.stop()


def flags_set(name, value):
    _require().pt_flags_set(name.encode(), str(value).encode())


def flags_get(name):
    """The registry's string value of `name` (seeded from the environment
    on first read), or None."""
    v = _require().pt_flags_get(name.encode())
    return v.decode() if v is not None else None
