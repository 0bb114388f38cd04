"""The port's `_C_ops`, `paddle.save` / `paddle.load` and native core against
the JAX package's, on the CPU.

  - `_C_ops` called with the reference kernels' argument lists (the calls
    of tests/test_c_ops.py, `rms_norm`'s eleven arguments, and a sample of
    the functional targets) gives the JAX `_C_ops`' values;
  - each package loads the other's `save` files (f32, int64 and bf16
    leaves in a nested dict, list and tuple, and bare numpy arrays) with
    the same bits; the port
    reads them with `ml_dtypes` blocked (a subprocess); a save that fails
    midway leaves the old file whole;
  - the port's TCPStore talks to the JAX package's across two processes,
    each side as master once; `set_flags` mirrors into the port's C++
    registry once it is loaded, and the registry takes the flags' values
    when it loads; the port's watchdog fires.
"""

import os
import pickle
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import ml_dtypes
import numpy as np
import pytest

import paddle_tpu
import paddle_tpu_torch as P
from paddle_tpu import _C_ops as RC
from paddle_tpu.core import native as ref_native
from paddle_tpu_torch import _C_ops as PC
from paddle_tpu_torch.core import native
from paddle_tpu_torch.framework import device as port_device
import torch

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    P.set_device("cpu")
    yield
    port_device._current = prev


def _a(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


# --------------------------------------------------------------------------
# _C_ops: the kernel argument lists
# --------------------------------------------------------------------------

_ONES = np.ones((4, 4), np.float32)
CALLS = {
    "matmul": (lambda C, t: C.matmul(t(_a((2, 3), 1)), t(_a((3, 4), 2)),
                                     False, False)),
    "matmul_transpose": (lambda C, t: C.matmul(t(_a((3, 2), 1)),
                                               t(_a((3, 4), 2)), True,
                                               False)),
    "softmax": lambda C, t: C.softmax(t(_a((2, 3), 3)), -1),
    "mean": lambda C, t: C.mean(t(_a((2, 3), 3)), [-1], False),
    "argmax": lambda C, t: C.argmax(t(_a((2, 3), 3)), 1, False, False),
    "leaky_relu": lambda C, t: C.leaky_relu(t(_a((2, 3), 4)), 0.5),
    "leaky_relu_default": lambda C, t: C.leaky_relu(t(_a((2, 3), 4))),
    "dropout_swallows_seed": lambda C, t: C.dropout(
        t(_ONES), None, 0.0, False, "upscale_in_train", 0, False),
    "dropout_is_test": lambda C, t: C.dropout(
        t(_ONES), None, 0.5, True, "upscale_in_train", 0, False),
    "elu": lambda C, t: C.elu(t(_a((2, 3), 5))),
    "pow": lambda C, t: C.pow(t(_a((2, 3), 5))),
    "softplus": lambda C, t: C.softplus(t(_a((2, 3), 5))),
    "full_like": lambda C, t: C.full_like(t(np.zeros((2, 3), np.float32)),
                                          3.0),
    "ones_like": lambda C, t: C.ones_like(t(np.zeros((2, 3), np.float32))),
    "zeros_like": lambda C, t: C.zeros_like(t(np.ones((2, 3), np.float32))),
    "rms_norm_eleven_arguments": lambda C, t: C.rms_norm(
        t(_a((3, 8), 6)), None, None, t(_a((8,), 7)), None, 1e-6, 1, -1.0,
        0, 0.0, 0.0),
    "gelu": lambda C, t: C.gelu(t(_a((2, 3), 8)), True),
    "one_hot": lambda C, t: C.one_hot(t(np.array([0, 3, 1])), 4),
    "swiglu": lambda C, t: C.swiglu(t(_a((2, 4), 9)), t(_a((2, 4), 10))),
    "huber_loss": lambda C, t: C.huber_loss(t(_a((2, 3), 11)),
                                            t(_a((2, 3), 12)), 0.5),
    "pixel_shuffle": lambda C, t: C.pixel_shuffle(t(_a((1, 8, 2, 2), 13)),
                                                  2),
    "cross_entropy": lambda C, t: C.cross_entropy(t(_a((4, 5), 14)),
                                                  t(np.array([0, 4, 2, 1]))),
    "batch_fc": lambda C, t: C.batch_fc(t(_a((2, 3, 4), 15)),
                                        t(_a((2, 4, 5), 16)),
                                        t(_a((2, 5), 17))),
    "as_strided": lambda C, t: C.as_strided(t(_a((3, 4), 18)), [2, 2],
                                            [4, 1], 1),
    "affine_grid": lambda C, t: C.affine_grid(t(_a((1, 2, 3), 19)),
                                              [1, 1, 2, 3], False),
    "pad3d": lambda C, t: C.pad3d(t(_a((1, 1, 2, 2, 2), 20)),
                                  [1, 0, 0, 1, 1, 0], "reflect"),
    "sequence_mask": lambda C, t: C.sequence_mask(t(np.array([1, 3])), 4,
                                                  "int64"),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_c_ops_kernel_arguments_match_the_jax_package(name):
    ref = CALLS[name](RC, paddle_tpu.to_tensor)
    got = CALLS[name](PC, P.to_tensor)
    ref, got = np.asarray(ref.numpy()), got.numpy()
    assert ref.shape == got.shape
    np.testing.assert_allclose(got.astype(np.float64), ref, rtol=1e-5,
                               atol=1e-6)


# --------------------------------------------------------------------------
# save / load across packages
# --------------------------------------------------------------------------

def _arrays():
    rng = np.random.default_rng(3)
    f32 = rng.standard_normal((3, 4)).astype(np.float32)
    i64 = rng.integers(-2 ** 20, 2 ** 20, (5,)).astype(np.int64)
    bf = rng.standard_normal((2, 3, 5)).astype(np.float32)
    bf16 = bf.astype(ml_dtypes.bfloat16)
    return f32, i64, bf16


def _tree(mod, f32, i64, bf16):
    bf = mod.to_tensor(bf16.astype(np.float32)).astype("bfloat16")
    return {"w": mod.to_tensor(f32),
            "nested": {"ids": mod.to_tensor(i64), "bf": bf},
            "list": [bf, 7, "text"], "tuple": (mod.to_tensor(f32), 1.5),
            "bare": {"bf": bf16, "f32": f32}}


def _bits(t):
    """A loaded leaf's raw bits: bf16 as uint16 (the port's .numpy()
    already gives them; the JAX package's gives ml_dtypes.bfloat16)."""
    a = np.asarray(t.numpy())
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _check(loaded, f32, i64, bf16):
    bf_bits = bf16.view(np.uint16)
    np.testing.assert_array_equal(_bits(loaded["w"]), f32)
    np.testing.assert_array_equal(_bits(loaded["nested"]["ids"]), i64)
    np.testing.assert_array_equal(_bits(loaded["nested"]["bf"]), bf_bits)
    np.testing.assert_array_equal(_bits(loaded["list"][0]), bf_bits)
    assert loaded["list"][1:] == [7, "text"]
    np.testing.assert_array_equal(_bits(loaded["tuple"][0]), f32)
    assert loaded["tuple"][1] == 1.5 and isinstance(loaded["tuple"], tuple)
    # bare arrays stay numpy arrays: the JAX package gives bf16 as
    # ml_dtypes.bfloat16, the port as its uint16 bits
    bare = loaded["bare"]
    assert isinstance(bare["bf"], np.ndarray)
    assert bare["bf"].dtype.name in ("bfloat16", "uint16")
    np.testing.assert_array_equal(bare["bf"].view(np.uint16), bf_bits)
    np.testing.assert_array_equal(bare["f32"], f32)


def test_the_jax_package_loads_the_ports_file(tmp_path):
    f32, i64, bf16 = _arrays()
    path = str(tmp_path / "port.pdparams")
    P.save(_tree(P, f32, i64, bf16), path)
    loaded = paddle_tpu.load(path)
    assert np.asarray(loaded["nested"]["bf"].numpy()).dtype.name == \
        "bfloat16"
    assert loaded["bare"]["bf"].dtype.name == "bfloat16"
    # the JAX package narrows int64 (x64 off): same values, int32
    assert np.asarray(loaded["nested"]["ids"].numpy()).dtype == np.int32
    loaded["nested"]["ids"] = P.to_tensor(np.asarray(
        loaded["nested"]["ids"].numpy()).astype(np.int64))
    _check(loaded, f32, i64, bf16)


def test_the_port_loads_the_jax_packages_file(tmp_path):
    f32, i64, bf16 = _arrays()
    path = str(tmp_path / "jax.pdparams")
    paddle_tpu.save(_tree(paddle_tpu, f32, i64, bf16), path)
    loaded = P.load(path)
    assert loaded["nested"]["bf"].dtype == P.bfloat16
    assert loaded["w"].place.type == "cpu"
    assert loaded["bare"]["bf"].dtype == np.uint16
    _check(loaded, f32, i64.astype(np.int32), bf16)
    numpy_tree = P.load(path, return_numpy=True)
    np.testing.assert_array_equal(numpy_tree["nested"]["bf"],
                                  bf16.view(np.uint16))


def test_the_port_round_trips_its_own_file(tmp_path):
    f32, i64, bf16 = _arrays()
    path = str(tmp_path / "own.pdparams")
    P.save(_tree(P, f32, i64, bf16), path)
    _check(P.load(path), f32, i64, bf16)


def test_the_port_reads_bf16_files_without_ml_dtypes(tmp_path):
    """Both packages' files, in a process where `import ml_dtypes`
    fails (the card's machine has no ml_dtypes)."""
    f32, i64, bf16 = _arrays()
    jax_path, port_path = tmp_path / "jax.pdparams", tmp_path / "port.pdp"
    paddle_tpu.save(_tree(paddle_tpu, f32, i64, bf16), str(jax_path))
    P.save(_tree(P, f32, i64, bf16), str(port_path))
    np.save(tmp_path / "bits.npy", bf16.view(np.uint16))
    code = textwrap.dedent(f"""
        import sys
        sys.modules["ml_dtypes"] = None     # import ml_dtypes now fails
        import numpy as np
        import paddle_tpu_torch as P
        P.set_device("cpu")
        bits = np.load({str(tmp_path / "bits.npy")!r})
        for path in ({str(jax_path)!r}, {str(port_path)!r}):
            t = P.load(path)["nested"]["bf"]
            assert t.dtype == P.bfloat16, t.dtype
            np.testing.assert_array_equal(t.numpy(), bits)
            bare = P.load(path)["bare"]["bf"]
            assert bare.dtype == np.uint16, bare.dtype
            np.testing.assert_array_equal(bare, bits)
        assert "jax" not in sys.modules
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr[-2000:]


def test_an_interrupted_save_leaves_the_old_file_whole(tmp_path,
                                                       monkeypatch):
    path = tmp_path / "ckpt.pdparams"
    P.save({"w": P.to_tensor(np.arange(4.0, dtype=np.float32))}, str(path))
    before = path.read_bytes()

    def torn(obj, f, protocol=None):
        f.write(b"\x80\x04 half a pickle")
        raise OSError("disk full")

    monkeypatch.setattr(pickle, "dump", torn)
    with pytest.raises(OSError, match="disk full"):
        P.save({"w": P.zeros([1000])}, str(path))
    assert path.read_bytes() == before
    assert [p.name for p in tmp_path.iterdir()] == [path.name]
    monkeypatch.undo()
    np.testing.assert_array_equal(P.load(str(path))["w"].numpy(),
                                  np.arange(4.0))


# --------------------------------------------------------------------------
# the native core
# --------------------------------------------------------------------------

needs_ref_native = pytest.mark.skipif(
    not ref_native.available(),
    reason="the JAX package's native core is not built (cmake + ninja)")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_MASTER = """
import sys
sys.path.insert(0, {root!r})
from {pkg}.core import native
store = native.TCPStore("127.0.0.1", {port}, is_master=True, world_size=2)
store.set("from_master", b"hello \\x00 from {pkg}")
store.add("counter", 5)
store.wait("from_client", timeout=60.0)
store.set("echo", store.get("from_client") + b" (echoed)")
store.wait("done", timeout=60.0)
print("master done", flush=True)
"""


def _store_pair(master_pkg, client_mod):
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-c", _MASTER.format(root=str(ROOT),
                                              pkg=master_pkg, port=port)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        client = None
        for _ in range(100):   # the master needs a moment to listen
            try:
                client = client_mod.TCPStore("127.0.0.1", port,
                                             is_master=False, world_size=2,
                                             timeout=5.0)
                break
            except RuntimeError:
                time.sleep(0.1)
        assert client is not None, "no master listening"
        client.wait("from_master", timeout=30.0)
        assert client.get("from_master") == \
            f"hello \x00 from {master_pkg}".encode()
        assert client.add("counter", 2) == 7
        client.set("from_client", b"\x01\x02 client")
        assert client.get("echo", timeout=30.0) == \
            b"\x01\x02 client (echoed)"
        client.set("done", "1")
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == 0 and "master done" in out, err[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_native_core_builds_here():
    assert native.available()
    assert native.library_path().exists()


@needs_ref_native
def test_the_ports_store_is_a_client_of_a_jax_package_master():
    _store_pair("paddle_tpu", native)


@needs_ref_native
def test_a_jax_package_store_is_a_client_of_the_ports_master():
    _store_pair("paddle_tpu_torch", ref_native)


def test_set_flags_mirrors_into_the_native_registry():
    from paddle_tpu_torch.framework import flags

    saved = P.get_flags(["FLAGS_v", "FLAGS_log_dir"])
    try:
        P.set_flags({"FLAGS_v": 7, "FLAGS_log_dir": "/tmp/x"})
        assert native.flags_get("FLAGS_v") == "7"
        assert native.flags_get("FLAGS_log_dir") == "/tmp/x"
    finally:
        flags._flags.update(saved)


def test_flags_reach_the_registry_when_it_loads_and_never_build_it():
    """A FLAGS_* variable at import and a set_flags before the library
    loads build nothing; the library takes both values when it loads."""
    code = textwrap.dedent("""
        import paddle_tpu_torch as P
        from paddle_tpu_torch.core import native
        P.set_flags({"FLAGS_log_dir": "/tmp/y"})
        assert native._lib is None
        assert native.flags_get("FLAGS_v") == "3"
        assert native.flags_get("FLAGS_log_dir") == "/tmp/y"
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "FLAGS_v": "3"},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr[-2000:]


def test_the_watchdog_fires_and_a_finished_task_does_not():
    fired = []
    wd = native.Watchdog(poll_interval=0.05,
                         on_timeout=lambda name, ms: fired.append(name))
    wd.begin("allreduce_step", timeout=0.1)
    wd.begin("quick_task", timeout=0.1)
    wd.end("quick_task")
    deadline = time.time() + 5.0
    while not fired and time.time() < deadline:
        time.sleep(0.05)
    time.sleep(0.2)
    wd.stop()
    assert fired == ["allreduce_step"]
