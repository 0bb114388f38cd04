"""Checkpoints of the PyTorch port (`paddle_tpu_torch/distributed/
checkpoint/`) against the JAX package's, on the CPU.

  - across packages: a checkpoint the JAX `CheckpointManager` writes (f32
    and bf16 leaves) is restored by the port's with equal values; the
    JAX `load_state_dict` reads the port's files with equal values and its
    `verify_snapshot` passes on them; a bf16 shard of the port is the JAX
    package's file byte for byte;
  - the JAX engine commits step 2, and the port's engine resumes from that
    directory and runs steps 2-4 to the JAX uninterrupted losses (rel
    1e-5, the training-parity bar); the port's own resumed run is
    bit-identical to its uninterrupted one;
  - the cases of tests/test_checkpoint_manager.py replayed on the port's
    manager over torch tensors: the commit manifest, write-once, an empty
    root, the env root, a fault at each seam of the commit, a torn
    rename, an async error on the handle, IO retry, CRC corruption and
    quarantine, an explicit step's corruption, the preflight naming a
    missing shard, retention GC and a hard kill in a subprocess.
"""

import io
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.distributed import checkpoint as jck
from paddle_tpu.distributed.hybrid_engine import \
    HybridParallelEngine as JaxEngine
from paddle_tpu.models.llama import LlamaConfig
from paddle_tpu.observability.registry import MetricsRegistry as JaxRegistry
from paddle_tpu_torch.distributed import HybridParallelEngine
from paddle_tpu_torch.distributed.checkpoint import (
    CheckpointCorruptError, CheckpointManager, is_committed, load_state_dict,
    verify_snapshot)
from paddle_tpu_torch.distributed.checkpoint.chaos import (CRASH_EXIT_CODE,
                                                           ChaosError)
from paddle_tpu_torch.distributed.checkpoint.integrity import (
    read_commit_marker)
from paddle_tpu_torch.observability import MetricsRegistry

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(seed=0, n=3):
    rng = np.random.default_rng(seed)
    return {f"w{i}": torch.from_numpy(rng.normal(size=(4, 4))
                                      .astype(np.float32))
            for i in range(n)}


def _zeros_like(state):
    return {k: torch.zeros_like(v) for k, v in state.items()}


def _equal(got, want):
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _mgr(root, **kw):
    kw.setdefault("registry", MetricsRegistry())
    return CheckpointManager(root=str(root), **kw)


@pytest.fixture
def chaos(monkeypatch):
    """Arm the port's fault injector for one test; disarmed on teardown."""

    def arm(spec, seed="0"):
        monkeypatch.setenv("PADDLE_CHAOS", spec)
        monkeypatch.setenv("PADDLE_CHAOS_SEED", seed)

    yield arm


# -- across packages -----------------------------------------------------------


def _mixed(seed=0):
    """numpy values of an f32 matrix, a bf16 matrix, an int32 scalar and an
    f32 vector, as nested names like an engine's."""
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(5, 7)).astype(np.float32),
                       "h": rng.normal(size=(6, 8)).astype(
                           ml_dtypes.bfloat16)},
            "opt": {"step": np.asarray(3, np.int32),
                    "m": {"w": rng.normal(size=(7,)).astype(np.float32)}}}


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _torch_of(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """The JAX manager writes f32, bf16 and int32 leaves; the port's
    manager restores them into its own tensors with equal values (the
    step into an int64 tensor, as the port's optimizer holds it)."""
    vals = _mixed()
    jm = jck.CheckpointManager(root=str(tmp_path), async_save=False,
                               registry=JaxRegistry())
    jm.save(_tree_map(jnp.asarray, vals), 2)
    dst = _tree_map(lambda x: torch.zeros_like(_torch_of(x)), vals)
    dst["opt"]["step"] = torch.zeros((), dtype=torch.int64)
    extras = _mgr(tmp_path).restore(dst, verify=True)
    assert extras["step"] == 2
    assert torch.equal(dst["params"]["w"], _torch_of(vals["params"]["w"]))
    assert torch.equal(dst["params"]["h"], _torch_of(vals["params"]["h"]))
    assert torch.equal(dst["opt"]["m"]["w"], _torch_of(vals["opt"]["m"]["w"]))
    assert int(dst["opt"]["step"]) == 3


def test_port_checkpoint_reads_in_the_jax_package(tmp_path):
    """The port's files are the JAX package's: its `verify_snapshot` passes
    (CRCs re-read), its `load_state_dict` reads the f32 and int32 leaves
    with equal values, and a bf16 shard is byte for byte what numpy writes
    for `ml_dtypes.bfloat16` (read back through ml_dtypes, equal). The
    JAX loader itself has no cast from a '<V2' shard to bfloat16, for its
    own files as for these (ROADMAP §C)."""
    vals = _mixed(1)
    mgr = _mgr(tmp_path, async_save=False)
    mgr.save(_tree_map(_torch_of, vals), 4)
    path = mgr.step_dir(4)
    marker = jck.verify_snapshot(path, deep=True)
    assert marker["step"] == 4 and marker["world_size"] == 1
    dst = {"params": {"w": np.zeros((5, 7), np.float32)},
           "opt": {"step": np.zeros((), np.int32),
                   "m": {"w": np.zeros((7,), np.float32)}}}
    jck.load_state_dict(dst, path, verify=True)
    np.testing.assert_array_equal(np.asarray(dst["params"]["w"]),
                                  vals["params"]["w"])
    np.testing.assert_array_equal(np.asarray(dst["opt"]["m"]["w"]),
                                  vals["opt"]["m"]["w"])
    assert int(dst["opt"]["step"]) == 3
    md = jck.Metadata.load_dir(path)
    assert md.tensors["params.h"].dtype == "bfloat16"
    shard = os.path.join(path, md.tensors["params.h"].shards[0].file)
    want = io.BytesIO()
    np.save(want, vals["params"]["h"])
    assert open(shard, "rb").read() == want.getvalue()
    back = np.load(shard).view(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(back.astype(np.float32),
                                  vals["params"]["h"].astype(np.float32))


def _engine_cfg():
    # tests/test_checkpoint_manager.py's engine config
    return LlamaConfig.tiny(
        num_hidden_layers=2, hidden_size=32, intermediate_size=64,
        num_attention_heads=2, vocab_size=64, max_position_embeddings=32)


def _batch(step, vocab=64):
    rng = np.random.default_rng(step)   # a per-step-seeded data pipeline
    ids = rng.integers(0, vocab, (2, 16)).astype(np.int32)
    return ids, rng.integers(0, vocab, (2, 16)).astype(np.int32)


def _jax_run(n_steps, root=None):
    kw = {}
    if root is not None:
        kw = dict(save_every=2, checkpoint=root, keep_last_k=3)
    eng = JaxEngine(_engine_cfg(), dp=1, pp=1, mp=1, micro_batches=2,
                    devices=jax.devices("cpu")[:1], **kw)
    params, opt = eng.init_state(0)
    losses = {}
    for step in range(n_steps):
        loss, params, opt = eng.train_batch(params, opt, *_batch(step))
        losses[step] = float(loss)
    if eng.checkpoint_manager is not None:
        eng.checkpoint_manager.wait()
    return losses


def _port_run(n_steps, root=None, resume=False, seed=0):
    kw = {}
    if root is not None:
        kw = dict(save_every=2, checkpoint=str(root), resume=resume,
                  keep_last_k=3)
    eng = HybridParallelEngine(_engine_cfg(), micro_batches=2, device="cpu",
                               **kw)
    params, opt = eng.init_state(seed)
    params, opt, start = eng.maybe_resume(params, opt)
    losses = {}
    for step in range(start, n_steps):
        loss, params, opt = eng.train_batch(params, opt, *_batch(step))
        losses[step] = loss.item()
    if eng.checkpoint_manager is not None:
        eng.checkpoint_manager.wait()
    return losses, eng


def test_port_engine_resumes_a_jax_checkpoint(tmp_path):
    """The JAX engine trains 3 steps and commits step 2; the port's engine
    (its own random init, then restored) resumes there and runs steps 2-4
    to the JAX uninterrupted run's losses within rel 1e-5."""
    ref = _jax_run(5)
    root = tmp_path / "ck"
    _jax_run(3, root=str(root))
    losses, eng = _port_run(5, root=root, resume=True, seed=123)
    assert set(losses) == {2, 3, 4}
    for s, v in losses.items():
        assert abs(v - ref[s]) <= 1e-5 * abs(ref[s]), (s, v, ref[s])
    assert eng.checkpoint_manager.latest_committed()[0] == 4


def test_port_resume_is_bit_identical(tmp_path):
    """The port's engine saved every 2 steps, stopped after step 3 and
    resumed: steps 2-4 give the uninterrupted run's losses bit for bit,
    and the resumed run commits step 4."""
    ref, eng = _port_run(5)
    assert eng.checkpoint_manager is None
    assert eng.monitor.steps == 5
    root = tmp_path / "ck"
    part, eng1 = _port_run(3, root=root)
    assert eng1.checkpoint_manager.latest_committed()[0] == 2
    resumed, eng2 = _port_run(5, root=root, resume=True, seed=7)
    assert set(resumed) == {2, 3, 4}
    for s, v in list(resumed.items()) + list(part.items()):
        assert v == ref[s], (s, v, ref[s])
    assert eng2.checkpoint_manager.committed_steps() == [2, 4]


# -- the JAX manager's behaviours on the port's -------------------------------


def test_save_commit_manifest_and_restore(tmp_path):
    reg = MetricsRegistry()
    mgr = _mgr(tmp_path, keep_last_k=3, async_save=False, registry=reg)
    state = _state()
    mgr.save(dict(state), 1, extras={"lr": 0.5})
    mgr.save(dict(state), 2, extras={"lr": 0.25})
    assert mgr.committed_steps() == [1, 2]
    step, path = mgr.latest_committed()
    assert step == 2 and path == mgr.step_dir(2)
    marker = read_commit_marker(path)
    assert marker["step"] == 2 and marker["world_size"] == 1
    assert set(marker["nonces"]) == {"0"}
    int(marker["nonces"]["0"], 16)
    inv = marker["inventory"]
    assert len(inv) == len(state)
    for ent in inv.values():
        assert ent["nbytes"] > 0 and ent["crc32"] is not None
    assert marker["extras_crc32"] is not None
    verify_snapshot(path, deep=True)
    dst = _zeros_like(state)
    extras = mgr.restore(dst, verify=True)
    assert extras["step"] == 2 and extras["lr"] == 0.25
    _equal(dst, state)
    assert reg.counter("checkpoint/saves", labels={"result": "committed"}) == 2
    assert reg.counter("checkpoint/restores", labels={"result": "ok"}) == 1
    assert reg.gauge("checkpoint/last_committed_step") == 2


def test_write_once_and_async_handle(tmp_path):
    mgr = _mgr(tmp_path, async_save=True)
    state = _state()
    h = mgr.save(dict(state), 5)
    assert h.result() == mgr.step_dir(5)
    assert h.done()
    with pytest.raises(RuntimeError, match="write-once"):
        mgr.save(dict(state), 5)
    assert mgr.restore(_zeros_like(state))["step"] == 5


def test_snapshot_is_taken_before_save_returns(tmp_path):
    """The caller may update its tensors the moment an async save returns:
    the committed bytes are those of the call."""
    mgr = _mgr(tmp_path, async_save=True)
    state = _state()
    want = {k: v.clone() for k, v in state.items()}
    h = mgr.save(state, 1)
    for v in state.values():
        v.add_(1.0)
    h.result()
    dst = _zeros_like(state)
    mgr.restore(dst)
    _equal(dst, want)


def test_resume_empty_root_returns_none(tmp_path):
    assert _mgr(tmp_path).resume(_zeros_like(_state())) is None


def test_root_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_CHECKPOINT_DIR", str(tmp_path / "auto"))
    mgr = CheckpointManager(registry=MetricsRegistry(), async_save=False)
    mgr.save(_state(), 1)
    assert mgr.latest_committed()[0] == 1
    monkeypatch.delenv("PADDLE_CHECKPOINT_DIR")
    with pytest.raises(ValueError, match="PADDLE_CHECKPOINT_DIR"):
        CheckpointManager(registry=MetricsRegistry())


@pytest.mark.parametrize("point", ["shard_write#2", "after_shards",
                                   "after_metadata", "before_rename"])
def test_fault_before_commit_keeps_previous_latest(tmp_path, chaos, point):
    reg = MetricsRegistry()
    mgr = _mgr(tmp_path, async_save=False, registry=reg)
    state = _state()
    mgr.save(dict(state), 1)
    chaos(f"fail_at:{point}")
    with pytest.raises(ChaosError):
        mgr.save(_state(seed=9), 2)
    assert reg.counter("checkpoint/saves", labels={"result": "failed"}) == 1
    assert mgr.committed_steps() == [1]
    assert not os.path.isdir(mgr.step_dir(2))
    dst = _zeros_like(state)
    assert mgr.restore(dst)["step"] == 1
    _equal(dst, state)


def test_fault_after_rename_is_torn_and_resavable(tmp_path, chaos,
                                                  monkeypatch):
    reg = MetricsRegistry()
    mgr = _mgr(tmp_path, async_save=False, registry=reg)
    state = _state()
    mgr.save(dict(state), 1)
    chaos("fail_at:after_rename")
    with pytest.raises(ChaosError):
        mgr.save(_state(seed=9), 2)
    assert os.path.isdir(mgr.step_dir(2))
    assert not is_committed(mgr.step_dir(2))
    assert mgr.committed_steps() == [1]
    assert reg.counter("checkpoint/torn_dirs_skipped") > 0
    assert mgr.restore(_zeros_like(state))["step"] == 1
    with pytest.raises(CheckpointCorruptError):
        load_state_dict(_zeros_like(state), mgr.step_dir(2))
    monkeypatch.delenv("PADDLE_CHAOS")
    state2 = _state(seed=9)
    mgr.save(dict(state2), 2)
    assert mgr.committed_steps() == [1, 2]
    dst = _zeros_like(state2)
    assert mgr.restore(dst)["step"] == 2
    _equal(dst, state2)


def test_fault_after_commit_marker_already_landed(tmp_path, chaos):
    mgr = _mgr(tmp_path, async_save=False)
    state = _state()
    chaos("fail_at:after_commit")
    with pytest.raises(ChaosError):
        mgr.save(dict(state), 1)
    assert mgr.committed_steps() == [1]
    dst = _zeros_like(state)
    assert mgr.restore(dst)["step"] == 1


def test_async_error_surfaces_on_handle(tmp_path, chaos, monkeypatch):
    monkeypatch.setenv("PADDLE_CKPT_IO_RETRIES", "2")
    reg = MetricsRegistry()
    mgr = _mgr(tmp_path, registry=reg)
    state = _state()
    mgr.save(dict(state), 1).result()
    chaos("io_error:1.0")
    h = mgr.save(dict(state), 2)
    with pytest.raises(OSError):
        h.result(timeout=30)
    assert reg.counter("checkpoint/write_retries") > 0
    assert mgr.latest_committed()[0] == 1
    mgr2 = _mgr(tmp_path, registry=reg)
    mgr2._handle = mgr.save(dict(state), 3)
    with pytest.warns(RuntimeWarning, match="previous async checkpoint"):
        mgr2.wait(swallow=True)
    monkeypatch.delenv("PADDLE_CHAOS")
    mgr.save(dict(state), 4).result()
    assert [n for n in os.listdir(tmp_path) if ".tmp." in n] == []
    assert reg.counter("checkpoint/gc_removed", labels={"kind": "staging"}) > 0


def test_retry_absorbs_transient_io_errors(tmp_path, chaos):
    reg = MetricsRegistry()
    mgr = _mgr(tmp_path, async_save=False, registry=reg)
    chaos("io_error:0.5", seed="3")
    state = _state(n=6)
    mgr.save(dict(state), 1)
    assert reg.counter("checkpoint/write_retries") > 0
    verify_snapshot(mgr.step_dir(1), deep=True)
    dst = _zeros_like(state)
    mgr.restore(dst, verify=True)
    _equal(dst, state)


def _flip_byte(path):
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))


def _a_shard(path):
    return os.path.join(path, next(n for n in sorted(os.listdir(path))
                                   if n.endswith(".npy")))


def test_crc_corruption_falls_back_and_quarantines(tmp_path):
    reg = MetricsRegistry()
    mgr = _mgr(tmp_path, async_save=False, registry=reg)
    s1, s2 = _state(seed=1), _state(seed=2)
    mgr.save(dict(s1), 1)
    mgr.save(dict(s2), 2)
    _flip_byte(_a_shard(mgr.step_dir(2)))
    dst = _zeros_like(s1)
    assert mgr.restore(dst, verify=True)["step"] == 1
    _equal(dst, s1)
    assert reg.counter("checkpoint/restores",
                       labels={"result": "fallback"}) == 1
    assert reg.counter("checkpoint/quarantined") == 1
    assert mgr.committed_steps() == [1]
    assert os.path.isdir(mgr.step_dir(2) + ".corrupt")
    mgr.save(dict(s2), 2)
    assert mgr.latest_committed()[0] == 2


def test_explicit_step_corruption_raises(tmp_path):
    mgr = _mgr(tmp_path, async_save=False)
    state = _state()
    mgr.save(dict(state), 1)
    _flip_byte(_a_shard(mgr.step_dir(1)))
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(_zeros_like(state), step=1, verify=True)


def test_load_preflight_missing_shard_names_it(tmp_path):
    mgr = _mgr(tmp_path, async_save=False)
    state = _state()
    mgr.save(dict(state), 1)
    path = mgr.step_dir(1)
    victim = _a_shard(path)
    os.remove(victim)
    dst = _zeros_like(state)
    with pytest.raises(CheckpointCorruptError) as ei:
        load_state_dict(dst, path)
    assert os.path.basename(victim).split(".")[0] in str(ei.value)
    for v in dst.values():
        assert not v.any()   # nothing was placed
    with pytest.raises(CheckpointCorruptError):
        verify_snapshot(path)


def test_gc_retention_keeps_last_k(tmp_path):
    reg = MetricsRegistry()
    mgr = _mgr(tmp_path, keep_last_k=2, async_save=False, registry=reg)
    state = _state(n=1)
    for s in (1, 2, 3, 4):
        mgr.save(dict(state), s)
    assert mgr.committed_steps() == [3, 4]
    assert reg.counter("checkpoint/gc_removed", labels={"kind": "step"}) == 2


CRASH_CHILD = textwrap.dedent("""
    import os, sys
    import torch
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager

    root = sys.argv[1]
    state = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
    mgr = CheckpointManager(root=root, async_save=False)
    mgr.save(dict(state), 1)
    print("STEP1_COMMITTED", flush=True)
    os.environ["PADDLE_CHAOS"] = "crash_at:after_metadata"
    mgr.save(dict(state), 2)   # os._exit(13) mid-protocol
    print("UNREACHABLE", flush=True)
""")


def test_hard_kill_mid_save_leaves_previous_committed(tmp_path):
    script = tmp_path / "crash_child.py"
    script.write_text(CRASH_CHILD)
    root = str(tmp_path / "ck")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("PADDLE_CHAOS", None)
    out = subprocess.run([sys.executable, str(script), root],
                         capture_output=True, text=True, env=env,
                         timeout=180)
    assert out.returncode == CRASH_EXIT_CODE, (out.returncode, out.stdout,
                                               out.stderr)
    assert "STEP1_COMMITTED" in out.stdout
    assert "UNREACHABLE" not in out.stdout
    mgr = _mgr(root, async_save=False)
    assert mgr.committed_steps() == [1]
    dst = {"w": torch.zeros(4, 4)}
    assert mgr.restore(dst, verify=True)["step"] == 1
    assert torch.equal(dst["w"], torch.arange(16.0).reshape(4, 4))
    mgr.save(dict(dst), 2)
    assert mgr.committed_steps() == [1, 2]
    assert [n for n in os.listdir(root) if ".tmp." in n] == []
