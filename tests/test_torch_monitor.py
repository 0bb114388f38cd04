"""The training monitor of the PyTorch port (`paddle_tpu_torch/
observability/monitor.py`) against the JAX package's.

  - the cases of tests/test_observability.py::TestTrainingMonitor: for
    the same `record_step` / `end_step` inputs both monitors write the
    same series, labels and values into fresh registries (wall times set
    by hand), and raise, warn or stay silent alike;
  - the engine-wiring cases of TestHybridEngineWiring on the port's
    engine on the CPU (no jit: no `train/compiles`);
  - the peak table and the per-run telemetry artifact.
"""

import json
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu.observability import MetricsRegistry as JaxRegistry
from paddle_tpu.observability import TrainingMonitor as JaxMonitor
from paddle_tpu.observability import hardware as jhw
from paddle_tpu.observability import telemetry as jtel
from paddle_tpu_torch.distributed import HybridParallelEngine
from paddle_tpu_torch.models import LlamaArgs
from paddle_tpu_torch.observability import (MetricsRegistry,
                                            NonFiniteLossError,
                                            TrainingMonitor, hardware,
                                            set_global_registry,
                                            write_run_telemetry)

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)


def _pair(**kw):
    """(port monitor, JAX monitor), each over its own fresh registry."""
    return (TrainingMonitor(registry=MetricsRegistry(), **kw),
            JaxMonitor(registry=JaxRegistry(), **kw))


def _series(reg):
    """The registry's snapshot without the device-memory gauge (the JAX
    monitor reads its backend, the port the card)."""
    snap = reg.snapshot()
    snap["gauges"].pop("train/hbm_high_water_bytes", None)
    return snap


STEPS = [  # record_step keyword arguments
    dict(wall_s=0.5, tokens=100),
    dict(wall_s=0.25, tokens=100, samples=4, loss_value=2.5),
    dict(wall_s=0.125, samples=8, loss_value=1.25),
    dict(wall_s=0.0, tokens=64),
]


@pytest.mark.parametrize("nan_action", ["raise", "warn", "none"])
def test_record_step_writes_the_jax_series(nan_action):
    """tokens/s, samples/s, MFU, loss, the step counter and histograms:
    the same series, labels and values as the JAX monitor's."""
    mine, ref = _pair(source="t", flops_per_token=2.0, peak_flops=1000.0,
                      nan_action=nan_action)
    for kw in STEPS:
        assert mine.record_step(**kw) == {
            k: v for k, v in ref.record_step(**kw).items()
            if k != "hbm_high_water_bytes"} | {"hbm_high_water_bytes": 0}
    assert _series(mine.registry) == _series(ref.registry)
    assert mine.registry.snapshot()["gauges"][
        "train/hbm_high_water_bytes"] == {"source=t": {"value": 0, "max": 0}}


def test_record_step_tokens_mfu():
    r = MetricsRegistry()
    mon = TrainingMonitor(registry=r, source="t", flops_per_token=2.0,
                          peak_flops=1000.0, nan_action="none")
    stats = mon.record_step(0.5, tokens=100)
    assert stats["tokens_per_sec"] == pytest.approx(200.0)
    assert stats["mfu"] == pytest.approx(200.0 * 2.0 / 1000.0)
    assert r.counter("train/steps", labels={"source": "t"}) == 1
    assert r.observation("train/mfu", labels={"source": "t"})["count"] == 1


@pytest.mark.parametrize("loss", [float("nan"), float("inf")])
def test_nan_action_raise(loss):
    mine, ref = _pair(source="t", nan_action="raise")
    for mon in (mine, ref):
        mon.start_step()
        with pytest.raises(FloatingPointError):
            mon.end_step(loss=np.float32(loss))
    assert mine.registry.counter("train/non_finite_loss",
                                 labels={"source": "t"}) == 1
    mine.start_step()
    with pytest.raises(NonFiniteLossError):
        mine.end_step(loss=torch.tensor(loss))   # a tensor, read back


def test_nan_action_warn():
    mine, ref = _pair(source="t", nan_action="warn")
    for mon in (mine, ref):
        mon.start_step()
        with pytest.warns(RuntimeWarning, match="non-finite loss"):
            mon.end_step(loss=np.float32("inf"))
    assert _series(mine.registry)["counters"] == \
        _series(ref.registry)["counters"]


def test_nan_action_none_skips_readback():
    """'none' never reads the loss: not even a tensor whose read would
    fail is touched, so the step never waits for the card."""

    class Unreadable:
        def __float__(self):
            raise AssertionError("the loss was read")

        def __array__(self, *a, **k):
            raise AssertionError("the loss was read")

    mon = TrainingMonitor(registry=MetricsRegistry(), source="t",
                          nan_action="none")
    mon.start_step()
    stats = mon.end_step(loss=Unreadable())
    assert "loss" not in stats
    assert mon.registry.counter("train/non_finite_loss",
                                labels={"source": "t"}) == 0


def test_nan_action_none_with_explicit_loss_stays_silent():
    mine, ref = _pair(source="t", nan_action="none")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for mon in (mine, ref):
            stats = mon.record_step(0.1, loss_value=float("nan"))
            assert stats["loss"] != stats["loss"]
    assert _series(mine.registry) == _series(ref.registry)


def test_invalid_nan_action_rejected():
    with pytest.raises(ValueError):
        TrainingMonitor(nan_action="explode")


def test_step_context_manager():
    mine, ref = _pair(source="t", nan_action="none")
    for mon in (mine, ref):
        with mon.step(tokens=10):
            pass
    assert mine.registry.counter("train/steps", labels={"source": "t"}) == 1
    assert set(_series(mine.registry)["histograms"]) == \
        set(_series(ref.registry)["histograms"])


def test_end_step_without_start_raises():
    with pytest.raises(RuntimeError):
        TrainingMonitor(registry=MetricsRegistry()).end_step()


def test_peak_table_and_flops_formulas():
    """The port's table has the card rows only (no TPU number); the FLOPs
    formulas are the JAX package's."""
    assert hardware.peaks_for("NVIDIA H100 80GB HBM3") == (3.35e12, 989e12)
    assert hardware.peaks_for("NVIDIA H100 PCIe") == (2.0e12, 756e12)
    assert hardware.peaks_for("TPU v5 lite") is None
    assert hardware.detect_peak_flops("cpu") is None
    args = LlamaArgs(vocab_size=32000, hidden_size=4096,
                     intermediate_size=11008, num_layers=2, num_heads=32,
                     num_kv_heads=32, rope_theta=1e4, rms_eps=1e-6)
    assert hardware.llama_param_count(args) == jhw.llama_param_count(args)
    assert hardware.llama_flops_per_token(args, 2048) == \
        jhw.llama_flops_per_token(args, 2048)


def test_telemetry_artifact_is_the_jax_schema(tmp_path):
    r = MetricsRegistry()
    r.inc("train/steps")
    a = write_run_telemetry(tmp_path / "a.json", record={"tps": 1.0},
                            registry=r, meta={"tool": "t"})
    b = jtel.write_run_telemetry(tmp_path / "b.json", record={"tps": 1.0},
                                 registry=r, meta={"tool": "t"})
    assert a["schema"] == b["schema"] == jtel.SCHEMA
    on_disk = json.loads((tmp_path / "a.json").read_text())
    assert set(on_disk) == set(json.loads((tmp_path / "b.json").read_text()))
    assert on_disk["metrics"]["counters"]["train/steps"][""] == 1
    assert not (tmp_path / "a.json.tmp").exists()


# -- the engine's wiring ---------------------------------------------------------


@pytest.fixture
def fresh_registry():
    r = MetricsRegistry()
    prev = set_global_registry(r)
    yield r
    set_global_registry(prev)


def _tiny():
    return LlamaArgs(vocab_size=128, hidden_size=32, intermediate_size=64,
                     num_layers=2, num_heads=4, num_kv_heads=4,
                     rope_theta=10000.0, rms_eps=1e-6)


def test_train_batch_reports_steps_mfu_hbm(fresh_registry):
    eng = HybridParallelEngine(_tiny(), device="cpu")
    assert eng.monitor.nan_action == "none"
    assert eng.monitor.device == torch.device("cpu")
    eng.monitor.peak_flops = 1e12   # the CPU has no peak
    params, opt = eng.init_state(0)
    ids = np.random.default_rng(0).integers(0, 128, (2, 16)).astype(np.int32)
    for _ in range(2):
        loss, params, opt = eng.train_batch(params, opt, ids, ids)
    snap = fresh_registry.snapshot()
    lbl = "source=hybrid_engine"
    assert snap["counters"]["train/steps"][lbl] == 2
    assert "train/compiles" not in snap["counters"]   # no jit in the port
    assert snap["histograms"]["train/tokens_per_sec"][lbl]["count"] == 2
    assert snap["histograms"]["train/mfu"][lbl]["count"] == 2
    assert snap["gauges"]["train/hbm_high_water_bytes"][lbl]["value"] == 0
    assert eng.monitor.flops_per_token == hardware.llama_flops_per_token(
        eng.args, 16)
    assert eng.monitor.last["tokens_per_sec"] > 0


def test_auto_peak_flops_on_the_cpu_is_none(fresh_registry):
    """No peak on the CPU: MFU is left out, not made up."""
    eng = HybridParallelEngine(_tiny(), device="cpu")
    params, opt = eng.init_state(0)
    ids = np.ones((2, 16), np.int32)
    eng.train_batch(params, opt, ids, ids)
    assert eng.monitor.peak_flops is None
    assert "mfu" not in eng.monitor.last


def test_user_flops_per_token_not_overwritten(fresh_registry):
    mon = TrainingMonitor(source="custom_fpt", flops_per_token=123.0,
                          peak_flops=1e12, nan_action="none")
    eng = HybridParallelEngine(_tiny(), monitor=mon, device="cpu")
    params, opt = eng.init_state(0)
    ids = np.ones((2, 16), np.int32)
    eng.train_batch(params, opt, ids, ids)
    assert mon.flops_per_token == 123.0


def test_nan_loss_raises_through_engine(fresh_registry):
    mon = TrainingMonitor(source="nan_engine", nan_action="raise")
    eng = HybridParallelEngine(_tiny(), monitor=mon, device="cpu")
    params, opt = eng.init_state(0)
    with torch.no_grad():
        for p in params["layers"].values():
            p.mul_(float("nan"))
    ids = np.ones((2, 16), np.int32)
    with pytest.raises(NonFiniteLossError):
        eng.train_batch(params, opt, ids, ids)
