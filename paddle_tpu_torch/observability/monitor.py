"""TrainingMonitor: per-step training telemetry into the metrics registry
(port of `paddle_tpu/observability/monitor.py`: the same series, labels
and NaN actions).

Per step it reports:

  - wall time (`train/step_time_s` histogram) and a step counter
    (`train/steps`);
  - tokens/sec and samples/sec when the caller gives batch sizes;
  - MFU (`train/mfu`) from a flops-per-token against the card's peak bf16
    FLOP/s (`hardware.detect_peak_flops`; None on the CPU disables MFU);
  - the device-memory high-water mark (`train/hbm_high_water_bytes`
    gauge): `torch.cuda.max_memory_allocated` on the monitor's device, 0
    on the CPU;
  - a NaN/inf loss check: 'raise' fails loudly (NonFiniteLossError), 'warn'
    warns and counts `train/non_finite_loss`, 'none' skips the check AND
    the device sync it needs.

With nan_action='none' `end_step` never reads the loss back, so the wall
time is the step's dispatch time, not its device time: the step never
waits for the card.
"""

from __future__ import annotations

import contextlib
import math
import time
import warnings

import numpy as np
import torch

from paddle_tpu_torch.observability import hardware
from paddle_tpu_torch.observability.registry import global_registry

__all__ = ["TrainingMonitor", "NonFiniteLossError"]


class NonFiniteLossError(FloatingPointError):
    """Raised by nan_action='raise' when a step's loss is NaN/inf."""


def _host_float(loss):
    if torch.is_tensor(loss):
        return float(loss.detach().float().cpu())
    return float(np.asarray(loss))


class TrainingMonitor:
    def __init__(self, registry=None, *, source="train", flops_per_token=None,
                 peak_flops="auto", nan_action="warn", device=None):
        if nan_action not in ("raise", "warn", "none"):
            raise ValueError("nan_action must be 'raise', 'warn' or 'none'")
        self.registry = registry if registry is not None else global_registry()
        self.source = str(source)
        self.flops_per_token = flops_per_token
        self.peak_flops = peak_flops  # 'auto' resolved lazily on first use
        self.nan_action = nan_action
        # the device whose memory high water the gauge reads (the engine
        # sets its own when the caller gave none)
        self.device = None if device is None else torch.device(device)
        self.steps = 0
        self.last = {}
        self._t0 = None

    def _labels(self):
        return {"source": self.source}

    def _resolve_peak(self):
        if self.peak_flops == "auto":
            self.peak_flops = (hardware.detect_peak_flops(self.device)
                               if self.device is not None
                               and self.device.type == "cuda" else None)
        return self.peak_flops

    def _hbm(self):
        if self.device is None or self.device.type != "cuda":
            return 0
        return torch.cuda.max_memory_allocated(self.device)

    # -- step bracketing ----------------------------------------------------
    def record_compile(self, kind="train_step"):
        """Count one compilation (a static Executor's traced step)."""
        self.registry.inc("train/compiles",
                          labels={"source": self.source, "kind": kind})

    def start_step(self):
        self._t0 = time.perf_counter()

    def end_step(self, loss=None, tokens=None, samples=None):
        if self._t0 is None:
            raise RuntimeError("end_step() without a matching start_step()")
        loss_value = None
        if loss is not None and self.nan_action != "none":
            # a read back to the host: waits for the card, so the wall time
            # below is the step's device time rather than its dispatch time
            loss_value = _host_float(loss)
        wall = time.perf_counter() - self._t0
        self._t0 = None
        return self.record_step(wall, loss_value=loss_value, tokens=tokens,
                                samples=samples)

    @contextlib.contextmanager
    def step(self, tokens=None, samples=None):
        """Wall-time-only bracket for loops that don't surface a loss."""
        self.start_step()
        try:
            yield self
        finally:
            if self._t0 is not None:  # end_step not called inside the block
                self.end_step(tokens=tokens, samples=samples)

    def record_step(self, wall_s, loss_value=None, tokens=None, samples=None):
        r, lbl = self.registry, self._labels()
        self.steps += 1
        stats = {"step_time_s": wall_s}
        r.inc("train/steps", labels=lbl)
        r.observe("train/step_time_s", wall_s, labels=lbl)
        if tokens:
            tps = tokens / wall_s if wall_s > 0 else 0.0
            stats["tokens_per_sec"] = tps
            r.observe("train/tokens_per_sec", tps, labels=lbl)
            peak = self._resolve_peak()
            if self.flops_per_token and peak:
                mfu = tps * self.flops_per_token / peak
                stats["mfu"] = mfu
                r.observe("train/mfu", mfu, labels=lbl)
        if samples:
            sps = samples / wall_s if wall_s > 0 else 0.0
            stats["samples_per_sec"] = sps
            r.observe("train/samples_per_sec", sps, labels=lbl)
        hbm = self._hbm()
        stats["hbm_high_water_bytes"] = hbm
        r.set_gauge("train/hbm_high_water_bytes", hbm, labels=lbl)
        self.last = stats
        if loss_value is not None:
            stats["loss"] = loss_value
            if math.isfinite(loss_value):
                r.set_gauge("train/loss", loss_value, labels=lbl)
            elif self.nan_action != "none":
                r.inc("train/non_finite_loss", labels=lbl)
                msg = (f"[telemetry] non-finite loss ({loss_value}) at "
                       f"monitored step {self.steps} (source="
                       f"{self.source!r})")
                if self.nan_action == "raise":
                    raise NonFiniteLossError(msg)
                warnings.warn(msg, RuntimeWarning, stacklevel=3)
        return stats
