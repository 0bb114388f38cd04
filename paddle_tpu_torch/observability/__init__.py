"""Observability of the port: the metrics registry, the training monitor,
the card's peak table and the per-run telemetry artifact."""

from paddle_tpu_torch.observability.monitor import (NonFiniteLossError,
                                                    TrainingMonitor)
from paddle_tpu_torch.observability.registry import (MetricsRegistry,
                                                     global_registry,
                                                     set_global_registry)
from paddle_tpu_torch.observability.telemetry import (SCHEMA,
                                                      write_run_telemetry)

__all__ = ["MetricsRegistry", "global_registry", "set_global_registry",
           "TrainingMonitor", "NonFiniteLossError", "SCHEMA",
           "write_run_telemetry"]
