"""Training: the single-card `HybridParallelEngine` and its AdamW, the
model-generic `Engine` on one card (`distributed/engine.py`) and
`fleet.recompute`."""

from paddle_tpu_torch.distributed.engine import Engine
from paddle_tpu_torch.distributed.hybrid_engine import (HybridParallelEngine,
                                                        adamw_init,
                                                        adamw_update)
from paddle_tpu_torch.distributed import fleet  # noqa: F401

__all__ = ["Engine", "HybridParallelEngine", "adamw_init", "adamw_update"]
