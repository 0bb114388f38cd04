"""Training: the single-card `HybridParallelEngine` and its AdamW, and the
model-generic `Engine` on one card (`distributed/engine.py`)."""

from paddle_tpu_torch.distributed.engine import Engine
from paddle_tpu_torch.distributed.hybrid_engine import (HybridParallelEngine,
                                                        adamw_init,
                                                        adamw_update)

__all__ = ["Engine", "HybridParallelEngine", "adamw_init", "adamw_update"]
