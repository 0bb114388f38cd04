"""Training: the single-card `HybridParallelEngine` and its AdamW."""

from paddle_tpu_torch.distributed.hybrid_engine import (HybridParallelEngine,
                                                        adamw_init,
                                                        adamw_update)

__all__ = ["HybridParallelEngine", "adamw_init", "adamw_update"]
