"""paddle.incubate.nn of the port (`paddle_tpu/incubate/nn/__init__.py`;
reference `python/paddle/incubate/nn/layer/fused_transformer.py`)."""

from paddle_tpu_torch.incubate.nn import functional  # noqa: F401
from paddle_tpu_torch.incubate.nn.layer.fused_transformer import (  # noqa: F401
    FusedMultiHeadAttention,
    FusedFeedForward,
    FusedTransformerEncoderLayer,
)

__all__ = ["functional", "FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer"]
