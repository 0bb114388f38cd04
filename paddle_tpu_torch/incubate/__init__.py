"""paddle.incubate of the port (`paddle_tpu/incubate/__init__.py`): the
fused layers and functions of `incubate.nn`. The rest of the JAX module
(the graph ops over `geometric`, LookAhead, ModelAverage, the MoE layers of
`incubate.distributed`) waits for ROADMAP A10g."""

from paddle_tpu_torch.incubate import nn  # noqa: F401
