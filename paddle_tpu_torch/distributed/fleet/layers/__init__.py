"""fleet.layers of the port (`paddle_tpu/distributed/fleet/layers/`)."""

from paddle_tpu_torch.distributed.fleet.layers import mpu  # noqa: F401
