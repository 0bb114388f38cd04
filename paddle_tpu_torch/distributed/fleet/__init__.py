"""paddle.distributed.fleet of the port (`paddle_tpu/distributed/fleet/`):
what runs on one card, `recompute` and the RNG state tracker it restores.
The hybrid-parallel API (`init`, `distributed_model`, the topology, the
meta-parallel layers) waits for ROADMAP A9."""

from paddle_tpu_torch.distributed.fleet import layers  # noqa: F401
from paddle_tpu_torch.distributed.fleet import recompute as _recompute_mod  # noqa: F401
from paddle_tpu_torch.distributed.fleet.recompute import (  # noqa: F401
    recompute, recompute_sequential)

__all__ = ["recompute", "recompute_sequential"]
