"""Model-parallel utilities of the port (`paddle_tpu/distributed/fleet/
layers/mpu/`): the RNG state tracker. The parallel layers and ops wait for
ROADMAP A9."""

from paddle_tpu_torch.distributed.fleet.layers.mpu.random import (  # noqa: F401
    RNGStatesTracker, get_rng_state_tracker, model_parallel_random_seed,
)
