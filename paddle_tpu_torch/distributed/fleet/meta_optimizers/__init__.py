"""fleet.meta_optimizers of the port (`paddle_tpu/distributed/fleet/
meta_optimizers/`)."""
