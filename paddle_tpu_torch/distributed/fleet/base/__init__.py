"""fleet.base of the port (`paddle_tpu/distributed/fleet/base/`)."""
