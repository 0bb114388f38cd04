"""The op surface of the port (`paddle_tpu/ops/`), over torch."""
