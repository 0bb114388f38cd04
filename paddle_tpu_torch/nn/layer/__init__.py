"""The layer classes of `nn` (`paddle_tpu/nn/layer/`)."""
