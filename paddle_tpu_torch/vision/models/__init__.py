"""Vision models of the port: `LeNet` (`paddle_tpu/vision/models/`); the
other models are ported with ROADMAP A10d."""

from paddle_tpu_torch.vision.models.lenet import LeNet  # noqa: F401

__all__ = ["LeNet"]
