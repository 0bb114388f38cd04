"""paddle.nn of the port. So far only `functional.flash_attention`; the rest
of nn (layers, losses, initializers) is ported with ROADMAP A10b."""

from paddle_tpu_torch.nn import functional  # noqa: F401
