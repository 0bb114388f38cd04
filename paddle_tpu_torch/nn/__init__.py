"""paddle.nn of the port. So far `functional` (every functional of the JAX
package's `nn.functional`); the layers, initializers and the rest of nn are
ported with ROADMAP A10b."""

from paddle_tpu_torch.nn import functional  # noqa: F401
