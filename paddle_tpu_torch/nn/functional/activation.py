"""Activation functionals (`paddle_tpu/nn/functional/activation.py`;
reference `python/paddle/nn/functional/activation.py`), elementwise in
plain PyTorch. The random ones (`rrelu` in training, `gumbel_softmax`)
draw from the framework generator of the input's device."""

import torch
import torch.nn.functional as TF

from paddle_tpu_torch.core.tensor import apply
from paddle_tpu_torch.framework import dtypes as _dtypes
from paddle_tpu_torch.framework import random as _rng

__all__ = [
    "relu", "relu_", "relu6", "sigmoid", "tanh", "gelu", "silu", "swish",
    "mish", "leaky_relu", "prelu", "rrelu", "elu", "selu", "celu",
    "hardtanh", "hardshrink", "softshrink", "tanhshrink", "hardsigmoid",
    "hardswish", "softplus", "softsign", "softmax", "softmax_",
    "log_softmax", "gumbel_softmax", "maxout", "glu", "thresholded_relu",
    "log_sigmoid", "swiglu",
]


def relu(x, name=None):
    return apply(torch.relu, x, _name="relu")


def relu_(x, name=None):
    return x._rebind(relu(x)._data)


def relu6(x, name=None):
    # TF.relu6, not a clamp: its gradient is 0 at x == 0 and x == 6, as the
    # JAX package's jax.nn.relu6 and Paddle's; a clamp's is 1 there (a
    # batch-norm output of exactly 0 feeds it in MobileNetV2)
    return apply(TF.relu6, x, _name="relu6")


def sigmoid(x, name=None):
    return apply(torch.sigmoid, x, _name="sigmoid")


def tanh(x, name=None):
    return apply(torch.tanh, x, _name="tanh")


def gelu(x, approximate=False, name=None):
    mode = "tanh" if approximate else "none"
    return apply(lambda a: TF.gelu(a, approximate=mode), x, _name="gelu")


def silu(x, name=None):
    return apply(TF.silu, x, _name="silu")


swish = silu


def mish(x, name=None):
    return apply(lambda a: a * torch.tanh(torch.logaddexp(a, torch.zeros_like(
        a))), x, _name="mish")


def leaky_relu(x, negative_slope=0.01, name=None):
    return apply(lambda a: torch.where(a >= 0, a, negative_slope * a), x,
                 _name="leaky_relu")


def prelu(x, weight, data_format="NCHW", name=None):
    def fn(a, w):
        if w.numel() > 1:
            shape = [1] * a.ndim
            shape[1 if data_format == "NCHW" else a.ndim - 1] = w.numel()
            w = w.reshape(shape)
        return torch.where(a >= 0, a, w * a)

    return apply(fn, x, weight, _name="prelu")


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None):
    """Randomized leaky ReLU: in training the negative slope of each
    element is drawn uniformly from [lower, upper) (the framework
    generator), else it is (lower + upper) / 2."""
    if training:
        def fn(a):
            slope = torch.empty_like(a).uniform_(
                lower, upper, generator=_rng.generator(a.device))
            return torch.where(a >= 0, a, slope * a)

        return apply(fn, x, _name="rrelu")
    mid = (lower + upper) / 2.0
    return apply(lambda a: torch.where(a >= 0, a, mid * a), x, _name="rrelu")


def elu(x, alpha=1.0, name=None):
    return apply(lambda a: torch.where(a > 0, a, alpha * torch.expm1(a)), x,
                 _name="elu")


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return apply(lambda a: scale * torch.where(a > 0, a,
                                               alpha * torch.expm1(a)),
                 x, _name="selu")


def celu(x, alpha=1.0, name=None):
    return apply(lambda a: TF.celu(a, alpha), x, _name="celu")


# hardtanh, hardsigmoid and hardswish clip through TF.hardtanh: its
# gradient at the clip points is 0, Paddle's; torch.clamp's is 1 there and
# the JAX package's jnp.clip 0.5 (ROADMAP §C)
def hardtanh(x, min=-1.0, max=1.0, name=None):
    return apply(lambda a: TF.hardtanh(a, min, max), x, _name="hardtanh")


def hardshrink(x, threshold=0.5, name=None):
    return apply(lambda a: torch.where(torch.abs(a) > threshold, a, 0.0), x,
                 _name="hardshrink")


def softshrink(x, threshold=0.5, name=None):
    return apply(lambda a: torch.where(
        a > threshold, a - threshold,
        torch.where(a < -threshold, a + threshold, 0.0)), x,
        _name="softshrink")


def tanhshrink(x, name=None):
    return apply(lambda a: a - torch.tanh(a), x, _name="tanhshrink")


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return apply(lambda a: TF.hardtanh(slope * a + offset, 0.0, 1.0), x,
                 _name="hardsigmoid")


def hardswish(x, name=None):
    return apply(lambda a: a * TF.hardtanh(a + 3.0, 0.0, 6.0) / 6.0, x,
                 _name="hardswish")


def softplus(x, beta=1, threshold=20, name=None):
    return apply(lambda a: torch.where(
        beta * a > threshold, a,
        torch.logaddexp(beta * a, torch.zeros_like(a)) / beta), x,
        _name="softplus")


def softsign(x, name=None):
    return apply(lambda a: a / (1.0 + torch.abs(a)), x, _name="softsign")


def _cast(a, dtype):
    dt = _dtypes.convert_dtype(dtype)
    return a if dt is None else a.to(dt)


def softmax(x, axis=-1, dtype=None, name=None):
    return apply(lambda a: torch.softmax(_cast(a, dtype), dim=axis), x,
                 _name="softmax")


def softmax_(x, axis=-1, dtype=None, name=None):
    return x._rebind(softmax(x, axis, dtype)._data)


def log_softmax(x, axis=-1, dtype=None, name=None):
    return apply(lambda a: torch.log_softmax(_cast(a, dtype), dim=axis), x,
                 _name="log_softmax")


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """softmax((x + g) / temperature) with g Gumbel noise from the
    framework generator; `hard` gives the one-hot of the argmax forward
    and the soft gradient backward (straight through)."""
    def fn(a):
        u = torch.empty_like(a).uniform_(generator=_rng.generator(a.device))
        g = -torch.log(-torch.log(u.clamp_min(torch.finfo(a.dtype).tiny)))
        y = torch.softmax((a + g) / temperature, dim=axis)
        if hard:
            idx = torch.argmax(y, dim=axis, keepdim=True)
            hard_y = torch.zeros_like(y).scatter_(axis, idx, 1.0)
            return (hard_y - y).detach() + y
        return y

    return apply(fn, x, _name="gumbel_softmax")


def maxout(x, groups, axis=1, name=None):
    def fn(a):
        shape = list(a.shape)
        shape[axis:axis + 1] = [shape[axis] // groups, groups]
        return torch.amax(a.reshape(shape), dim=axis + 1)

    return apply(fn, x, _name="maxout")


def glu(x, axis=-1, name=None):
    return apply(lambda a: TF.glu(a, dim=axis), x, _name="glu")


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return apply(lambda a: torch.where(a > threshold, a, value), x,
                 _name="thresholded_relu")


def log_sigmoid(x, name=None):
    return apply(TF.logsigmoid, x, _name="log_sigmoid")


def swiglu(x, y=None, name=None):
    """silu(x) * y; with y=None, x is split in half on the last dim (the
    fused SwiGLU of the Llama MLP)."""
    if y is None:
        def fn(a):
            a1, a2 = torch.chunk(a, 2, dim=-1)
            return TF.silu(a1) * a2

        return apply(fn, x, _name="swiglu")
    return apply(lambda a, b: TF.silu(a) * b, x, y, _name="swiglu")
