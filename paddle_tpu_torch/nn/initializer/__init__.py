"""Initializers (`paddle_tpu/nn/initializer/__init__.py`; reference
`python/paddle/nn/initializer/`).

Each initializer returns a torch tensor of `shape` and `dtype` on the
creation place (`framework.device.place`: the card unless the caller chose
the CPU). Random ones draw in float32 from the framework generator of that
place (`framework.random.generator`, seeded by `paddle.seed`) and cast to
`dtype`: the distributions are the JAX package's (the same fans, bounds and
moments), the bits are not, since torch's generators are not JAX's
threefry.
"""

import math

import numpy as np
import torch

from paddle_tpu_torch.framework import device as _device
from paddle_tpu_torch.framework import dtypes
from paddle_tpu_torch.framework import random as _rng


def _draw(shape, fill):
    """A float32 tensor of `shape` on the creation place, filled in place
    by `fill(tensor, generator)`."""
    dev = _device.place()
    out = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
    fill(out, _rng.generator(dev))
    return out


class Initializer:
    def __call__(self, shape, dtype):
        raise NotImplementedError

    def _compute_fans(self, shape):
        if len(shape) == 0:
            return 1, 1
        if len(shape) == 1:
            return shape[0], shape[0]
        if len(shape) == 2:
            return shape[0], shape[1]
        receptive = int(np.prod(shape[2:]))
        return shape[1] * receptive, shape[0] * receptive


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype):
        return torch.full(tuple(shape), self.value,
                          dtype=dtypes.convert_dtype(dtype),
                          device=_device.place())


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        out = _draw(shape, lambda t, g: t.normal_(0.0, 1.0, generator=g))
        return (self.mean + self.std * out).to(dtypes.convert_dtype(dtype))


class TruncatedNormal(Initializer):
    """N(mean, std) truncated to [a, b], drawn by the inverse CDF of a
    uniform draw between the standard normal CDF's values at the bounds."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def __call__(self, shape, dtype):
        lo = (self.a - self.mean) / self.std
        hi = (self.b - self.mean) / self.std
        cdf_lo = 0.5 * (1.0 + math.erf(lo / math.sqrt(2.0)))
        cdf_hi = 0.5 * (1.0 + math.erf(hi / math.sqrt(2.0)))
        u = _draw(shape, lambda t, g: t.uniform_(cdf_lo, cdf_hi,
                                                 generator=g))
        z = torch.special.ndtri(u).clamp_(lo, hi)
        return (self.mean + self.std * z).to(dtypes.convert_dtype(dtype))


def _uniform(shape, dtype, low, high):
    out = _draw(shape, lambda t, g: t.uniform_(low, high, generator=g))
    return out.to(dtypes.convert_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def __call__(self, shape, dtype):
        return _uniform(shape, dtype, self.low, self.high)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fin, fout = self._compute_fans(shape)
        fin = self.fan_in or fin
        fout = self.fan_out or fout
        std = self.gain * math.sqrt(2.0 / (fin + fout))
        return Normal(0.0, std)(shape, dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fin, fout = self._compute_fans(shape)
        fin = self.fan_in or fin
        fout = self.fan_out or fout
        limit = self.gain * math.sqrt(6.0 / (fin + fout))
        return _uniform(shape, dtype, -limit, limit)


def _kaiming_gain(nonlinearity, negative_slope):
    if nonlinearity in ("relu", "leaky_relu"):
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return 1.0


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fin, _ = self._compute_fans(shape)
        fin = self.fan_in or fin
        std = _kaiming_gain(self.nonlinearity, self.negative_slope) \
            / math.sqrt(fin)
        return Normal(0.0, std)(shape, dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fin, _ = self._compute_fans(shape)
        fin = self.fan_in or fin
        limit = _kaiming_gain(self.nonlinearity, self.negative_slope) \
            * math.sqrt(3.0 / fin)
        return _uniform(shape, dtype, -limit, limit)


class Orthogonal(Initializer):
    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def __call__(self, shape, dtype):
        rows = shape[0]
        cols = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        flat = _draw((max(rows, cols), min(rows, cols)),
                     lambda t, g: t.normal_(0.0, 1.0, generator=g))
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols]).reshape(tuple(shape)).to(
            dtypes.convert_dtype(dtype))


class Assign(Initializer):
    def __init__(self, value, name=None):
        self.value = value

    def __call__(self, shape, dtype):
        from paddle_tpu_torch.core.tensor import Tensor, _torch_data

        v = self.value
        arr = v._data.detach() if isinstance(v, Tensor) else _torch_data(
            np.asarray(v))
        return arr.to(_device.place()).reshape(tuple(shape)).to(
            dtypes.convert_dtype(dtype))


class Dirac(Initializer):
    def __init__(self, groups=1, name=None):
        self.groups = groups

    def __call__(self, shape, dtype):
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        centers = [s // 2 for s in shape[2:]]
        for g in range(self.groups):
            for i in range(min(oc // self.groups, ic)):
                idx = (g * (oc // self.groups) + i, i) + tuple(centers)
                out[idx] = 1.0
        return torch.from_numpy(out).to(_device.place(),
                                        dtypes.convert_dtype(dtype))


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = param if param is not None else 0.01
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0


def set_global_initializer(weight_init, bias_init=None):
    # stored for create_parameter default lookup
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


_global_weight_init = None
_global_bias_init = None


class Bilinear(Initializer):
    """Bilinear-upsampling kernel init for transposed convs (reference
    `nn/initializer/Bilinear`): weight[c_out, c_in, kh, kw] filled with
    the separable triangle filter so a stride-s deconv starts as exact
    bilinear interpolation."""

    def __call__(self, shape, dtype):
        if len(shape) != 4:
            raise ValueError(
                "Bilinear initializer expects a 4-D conv weight, got "
                f"shape {list(shape)}")
        kh, kw = shape[2], shape[3]

        def tri(k):
            f = (k + 1) // 2
            center = f - 1 if k % 2 == 1 else f - 0.5
            return 1 - np.abs(np.arange(k) - center) / f

        kernel = np.outer(tri(kh), tri(kw)).astype("float32")
        w = np.zeros(tuple(shape), "float32")
        for i in range(shape[0]):
            w[i, i % shape[1]] = kernel
        return torch.from_numpy(w).to(_device.place(),
                                      dtypes.convert_dtype(dtype))
