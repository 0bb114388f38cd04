"""Tensor creation ops (`paddle_tpu/ops/creation.py`; reference
`python/paddle/tensor/creation.py` and `random.py`).

Every tensor is made on the creation place (`framework.device.place`).
Random ops draw from the framework generator of that device
(`framework.random.generator`), never from torch's global one.
"""

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor, apply
from paddle_tpu_torch.framework import dtypes, random as _rng
from paddle_tpu_torch.ops._common import dtype_or as _dt
from paddle_tpu_torch.ops._common import int_shape as _shape
from paddle_tpu_torch.ops._common import place as _place
from paddle_tpu_torch.ops._common import scalar as _scalar


def zeros(shape, dtype=None, name=None):
    return Tensor(torch.zeros(_shape(shape), dtype=_dt(dtype),
                              device=_place()))


def ones(shape, dtype=None, name=None):
    return Tensor(torch.ones(_shape(shape), dtype=_dt(dtype),
                             device=_place()))


def full(shape, fill_value, dtype=None, name=None):
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    if dtype is None:
        if isinstance(fill_value, bool):
            dtype = "bool"
        elif isinstance(fill_value, float):
            dtype = "float32"
        else:
            dtype = "int64"
    return Tensor(torch.full(_shape(shape), fill_value, dtype=_dt(dtype),
                             device=_place()))


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def zeros_like(x, dtype=None, name=None):
    return Tensor(torch.zeros_like(x._data, dtype=_dt(dtype, None)))


def ones_like(x, dtype=None, name=None):
    return Tensor(torch.ones_like(x._data, dtype=_dt(dtype, None)))


def full_like(x, fill_value, dtype=None, name=None):
    return Tensor(torch.full_like(x._data, _scalar(fill_value),
                                  dtype=_dt(dtype, None)))


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("float32" if any(isinstance(v, float)
                                  for v in (start, end, step)) else "int64")
    return Tensor(torch.arange(start, end, step, dtype=_dt(dtype),
                               device=_place()))


def linspace(start, stop, num, dtype=None, name=None):
    return Tensor(torch.linspace(_scalar(start), _scalar(stop),
                                 int(_scalar(num)), dtype=_dt(dtype),
                                 device=_place()))


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return Tensor(torch.logspace(_scalar(start), _scalar(stop),
                                 int(_scalar(num)), base=base,
                                 dtype=_dt(dtype), device=_place()))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    cols = num_rows if num_columns is None else num_columns
    return Tensor(torch.eye(num_rows, cols, dtype=_dt(dtype),
                            device=_place()))


def diag(x, offset=0, padding_value=0, name=None):
    if x.ndim == 1 and padding_value != 0:
        def fn(a):
            d = torch.diag(a, offset)
            mask = torch.diag(torch.ones_like(a, dtype=torch.bool), offset)
            return torch.where(mask, d, torch.tensor(padding_value,
                                                     dtype=a.dtype,
                                                     device=a.device))
        return apply(fn, x, _name="diag")
    return apply(lambda a: torch.diag(a, offset), x, _name="diag")


def diagflat(x, offset=0, name=None):
    return apply(lambda a: torch.diagflat(a, offset), x, _name="diagflat")


def tril(x, diagonal=0, name=None):
    return apply(lambda a: torch.tril(a, diagonal), x, _name="tril")


def triu(x, diagonal=0, name=None):
    return apply(lambda a: torch.triu(a, diagonal), x, _name="triu")


def meshgrid(*args, **kwargs):
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        args = args[0]
    return apply(lambda *a: list(torch.meshgrid(*a, indexing="ij")), *args,
                 _name="meshgrid")


def assign(x, output=None):
    data = x if isinstance(x, Tensor) else Tensor(np.asarray(x))
    if output is None:
        return apply(torch.clone, data, _name="assign")
    return output._refill(data._data)


def clone(x, name=None):
    return x.clone()


def tril_indices(row, col, offset=0, dtype="int64", name=None):
    return Tensor(torch.tril_indices(row, col, offset, dtype=_dt(dtype),
                                     device=_place()))


def triu_indices(row, col=None, offset=0, dtype="int64", name=None):
    col = row if col is None else col
    return Tensor(torch.triu_indices(row, col, offset, dtype=_dt(dtype),
                                     device=_place()))


def complex(real, imag, name=None):
    return apply(torch.complex, real, imag, _name="complex")


# ---- random creation (reference: python/paddle/tensor/random.py) ----------


def rand(shape, dtype=None, name=None):
    dev = _place()
    return Tensor(torch.rand(_shape(shape), dtype=_dt(dtype), device=dev,
                             generator=_rng.generator(dev)))


def randn(shape, dtype=None, name=None):
    dev = _place()
    return Tensor(torch.randn(_shape(shape), dtype=_dt(dtype), device=dev,
                              generator=_rng.generator(dev)))


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = _place()
    gen = (torch.Generator(device=dev).manual_seed(int(seed)) if seed
           else _rng.generator(dev))
    out = torch.empty(_shape(shape), dtype=_dt(dtype), device=dev)
    return Tensor(out.uniform_(_scalar(min), _scalar(max), generator=gen))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m = mean._data if isinstance(mean, Tensor) else mean
        s = std._data if isinstance(std, Tensor) else std
        ref = m if isinstance(m, torch.Tensor) else s
        shp = torch.broadcast_shapes(tuple(getattr(m, "shape", ())),
                                     tuple(getattr(s, "shape", ())))
        z = torch.randn(shp, dtype=ref.dtype, device=ref.device,
                        generator=_rng.generator(ref.device))
        return Tensor(z * s + m)
    dev = _place()
    z = torch.randn(_shape(shape), dtype=dtypes.default_float(), device=dev,
                    generator=_rng.generator(dev))
    return Tensor(z * std + mean)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = _place()
    return Tensor(torch.randint(int(low), int(high), _shape(shape),
                                dtype=_dt(dtype), device=dev,
                                generator=_rng.generator(dev)))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dt = _dt(dtype, None) or x.dtype
    dev = x._data.device
    return Tensor(torch.randint(int(low), int(high), tuple(x.shape),
                                dtype=dt, device=dev, generator=_rng.generator(dev)))


def randperm(n, dtype="int64", name=None):
    dev = _place()
    return Tensor(torch.randperm(int(n), dtype=_dt(dtype), device=dev,
                                 generator=_rng.generator(dev)))


def bernoulli(x, name=None):
    d = x._data.detach()
    return Tensor(torch.bernoulli(d, generator=_rng.generator(d.device)))


def multinomial(x, num_samples=1, replacement=False, name=None):
    d = x._data.detach()
    return Tensor(torch.multinomial(d, num_samples, replacement,
                                    generator=_rng.generator(d.device)))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def poisson(x, name=None):
    d = x._data.detach()
    return Tensor(torch.poisson(d, generator=_rng.generator(d.device)))


def exponential_(x, lam=1.0, name=None):
    return x.exponential_(lam)


def standard_gamma(x, name=None):
    """Gamma(alpha=x, 1) elementwise (reference ops.yaml standard_gamma)."""
    d = x._data.detach()
    return Tensor(torch._standard_gamma(d, generator=_rng.generator(d.device)))


def binomial(count, prob, name=None):
    """Binomial(count, prob) elementwise (reference ops.yaml binomial),
    int64 as in Paddle."""
    c = count._data if isinstance(count, Tensor) else torch.as_tensor(count)
    p = prob._data if isinstance(prob, Tensor) else torch.as_tensor(prob)
    c, p = torch.broadcast_tensors(c.detach().float(), p.detach().float())
    return Tensor(torch.binomial(c, p, generator=_rng.generator(c.device))
                  .to(torch.int64))


__all__ = [n for n, v in list(globals().items())
           if not n.startswith("_") and callable(v)
           and getattr(v, "__module__", None) == __name__]
