"""Argument helpers shared by the op modules."""

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor, _as_torch
from paddle_tpu_torch.framework import device as _device
from paddle_tpu_torch.framework import dtypes as _dtypes


def axes(axis):
    """An int, a tuple of ints or None from an int, list, tuple or
    Tensor."""
    if axis is None:
        return None
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def dims(axis, ndim):
    """`axes(axis)` as a tuple of dims; None means every dim."""
    ax = axes(axis)
    if ax is None:
        return tuple(range(ndim))
    return ax if isinstance(ax, tuple) else (ax,)


def raw(v, ref=None):
    """The torch tensor of a Tensor, or of Python / numpy data (on `ref`'s
    device when given)."""
    if isinstance(v, Tensor):
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v),
                           device=None if ref is None else ref.device)


def scalar(v):
    return v.item() if isinstance(v, Tensor) else v


def int_shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(v) for v in shape.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item()) if isinstance(s, Tensor) else int(s)
                 for s in shape)


def dtype_or(dtype, default="float32"):
    return _dtypes.convert_dtype(dtype if dtype is not None else default)


def place():
    return _device.place()


def as_tensor(v, ref):
    """`v` as a torch tensor on `ref`'s device; a Python float takes a
    floating `ref`'s dtype, as a weak scalar does in JAX."""
    if isinstance(v, Tensor):
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, float) and (ref.dtype.is_floating_point
                                 or ref.dtype.is_complex):
        return torch.tensor(v, dtype=ref.dtype, device=ref.device)
    return _as_torch(v, like=ref)
