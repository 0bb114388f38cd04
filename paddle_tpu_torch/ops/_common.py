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


def _dim(s):
    """One dimension as an int; a `torch.SymInt` (a dimension
    `torch.export` traces symbolically, such as a dynamic batch) passes as
    it is, since `int()` would fix it to the traced value."""
    if isinstance(s, torch.SymInt):
        return s
    return int(s.item()) if isinstance(s, Tensor) else int(s)


def int_shape(shape):
    if isinstance(shape, Tensor):
        return tuple(int(v) for v in shape.tolist())
    if isinstance(shape, (int, np.integer, torch.SymInt)):
        return (_dim(shape),)
    return tuple(_dim(s) for s in shape)


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



def waits_for(name, slice_id, why):
    """The NotImplementedError a name raises whose JAX body reaches a
    subsystem the port has not ported yet: it names the ROADMAP slice that
    ports it."""
    return NotImplementedError(
        f"paddle.{name} is ported with ROADMAP {slice_id} ({why})")
