"""Argument helpers shared by the op modules."""

import numpy as np
import torch

from paddle_tpu_torch.core import tensor as _tc
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
    device when given). Reading a Tensor here, outside the dispatch waist,
    is a closure over its value: SOT's capture marks the call
    uncapturable (`_mutation_hook`), and a static Program refuses an
    abstract Variable. An op that reads a Tensor passes it to `apply`
    instead (`as_input`)."""
    if isinstance(v, Tensor):
        if _tc._mutation_hook is not None:
            _tc._mutation_hook(v, "read outside the dispatch waist")
        if _tc._static_tape is not None:
            _tc._check_concrete(v)
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v),
                           device=None if ref is None else ref.device)


def as_input(v, ref=None):
    """v as a Tensor an op passes to `apply` (Python or numpy data made a
    constant on `ref`'s device), so that SOT and the static recorder see
    every tensor the op reads."""
    return v if isinstance(v, Tensor) else Tensor(raw(v, ref))


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


_INTS = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)


def as_tensor(v, ref):
    """`v` as a torch tensor on `ref`'s device; a Python float takes a
    floating `ref`'s dtype and a Python int an integer `ref`'s, as a weak
    scalar does in JAX (int32 + 1 stays int32)."""
    if isinstance(v, Tensor):
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    if isinstance(v, float) and (ref.dtype.is_floating_point
                                 or ref.dtype.is_complex):
        return torch.tensor(v, dtype=ref.dtype, device=ref.device)
    if isinstance(v, int) and not isinstance(v, bool) and \
            ref.dtype in _INTS and \
            torch.iinfo(ref.dtype).min <= v <= torch.iinfo(ref.dtype).max:
        return torch.tensor(v, dtype=ref.dtype, device=ref.device)
    return _as_torch(v, like=ref)



def waits_for(name, slice_id, why):
    """The NotImplementedError a name raises whose JAX body reaches a
    subsystem the port has not ported yet: it names the ROADMAP slice that
    ports it."""
    return NotImplementedError(
        f"paddle.{name} is ported with ROADMAP {slice_id} ({why})")
