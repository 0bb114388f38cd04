"""The eager Tensor of the port (`paddle_tpu/core/tensor.py`).

A `Tensor` wraps a `torch.Tensor` (`_data`), as the JAX package's wraps a
`jax.Array`. It is a wrapper and not a subclass: Paddle's methods of the
same names as torch's mean other things (`reshape(list)`,
`transpose(perm)`, `sum(axis=)`, `max` returning values only).

Autograd is torch's engine. `stop_gradient` is `not _data.requires_grad`
(only float and complex tensors can need a gradient), `grad` wraps
`_data.grad`, and `no_grad` / `enable_grad` are torch's grad modes. An op
records nothing of its own: `apply` runs a function over the torch tensors
and wraps what comes out, and torch records the graph.

In-place methods compute out of place and rebind `_data`, so autograd
never sees a tensor it saved being mutated, and views taken earlier keep
their values, as JAX's immutable arrays do. Arithmetic in place keeps the
chain rule (the rebound tensor's history runs through the op); a fill cuts
the history (`_refill`). A leaf that needs a gradient keeps its gradient,
its hooks and its leaf-ness across an update under `no_grad` (the
optimizer's path), and may not be changed in place while grad is enabled.

Tensors are created on the place `framework.device` gives: the device of
`set_device`, else the current CUDA device; with no card and no
`set_device('cpu')`, creation raises.

AMP hangs on the dispatch waist as in the JAX package: inside
`amp.auto_cast`, `apply` casts the float32 inputs of a white-list op (by
its `_name`) to the AMP dtype before the op runs (`amp_local`). Not ported
here: the waist's other hooks (the nan/inf sanitizer, the profiler's
tracer, SOT capture, the static tape); each arrives with the slice that
ports its subsystem.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from paddle_tpu_torch.framework import device as _device
from paddle_tpu_torch.framework import dtypes as _dtypes

__all__ = [
    "Tensor",
    "to_tensor",
    "no_grad",
    "enable_grad",
    "is_grad_enabled",
    "set_grad_enabled",
    "apply",
    "apply_multi",
]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
is_grad_enabled = torch.is_grad_enabled


def set_grad_enabled(mode):
    torch.set_grad_enabled(bool(mode))


def _needs_grad_dtype(dtype):
    return dtype.is_floating_point or dtype.is_complex


def _torch_data(data, dtype=None, place=None):
    """A torch tensor from Python or numpy data, on `place` (default: the
    creation place). Python floats take the default float dtype, Python
    ints int64; a numpy array keeps its dtype unless `dtype` is given."""
    dev = _device.place(place)
    dt = _dtypes.convert_dtype(dtype)
    from_numpy = isinstance(data, (np.ndarray, np.generic))
    arr = np.asarray(data)
    if arr.dtype == object:
        raise TypeError(f"cannot make a tensor of {type(data).__name__}")
    if not from_numpy and dt is None:
        if arr.dtype == np.float64:
            dt = _dtypes.default_float()
        elif arr.dtype == np.complex128:
            dt = _dtypes.complex64
    if dt == torch.bfloat16 or arr.dtype.name == "bfloat16":
        t = torch.tensor(np.asarray(arr, np.float32))
    else:
        t = torch.tensor(np.ascontiguousarray(arr))
    if dt is not None and t.dtype != dt:
        t = t.to(dt)
    return t.to(dev)


class Tensor:
    """A Paddle-like eager tensor backed by a torch.Tensor."""

    __slots__ = ("_data", "name", "persistable", "_hooks", "_owner",
                 "__weakref__")

    def __init__(self, data, stop_gradient=True, name=None):
        if isinstance(data, Tensor):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = _torch_data(data)
        self._data = data
        self.name = name
        self.persistable = False
        self._hooks = None
        self._owner = None   # the Tensor whose .grad this one is
        if not stop_gradient:
            self.stop_gradient = False

    # -- autograd state ----------------------------------------------------
    @property
    def stop_gradient(self):
        return not self._data.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        d = self._data
        if value:
            if d.requires_grad:
                self._data = d.detach()
        elif not d.requires_grad and _needs_grad_dtype(d.dtype):
            if d.grad_fn is None and d.is_leaf:
                d.requires_grad_(True)
            else:
                self._data = d.detach().requires_grad_(True)
            self._attach_hooks()

    @property
    def grad(self):
        """The accumulated gradient, a Tensor whose in-place ops (`zero_`,
        `scale_`, ...) write back to this tensor's gradient."""
        g = self._data.grad if self._data.is_leaf else None
        if g is None:
            return None
        t = Tensor(g)
        t._owner = self
        return t

    @grad.setter
    def grad(self, value):
        self._data.grad = None if value is None else _as_torch(value)

    @property
    def is_leaf(self):
        return self._data.grad_fn is None

    # -- basic properties --------------------------------------------------
    @property
    def data(self):
        return self

    @data.setter
    def data(self, value):
        self._refill(_as_torch(value, like=self._data))

    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def dtype(self):
        return self._data.dtype

    @property
    def size(self):
        return self._data.numel()

    @property
    def place(self):
        return self._data.device

    @property
    def T(self):
        from paddle_tpu_torch.ops import manipulation

        return manipulation.transpose(self, list(range(self.ndim))[::-1])

    def numel(self):
        return self._data.numel()

    def element_size(self):
        return self._data.element_size()

    def dim(self):
        return self.ndim

    def rank(self):
        return self.ndim

    # -- conversions -------------------------------------------------------
    def numpy(self):
        """A numpy copy. bfloat16 has no numpy dtype here, so a bf16
        tensor gives its raw bits as uint16, as Paddle's own does."""
        d = self._data.detach()
        if d.dtype == torch.bfloat16:
            return d.view(torch.int16).cpu().numpy().view(np.uint16)
        return d.cpu().resolve_conj().numpy()

    def item(self, *args):
        """numpy's `item`: no argument, one flat index or one index a dim."""
        d = self._data.detach()
        if len(args) == 1:
            return d.reshape(-1)[args[0]].item()
        return d[args].item() if args else d.item()

    def tolist(self):
        return self._data.tolist()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def astype(self, dtype):
        dt = _dtypes.convert_dtype(dtype)
        return apply(lambda x: x.to(dt), self, _name="cast")

    cast = astype

    def clone(self):
        return apply(torch.clone, self, _name="clone")

    def detach(self):
        return Tensor(self._data.detach())

    def detach_(self):
        self._data = self._data.detach()
        return self

    def cpu(self):
        return apply(lambda x: x.cpu(), self, _name="cpu")

    def cuda(self, device_id=None, blocking=True):
        dev = _device.place("gpu" if device_id is None else
                            f"gpu:{int(device_id)}")
        return apply(lambda x: x.to(dev), self, _name="cuda")

    def to(self, *args, **kwargs):
        """`to('cpu')`, `to('gpu:0')`, `to(torch.device)`, `to(dtype)`, or
        both; keyword `device=` and `dtype=` too."""
        out = self
        for a in list(args) + [kwargs.get("device"), kwargs.get("dtype")]:
            if a is None or isinstance(a, bool):
                continue
            if isinstance(a, torch.device) or (
                    isinstance(a, str) and
                    a.split(":")[0].lower() in ("cpu", "gpu", "cuda")):
                dev = _device.place(a)
                out = apply(lambda x: x.to(dev), out, _name="to")
            else:
                out = out.astype(a)
        return out

    def pin_memory(self):
        return self

    def contiguous(self):
        if self._data.is_contiguous():
            return self
        return apply(lambda x: x.contiguous(), self, _name="contiguous")

    def is_contiguous(self):
        return self._data.is_contiguous()

    # -- autograd ----------------------------------------------------------
    def backward(self, grad_tensor=None, retain_graph=False):
        from paddle_tpu_torch.core.backward import run_backward

        run_backward([self], [grad_tensor], retain_graph)

    def clear_grad(self):
        self._data.grad = None

    clear_gradient = clear_grad

    def register_hook(self, hook):
        """`hook(grad) -> grad or None` on the gradient that reaches this
        tensor (torch's `register_hook`); kept across in-place rebinds."""
        from paddle_tpu_torch.core.backward import register_tensor_hook

        return register_tensor_hook(self, hook)

    def _attach_hooks(self):
        if self._hooks and self._data.requires_grad:
            for entry in self._hooks.values():
                entry[1] = self._data.register_hook(entry[0])

    def _rebind(self, new):
        """Make `new` this tensor's data, keeping the chain rule: `new`'s
        history is the op that made it. Under no_grad a leaf that needs a
        gradient stays one, with its gradient and hooks."""
        old = self._data
        if old.requires_grad and old.is_leaf:
            if torch.is_grad_enabled():
                raise RuntimeError(
                    "a leaf Tensor that needs a gradient cannot be changed "
                    "in place while grad is enabled; wrap the update in "
                    "paddle.no_grad()")
            new = new.detach().requires_grad_(True)
            if new.shape == old.shape and new.dtype == old.dtype:
                new.grad = old.grad
            self._data = new
            self._attach_hooks()
            return self
        self._data = new
        if not old.requires_grad:
            self._attach_hooks()
        self._write_back(old)
        return self

    def _refill(self, data):
        """A fill: `data` becomes this tensor's value and its history is
        cut. It keeps its stop_gradient, and as a leaf its gradient."""
        old = self._data
        new = data.detach().to(old.device)
        if old.requires_grad:
            new.requires_grad_(True)
            if old.is_leaf and old.grad is not None and \
                    new.shape == old.shape and new.dtype == old.dtype:
                new.grad = old.grad
        self._data = new
        self._attach_hooks()
        self._write_back(old)
        return self

    def _write_back(self, old):
        """An in-place op on a `.grad` Tensor updates its owner's
        gradient."""
        owner = self._owner
        if owner is not None and owner._data.grad is old:
            owner._data.grad = self._data

    def zero_(self):
        return self._refill(torch.zeros_like(self._data))

    def fill_(self, value):
        return self._refill(torch.full_like(self._data, value))

    # -- in-place RNG refills (reference gaussian_inplace / uniform_inplace
    #    / exponential_ kernels) -------------------------------------------
    def _draw(self):
        from paddle_tpu_torch.framework import random as _rng

        return torch.empty_like(self._data, requires_grad=False), \
            _rng.generator(self._data.device)

    def normal_(self, mean=0.0, std=1.0):
        buf, gen = self._draw()
        return self._refill(buf.normal_(mean, std, generator=gen))

    def uniform_(self, min=-1.0, max=1.0, seed=0):
        buf, gen = self._draw()
        if seed:
            gen = torch.Generator(device=buf.device).manual_seed(int(seed))
        return self._refill(buf.uniform_(min, max, generator=gen))

    def exponential_(self, lam=1.0):
        buf, gen = self._draw()
        return self._refill(buf.exponential_(lam, generator=gen))

    # -- in-place helpers ---------------------------------------------------
    def copy_(self, other, *args):
        return self._refill(_as_torch(other, like=self._data))

    def set_value(self, value):
        return self._refill(_as_torch(value, like=self._data))

    def add_(self, y):
        return self._rebind(self._data + _as_torch(y, like=self._data))

    def subtract_(self, y):
        return self._rebind(self._data - _as_torch(y, like=self._data))

    def multiply_(self, y):
        return self._rebind(self._data * _as_torch(y, like=self._data))

    def scale_(self, scale=1.0, bias=0.0):
        return self._rebind(self._data * scale + bias)

    def clip_(self, min=None, max=None):
        if min is None and max is None:
            return self
        return self._rebind(torch.clamp(self._data, min, max))

    # -- python protocol ---------------------------------------------------
    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __repr__(self):
        grad_info = "" if self.stop_gradient else ", stop_gradient=False"
        body = np.array2string(
            self._data.detach().float().cpu().numpy()
            if self._data.dtype == torch.bfloat16 else self.numpy(),
            prefix="       ")
        return (f"Tensor(shape={self.shape}, "
                f"dtype={_dtypes.dtype_name(self.dtype)}, "
                f"place={self.place}{grad_info},\n       {body})")

    def __bool__(self):
        return bool(self._data)

    def __int__(self):
        return int(self._data)

    def __float__(self):
        return float(self._data)

    def __hash__(self):
        return id(self)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __format__(self, spec):
        if self.ndim == 0:
            return format(self.item(), spec)
        return repr(self)

    # math dunders are patched in paddle_tpu_torch/core/ops_patch.py


def _as_torch(x, like=None):
    """The torch tensor of a Tensor, or of Python/numpy data on `like`'s
    device (keeping a float `like`'s dtype for Python and float numpy
    data)."""
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    if like is None:
        return _torch_data(x)
    arr = np.asarray(x)
    dt = None
    if arr.dtype.kind == "f" and (like.dtype.is_floating_point
                                  or like.dtype.is_complex):
        dt = like.dtype
    return _torch_data(x, dtype=dt, place=like.device)


# --------------------------------------------------------------------------
# op application (the dispatch waist, `paddle_tpu/core/tensor.py:466`)
# --------------------------------------------------------------------------


# the auto_cast scope of this thread (`amp.auto_cast` sets `state`: the
# AMP dtype and the white and black lists), or no `state` outside one
amp_local = threading.local()

# the two hooks of the waist (`paddle_tpu/core/tensor.py:443-503`), None
# while off, so an op pays one None check for each: `_sanitizer(op_name,
# outputs)` sees every op's torch outputs (the nan/inf checker and the
# operator stats of `amp.debugging`), `_op_tracer(op_name, host_seconds)`
# every op's host time (`profiler.Profiler`)
_sanitizer = None
_op_tracer = None


def apply(fn, *tensors, _name="op"):
    """Run `fn(*torch_tensors) -> tensor | tuple(tensors)` over Tensor args
    and wrap the result (a list for several outputs). Torch records the
    graph when grad is enabled and an input needs a gradient. `_name`
    names the op: inside an auto_cast scope, the float32 inputs of a
    white-list op are cast to the AMP dtype first (the cast is recorded,
    so gradients reach the float32 inputs)."""
    datas = [t._data for t in tensors]
    st = getattr(amp_local, "state", None)
    if st is not None and _name in st["white"]:
        dt = st["dtype"]
        datas = [d.to(dt) if d.dtype == torch.float32 else d for d in datas]
    tracer = _op_tracer
    if tracer is not None:
        t0 = time.perf_counter()
        out = fn(*datas)
        tracer(_name, time.perf_counter() - t0)
    else:
        out = fn(*datas)
    multi = isinstance(out, (tuple, list))
    if _sanitizer is not None:
        _sanitizer(_name, list(out) if multi else [out])
    if multi:
        return [Tensor(o) for o in out]
    return Tensor(out)


def apply_multi(fn, tensor_list, *tensors, _name="op"):
    """Like `apply` but the first argument is a list of Tensors
    (concat/stack)."""
    n = len(tensor_list)

    def wrapped(*datas):
        return fn(list(datas[:n]), *datas[n:])

    return apply(wrapped, *tensor_list, *tensors, _name=_name)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """paddle.to_tensor (reference: python/paddle/tensor/creation.py).
    Python floats take the default dtype (float32), Python ints int64, a
    numpy array keeps its dtype; `dtype` overrides. `place` defaults to
    the creation place (`framework.device.place`)."""
    if isinstance(data, Tensor):
        t = data._data.detach()
        if place is not None:
            t = t.to(_device.place(place))
        if dtype is not None:
            t = t.to(_dtypes.convert_dtype(dtype))
        return Tensor(t, stop_gradient=stop_gradient)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(_device.place(place))
        if dtype is not None:
            t = t.to(_dtypes.convert_dtype(dtype))
        return Tensor(t, stop_gradient=stop_gradient)
    if isinstance(data, (list, tuple)) and \
            any(isinstance(x, Tensor) for x in data):
        data = [x.numpy() if isinstance(x, Tensor) else x for x in data]
    return Tensor(_torch_data(data, dtype, place),
                  stop_gradient=stop_gradient)
