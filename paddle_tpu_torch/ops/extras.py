"""The rest of the top-level namespace (`paddle_tpu/ops/extras.py`;
reference `python/paddle/__init__.py` __all__ members not covered by the
other op modules): constants, dtype helpers, small tensor ops, the place
classes and framework toggles.

Where the JAX package drops a gradient because it wraps a raw result
(`combinations`, `tensor_split`) the port keeps it, as Paddle does.
`take(mode="raise")` raises on an index out of range, as Paddle does; the
JAX package clamps. Two names reach a subsystem a later slice ports and
raise NotImplementedError naming it: `enable_static` and `disable_static`
(the static graph, ROADMAP A10f). `flops` and `summary` walk an
`nn.Layer`.
"""

from __future__ import annotations

import itertools
import math as _math

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor, apply, apply_multi
from paddle_tpu_torch.framework import device as _device
from paddle_tpu_torch.framework import dtypes as _dtypes
from paddle_tpu_torch.ops._common import raw as _raw, waits_for

__all__ = [
    "pi", "e", "inf", "nan", "newaxis", "float8_e4m3fn", "float8_e5m2",
    "dtype", "finfo", "iinfo", "is_floating_point", "is_integer",
    "is_complex", "block_diag", "cartesian_prod", "cdist", "pdist",
    "column_stack", "row_stack", "combinations", "trapezoid",
    "cumulative_trapezoid", "diagonal_scatter", "slice_scatter",
    "dsplit", "hsplit", "vsplit", "tensor_split", "frexp",
    "histogram_bin_edges", "index_fill", "isin", "isposinf", "isneginf",
    "matrix_transpose", "multigammaln", "nanquantile", "polar",
    "positive", "rank", "reverse", "sgn", "signbit", "sinc", "take",
    "unflatten", "unfold", "vander", "vecdot", "view_as",
    "bitwise_invert", "less", "enable_static", "disable_static",
    "in_dynamic_mode", "disable_signal_handler", "check_shape",
    "set_printoptions", "batch", "to_dlpack", "from_dlpack", "tolist",
    "flops", "summary", "pstring", "raw", "CPUPlace", "CUDAPlace",
    "CUDAPinnedPlace", "LazyGuard", "as_strided",
]

# -- constants (reference paddle.pi / e / inf / nan / newaxis) --------------
pi = _math.pi
e = _math.e
inf = float("inf")
nan = float("nan")
newaxis = None

float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2


class dtype:
    """paddle.dtype: `paddle.dtype("float32")` is the torch dtype."""

    def __new__(cls, name):
        return _dtypes.convert_dtype(name)


def finfo(dt):
    return torch.finfo(_dtypes.convert_dtype(dt))


def iinfo(dt):
    return torch.iinfo(_dtypes.convert_dtype(dt))


def _dt(x):
    if isinstance(x, Tensor):
        return x.dtype
    if isinstance(x, torch.dtype):
        return x
    return torch.as_tensor(np.asarray(x)).dtype


def is_floating_point(x):
    return _dt(x).is_floating_point


def is_integer(x):
    d = _dt(x)
    return not (d.is_floating_point or d.is_complex or d == torch.bool)


def is_complex(x):
    return _dt(x).is_complex


# -- small tensor ops --------------------------------------------------------


def block_diag(inputs, name=None):
    return apply_multi(lambda ms: torch.block_diag(*ms), list(inputs),
                       _name="block_diag")


def cartesian_prod(x, name=None):
    def fn(arrs):
        grids = torch.meshgrid(*arrs, indexing="ij")
        return torch.stack([g.reshape(-1) for g in grids], dim=-1)

    return apply_multi(fn, list(x), _name="cartesian_prod")


def _p_dist(d, p):
    if p == 2.0:
        return torch.sqrt(torch.sum(d * d, dim=-1))
    return torch.sum(d ** p, dim=-1) ** (1.0 / p)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    return apply(lambda a, b: _p_dist(
        torch.abs(a[..., :, None, :] - b[..., None, :, :]), p), x, y,
        _name="cdist")


def pdist(x, p=2.0, name=None):
    def fn(a):
        n = a.shape[0]
        full = _p_dist(torch.abs(a[:, None, :] - a[None, :, :]), p)
        iu = torch.triu_indices(n, n, 1, device=a.device)
        return full[iu[0], iu[1]]

    return apply(fn, x, _name="pdist")


def column_stack(x, name=None):
    return apply_multi(lambda ms: torch.column_stack(ms), list(x),
                       _name="column_stack")


def row_stack(x, name=None):
    return apply_multi(lambda ms: torch.vstack(ms), list(x),
                       _name="row_stack")


def combinations(x, r=2, with_replacement=False, name=None):
    n = x.shape[0]
    it = (itertools.combinations_with_replacement(range(n), r)
          if with_replacement else itertools.combinations(range(n), r))
    idx = torch.as_tensor(np.asarray(list(it), np.int64).reshape(-1, r))
    return apply(lambda a: a[idx.to(a.device)], x, _name="combinations")


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    if x is not None:
        return apply(lambda yv, xv: torch.trapezoid(yv, xv, dim=axis), y, x,
                     _name="trapezoid")
    return apply(lambda yv: torch.trapezoid(
        yv, dx=dx if dx is not None else 1.0, dim=axis), y,
        _name="trapezoid")


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    def fn(yv, *rest):
        y1 = torch.movedim(yv, axis, -1)
        if rest:
            xx = torch.movedim(rest[0], axis, -1) \
                if rest[0].ndim == yv.ndim else rest[0]
            dxs = torch.diff(xx, dim=-1)
        else:
            dxs = dx if dx is not None else 1.0
        avg = (y1[..., 1:] + y1[..., :-1]) / 2.0
        return torch.movedim(torch.cumsum(avg * dxs, dim=-1), -1, axis)

    args = [y] + ([x] if x is not None else [])
    return apply(fn, *args, _name="cumulative_trapezoid")


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    return apply(lambda a, b: torch.diagonal_scatter(a, b, offset, axis1,
                                                     axis2), x, y,
                 _name="diagonal_scatter")


def slice_scatter(x, value, axes, starts, ends, strides, name=None):
    def fn(a, v):
        sl = [slice(None)] * a.ndim
        for ax, st, en, sp in zip(axes, starts, ends, strides):
            sl[ax] = slice(st, en, sp)
        out = a.clone()
        out[tuple(sl)] = v.to(a.dtype)
        return out

    return apply(fn, x, value, _name="slice_scatter")


def dsplit(x, num_or_indices, name=None):
    from paddle_tpu_torch.ops.manipulation import split

    return split(x, num_or_indices, axis=2)


def hsplit(x, num_or_indices, name=None):
    from paddle_tpu_torch.ops.manipulation import split

    return split(x, num_or_indices, axis=1 if x.ndim > 1 else 0)


def vsplit(x, num_or_indices, name=None):
    from paddle_tpu_torch.ops.manipulation import split

    return split(x, num_or_indices, axis=0)


def tensor_split(x, num_or_indices, axis=0, name=None):
    """numpy's array_split: an int gives that many near-equal pieces, a
    list the split points."""
    sections = num_or_indices if isinstance(num_or_indices, int) else \
        [int(i) for i in num_or_indices]
    return apply(lambda a: list(torch.tensor_split(a, sections, dim=axis)),
                 x, _name="tensor_split")


def frexp(x, name=None):
    def fn(a):
        m, ex = torch.frexp(a)
        return m, ex.to(torch.int32)

    return apply(fn, x, _name="frexp")


def histogram_bin_edges(input, bins=100, min=0, max=0, name=None):
    d = input._data
    lo, hi = ((float(d.min()), float(d.max())) if min == 0 and max == 0
              else (min, max))
    return Tensor(torch.linspace(lo, hi, bins + 1, dtype=torch.float32,
                                 device=d.device))


def index_fill(x, index, axis, value, name=None):
    return apply(lambda a, idx: torch.index_fill(a, axis, idx, value), x,
                 index, _name="index_fill")


def isin(x, test_x, assume_unique=False, invert=False, name=None):
    return apply(lambda a, t: torch.isin(a, t, invert=invert), x, test_x,
                 _name="isin")


def isposinf(x, name=None):
    return apply(torch.isposinf, x, _name="isposinf")


def isneginf(x, name=None):
    return apply(torch.isneginf, x, _name="isneginf")


def matrix_transpose(x, name=None):
    return apply(lambda a: a.transpose(-1, -2), x, _name="matrix_transpose")


def multigammaln(x, p, name=None):
    return apply(lambda a: torch.special.multigammaln(a, p), x,
                 _name="multigammaln")


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    """numpy's nanquantile: q a float or a list (a leading q dim), over
    one axis, several (moved to the end and flattened) or all."""
    def fn(a):
        qs = torch.as_tensor(q, dtype=a.dtype, device=a.device)
        if axis is None:
            out = torch.nanquantile(a.reshape(-1), qs, dim=0,
                                    interpolation=interpolation)
            if keepdim:
                out = out.reshape(tuple(qs.shape) + (1,) * a.ndim)
            return out
        axes = [axis] if isinstance(axis, int) else list(axis)
        axes = [ax % a.ndim for ax in axes]
        rest = [d for d in range(a.ndim) if d not in axes]
        m = a.permute(rest + axes).reshape(
            [a.shape[d] for d in rest] + [-1])
        out = torch.nanquantile(m, qs, dim=-1, interpolation=interpolation)
        if keepdim:
            shape = [1 if d in axes else a.shape[d] for d in range(a.ndim)]
            out = out.reshape(tuple(qs.shape) + tuple(shape))
        return out

    return apply(fn, x, _name="nanquantile")


def polar(abs, angle, name=None):
    return apply(lambda r, t: torch.polar(r, t).to(torch.complex64), abs,
                 angle, _name="polar")


def positive(x, name=None):
    return apply(lambda a: +a, x, _name="positive")


def rank(input, name=None):
    d = input._data.device if isinstance(input, Tensor) else _device.place()
    return Tensor(torch.tensor(input.ndim if hasattr(input, "ndim") else
                               np.ndim(input), dtype=torch.int32, device=d))


def reverse(x, axis, name=None):
    from paddle_tpu_torch.ops.manipulation import flip

    return flip(x, axis)


def sgn(x, name=None):
    return apply(torch.sgn, x, _name="sgn")


def signbit(x, name=None):
    return apply(torch.signbit, x, _name="signbit")


def sinc(x, name=None):
    return apply(torch.sinc, x, _name="sinc")


def take(x, index, mode="raise", name=None):
    """Flat gather (reference paddle.take): 'raise' takes indices in [-n,
    n) and raises on others, 'wrap' wraps them modulo n, 'clip' clamps
    them to [0, n - 1]."""
    if mode not in ("raise", "wrap", "clip"):
        raise ValueError(f"take: mode {mode!r} is not raise, wrap or clip")

    def fn(a, i):
        flat = a.reshape(-1)
        n = flat.shape[0]
        if mode == "wrap":
            i = torch.remainder(i, n)
        elif mode == "clip":
            i = i.clamp(0, n - 1)
        else:
            if i.numel() and (int(i.min()) < -n or int(i.max()) >= n):
                raise IndexError(f"take: an index is out of range for "
                                 f"{n} elements")
            i = torch.where(i < 0, i + n, i)
        return flat[i]

    return apply(fn, x, index, _name="take")


def unflatten(x, axis, shape, name=None):
    return apply(lambda a: a.unflatten(axis % a.ndim, tuple(shape)), x,
                 _name="unflatten")


def unfold(x, axis, size, step, name=None):
    """The windows of `size` every `step` along `axis`, the window dim
    last (Tensor.unfold)."""
    return apply(lambda a: a.unfold(axis % a.ndim, size, step), x,
                 _name="unfold")


def vander(x, n=None, increasing=False, name=None):
    """Columns x^0 .. x^(n-1) (decreasing powers unless `increasing`),
    built by products so that the gradient at x = 0 is finite."""
    def fn(a):
        cols = [torch.ones_like(a)]
        for _ in range((a.shape[0] if n is None else n) - 1):
            cols.append(cols[-1] * a)
        return torch.stack(cols if increasing else cols[::-1], dim=-1)

    return apply(fn, x, _name="vander")


def vecdot(x, y, axis=-1, name=None):
    return apply(lambda a, b: torch.sum(a * b, dim=axis), x, y,
                 _name="vecdot")


def view_as(x, other, name=None):
    return apply(lambda a: a.reshape(list(other.shape)), x, _name="view_as")


def bitwise_invert(x, out=None, name=None):
    from paddle_tpu_torch.ops.math import bitwise_not

    return bitwise_not(x)


def less(x, y, name=None):
    from paddle_tpu_torch.ops.logic import less_than

    return less_than(x, y)


def t_alias(x, name=None):
    return apply(lambda a: a.permute(*reversed(range(a.ndim))), x, _name="t")


# -- framework toggles / misc ------------------------------------------------


def enable_static():
    raise waits_for("enable_static", "A10f", "the static graph")


def disable_static():
    raise waits_for("disable_static", "A10f", "the static graph")


def in_dynamic_mode():
    return True


def disable_signal_handler():
    pass  # no native signal handlers are installed


def check_shape(shape):
    for d in (shape or []):
        if isinstance(d, int) and d < -1:
            raise ValueError(f"invalid dim {d} in shape {shape}")


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    kw = {k: v for k, v in (("precision", precision),
                            ("threshold", threshold),
                            ("edgeitems", edgeitems),
                            ("linewidth", linewidth)) if v is not None}
    np.set_printoptions(**kw)
    torch.set_printoptions(sci_mode=sci_mode, **kw)


def batch(reader, batch_size, drop_last=False):
    """Legacy reader batching decorator (reference `paddle.batch`)."""
    def batched():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batched


def to_dlpack(x):
    return torch.utils.dlpack.to_dlpack(_raw(x))


def from_dlpack(capsule):
    return Tensor(torch.utils.dlpack.from_dlpack(capsule))


def tolist(x):
    return x.tolist() if isinstance(x, Tensor) else np.asarray(x).tolist()


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Model FLOPs estimate (reference `paddle.flops` / hapi dynamic_flops):
    counts matmul/conv MACs via a shape-driven walk of the layers."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn

    total = [0]

    def hook(layer, ins, out):
        x = ins[0]
        if isinstance(layer, nn.Linear):
            total[0] += 2 * int(np.prod(x.shape)) * layer.weight.shape[-1]
        elif hasattr(layer, "weight") and getattr(layer, "_kernel_size",
                                                  None) is not None:
            w = layer.weight
            total[0] += 2 * int(np.prod(out[0].shape if isinstance(
                out, (tuple, list)) else out.shape)) \
                * int(np.prod(w.shape[1:]))

    handles = [l.register_forward_post_hook(hook)
               for l in net.sublayers(include_self=True)]
    try:
        net(paddle.zeros(list(input_size)))
    finally:
        for h in handles:
            h.remove()
    if print_detail:
        print(f"Total FLOPs: {total[0]}")
    return total[0]


def summary(net, input_size=None, dtypes=None, input=None):
    """Layer/parameter summary (reference `paddle.summary` / hapi): prints
    a per-layer table and returns {'total_params', 'trainable_params'}."""
    rows = []
    total = trainable = 0
    for name, sub in net.named_sublayers(include_self=True):
        n_p = 0
        for p in sub.parameters(include_sublayers=False) \
                if hasattr(sub, "parameters") else []:
            n_p += int(np.prod(p.shape))
            if not p.stop_gradient:
                trainable += int(np.prod(p.shape))
        total += n_p
        if n_p:
            rows.append((name or type(sub).__name__,
                         type(sub).__name__, n_p))
    width = max((len(r[0]) for r in rows), default=10) + 2
    print(f"{'Layer'.ljust(width)}{'Type'.ljust(20)}Params")
    for nm, ty, n_p in rows:
        print(f"{nm.ljust(width)}{ty.ljust(20)}{n_p}")
    print(f"Total params: {total}")
    return {"total_params": total, "trainable_params": trainable}


# dtype-name compat strings
pstring = "pstring"
raw = "raw"


class CPUPlace:
    """reference `paddle.CPUPlace`: the CPU, as `device` (a torch.device)
    for `to_tensor(place=...)` and `set_device`."""

    device = torch.device("cpu")

    def __repr__(self):
        return "Place(cpu)"


class CUDAPlace:
    """reference `paddle.CUDAPlace(id)`: card `id`, as `device`."""

    def __init__(self, device_id=0):
        self.device_id = int(device_id)
        self.device = torch.device("cuda", self.device_id)

    def get_device_id(self):
        return self.device_id

    def __repr__(self):
        return f"Place(gpu:{self.device_id})"


class CUDAPinnedPlace:
    """reference `paddle.CUDAPinnedPlace`: host memory the card reads
    directly; tensors placed there live on the CPU."""

    device = torch.device("cpu")

    def __repr__(self):
        return "Place(gpu_pinned)"


class LazyGuard:
    """reference `paddle.LazyGuard`: parameters are made eagerly, so this
    is a pass-through scope."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def as_strided(x, shape, stride, offset=0, name=None):
    """reference `paddle.as_strided`: the elements of x's logical
    (row-major) order at offset + sum_i idx_i * stride_i, gathered, so
    that the result does not depend on x's storage layout."""
    def fn(a):
        flat = a.reshape(-1)
        lin = torch.full((), offset, dtype=torch.int64, device=a.device)
        for i, (s, st) in enumerate(zip(shape, stride)):
            view = [1] * len(shape)
            view[i] = s
            lin = lin + (torch.arange(s, device=a.device) * st).reshape(view)
        return flat[lin.reshape(-1)].reshape(list(shape))

    return apply(fn, x, _name="as_strided")
