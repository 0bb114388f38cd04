"""Shape and layout manipulation ops (`paddle_tpu/ops/manipulation.py`;
reference `python/paddle/tensor/manipulation.py`).

A view torch hands back (reshape, transpose, slicing) shares storage with
its input; nothing in the port writes into storage in place, so a view
behaves as the JAX package's copies do. Ops whose output shape depends on
the data (`masked_select`, `unique`, `where` with one argument) read it on
the host, as the JAX package does.
"""

import builtins

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor, apply, apply_multi, to_tensor
from paddle_tpu_torch.framework import dtypes as _dtypes
from paddle_tpu_torch.ops._common import as_tensor as _as
from paddle_tpu_torch.ops._common import int_shape as _int_shape


def _index(index, ref):
    """An index Tensor / array as a torch int64 tensor on `ref`'s device."""
    if isinstance(index, Tensor):
        t = index._data
    elif isinstance(index, torch.Tensor):
        t = index
    else:
        t = torch.as_tensor(np.asarray(index), device=ref.device)
    return t.to(ref.device).long() if t.dtype != torch.bool else t


def reshape(x, shape, name=None):
    shp = _int_shape(shape)
    return apply(lambda a: torch.reshape(a, shp), x, _name="reshape")


def reshape_(x, shape, name=None):
    return x._rebind(torch.reshape(x._data, _int_shape(shape)))


def cast(x, dtype, name=None):
    """paddle.cast (reference: python/paddle/tensor/manipulation.py cast)."""
    return x.astype(dtype)


def cast_(x, dtype, name=None):
    return x._rebind(x._data.to(_dtypes.convert_dtype(dtype)))


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return x.astype(shape_or_dtype)


def transpose(x, perm, name=None):
    perm = [int(p) for p in perm]
    return apply(lambda a: a.permute(perm), x, _name="transpose")


def t(x, name=None):
    if x.ndim < 2:
        return x
    return transpose(x, [1, 0])


def moveaxis(x, source, destination, name=None):
    return apply(lambda a: torch.movedim(a, source, destination), x,
                 _name="moveaxis")


def swapaxes(x, axis1, axis2, name=None):
    return apply(lambda a: torch.swapaxes(a, axis1, axis2), x,
                 _name="swapaxes")


def _tensors(xs):
    return [t if isinstance(t, Tensor) else to_tensor(t) for t in xs]


def concat(x, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    return apply_multi(lambda arrs: torch.cat(arrs, dim=axis), _tensors(x),
                       _name="concat")


def stack(x, axis=0, name=None):
    return apply_multi(lambda arrs: torch.stack(arrs, dim=axis), _tensors(x),
                       _name="stack")


def hstack(x, name=None):
    return apply_multi(torch.hstack, list(x), _name="hstack")


def vstack(x, name=None):
    return apply_multi(torch.vstack, list(x), _name="vstack")


def dstack(x, name=None):
    return apply_multi(torch.dstack, list(x), _name="dstack")


def split(x, num_or_sections, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(
                f"paddle.split: axis {axis} length {dim} is not divisible by "
                f"num_or_sections={num_or_sections}")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [int(s) for s in num_or_sections]
        if sizes.count(-1):
            rest = dim - builtins.sum(s for s in sizes if s >= 0)
            sizes = [rest if s == -1 else s for s in sizes]
    return apply(lambda a: list(torch.split(a, sizes, dim=axis)), x,
                 _name="split")


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    return apply(lambda a: list(torch.unbind(a, axis)), x, _name="unbind")


def squeeze(x, axis=None, name=None):
    if axis is None:
        return apply(torch.squeeze, x, _name="squeeze")
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    axes = tuple(int(a) for a in axes if x.shape[int(a)] == 1)
    return apply(lambda a: torch.squeeze(a, axes) if axes else a, x,
                 _name="squeeze")


def squeeze_(x, axis=None, name=None):
    return x._rebind(squeeze(x, axis)._data)


def _unsqueeze(a, axes):
    nd = a.dim() + len(axes)
    for ax in sorted(int(d) % nd for d in axes):
        a = a.unsqueeze(ax)
    return a


def unsqueeze(x, axis, name=None):
    if isinstance(axis, Tensor):
        axis = axis.tolist()
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return apply(lambda a: _unsqueeze(a, axes), x, _name="unsqueeze")


def unsqueeze_(x, axis, name=None):
    return x._rebind(unsqueeze(x, axis)._data)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    nd = x.ndim
    if nd == 0:
        return reshape(x, [1])
    sa, ea = start_axis % nd, stop_axis % nd
    shp = x.shape
    return reshape(x, shp[:sa] + [int(np.prod(shp[sa:ea + 1]))]
                   + shp[ea + 1:])


def expand(x, shape, name=None):
    shp = list(_int_shape(shape))
    xs = x.shape
    off = len(shp) - len(xs)
    for i, s in enumerate(shp):
        if s == -1:   # Paddle: -1 keeps this dim
            shp[i] = xs[i - off]
    return apply(lambda a: torch.broadcast_to(a, tuple(shp)), x,
                 _name="expand")


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def expand_as(x, y, name=None):
    return expand(x, y.shape)


def broadcast_tensors(inputs, name=None):
    shp = torch.broadcast_shapes(*[tuple(t.shape) for t in inputs])
    return [expand(t, list(shp)) for t in inputs]


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def tile(x, repeat_times, name=None):
    reps = _int_shape(repeat_times)
    return apply(lambda a: torch.tile(a, reps), x, _name="tile")


def repeat_interleave(x, repeats, axis=None, name=None):
    def fn(a):
        r = repeats._data if isinstance(repeats, Tensor) else repeats
        return torch.repeat_interleave(a, r, dim=axis)

    return apply(fn, x, _name="repeat_interleave")


def flip(x, axis, name=None):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    axes = tuple(int(a) for a in axes)
    return apply(lambda a: torch.flip(a, axes), x, _name="flip")


def rot90(x, k=1, axes=(0, 1), name=None):
    return apply(lambda a: torch.rot90(a, k, tuple(axes)), x, _name="rot90")


def roll(x, shifts, axis=None, name=None):
    sh = tuple(shifts) if isinstance(shifts, (list, tuple)) else shifts
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    if ax is None:
        return apply(lambda a: torch.roll(a, sh), x, _name="roll")
    return apply(lambda a: torch.roll(a, sh, ax), x, _name="roll")


def gather(x, index, axis=0, name=None):
    if isinstance(axis, Tensor):
        axis = int(axis.item())
    idx = index if isinstance(index, Tensor) else Tensor(
        torch.as_tensor(np.asarray(index), device=x._data.device))
    return apply(lambda a, i: torch.index_select(a, axis, i.reshape(-1)
                                                 .long()), x, idx,
                 _name="gather")


def gather_nd(x, index, name=None):
    def fn(a):
        idx = _index(index, a)
        return a[tuple(torch.movedim(idx, -1, 0))]

    return apply(fn, x, _name="gather_nd")


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return apply(lambda a: torch.take_along_dim(a, _index(indices, a), axis),
                 arr, _name="take_along_axis")


_REDUCE = {"add": "sum", "sum": "sum", "mul": "prod", "multiply": "prod",
           "amax": "amax", "amin": "amin"}


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    def fn(a, v):
        idx = _index(indices, a)
        v = _as(v, a).to(a.dtype)
        v = torch.broadcast_to(v, idx.shape) if v.dim() == 0 or \
            v.shape != idx.shape else v
        ax = axis % a.dim()
        if reduce == "assign":
            return torch.scatter(a, ax, idx, v)
        if reduce not in _REDUCE:
            raise ValueError(f"unknown reduce {reduce}")
        return torch.scatter_reduce(a, ax, idx, v, _REDUCE[reduce],
                                    include_self=True)

    if isinstance(values, Tensor):
        return apply(fn, arr, values, _name="put_along_axis")
    return apply(lambda a: fn(a, values), arr, _name="put_along_axis")


def scatter(x, index, updates, overwrite=True, name=None):
    def fn(a, u):
        idx = _index(index, a)
        if overwrite:
            return torch.index_put(a, (idx,), u.to(a.dtype))
        # Paddle: overwrite=False sums the updates after zeroing the rows
        zeroed = torch.index_put(a, (idx,), torch.zeros((), dtype=a.dtype,
                                                        device=a.device))
        return torch.index_put(zeroed, (idx,), u.to(a.dtype),
                               accumulate=True)

    return apply(fn, x, updates, _name="scatter")


def scatter_nd_add(x, index, updates, name=None):
    def fn(a, u):
        idx = _index(index, a)
        return torch.index_put(a, tuple(torch.movedim(idx, -1, 0)),
                               u.to(a.dtype), accumulate=True)

    return apply(fn, x, updates, _name="scatter_nd_add")


def scatter_nd(index, updates, shape, name=None):
    base = Tensor(torch.zeros(_int_shape(shape), dtype=updates.dtype,
                              device=updates._data.device))
    return scatter_nd_add(base, index, updates)


def index_select(x, index, axis=0, name=None):
    idx = index if isinstance(index, Tensor) else Tensor(
        torch.as_tensor(np.asarray(index), device=x._data.device))
    return apply(lambda a, i: torch.index_select(a, axis, i.long()), x, idx,
                 _name="index_select")


def index_sample(x, index):
    idx = index if isinstance(index, Tensor) else Tensor(
        torch.as_tensor(np.asarray(index), device=x._data.device))
    return apply(lambda a, i: torch.take_along_dim(a, i.long(), 1), x, idx,
                 _name="index_sample")


def index_add(x, index, axis, value, name=None):
    return apply(lambda a, v: torch.index_add(a, axis, _index(index, a),
                                              v.to(a.dtype)), x, value,
                 _name="index_add")


def index_put(x, indices, value, accumulate=False, name=None):
    def fn(a, v):
        idx = tuple(_index(i, a) for i in indices)
        return torch.index_put(a, idx, _as(v, a).to(a.dtype), accumulate)

    if isinstance(value, Tensor):
        return apply(fn, x, value, _name="index_put")
    return apply(lambda a: fn(a, value), x, _name="index_put")


def masked_select(x, mask, name=None):
    return apply(lambda a: torch.masked_select(a, _index(mask, a).bool()), x,
                 _name="masked_select")


def masked_fill(x, mask, value, name=None):
    def fn(a):
        v = value._data if isinstance(value, Tensor) else value
        return torch.where(_index(mask, a).bool(),
                           torch.as_tensor(v, dtype=a.dtype, device=a.device),
                           a)

    return apply(fn, x, _name="masked_fill")


def masked_scatter(x, mask, value, name=None):
    def fn(a, v):
        m = torch.broadcast_to(_index(mask, a).bool(), a.shape)
        return torch.masked_scatter(a, m, v.to(a.dtype))

    return apply(fn, x, value if isinstance(value, Tensor)
                 else to_tensor(value), _name="masked_scatter")


def where(condition, x=None, y=None, name=None):
    cond = condition._data if isinstance(condition, Tensor) else \
        torch.as_tensor(np.asarray(condition))
    if x is None and y is None:
        return [Tensor(i) for i in torch.nonzero(cond, as_tuple=True)]
    if isinstance(x, Tensor) and isinstance(y, Tensor):
        return apply(lambda a, b: torch.where(cond.to(a.device), a, b), x, y,
                     _name="where")
    if isinstance(x, Tensor):
        return apply(lambda a: torch.where(cond.to(a.device), a, _as(y, a)),
                     x, _name="where")
    if isinstance(y, Tensor):
        return apply(lambda b: torch.where(cond.to(b.device), _as(x, b), b),
                     y, _name="where")
    c = Tensor(cond)
    return apply(lambda cd: torch.where(cd, _as(x, cd), _as(y, cd)), c,
                 _name="where")


def select_scatter(x, values, axis, index, name=None):
    return apply(lambda a, v: torch.select_scatter(a, v.to(a.dtype), axis,
                                                   index), x, values,
                 _name="select_scatter")


builtins_slice = builtins.slice


def slice(input, axes, starts, ends, name=None):
    def _v(s):
        return int(s.item()) if isinstance(s, Tensor) else int(s)

    sl = [builtins_slice(None)] * input.ndim
    for ax, st, en in zip(axes, starts, ends):
        sl[ax] = builtins_slice(_v(st), _v(en))
    sl = tuple(sl)
    return apply(lambda a: a[sl], input, _name="slice")


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slicing along `axes`; a negative stride runs backwards (torch
    slicing takes positive steps only, so the backward slice is a flip of
    the forward one)."""
    def fn(a):
        for ax, st, en, sd in zip(axes, starts, ends, strides):
            st, en, sd = int(st), int(en), int(sd)
            n = a.shape[ax]
            picks = list(range(n))[builtins_slice(st, en, sd)]
            idx = torch.as_tensor(picks, dtype=torch.long, device=a.device)
            a = torch.index_select(a, ax, idx)
        return a

    return apply(fn, x, _name="strided_slice")


def crop(x, shape=None, offsets=None, name=None):
    shp = _int_shape(shape)
    offs = _int_shape(offsets) if offsets is not None else (0,) * x.ndim
    sl = tuple(builtins_slice(o, o + s) for o, s in zip(offs, shp))
    return apply(lambda a: a[sl], x, _name="crop")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """Sorted unique values (numpy's order), with the first index of each,
    the inverse and the counts as asked; index outputs in `dtype`."""
    a = x._data.detach()
    dt = _dtypes.convert_dtype(dtype)
    src = a.reshape(-1) if axis is None else a
    vals, inv, counts = torch.unique(src, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    if not (return_index or return_inverse or return_counts):
        return Tensor(vals)
    outs = [Tensor(vals)]
    if return_index:
        pos = torch.arange(inv.shape[0], device=a.device)
        first = torch.full((vals.shape[0] if axis is None
                            else vals.shape[axis],), inv.shape[0],
                           dtype=torch.long, device=a.device)
        first = first.scatter_reduce(0, inv, pos, "amin")
        outs.append(Tensor(first.to(dt)))
    if return_inverse:
        outs.append(Tensor(inv.to(dt)))
    if return_counts:
        outs.append(Tensor(counts.to(dt)))
    return tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    a = x._data.detach()
    dt = _dtypes.convert_dtype(dtype)
    src = a.reshape(-1) if axis is None else a
    vals, inv, counts = torch.unique_consecutive(
        src, return_inverse=True, return_counts=True,
        dim=None if axis is None else axis)
    out = [Tensor(vals)]
    if return_inverse:
        out.append(Tensor(inv.to(dt)))
    if return_counts:
        out.append(Tensor(counts.to(dt)))
    return out[0] if len(out) == 1 else tuple(out)


def as_complex(x, name=None):
    return apply(lambda a: torch.complex(a[..., 0], a[..., 1]), x,
                 _name="as_complex")


def as_real(x, name=None):
    return apply(lambda a: torch.stack([torch.real(a), torch.imag(a)], -1),
                 x, _name="as_real")


def numel(x, name=None):
    return Tensor(torch.tensor(x.size, dtype=torch.int64,
                               device=x._data.device))


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    shard_size = (index_num + nshards - 1) // nshards

    def fn(a):
        in_shard = torch.div(a, shard_size, rounding_mode="floor") == \
            shard_id
        return torch.where(in_shard, torch.remainder(a, shard_size),
                           torch.full_like(a, ignore_value))

    return apply(fn, input, _name="shard_index")


def tensordot(x, y, axes=2, name=None):
    ax = axes
    if isinstance(ax, (list, tuple)):
        ax = [[int(i) for i in a] if isinstance(a, (list, tuple)) else
              [int(a)] for a in ax]
    return apply(lambda a, b: torch.tensordot(a, b, dims=ax), x, y,
                 _name="tensordot")


def atleast_1d(*inputs, name=None):
    outs = [reshape(x, [1]) if x.ndim == 0 else x for x in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    outs = []
    for x in inputs:
        while x.ndim < 2:
            x = unsqueeze(x, 0)
        outs.append(x)
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    outs = []
    for x in inputs:
        while x.ndim < 3:
            x = unsqueeze(x, -1) if x.ndim >= 2 else unsqueeze(x, 0)
        outs.append(x)
    return outs[0] if len(outs) == 1 else outs


def unstack(x, axis=0, num=None, name=None):
    """Split along axis into a list of tensors (reference ops.yaml
    unstack)."""
    n = num if num is not None else x.shape[axis]
    return [squeeze(p, axis=axis) for p in split(x, n, axis=axis)]


def shape(input, name=None):
    """Shape as a 1-D int32 tensor (reference ops.yaml shape)."""
    return Tensor(torch.tensor(input.shape, dtype=torch.int32,
                               device=input._data.device))


# -- padded-sequence ops (the reference's LoD sequence stack) ----------------


def sequence_pool(x, pool_type=None, lengths=None, pad_value=0.0,
                  is_test=False, pooltype="AVERAGE", name=None):
    """Pool each sequence to one vector (reference sequence_pool op). x is
    padded [B, T, D] with `lengths` [B] marking the valid prefix (None:
    all valid). pool_type: SUM / MEAN / MAX / MIN / SQRT (sum / sqrt(len))
    / LAST / FIRST."""
    xd = x._data if isinstance(x, Tensor) else torch.as_tensor(x)
    B, T = xd.shape[0], xd.shape[1]
    dev = xd.device
    if lengths is not None:
        ln = (lengths._data if isinstance(lengths, Tensor) else
              torch.as_tensor(np.asarray(lengths))).to(dev).reshape(B).long()
    else:
        ln = torch.full((B,), T, dtype=torch.long, device=dev)
    tail = [1] * (xd.dim() - 2)
    valid = torch.arange(T, device=dev)[None, :] < ln[:, None]
    vmask = valid.reshape(B, T, *tail)
    pt = (pool_type if pool_type is not None else pooltype).upper()
    if pt == "AVERAGE":
        pt = "MEAN"
    x32 = xd.float()
    denom = torch.clamp(ln.float(), min=1.0).reshape(B, *tail)
    if pt == "SUM":
        out = torch.sum(torch.where(vmask, x32, 0.0), 1)
    elif pt == "MEAN":
        out = torch.sum(torch.where(vmask, x32, 0.0), 1) / denom
    elif pt == "SQRT":
        out = torch.sum(torch.where(vmask, x32, 0.0), 1) / torch.sqrt(denom)
    elif pt == "MAX":
        out = torch.amax(torch.where(vmask, x32, -torch.inf), 1)
    elif pt == "MIN":
        out = torch.amin(torch.where(vmask, x32, torch.inf), 1)
    elif pt == "LAST":
        idx = torch.clamp(ln - 1, min=0).reshape(B, 1, *tail)
        out = torch.take_along_dim(x32, idx, 1)[:, 0]
    elif pt == "FIRST":
        out = x32[:, 0]
    else:
        raise ValueError(f"unknown pool_type {pool_type!r}")
    return Tensor(out.to(xd.dtype))


def sequence_conv(x, weight=None, bias=None, context_length=3,
                  context_start=None, padding_data=None, filter=None,
                  padding_trainable=False, context_stride=1, lengths=None,
                  name=None):
    """Context-window sequence convolution (reference sequence_conv op):
    each position concatenates `context_length` neighbouring steps
    (starting at context_start, default -(L-1)//2) and multiplies by
    weight [context_length * D, M]. Padded [B, T, D]; context out of range
    is zero."""
    if weight is None:
        weight = filter
    if padding_trainable or padding_data is not None:
        raise NotImplementedError(
            "sequence_conv: trainable context padding is not implemented; "
            "out-of-range context is zero")
    if context_stride != 1:
        raise NotImplementedError("sequence_conv: context_stride must be 1")
    L = int(context_length)
    start = -((L - 1) // 2) if context_start is None else int(context_start)

    def fn(xd, wd, *b):
        _, T, _ = xd.shape
        t = torch.arange(T, device=xd.device)
        cols = []
        for off in range(start, start + L):
            shifted = torch.roll(xd, -off, 1)
            ok = ((t + off >= 0) & (t + off < T))[None, :, None]
            cols.append(torch.where(ok, shifted, 0))
        out = torch.cat(cols, -1) @ wd
        if b:
            out = out + b[0]
        if lengths is not None:
            ln = (lengths._data if isinstance(lengths, Tensor) else
                  torch.as_tensor(np.asarray(lengths))).to(xd.device)
            keep = t[None, :] < ln.reshape(-1)[:, None]
            out = torch.where(keep[..., None], out, 0)
        return out

    extra = () if bias is None else (bias,)
    return apply(fn, x, weight, *extra, _name="sequence_conv")


def im2sequence(x, kernels, strides=(1, 1), paddings=(0, 0, 0, 0),
                out_stride=(1, 1), name=None):
    """Sliding-window patches as a sequence (reference im2sequence op):
    x [B, C, H, W] -> [B, nH * nW, C * kh * kw], channels outermost in
    each patch."""
    kh, kw = kernels
    pu, pd, pl, pr = paddings

    def fn(xd):
        padded = torch.nn.functional.pad(xd, (pl, pr, pu, pd))
        patches = torch.nn.functional.unfold(padded, (kh, kw),
                                             stride=tuple(strides))
        return patches.transpose(1, 2)

    return apply(fn, x, _name="im2sequence")


__all__ = [n for n, v in list(globals().items())
           if not n.startswith("_") and callable(v)
           and getattr(v, "__module__", None) == __name__]
