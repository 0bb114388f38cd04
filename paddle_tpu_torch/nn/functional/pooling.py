"""Pooling (`paddle_tpu/nn/functional/pooling.py`; reference
`python/paddle/nn/functional/pooling.py`, kernels `phi/kernels/funcs/
pooling.cc`) in plain PyTorch.

Max, average and Lp pooling take their windows by `Tensor.unfold` over
the input padded as Paddle pads it: explicit (before, after) pairs or
"SAME" / "VALID", and with `ceil_mode` the last window may run past the
end (out = ceil((in + pads - k) / stride) + 1). Average pooling with
`exclusive` divides by the window's elements inside the input, else by
the kernel's size (or `divisor_override`). `return_mask` gives the flat
index of each maximum within its (N, C) spatial slab, the input
`max_unpool` takes. Adaptive pooling uses the bins [floor(i in / out),
ceil((i + 1) in / out)). The JAX package ignores `ceil_mode` and
`divisor_override` and divides "SAME" windows by the kernel's size
(ROADMAP §C).
"""

import numpy as np
import torch
import torch.nn.functional as TF

from paddle_tpu_torch.core.tensor import apply
from paddle_tpu_torch.framework import random as _rng

__all__ = [
    "max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d",
    "avg_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d", "lp_pool2d", "max_unpool1d", "max_unpool2d",
    "max_unpool3d", "fractional_max_pool2d", "fractional_max_pool3d",
]


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _plan(spatial, kernel, stride, padding, ceil_mode):
    """(k, s, [(before, after)] with the ceil-mode overhang added to
    `after`, the output sizes) of a pool over `spatial`."""
    n = len(spatial)
    k = _tuple(kernel, n)
    s = _tuple(stride if stride is not None else kernel, n)
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            pairs = [(0, 0)] * n
        else:
            pairs = []
            for size, kk, ss in zip(spatial, k, s):
                total = max((-(-size // ss) - 1) * ss + kk - size, 0)
                pairs.append((total // 2, total - total // 2))
    elif isinstance(padding, int):
        pairs = [(padding, padding)] * n
    else:
        p = [int(v) for v in padding]
        pairs = ([(v, v) for v in p] if len(p) == n else
                 [(p[2 * i], p[2 * i + 1]) for i in range(n)])
    outs, full = [], []
    for size, kk, ss, (lo, hi) in zip(spatial, k, s, pairs):
        span = size + lo + hi - kk
        o = (-(-span // ss) if ceil_mode else span // ss) + 1
        outs.append(o)
        full.append((lo, (o - 1) * ss + kk - size - lo))
    return k, s, full, outs


def _windows(a, k, s, pairs, fill):
    """a [N, C, *spatial] padded by `pairs` with `fill`, as windows [N, C,
    *out, *k]."""
    flat = [p for pair in reversed(pairs) for p in pair]
    out = TF.pad(a, flat, value=fill) if any(flat) else a
    for d, (kk, ss) in enumerate(zip(k, s)):
        out = out.unfold(2 + d, kk, ss)
    return out


def _channels_first(a, cf):
    return a if cf else a.movedim(-1, 1)


def _back(a, cf):
    return a if cf else a.movedim(1, -1)


def _reduce_pool(x, kernel, stride, padding, n, data_format, kind,
                 ceil_mode=False, exclusive=True, divisor=None):
    cf = data_format.startswith("NC")

    def fn(a):
        a = _channels_first(a, cf)
        k, s, pairs, _ = _plan(a.shape[2:], kernel, stride, padding,
                               ceil_mode)
        dims = tuple(range(-n, 0))
        if kind == "max":
            win = _windows(a, k, s, pairs, float("-inf"))
            return _back(win.amax(dim=dims), cf)
        total = _windows(a, k, s, pairs, 0.0).sum(dim=dims)
        if divisor:
            count = divisor
        elif exclusive:
            count = _windows(torch.ones_like(a[:1, :1]), k, s, pairs,
                             0.0).sum(dim=dims)
        else:
            count = float(np.prod(k))
        return _back(total / count if kind == "avg" else total, cf)

    return apply(fn, x, _name=f"{kind}_pool{n}d")


def _max_pool_with_index(x, kernel, stride, padding, n, data_format,
                         ceil_mode=False):
    """(max pool, the flat index of each maximum in its (N, C) spatial
    slab)."""
    cf = data_format.startswith("NC")

    def fn(a):
        a = _channels_first(a, cf)
        sp = a.shape[2:]
        k, s, pairs, outs = _plan(sp, kernel, stride, padding, ceil_mode)
        win = _windows(a, k, s, pairs, float("-inf"))
        flatwin = win.reshape(tuple(win.shape[:2 + n]) + (-1,))
        vals = flatwin.amax(dim=-1)
        off = flatwin.detach().argmax(dim=-1)
        flat = torch.zeros_like(off)
        rem = off
        for i in range(n):
            tail = int(np.prod(k[i + 1:]))
            dk, rem = rem // tail, rem % tail
            shape = [1] * off.ndim
            shape[2 + i] = outs[i]
            grid = (torch.arange(outs[i], device=a.device) * s[i]
                    - pairs[i][0]).reshape(shape)
            flat = flat * sp[i] + (dk + grid).clamp(0, sp[i] - 1)
        return _back(vals, cf), _back(flat, cf)

    return apply(fn, x, _name=f"max_pool{n}d_with_index")


def _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode, n,
              data_format):
    if return_mask:
        return _max_pool_with_index(x, kernel_size, stride, padding, n,
                                    data_format, ceil_mode)
    return _reduce_pool(x, kernel_size, stride, padding, n, data_format,
                        "max", ceil_mode)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask,
                     ceil_mode, 1, "NCL")


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask,
                     ceil_mode, 2, data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask,
                     ceil_mode, 3, data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, name=None):
    return _reduce_pool(x, kernel_size, stride, padding, 1, "NCL", "avg",
                        ceil_mode, exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _reduce_pool(x, kernel_size, stride, padding, 2, data_format,
                        "avg", ceil_mode, exclusive, divisor_override)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _reduce_pool(x, kernel_size, stride, padding, 3, data_format,
                        "avg", ceil_mode, exclusive, divisor_override)


_ADAPTIVE = {("avg", 1): TF.adaptive_avg_pool1d,
             ("avg", 2): TF.adaptive_avg_pool2d,
             ("avg", 3): TF.adaptive_avg_pool3d,
             ("max", 1): TF.adaptive_max_pool1d,
             ("max", 2): TF.adaptive_max_pool2d,
             ("max", 3): TF.adaptive_max_pool3d}


def _adaptive(x, output_size, n, data_format, kind, return_mask=False):
    cf = data_format.startswith("NC")
    spatial = x.shape[2:2 + n] if cf else x.shape[1:1 + n]
    os_ = tuple(o if o is not None else s for o, s in
                zip(output_size if isinstance(output_size, (list, tuple))
                    else (output_size,) * n, spatial))

    def fn(a):
        a = _channels_first(a, cf)
        if kind == "max" and return_mask:
            vals, idx = _ADAPTIVE[kind, n](a, os_, return_indices=True)
            return _back(vals, cf), _back(idx, cf)
        return _back(_ADAPTIVE[kind, n](a, os_), cf)

    return apply(fn, x, _name=f"adaptive_{kind}_pool{n}d")


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, "NCL", "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, data_format, "avg")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, data_format, "avg")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 1, "NCL", "max", return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 2, "NCHW", "max", return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, output_size, 3, "NCDHW", "max", return_mask)


def lp_pool2d(x, norm_type, kernel_size, stride=None, padding=0,
              ceil_mode=False, data_format="NCHW", name=None):
    """(sum of |x|^p over each window)^(1/p)."""
    p = float(norm_type)
    powed = apply(lambda a: torch.pow(torch.abs(a), p), x, _name="lp_pow")
    pooled = _reduce_pool(powed, kernel_size, stride, padding, 2,
                          data_format, "sum", ceil_mode)
    return apply(lambda a: torch.pow(a, 1.0 / p), pooled, _name="lp_root")


def _max_unpool(x, indices, n, kernel_size, stride, padding, output_size,
                data_format):
    """Scatter pooled values back to the flat positions `indices` of each
    (N, C) spatial slab (what max_poolNd(return_mask=True) gives)."""
    k = _tuple(kernel_size, n)
    s = _tuple(stride, n) if stride is not None else k
    pad = _tuple(padding, n)
    cf = data_format.startswith("NC")

    def fn(a, idx):
        a, idx = _channels_first(a, cf), _channels_first(idx, cf)
        nb, c = a.shape[:2]
        if output_size is not None:
            sp = tuple(int(v) for v in output_size)[-n:]
        else:
            sp = tuple((a.shape[2 + i] - 1) * s[i] - 2 * pad[i] + k[i]
                       for i in range(n))
        out = a.new_zeros((nb, c, int(np.prod(sp))))
        out = out.scatter(2, idx.reshape(nb, c, -1).long(),
                          a.reshape(nb, c, -1))
        return _back(out.reshape((nb, c) + sp), cf)

    return apply(fn, x, indices, _name=f"max_unpool{n}d")


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(x, indices, 1, kernel_size, stride, padding,
                       output_size, data_format)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(x, indices, 2, kernel_size, stride, padding,
                       output_size, data_format)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(x, indices, 3, kernel_size, stride, padding,
                       output_size, data_format)


def _fractional_bounds(n_in, n_out, u):
    """Pseudo-random bin edges (Graham 2014): index(i) = ceil(alpha (i +
    u)) - 1 with alpha = n_in / n_out; bin i is [index(i), index(i+1))."""
    alpha = n_in / n_out
    idx = np.ceil(alpha * (np.arange(n_out + 1) + u)).astype(np.int64) - 1
    idx[0] = 0
    idx[-1] = n_in
    return idx


def _fractional_max(x, output_size, kernel_size, random_u, return_mask, n):
    if return_mask:
        raise NotImplementedError(
            "fractional_max_pool return_mask: use return_mask=False (the "
            "mask only feeds the legacy unpool path)")
    spatial = x.shape[2:]
    outs = _tuple(output_size, n)
    if random_u is None:
        # a fresh u per call from the framework generator (paddle.seed
        # reproducible): the random regions are the regulariser
        dev = x._data.device
        u = 1e-3 + (1 - 2e-3) * float(torch.rand(
            (), device=dev, generator=_rng.generator(dev)))
    else:
        u = float(random_u)
    if not 0 < u < 1:
        raise ValueError("random_u must be in (0, 1)")
    bounds = [_fractional_bounds(spatial[d], outs[d], u) for d in range(n)]
    kmax = [int(np.max(np.diff(b))) for b in bounds]
    if kernel_size is not None:
        kmax = [max(k, m) for k, m in zip(_tuple(kernel_size, n), kmax)]

    def fn(a):
        out = a
        for d in range(n):
            b = bounds[d]
            idx = b[:-1, None] + np.arange(kmax[d])[None, :]
            valid = idx < b[1:, None]
            idx = np.minimum(idx, spatial[d] - 1)
            ax = 2 + d
            g = out.index_select(ax, torch.as_tensor(idx.reshape(-1),
                                                     device=a.device))
            g = g.reshape(out.shape[:ax] + (len(b) - 1, kmax[d])
                          + out.shape[ax + 1:])
            shape = [1] * g.ndim
            shape[ax], shape[ax + 1] = len(b) - 1, kmax[d]
            m = torch.as_tensor(valid, device=a.device).reshape(shape)
            out = torch.where(m, g, float("-inf")).amax(dim=ax + 1)
        return out

    return apply(fn, x, _name=f"fractional_max_pool{n}d")


def fractional_max_pool2d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    """Fractional max pooling (Graham 2014): bin edges from `random_u`,
    or from a u drawn from the framework generator."""
    return _fractional_max(x, output_size, kernel_size, random_u,
                           return_mask, 2)


def fractional_max_pool3d(x, output_size, kernel_size=None, random_u=None,
                          return_mask=False, name=None):
    return _fractional_max(x, output_size, kernel_size, random_u,
                           return_mask, 3)
