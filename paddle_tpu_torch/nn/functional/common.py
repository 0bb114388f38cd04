"""Common functionals (`paddle_tpu/nn/functional/common.py`; reference
`python/paddle/nn/functional/common.py`, `input.py`, `vision.py`,
`extension.py`): linear, the dropouts, embedding, one_hot, padding,
interpolation, unfold/fold, the pixel shuffles, affine_grid/grid_sample,
sequence_mask and gather_tree, in plain PyTorch.

The dropouts draw their masks from the framework generator of the input's
device (torch's generators are not the JAX package's threefry: the masks
are held to seed reproducibility and to their statistics).

`interpolate` follows Paddle's formulas (`phi/kernels/funcs/
interpolate_function.h`, the interpolate kernels): `align_corners`,
`align_mode`, nearest by truncation, bicubic with a = -0.75, `area` as
adaptive average pooling, no antialiasing, and with a `scale_factor` the
source ratio 1 / scale. The JAX package's `jax.image.resize` departs from
these (ROADMAP §C). `unfold`'s four paddings are Paddle's order [top,
left, bottom, right].
"""

import numpy as np
import torch
import torch.nn.functional as TF

from paddle_tpu_torch.core.tensor import Tensor, apply
from paddle_tpu_torch.framework import dtypes as _dtypes
from paddle_tpu_torch.framework import random as _rng
from paddle_tpu_torch.ops._common import as_input

__all__ = [
    "linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
    "embedding", "one_hot", "label_smooth", "pad", "zeropad2d",
    "interpolate", "upsample", "unfold", "fold", "cosine_similarity",
    "pixel_shuffle", "pixel_unshuffle", "channel_shuffle", "bilinear",
    "pad3d", "affine_grid", "grid_sample", "sequence_mask",
    "temporal_shift", "gather_tree",
]


def linear(x, weight, bias=None, name=None):
    """x @ weight (+ bias), weight [in, out] as Paddle stores it."""
    if bias is not None:
        return apply(lambda a, w, b: torch.matmul(a, w) + b, x, weight, bias,
                     _name="linear")
    return apply(torch.matmul, x, weight, _name="linear")


def _keep_mask(a, p, shape):
    return torch.rand(shape, device=a.device,
                      generator=_rng.generator(a.device)) < 1.0 - p


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element (or each slice along `axis`) with probability p;
    "upscale_in_train" scales the kept ones by 1 / (1 - p) in training,
    "downscale_in_infer" scales the output by (1 - p) in inference."""
    if not training or p == 0.0:
        return x if mode == "upscale_in_train" else x * (1.0 - p)

    def fn(a):
        shape = list(a.shape)
        if axis is not None:
            axes = axis if isinstance(axis, (list, tuple)) else [axis]
            keep_dims = [ax % a.ndim for ax in axes]
            shape = [s if i in keep_dims else 1 for i, s in enumerate(shape)]
        keep = _keep_mask(a, p, shape)
        if mode == "upscale_in_train":
            return torch.where(keep, a / (1.0 - p), 0.0).to(a.dtype)
        return torch.where(keep, a, 0.0).to(a.dtype)

    return apply(fn, x, _name="dropout")


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    return dropout(x, p=p, axis=[0, 1] if data_format == "NCHW" else [0, 3],
                   training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    return dropout(x, p=p, axis=[0, 1] if data_format == "NCDHW" else [0, 4],
                   training=training)


SELU_ALPHA = 1.6732632423543772
SELU_SCALE = 1.0507009873554805


def alpha_dropout(x, p=0.5, training=True, name=None):
    """Dropout that keeps a SELU network's mean and variance: dropped
    elements take the SELU's negative saturation, then an affine map."""
    if not training or p == 0.0:
        return x
    alpha_p = -SELU_ALPHA * SELU_SCALE
    a = (1.0 - p + p * alpha_p ** 2 * (1.0 - p)) ** -0.5
    b = -a * alpha_p * p
    return apply(lambda t: (a * torch.where(_keep_mask(t, p, t.shape), t,
                                            alpha_p) + b).to(t.dtype),
                 x, _name="alpha_dropout")


def embedding(x, weight, padding_idx=None, sparse=False, max_norm=None,
              norm_type=2.0, name=None):
    """Rows of weight at the ids x; the rows of `padding_idx` are 0 (and
    take no gradient). The ids are an input of the op, not a closure."""
    def fn(w, idx):
        idx = idx.to(w.device)
        out = w[idx]
        if padding_idx is not None and padding_idx >= 0:
            out = torch.where((idx != padding_idx)[..., None], out, 0.0)
        return out

    return apply(fn, weight, as_input(x, weight._data), _name="embedding")


def one_hot(x, num_classes, name=None):
    return apply(lambda idx: TF.one_hot(idx.long(), num_classes).to(
        torch.float32), as_input(x), _name="one_hot")


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is None:
        return apply(lambda lab: (1.0 - epsilon) * lab +
                     epsilon / lab.shape[-1], label, _name="label_smooth")
    return apply(lambda lab, prior: (1.0 - epsilon) * lab +
                 epsilon * prior.to(lab.device),
                 label, as_input(prior_dist, label._data),
                 _name="label_smooth")


# numpy's pad modes, which give the source index of every padded position
_INDEX_MODES = {"reflect": "reflect", "replicate": "edge",
                "circular": "wrap"}


def _pad_width(x, pad, data_format):
    """Per-dim (before, after) from Paddle's pad list: 2 * ndim entries
    for every dim in order, else pairs for the spatial dims, innermost
    first."""
    if isinstance(pad, Tensor):
        pad = pad.tolist()
    pad = [int(p) for p in pad]
    nd = x.ndim
    if len(pad) == 2 * nd:
        return [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    width = [(0, 0)] * nd
    spatial = list(range(2, nd)) if data_format.startswith("NC") else \
        list(range(1, nd - 1))
    spatial = spatial[-(len(pad) // 2):]
    for i, d in enumerate(reversed(spatial)):
        width[d] = (pad[2 * i], pad[2 * i + 1])
    return width


def _pad_torch(a, width, mode, value):
    if mode == "constant":
        flat = [p for lo_hi in reversed(width) for p in lo_hi]
        return TF.pad(a, flat, mode="constant", value=value)
    np_mode = _INDEX_MODES[mode]
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            src = np.pad(np.arange(a.shape[d]), (lo, hi), mode=np_mode)
            a = a.index_select(d, torch.as_tensor(src, device=a.device))
    return a


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",
        pad_from_left_axis=True, name=None):
    if mode not in ("constant", *_INDEX_MODES):
        raise ValueError(f"pad: unknown mode {mode!r}")
    width = _pad_width(x, pad, data_format)
    return apply(lambda a: _pad_torch(a, width, mode, value), x, _name="pad")


def zeropad2d(x, padding, data_format="NCHW", name=None):
    return pad(x, padding, mode="constant", value=0.0,
               data_format=data_format)


# -- interpolate -------------------------------------------------------------


def _src_index(out_n, ratio, device, half_pixel):
    """Paddle's source coordinate of each output position, in f32 as its
    kernels compute it: ratio (dst + 0.5) - 0.5 clamped at 0, or ratio
    dst."""
    dst = torch.arange(out_n, dtype=torch.float32, device=device)
    r = torch.tensor(ratio, dtype=torch.float32, device=device)
    if half_pixel:
        return torch.clamp(r * (dst + 0.5) - 0.5, min=0.0)
    return r * dst


def _along(a, axis, idx, w=None):
    """a gathered at idx along axis, times the weights w (broadcast along
    that axis) when given."""
    g = a.index_select(axis, idx)
    if w is None:
        return g
    shape = [1] * a.ndim
    shape[axis] = w.shape[0]
    return g * w.reshape(shape).to(a.dtype)


def _cubic_weights(t, a=-0.75):
    """Keys' cubic convolution weights of the taps at -1, 0, 1, 2 for a
    fraction t (Paddle's and torch's bicubic, a = -0.75)."""
    def near(x):   # |x| <= 1
        return ((a + 2) * x - (a + 3)) * x * x + 1

    def far(x):    # 1 < |x| < 2
        return ((a * x - 5 * a) * x + 8 * a) * x - 4 * a

    return [far(t + 1), near(t), near(1 - t), far(2 - t)]


def _resize_axis(a, axis, out_n, ratio, mode, align_corners, align_mode):
    in_n = a.shape[axis]
    dev = a.device
    if mode == "nearest":
        src = _src_index(out_n, ratio, dev, False)
        idx = torch.floor(src + 0.5) if align_corners else torch.floor(src)
        return _along(a, axis, idx.long().clamp(0, in_n - 1))
    if mode == "cubic":
        dst = torch.arange(out_n, dtype=torch.float32, device=dev)
        r = torch.tensor(ratio, dtype=torch.float32, device=dev)
        src = r * dst if align_corners else r * (dst + 0.5) - 0.5
        base = torch.floor(src)
        t = src - base
        out = 0
        for j, w in enumerate(_cubic_weights(t)):
            idx = (base.long() - 1 + j).clamp(0, in_n - 1)
            out = out + _along(a, axis, idx, w)
        return out
    half = align_mode == 0 and not align_corners
    src = _src_index(out_n, ratio, dev, half)
    i0 = torch.floor(src).long().clamp(0, in_n - 1)
    i1 = torch.clamp(i0 + 1, max=in_n - 1)
    lam = src - i0.to(torch.float32)
    return _along(a, axis, i0, 1.0 - lam) + _along(a, axis, i1, lam)


_MODES = {"nearest": "nearest", "linear": "linear", "bilinear": "linear",
          "trilinear": "linear", "bicubic": "cubic", "area": "area"}


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial dims of x [N, C, *spatial] (or channels last)
    by Paddle's formulas: `nearest` (src = floor(ratio dst), or
    round(ratio dst) with align_corners), `linear` / `bilinear` /
    `trilinear` (one axis after another; half-pixel sources clamped at 0
    when align_mode is 0 and align_corners is off, else src = ratio dst),
    `bicubic` (a = -0.75, indices clamped), `area` (adaptive average
    pooling). ratio = (in - 1) / (out - 1) with align_corners, else 1 /
    scale_factor when one is given, else in / out."""
    if mode not in _MODES:
        raise ValueError(f"interpolate: unknown mode {mode!r}")
    kind = _MODES[mode]
    cf = data_format.startswith("NC")
    nsp = x.ndim - 2
    spatial = x.shape[2:] if cf else x.shape[1:-1]
    scales = None
    if size is not None:
        if isinstance(size, Tensor):
            size = size.tolist()
        if isinstance(size, int):
            size = [size] * nsp
        out_sp = [int(s.item()) if isinstance(s, Tensor) else int(s)
                  for s in size]
    else:
        if isinstance(scale_factor, Tensor):
            scale_factor = scale_factor.tolist()
        scales = ([float(scale_factor)] * nsp
                  if isinstance(scale_factor, (int, float))
                  else [float(s) for s in scale_factor])
        out_sp = [int(s * f) for s, f in zip(spatial, scales)]

    def fn(a):
        if not cf:
            a = a.movedim(-1, 1)
        if kind == "area":
            pool = (TF.adaptive_avg_pool1d, TF.adaptive_avg_pool2d,
                    TF.adaptive_avg_pool3d)[nsp - 1]
            out = pool(a, out_sp)
        else:
            out = a
            for d, (n_in, n_out) in enumerate(zip(spatial, out_sp)):
                if align_corners:
                    ratio = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
                elif scales is not None and scales[d] > 0:
                    ratio = 1.0 / scales[d]
                else:
                    ratio = n_in / n_out
                out = _resize_axis(out, 2 + d, n_out, ratio, kind,
                                   align_corners, align_mode)
        return out if cf else out.movedim(1, -1)

    return apply(fn, x, _name="interpolate")


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def _tlbr(paddings):
    """Paddle's unfold/fold paddings as (top, bottom, left, right): an
    int, [h, w], or [top, left, bottom, right]."""
    p = paddings if isinstance(paddings, (list, tuple)) else [paddings] * 2
    if len(p) == 2:
        return p[0], p[0], p[1], p[1]
    return p[0], p[2], p[1], p[3]


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: x [N, C, H, W] -> [N, C * kh * kw, L]."""
    top, bottom, left, right = _tlbr(paddings)

    def fn(a):
        a = TF.pad(a, (left, right, top, bottom))
        return TF.unfold(a, _pair(kernel_sizes), dilation=_pair(dilations),
                         stride=_pair(strides))

    return apply(fn, x, _name="unfold")


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the inverse of unfold: overlapping patches are summed."""
    top, bottom, left, right = _tlbr(paddings)
    oh, ow = _pair(output_sizes)

    def fn(a):
        full = TF.fold(a, (oh + top + bottom, ow + left + right),
                       _pair(kernel_sizes), dilation=_pair(dilations),
                       stride=_pair(strides))
        return full[:, :, top:top + oh, left:left + ow]

    return apply(fn, x, _name="fold")


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    def fn(a, b):
        num = torch.sum(a * b, dim=axis)
        den = torch.sqrt(torch.sum(a * a, dim=axis)) * \
            torch.sqrt(torch.sum(b * b, dim=axis))
        return num / torch.clamp(den, min=eps)

    return apply(fn, x1, x2, _name="cosine_similarity")


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor

    def fn(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            a = a.reshape(n, c // (r * r), r, r, h, w)
            return a.permute(0, 1, 4, 2, 5, 3).reshape(n, c // (r * r),
                                                       h * r, w * r)
        n, h, w, c = a.shape
        a = a.reshape(n, h, w, c // (r * r), r, r)
        return a.permute(0, 1, 4, 2, 5, 3).reshape(n, h * r, w * r,
                                                   c // (r * r))

    return apply(fn, x, _name="pixel_shuffle")


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor

    def fn(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            a = a.reshape(n, c, h // r, r, w // r, r)
            return a.permute(0, 1, 3, 5, 2, 4).reshape(n, c * r * r, h // r,
                                                       w // r)
        n, h, w, c = a.shape
        a = a.reshape(n, h // r, r, w // r, r, c)
        return a.permute(0, 2, 4, 5, 1, 3).reshape(n, h // r, w // r,
                                                   c * r * r)

    return apply(fn, x, _name="pixel_unshuffle")


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    def fn(a):
        if data_format == "NCHW":
            n, c, h, w = a.shape
            return a.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
                .reshape(n, c, h, w)
        n, h, w, c = a.shape
        return a.reshape(n, h, w, groups, c // groups).transpose(3, 4) \
            .reshape(n, h, w, c)

    return apply(fn, x, _name="channel_shuffle")


def bilinear(x1, x2, weight, bias=None, name=None):
    def fn(a, b, w, *bb):
        out = torch.einsum("bi,oij,bj->bo", a, w, b)
        return out + bb[0] if bb else out

    args = (x1, x2, weight) + ((bias,) if bias is not None else ())
    return apply(fn, *args, _name="bilinear")


def pad3d(x, paddings, mode="constant", value=0.0, data_format="NCDHW",
          name=None):
    """5-D padding; paddings [left, right, top, bottom, front, back] for
    W, H, D."""
    l, r, t, b, f, bk = paddings
    if data_format == "NCDHW":
        width = [(0, 0), (0, 0), (f, bk), (t, b), (l, r)]
    else:
        width = [(0, 0), (f, bk), (t, b), (l, r), (0, 0)]
    return apply(lambda a: _pad_torch(a, width, mode, value), x,
                 _name="pad3d")


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """Affine sampling grid: theta [N, 2, 3] -> [N, H, W, 2], or [N, 3, 4]
    -> [N, D, H, W, 3]."""
    shape = [int(s) for s in (out_shape.tolist() if isinstance(
        out_shape, Tensor) else out_shape)]

    def lin(n, th):
        half = 1.0 if align_corners else 1.0 - 1.0 / n
        return torch.linspace(-half, half, n, dtype=th.dtype,
                              device=th.device)

    def fn(th):
        if len(shape) == 4:
            _, _, h, w = shape
            ys, xs = torch.meshgrid(lin(h, th), lin(w, th), indexing="ij")
            base = torch.stack([xs, ys, torch.ones_like(xs)], -1)
            return torch.einsum("hwk,nck->nhwc", base, th)
        _, _, d, h, w = shape
        zs, ys, xs = torch.meshgrid(lin(d, th), lin(h, th), lin(w, th),
                                    indexing="ij")
        base = torch.stack([xs, ys, zs, torch.ones_like(xs)], -1)
        return torch.einsum("dhwk,nck->ndhwc", base, th)

    return apply(fn, theta, _name="affine_grid")


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample x [N, C, H, W] at grid [N, H', W', 2] locations in [-1, 1]:
    bilinear or nearest, with zeros, border or reflection padding."""
    def fn(a, g):
        n, c, h, w = a.shape
        gx, gy = g[..., 0], g[..., 1]

        def unnorm(u, size):
            if align_corners:
                return (u + 1) * (size - 1) / 2
            return ((u + 1) * size - 1) / 2

        fx, fy = unnorm(gx, w), unnorm(gy, h)

        def reflect(u, size):
            if size == 1:
                return torch.zeros_like(u)
            span = 2.0 * (size - 1)
            u = torch.remainder(torch.abs(u), span)
            return torch.minimum(u, span - u)

        def sample_at(ix, iy):
            inside = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
            if padding_mode == "reflection":
                ixc, iyc = reflect(ix, w), reflect(iy, h)
            else:
                ixc, iyc = ix.clamp(0, w - 1), iy.clamp(0, h - 1)
            if padding_mode in ("border", "reflection"):
                inside = torch.ones_like(inside)
            bidx = torch.arange(n, device=a.device).reshape(n, 1, 1)
            vals = a[bidx, :, iyc.long(), ixc.long()]     # [N, H', W', C]
            vals = torch.where(inside[..., None], vals, 0.0)
            return vals.movedim(-1, 1)

        if mode == "nearest":
            return sample_at(torch.round(fx), torch.round(fy))
        x0, y0 = torch.floor(fx), torch.floor(fy)
        x1, y1 = x0 + 1, y0 + 1
        wa = (x1 - fx) * (y1 - fy)
        wb = (fx - x0) * (y1 - fy)
        wc = (x1 - fx) * (fy - y0)
        wd = (fx - x0) * (fy - y0)
        return (sample_at(x0, y0) * wa[:, None] +
                sample_at(x1, y0) * wb[:, None] +
                sample_at(x0, y1) * wc[:, None] +
                sample_at(x1, y1) * wd[:, None])

    return apply(fn, x, grid, _name="grid_sample")


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """mask[i.., j] = j < x[i..]; maxlen=None takes x.max()."""
    x = as_input(x)
    if maxlen is None:
        maxlen = int(apply(torch.amax, x, _name="max"))
    dt = _dtypes.convert_dtype(dtype)
    return apply(lambda lens: (torch.arange(int(maxlen), device=lens.device)
                               < lens[..., None]).to(dt),
                 x, _name="sequence_mask")


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM temporal shift of x [N * T, C, H, W]: the first shift_ratio of
    the channels come from t - 1, the next from t + 1, the rest stay."""
    def fn(a):
        if data_format == "NHWC":
            a = a.permute(0, 3, 1, 2)
        nt, c, h, w = a.shape
        v = a.reshape(nt // seg_num, seg_num, c, h, w)
        c1, c2 = int(c * shift_ratio), int(c * 2 * shift_ratio)
        padded = TF.pad(v, (0, 0, 0, 0, 0, 0, 1, 1))
        out = torch.cat([padded[:, :seg_num, :c1], padded[:, 2:, c1:c2],
                         v[:, :, c2:]], dim=2).reshape(nt, c, h, w)
        return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out

    return apply(fn, x, _name="temporal_shift")


def gather_tree(ids, parents):
    """Beam-search backtrack: from the last step, follow the parent
    pointers so each beam holds its whole ancestry. ids / parents [T,
    batch, beam]."""
    def fn(idv, par):
        beam = torch.arange(idv.shape[2], device=idv.device).expand(
            idv.shape[1:])
        toks = []
        for t in range(idv.shape[0] - 1, -1, -1):
            toks.append(torch.gather(idv[t], -1, beam))
            beam = torch.gather(par[t], -1, beam)
        return torch.stack(toks[::-1])

    return apply(fn, ids, parents, _name="gather_tree")
