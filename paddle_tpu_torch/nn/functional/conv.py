"""Convolutions (`paddle_tpu/nn/functional/conv.py`; reference
`python/paddle/nn/functional/conv.py`) over torch's `conv{1,2,3}d` and
`conv_transpose{1,2,3}d`, channels first or last, with Paddle's padding:
an int, one per spatial dim, (before, after) per spatial dim, pairs that
include the batch and channel dims, or "SAME" / "VALID".

Asymmetric and "SAME" padding are applied by `F.pad` before a convolution
without padding ("SAME": ceil(in / stride) outputs, the extra pad after),
and by cropping the full output of a transposed convolution. On the card,
f32 convolutions run in TF32 when `torch.backends.cudnn.allow_tf32` is on
(torch's default); the port leaves that global setting to the caller.
"""

import torch.nn.functional as TF

from paddle_tpu_torch.core.tensor import apply

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
           3: TF.conv_transpose3d}


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _channels_last(data_format):
    return data_format not in ("NCHW", "NCL", "NCDHW")


def _pairs(padding, n, channels_last):
    """Paddle's explicit padding as n (before, after) pairs."""
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, int) for p in padding):
        return [(p, p) for p in padding]
    if len(padding) == 2 * n and all(isinstance(p, int) for p in padding):
        return [(padding[2 * i], padding[2 * i + 1]) for i in range(n)]
    pairs = [tuple(int(q) for q in p) for p in padding]
    if len(pairs) == n + 2:   # the batch and channel dims included
        pairs = pairs[1:-1] if channels_last else pairs[2:]
    return pairs


def _same(size, k, s, d):
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _flat(pairs):
    """(before, after) pairs, first spatial dim first, as F.pad's list."""
    return [p for pair in reversed(pairs) for p in pair]


def _conv(x, weight, bias, stride, padding, dilation, groups, n,
          data_format):
    strides, dil = _tuple(stride, n), _tuple(dilation, n)
    cl = _channels_last(data_format)

    def fn(a, w, *b):
        if cl:
            a = a.movedim(-1, 1)
        if isinstance(padding, str):
            if padding.upper() == "VALID":
                pairs = [(0, 0)] * n
            else:
                pairs = [_same(a.shape[2 + i], w.shape[2 + i], strides[i],
                               dil[i]) for i in range(n)]
        else:
            pairs = _pairs(padding, n, cl)
        if any(lo != hi for lo, hi in pairs):
            a, pad = TF.pad(a, _flat(pairs)), 0
        else:
            pad = tuple(lo for lo, _ in pairs)
        out = _CONV[n](a, w, b[0] if b else None, strides, pad, dil, groups)
        return out.movedim(1, -1) if cl else out

    args = (x, weight) + ((bias,) if bias is not None else ())
    return apply(fn, *args, _name=f"conv{n}d")


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 1,
                 data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 2,
                 data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups, 3,
                 data_format)


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, n, data_format, output_size=None):
    """weight [in, out / groups, *k]. The full transposed convolution,
    (in - 1) s + d (k - 1) + 1 + output_padding long, cropped by the
    padding: explicit pairs, "VALID" (none) or "SAME" (in * s outputs);
    `output_size` sets the output padding."""
    strides, dil = _tuple(stride, n), _tuple(dilation, n)
    opad = list(_tuple(output_padding, n))
    cl = _channels_last(data_format)

    def fn(a, w, *b):
        if cl:
            a = a.movedim(-1, 1)
        sizes = [a.shape[2 + i] for i in range(n)]
        full = [(sizes[i] - 1) * strides[i] + dil[i] * (w.shape[2 + i] - 1)
                + 1 for i in range(n)]
        if isinstance(padding, str):
            if padding.upper() == "VALID":
                pairs = [(0, 0)] * n
            else:
                pairs = []
                for i in range(n):
                    total = max(full[i] - sizes[i] * strides[i], 0)
                    pairs.append((total // 2, total - total // 2))
        else:
            pairs = _pairs(padding, n, cl)
        op = list(opad)
        if output_size is not None:
            want = _tuple(output_size, n)[-n:]
            op = [want[i] - (full[i] - sum(pairs[i])) for i in range(n)]
        if all(lo == hi for lo, hi in pairs) and \
                all(0 <= o < max(s, d) for o, s, d in zip(op, strides, dil)):
            out = _CONV_T[n](a, w, b[0] if b else None, strides,
                             tuple(lo for lo, _ in pairs), tuple(op), groups,
                             dil)
        else:
            out = _CONV_T[n](a, w, None, strides, 0, 0, groups, dil)
            out = TF.pad(out, _flat([(0, max(o, 0)) for o in op]))
            for i, (lo, hi) in enumerate(pairs):
                out = out.narrow(2 + i, lo, full[i] + op[i] - lo - hi)
            if b:
                out = out + b[0].reshape([1, -1] + [1] * n)
        return out.movedim(1, -1) if cl else out

    args = (x, weight) + ((bias,) if bias is not None else ())
    return apply(fn, *args, _name=f"conv{n}d_transpose")


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 1, data_format, output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 2, data_format, output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, 3, data_format, output_size)
