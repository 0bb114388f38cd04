"""Normalization functionals (`paddle_tpu/nn/functional/norm.py`;
reference `python/paddle/nn/functional/norm.py`).

`rms_norm` is the one with a kernel. The JAX package computes it as the
composite (x_f32 * rsqrt(mean(x_f32^2) + eps)).astype(x.dtype) * w, which
rounds twice; B9 rounds the same way (`kernels/rms_norm.py`), so on the
card the port runs B9 forward and B10 backward (through the kernel
wrapper's custom operator) for the same function. The route is decided by
shape and dtype before the launch (`kernels.rms_norm.supports`: x and w
of one dtype, bf16 or f32, H % 8 == 0, H <= MAX_HIDDEN); a strided view is
given a dense copy first. Off the gate, with `weight=None`, or on CPU
tensors the composite runs in plain PyTorch. While `torch.export` traces,
a norm on the gate is the kernel's operator whatever the device, so a
program saved on the CPU and moved to the card runs B9 there (the
operator picks B9 or its plain version at each call). x and weight on
different devices raise, as the kernel wrappers do
(`kernels.attention._on_card`). A failed build or launch raises: nothing
falls back.

The other norms are plain PyTorch, as the JAX package computes them
outside any Pallas kernel: statistics in f32, the normalised value cast
back to x's dtype, then the affine weight and bias.
"""

import torch

from paddle_tpu_torch.core.tensor import apply
from paddle_tpu_torch.kernels import rms_norm as _rn
from paddle_tpu_torch.kernels.attention import _dense, _on_card

__all__ = [
    "layer_norm", "rms_norm", "batch_norm", "instance_norm", "group_norm",
    "local_response_norm", "normalize", "spectral_norm",
]


def _normalise(a, axes, eps):
    """(a - mean) * rsqrt(var + eps) over `axes`, in f32, cast back."""
    a32 = a.float()
    m = a32.mean(dim=axes, keepdim=True)
    v = a32.var(dim=axes, unbiased=False, keepdim=True)
    return ((a32 - m) * torch.rsqrt(v + eps)).to(a.dtype)


def _scale_shift(out, weight, bias, wb, shape=None):
    i = 0
    if weight is not None:
        out = out * (wb[i] if shape is None else wb[i].reshape(shape))
        i += 1
    if bias is not None:
        out = out + (wb[i] if shape is None else wb[i].reshape(shape))
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    axes = tuple(range(-len(list(normalized_shape)), 0))
    args = [t for t in (weight, bias) if t is not None]
    return apply(lambda a, *wb: _scale_shift(_normalise(a, axes, epsilon),
                                             weight, bias, wb),
                 x, *args, _name="layer_norm")


def _rms_plain(a, eps, w=None):
    a32 = a.float()
    var = (a32 * a32).mean(dim=-1, keepdim=True)
    out = (a32 * torch.rsqrt(var + eps)).to(a.dtype)
    return out if w is None else out * w


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    """RMSNorm over the last dim: (x_f32 * rsqrt(mean(x_f32^2) + eps))
    cast to x's dtype, times weight. On the card and on B9's gate, kernel
    B9 (backward B10); else the plain composite."""
    def fn(a, *w):
        if w and (_on_card(a, w[0]) or torch.compiler.is_compiling()) \
                and _rn.supports(a, w[0]):
            return _rn.rms_norm(_dense(a), _dense(w[0]), epsilon)
        return _rms_plain(a, epsilon, *w)

    args = [weight] if weight is not None else []
    return apply(fn, x, *args, _name="rms_norm")


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch statistics in training (the running mean and unbiased
    variance updated in place: momentum * running + (1 - momentum) *
    batch), the running ones otherwise."""
    cf = data_format.startswith("NC")
    ch_axis = 1 if (cf and x.ndim > 1) else x.ndim - 1
    axes = tuple(i for i in range(x.ndim) if i != ch_axis)
    shape = [1] * x.ndim
    shape[ch_axis] = x.shape[ch_axis]
    args = [t for t in (weight, bias) if t is not None]

    if training and not use_global_stats:
        with torch.no_grad():
            a32 = x._data.float()
            mean, var = a32.mean(dim=axes), a32.var(dim=axes, unbiased=False)
            if running_mean is not None:
                n = x._data.numel() // x.shape[ch_axis]
                rm, rv = running_mean._data, running_var._data
                running_mean._data = (momentum * rm + (1.0 - momentum)
                                      * mean).to(rm.dtype)
                running_var._data = (momentum * rv + (1.0 - momentum) * var
                                     * (n / max(n - 1, 1))).to(rv.dtype)
        return apply(lambda a, *wb: _scale_shift(
            _normalise(a, axes, epsilon), weight, bias, wb, shape),
            x, *args, _name="batch_norm")

    rm = running_mean._data.reshape(shape)
    rv = running_var._data.reshape(shape)

    def fn(a, *wb):
        inv = torch.rsqrt(rv.float() + epsilon).to(a.dtype)
        return _scale_shift((a - rm.to(a.dtype)) * inv, weight, bias, wb,
                            shape)

    return apply(fn, x, *args, _name="batch_norm")


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    cf = data_format.startswith("NC")
    ch_axis = 1 if cf else x.ndim - 1
    axes = tuple(range(2, x.ndim)) if cf else tuple(range(1, x.ndim - 1))
    shape = [1] * x.ndim
    shape[ch_axis] = x.shape[ch_axis]
    args = [t for t in (weight, bias) if t is not None]
    return apply(lambda a, *wb: _scale_shift(_normalise(a, axes, eps),
                                             weight, bias, wb, shape),
                 x, *args, _name="instance_norm")


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    cf = data_format.startswith("NC")
    ch_axis = 1 if cf else x.ndim - 1
    c = x.shape[ch_axis]
    shape = [1] * x.ndim
    shape[ch_axis] = c

    def fn(a, *wb):
        n = a.shape[0]
        if cf:
            g = a.reshape((n, num_groups, c // num_groups) + a.shape[2:])
            axes = tuple(range(2, g.ndim))
        else:
            g = a.reshape((n,) + a.shape[1:-1] + (num_groups,
                                                  c // num_groups))
            axes = tuple(range(1, g.ndim - 2)) + (g.ndim - 1,)
        out = _normalise(g, axes, epsilon).reshape(a.shape)
        return _scale_shift(out, weight, bias, wb, shape)

    args = [t for t in (weight, bias) if t is not None]
    return apply(fn, x, *args, _name="group_norm")


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """x / (k + alpha * sum of x^2 over `size` neighbouring channels)^beta
    (the window centred, size // 2 channels before)."""
    ch = 1 if data_format.startswith("NC") else x.ndim - 1

    def fn(a):
        half = size // 2
        sq = (a * a).movedim(ch, -1)
        sq = torch.nn.functional.pad(sq, (half, size - half - 1))
        summed = sq.unfold(-1, size, 1).sum(-1).movedim(-1, ch)
        return a / torch.pow(k + alpha * summed, beta)

    return apply(fn, x, _name="lrn")


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    def fn(a):
        nrm = torch.pow(torch.sum(torch.pow(torch.abs(a), p), dim=axis,
                                  keepdim=True), 1.0 / p)
        return a / torch.clamp(nrm, min=epsilon)

    return apply(fn, x, _name="normalize")


def spectral_norm(weight, weight_u, weight_v, dim=0, power_iters=1,
                  eps=1e-12, name=None):
    """weight / sigma, sigma from `power_iters` steps of the power method
    from (u, v), weight viewed as a matrix with `dim` first."""
    def fn(w, u, v):
        wm = w.movedim(dim, 0).reshape(w.shape[dim], -1)
        for _ in range(power_iters):
            v = wm.T @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = wm @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
        return w / (u @ wm @ v)

    return apply(fn, weight, weight_u, weight_v, _name="spectral_norm")
