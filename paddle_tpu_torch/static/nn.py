"""paddle.static.nn — graph-building layer functions (`paddle_tpu/static/nn.py`;
reference `python/paddle/static/nn/common.py`): each call makes its
parameters eagerly (the Scope role) and applies the op through the dispatch
waist, so in static-graph mode the compute lands on the recorded Program
while the parameters stay shared, trainable externals."""

from __future__ import annotations

import numpy as np

__all__ = ["fc", "embedding", "batch_norm", "conv2d", "conv2d_transpose",
           "layer_norm", "dropout", "prelu", "sequence_softmax"]


def _param(shape, dtype, initializer=None, is_bias=False, fill=None):
    import torch

    from paddle_tpu_torch.framework import device as _device
    from paddle_tpu_torch.framework import dtypes
    from paddle_tpu_torch.nn.initializer import XavierNormal
    from paddle_tpu_torch.nn.layer.layers import Parameter

    dt = dtypes.convert_dtype(dtype)
    if fill is not None:
        data = torch.full(list(shape), fill, dtype=dt, device=_device.place())
    elif initializer is not None and callable(initializer):
        data = initializer(list(shape), dt)
    elif is_bias:
        data = torch.zeros(list(shape), dtype=dt, device=_device.place())
    else:
        data = XavierNormal()(list(shape), dt)
    p = Parameter(data)
    p.stop_gradient = False
    return p


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """reference static.nn.fc: flatten trailing dims, x @ W + b."""
    import paddle_tpu_torch.nn.functional as F
    from paddle_tpu_torch.ops import manipulation as M

    in_dim = int(np.prod(x.shape[num_flatten_dims:]))
    w = _param([in_dim, size], x.dtype)
    b = None if bias_attr is False else _param([size], x.dtype,
                                               is_bias=True)
    h = M.reshape(x, list(x.shape[:num_flatten_dims]) + [in_dim]) \
        if len(x.shape) > num_flatten_dims + 1 else x
    out = F.linear(h, w, b)
    if activation:
        out = getattr(F, activation)(out)
    return out


def embedding(input, size, is_sparse=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    import paddle_tpu_torch.nn.functional as F

    w = _param(list(size), dtype)
    return F.embedding(input, w, padding_idx=padding_idx)


def batch_norm(input, act=None, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               is_test=False, name=None, **kw):
    import paddle_tpu_torch.nn.functional as F

    c = input.shape[1 if data_layout == "NCHW" else -1]
    scale = _param([c], input.dtype)
    bias = _param([c], input.dtype, is_bias=True)
    mean = _param([c], input.dtype, is_bias=True)
    var = _param([c], input.dtype, fill=1.0)
    mean.stop_gradient = var.stop_gradient = True
    out = F.batch_norm(input, mean, var, weight=scale, bias=bias,
                       training=not is_test, momentum=momentum,
                       epsilon=epsilon, data_format=data_layout)
    if act:
        out = getattr(F, act)(out)
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None,
           data_format="NCHW", name=None, **kw):
    import paddle_tpu_torch.nn.functional as F

    ks = filter_size if isinstance(filter_size, (list, tuple)) \
        else [filter_size, filter_size]
    cin = input.shape[1 if data_format == "NCHW" else -1]
    w = _param([num_filters, cin // groups] + list(ks), input.dtype)
    b = None if bias_attr is False else _param([num_filters],
                                               input.dtype, is_bias=True)
    out = F.conv2d(input, w, bias=b, stride=stride, padding=padding,
                   dilation=dilation, groups=groups, data_format=data_format)
    if act:
        out = getattr(F, act)(out)
    return out


def conv2d_transpose(input, num_filters, filter_size=None, output_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, act=None,
                     data_format="NCHW", name=None, **kw):
    import paddle_tpu_torch.nn.functional as F

    ks = filter_size if isinstance(filter_size, (list, tuple)) \
        else [filter_size, filter_size]
    cin = input.shape[1 if data_format == "NCHW" else -1]
    w = _param([cin, num_filters // groups] + list(ks), input.dtype)
    b = None if bias_attr is False else _param([num_filters],
                                               input.dtype, is_bias=True)
    out = F.conv2d_transpose(input, w, bias=b, stride=stride, padding=padding,
                             dilation=dilation, groups=groups,
                             output_size=output_size, data_format=data_format)
    if act:
        out = getattr(F, act)(out)
    return out


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    import paddle_tpu_torch.nn.functional as F

    shape = input.shape[begin_norm_axis:]
    w = _param(shape, input.dtype, fill=1.0) if scale else None
    b = _param(shape, input.dtype, is_bias=True) if shift else None
    out = F.layer_norm(input, shape, weight=w, bias=b, epsilon=epsilon)
    if act:
        out = getattr(F, act)(out)
    return out


def dropout(x, dropout_prob=0.5, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    import paddle_tpu_torch.nn.functional as F

    mode = ("upscale_in_train"
            if dropout_implementation == "upscale_in_train"
            else "downscale_in_infer")
    return F.dropout(x, p=dropout_prob, training=not is_test, mode=mode)


def prelu(x, mode="all", param_attr=None, data_format="NCHW", name=None):
    import paddle_tpu_torch.nn.functional as F

    n = 1 if mode == "all" else x.shape[1 if data_format == "NCHW" else -1]
    w = _param([n], x.dtype, fill=0.25)
    return F.prelu(x, w)


def sequence_softmax(input, use_cudnn=False, name=None):
    import paddle_tpu_torch.nn.functional as F

    return F.softmax(input, axis=-1)
