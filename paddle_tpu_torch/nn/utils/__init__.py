"""nn.utils (`paddle_tpu/nn/utils/__init__.py`; reference
`python/paddle/nn/utils/`): clip_grad helpers, parameters_to_vector,
weight_norm, spectral_norm wrappers. A gradient is rewritten through its
parameter (`p.grad = ...`), which sets the torch leaf's `.grad`."""

import torch

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.framework import device as _device


def clip_grad_norm_(parameters, max_norm, norm_type=2.0, error_if_nonfinite=False):
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return Tensor(torch.zeros((), device=_device.place()))
    grads = [p._data.grad for p in params]
    if norm_type == float("inf"):
        total = torch.max(torch.stack([g.abs().max() for g in grads]))
    else:
        total = torch.pow(
            sum(torch.sum(torch.pow(g.abs(), norm_type)) for g in grads),
            1.0 / norm_type)
    clip_coef = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for p, g in zip(params, grads):
        p.grad = g * clip_coef.to(g.dtype)
    return Tensor(total)


def clip_grad_value_(parameters, clip_value):
    if isinstance(parameters, Tensor):
        parameters = [parameters]
    for p in parameters:
        if p.grad is not None:
            p.grad = torch.clamp(p._data.grad, -clip_value, clip_value)


def parameters_to_vector(parameters, name=None):
    return Tensor(torch.cat([p._data.detach().reshape(-1)
                             for p in parameters]))


def vector_to_parameters(vec, parameters, name=None):
    from paddle_tpu_torch.nn.layer.layers import _set_data

    offset = 0
    for p in parameters:
        n = p.size
        _set_data(p, vec._data[offset:offset + n].reshape(
            tuple(p.shape)).to(p.dtype))
        offset += n


def weight_norm(layer, name="weight", dim=0):
    # lightweight reparameterization: store g/v, recompute weight pre-forward
    w = getattr(layer, name)
    wd = w._data.detach()
    g = torch.linalg.norm(wd.reshape(w.shape[dim], -1), dim=1) if dim == 0 \
        else torch.linalg.norm(wd, dim=tuple(i for i in range(w.ndim)
                                             if i != dim))
    from paddle_tpu_torch.nn.layer.layers import Parameter, _set_data

    layer.add_parameter(name + "_g", Parameter(g))
    layer.add_parameter(name + "_v", Parameter(wd.clone()))

    def hook(l, inputs):
        v = getattr(l, name + "_v")._data
        gg = getattr(l, name + "_g")._data
        axes = tuple(i for i in range(v.ndim) if i != dim)
        norm = torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True) + 1e-12)
        shape = [1] * v.ndim
        shape[dim] = -1
        _set_data(getattr(l, name), v / norm * gg.reshape(shape))

    layer.register_forward_pre_hook(hook)
    return layer


def remove_weight_norm(layer, name="weight"):
    for attr in (name + "_g", name + "_v"):
        if attr in layer._parameters:
            del layer._parameters[attr]
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12, dim=None):
    return layer
