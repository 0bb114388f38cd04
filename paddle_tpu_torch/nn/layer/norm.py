"""Norm layers (`paddle_tpu/nn/layer/norm.py`; reference
`python/paddle/nn/layer/norm.py`). `RMSNorm` runs `F.rms_norm`: kernel B9
forward and B10 backward on the card, on B9's gate. BatchNorm's running
statistics are buffers `F.batch_norm` updates in training, in Paddle's
momentum convention (0.9 keeps 90% of the old value)."""

import torch

from paddle_tpu_torch.core.tensor import Tensor
from paddle_tpu_torch.framework import device as _device
from paddle_tpu_torch.nn.layer.layers import Layer
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr, default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr, is_bias=True)
        dev = _device.place()
        self.register_buffer("_mean", Tensor(torch.zeros(num_features, device=dev)))
        self.register_buffer("_variance", Tensor(torch.ones(num_features, device=dev)))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum, epsilon=self._epsilon,
            data_format=self._data_format, use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCDHW", use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr, bias_attr,
                         data_format, use_global_stats, name)


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm (reference: `python/paddle/nn/layer/norm.py`
    SyncBatchNorm). In one process it equals BatchNorm; the moments across
    ranks wait for the multi-card slice (ROADMAP A9)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, SyncBatchNorm):
            out = SyncBatchNorm(layer._num_features, layer._momentum, layer._epsilon,
                                data_format=layer._data_format)
            out.weight = layer.weight
            out.bias = layer.bias
            out._mean = layer._mean
            out._variance = layer._variance
        for name, sub in list(layer._sub_layers.items()):
            out._sub_layers[name] = cls.convert_sync_batchnorm(sub)
        return out


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None, bias_attr=None,
                 name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            self._normalized_shape, attr=weight_attr, default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    """Root-mean-square norm (reference fused kernel `fused_rms_norm`; used by
    the Llama family)."""

    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None, name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], attr=weight_attr, default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr, default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight, self.bias,
                            self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None):
        super().__init__()
        self._epsilon = epsilon
        self._data_format = data_format
        if weight_attr is False:
            self.weight = None
            self.bias = None
        else:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr, default_initializer=I.Constant(1.0))
            self.bias = self.create_parameter([num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias, eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta, self.k,
                                     self.data_format)


class SpectralNorm(Layer):
    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12, name=None):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._epsilon = epsilon
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        self.weight_u = self.create_parameter([h], default_initializer=I.Normal(0, 1))
        self.weight_v = self.create_parameter([w], default_initializer=I.Normal(0, 1))

    def forward(self, weight):
        return F.spectral_norm(weight, self.weight_u, self.weight_v, self._dim,
                               self._power_iters, self._epsilon)
