"""Conv layers (reference: `python/paddle/nn/layer/conv.py`)."""

import numpy as np

from paddle_tpu_torch.nn.layer.layers import Layer
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I


def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v] * n


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride, padding, dilation,
                 groups, ndim, transposed=False, output_padding=0, weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__()
        self._in_channels = in_channels
        self._out_channels = out_channels
        self._kernel_size = _ntuple(kernel_size, ndim)
        self._stride = _ntuple(stride, ndim)
        self._padding = padding
        self._dilation = _ntuple(dilation, ndim)
        self._groups = groups
        self._data_format = data_format
        self._output_padding = output_padding
        self._ndim = ndim
        self._transposed = transposed

        if transposed:
            w_shape = [in_channels, out_channels // groups] + self._kernel_size
        else:
            w_shape = [out_channels, in_channels // groups] + self._kernel_size
        fan_in = in_channels // groups * int(np.prod(self._kernel_size))
        bound = 1.0 / np.sqrt(fan_in)
        self.weight = self.create_parameter(
            w_shape, attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in))
        self.bias = self.create_parameter(
            [out_channels], attr=bias_attr, is_bias=True,
            default_initializer=I.Uniform(-bound, bound))

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={self._kernel_size}, stride={self._stride}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, 1, weight_attr=weight_attr,
                         bias_attr=bias_attr, data_format=data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, 2, weight_attr=weight_attr,
                         bias_attr=bias_attr, data_format=data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, 3, weight_attr=weight_attr,
                         bias_attr=bias_attr, data_format=data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None,
                 bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, 1, transposed=True, output_padding=output_padding,
                         weight_attr=weight_attr, bias_attr=bias_attr, data_format=data_format)

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride, self._padding,
                                  self._output_padding, self._groups, self._dilation,
                                  output_size, self._data_format)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, 2, transposed=True, output_padding=output_padding,
                         weight_attr=weight_attr, bias_attr=bias_attr, data_format=data_format)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride, self._padding,
                                  self._output_padding, self._groups, self._dilation,
                                  output_size, self._data_format)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None,
                 bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         dilation, groups, 3, transposed=True, output_padding=output_padding,
                         weight_attr=weight_attr, bias_attr=bias_attr, data_format=data_format)

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride, self._padding,
                                  self._output_padding, self._groups, self._dilation,
                                  output_size, self._data_format)
