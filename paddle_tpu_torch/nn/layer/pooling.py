"""Pooling layers (reference: `python/paddle/nn/layer/pooling.py`)."""

from paddle_tpu_torch.nn.layer.layers import Layer
from paddle_tpu_torch.nn import functional as F


class _PoolNd(Layer):
    def __init__(self, kernel_size=None, stride=None, padding=0, **kw):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kw = kw


class MaxPool1D(_PoolNd):
    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding)


class MaxPool2D(_PoolNd):
    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding)


class MaxPool3D(_PoolNd):
    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding)


class AvgPool1D(_PoolNd):
    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding)


class AvgPool2D(_PoolNd):
    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding)


class AvgPool3D(_PoolNd):
    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding)


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, self.data_format)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size, self.data_format)


class AdaptiveMaxPool1D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool3D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask

    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, self.return_mask)
