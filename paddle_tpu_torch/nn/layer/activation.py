"""Activation layers (reference: `python/paddle/nn/layer/activation.py`)."""

from paddle_tpu_torch.nn.layer.layers import Layer
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I


def _mk(name, fn, **defaults):
    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            self._kwargs = {**defaults}
            keys = list(defaults.keys())
            for i, a in enumerate(args):
                self._kwargs[keys[i]] = a
            for k, v in kwargs.items():
                if k in self._kwargs:
                    self._kwargs[k] = v

        def forward(self, x):
            return fn(x, **self._kwargs)

    _Act.__name__ = name
    _Act.__qualname__ = name
    return _Act


ReLU = _mk("ReLU", F.relu)
ReLU6 = _mk("ReLU6", F.relu6)
Sigmoid = _mk("Sigmoid", F.sigmoid)
Tanh = _mk("Tanh", F.tanh)
GELU = _mk("GELU", F.gelu, approximate=False)
SiLU = _mk("SiLU", F.silu)
Swish = _mk("Swish", F.silu)
Mish = _mk("Mish", F.mish)
LeakyReLU = _mk("LeakyReLU", F.leaky_relu, negative_slope=0.01)
ELU = _mk("ELU", F.elu, alpha=1.0)
SELU = _mk("SELU", F.selu)
CELU = _mk("CELU", F.celu, alpha=1.0)
Hardtanh = _mk("Hardtanh", F.hardtanh, min=-1.0, max=1.0)
Hardshrink = _mk("Hardshrink", F.hardshrink, threshold=0.5)
Softshrink = _mk("Softshrink", F.softshrink, threshold=0.5)
Tanhshrink = _mk("Tanhshrink", F.tanhshrink)
Hardsigmoid = _mk("Hardsigmoid", F.hardsigmoid)
Hardswish = _mk("Hardswish", F.hardswish)
Softplus = _mk("Softplus", F.softplus, beta=1, threshold=20)
Softsign = _mk("Softsign", F.softsign)
LogSigmoid = _mk("LogSigmoid", F.log_sigmoid)
Softmax = _mk("Softmax", F.softmax, axis=-1)
LogSoftmax = _mk("LogSoftmax", F.log_softmax, axis=-1)
ThresholdedReLU = _mk("ThresholdedReLU", F.thresholded_relu, threshold=1.0)
Maxout = _mk("Maxout", F.maxout, groups=2, axis=1)
GLU = _mk("GLU", F.glu, axis=-1)
RReLU = _mk("RReLU", F.rrelu, lower=1.0 / 8.0, upper=1.0 / 3.0)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr, default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)
