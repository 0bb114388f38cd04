"""InceptionV3 (`paddle_tpu/vision/models/inceptionv3.py`;
reference `python/paddle/vision/models/inceptionv3.py`):
the five mixed-block families (A, B, C, D, E) at 299x299."""

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn

__all__ = ["InceptionV3", "inception_v3"]


class _ConvBN(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride,
                              padding=padding, bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class _InceptionA(nn.Layer):
    def __init__(self, in_c, pool_c):
        super().__init__()
        self.b1 = _ConvBN(in_c, 64, 1)
        self.b5 = nn.Sequential(_ConvBN(in_c, 48, 1),
                                _ConvBN(48, 64, 5, padding=2))
        self.b3 = nn.Sequential(_ConvBN(in_c, 64, 1),
                                _ConvBN(64, 96, 3, padding=1),
                                _ConvBN(96, 96, 3, padding=1))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _ConvBN(in_c, pool_c, 1))

    def forward(self, x):
        return paddle.concat(
            [self.b1(x), self.b5(x), self.b3(x), self.bp(x)], axis=1)


class _InceptionB(nn.Layer):
    """Grid reduction 35->17."""

    def __init__(self, in_c):
        super().__init__()
        self.b3 = _ConvBN(in_c, 384, 3, stride=2)
        self.b3d = nn.Sequential(_ConvBN(in_c, 64, 1),
                                 _ConvBN(64, 96, 3, padding=1),
                                 _ConvBN(96, 96, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return paddle.concat([self.b3(x), self.b3d(x), self.pool(x)],
                             axis=1)


class _InceptionC(nn.Layer):
    """Factorized 7x7 blocks at 17x17."""

    def __init__(self, in_c, c7):
        super().__init__()
        self.b1 = _ConvBN(in_c, 192, 1)
        self.b7 = nn.Sequential(
            _ConvBN(in_c, c7, 1),
            _ConvBN(c7, c7, (1, 7), padding=(0, 3)),
            _ConvBN(c7, 192, (7, 1), padding=(3, 0)))
        self.b7d = nn.Sequential(
            _ConvBN(in_c, c7, 1),
            _ConvBN(c7, c7, (7, 1), padding=(3, 0)),
            _ConvBN(c7, c7, (1, 7), padding=(0, 3)),
            _ConvBN(c7, c7, (7, 1), padding=(3, 0)),
            _ConvBN(c7, 192, (1, 7), padding=(0, 3)))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _ConvBN(in_c, 192, 1))

    def forward(self, x):
        return paddle.concat(
            [self.b1(x), self.b7(x), self.b7d(x), self.bp(x)], axis=1)


class _InceptionD(nn.Layer):
    """Grid reduction 17->8."""

    def __init__(self, in_c):
        super().__init__()
        self.b3 = nn.Sequential(_ConvBN(in_c, 192, 1),
                                _ConvBN(192, 320, 3, stride=2))
        self.b7 = nn.Sequential(
            _ConvBN(in_c, 192, 1),
            _ConvBN(192, 192, (1, 7), padding=(0, 3)),
            _ConvBN(192, 192, (7, 1), padding=(3, 0)),
            _ConvBN(192, 192, 3, stride=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return paddle.concat([self.b3(x), self.b7(x), self.pool(x)],
                             axis=1)


class _InceptionE(nn.Layer):
    """Expanded-filter-bank blocks at 8x8."""

    def __init__(self, in_c):
        super().__init__()
        self.b1 = _ConvBN(in_c, 320, 1)
        self.b3_stem = _ConvBN(in_c, 384, 1)
        self.b3_a = _ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = _ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.b3d_stem = nn.Sequential(_ConvBN(in_c, 448, 1),
                                      _ConvBN(448, 384, 3, padding=1))
        self.b3d_a = _ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.b3d_b = _ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _ConvBN(in_c, 192, 1))

    def forward(self, x):
        s = self.b3_stem(x)
        b3 = paddle.concat([self.b3_a(s), self.b3_b(s)], axis=1)
        d = self.b3d_stem(x)
        b3d = paddle.concat([self.b3d_a(d), self.b3d_b(d)], axis=1)
        return paddle.concat([self.b1(x), b3, b3d, self.bp(x)], axis=1)


class InceptionV3(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _ConvBN(3, 32, 3, stride=2),
            _ConvBN(32, 32, 3),
            _ConvBN(32, 64, 3, padding=1),
            nn.MaxPool2D(3, stride=2),
            _ConvBN(64, 80, 1),
            _ConvBN(80, 192, 3),
            nn.MaxPool2D(3, stride=2),
        )
        self.blocks = nn.Sequential(
            _InceptionA(192, 32), _InceptionA(256, 64), _InceptionA(288, 64),
            _InceptionB(288),
            _InceptionC(768, 128), _InceptionC(768, 160),
            _InceptionC(768, 160), _InceptionC(768, 192),
            _InceptionD(768),
            _InceptionE(1280), _InceptionE(2048),
        )
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = nn.Dropout(0.5)
            self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(x.flatten(1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    return InceptionV3(**kwargs)
