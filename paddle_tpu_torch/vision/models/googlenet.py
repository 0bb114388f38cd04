"""GoogLeNet / Inception v1 (`paddle_tpu/vision/models/googlenet.py`;
reference `python/paddle/vision/models/googlenet.py`): 9 Inception
modules + two auxiliary classifier heads (returned during training, as the
reference does)."""

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn

__all__ = ["GoogLeNet", "googlenet"]


class _ConvBN(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride,
                              padding=padding, bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.relu(self.bn(self.conv(x)))


class _Inception(nn.Layer):
    def __init__(self, in_c, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = _ConvBN(in_c, c1, 1)
        self.b2 = nn.Sequential(_ConvBN(in_c, c3r, 1),
                                _ConvBN(c3r, c3, 3, padding=1))
        self.b3 = nn.Sequential(_ConvBN(in_c, c5r, 1),
                                _ConvBN(c5r, c5, 5, padding=2))
        self.b4 = nn.Sequential(nn.MaxPool2D(3, stride=1, padding=1),
                                _ConvBN(in_c, proj, 1))

    def forward(self, x):
        return paddle.concat(
            [self.b1(x), self.b2(x), self.b3(x), self.b4(x)], axis=1)


class _AuxHead(nn.Layer):
    def __init__(self, in_c, num_classes):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D(4)
        self.conv = _ConvBN(in_c, 128, 1)
        self.fc1 = nn.Linear(128 * 16, 1024)
        self.relu = nn.ReLU()
        self.drop = nn.Dropout(0.7)
        self.fc2 = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.conv(self.pool(x)).flatten(1)
        return self.fc2(self.drop(self.relu(self.fc1(x))))


class GoogLeNet(nn.Layer):
    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = nn.Sequential(
            _ConvBN(3, 64, 7, stride=2, padding=3),
            nn.MaxPool2D(3, stride=2, padding=1),
            _ConvBN(64, 64, 1),
            _ConvBN(64, 192, 3, padding=1),
            nn.MaxPool2D(3, stride=2, padding=1),
        )
        self.i3a = _Inception(192, 64, 96, 128, 16, 32, 32)
        self.i3b = _Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = nn.MaxPool2D(3, stride=2, padding=1)
        self.i4a = _Inception(480, 192, 96, 208, 16, 48, 64)
        self.i4b = _Inception(512, 160, 112, 224, 24, 64, 64)
        self.i4c = _Inception(512, 128, 128, 256, 24, 64, 64)
        self.i4d = _Inception(512, 112, 144, 288, 32, 64, 64)
        self.i4e = _Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = nn.MaxPool2D(3, stride=2, padding=1)
        self.i5a = _Inception(832, 256, 160, 320, 32, 128, 128)
        self.i5b = _Inception(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.pool5 = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.drop = nn.Dropout(0.2)
            self.fc = nn.Linear(1024, num_classes)
            self.aux1 = _AuxHead(512, num_classes)
            self.aux2 = _AuxHead(528, num_classes)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.i3b(self.i3a(x)))
        x = self.i4a(x)
        aux1 = self.aux1(x) if self.training and self.num_classes > 0 \
            else None
        x = self.i4d(self.i4c(self.i4b(x)))
        aux2 = self.aux2(x) if self.training and self.num_classes > 0 \
            else None
        x = self.pool4(self.i4e(x))
        x = self.i5b(self.i5a(x))
        if self.with_pool:
            x = self.pool5(x)
        if self.num_classes > 0:
            x = self.fc(self.drop(x.flatten(1)))
            # reference returns (out, aux1, aux2) — aux heads train only
            return x, aux1, aux2
        return x


def googlenet(pretrained=False, **kwargs):
    return GoogLeNet(**kwargs)
