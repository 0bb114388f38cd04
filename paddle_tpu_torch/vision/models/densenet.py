"""DenseNet (`paddle_tpu/vision/models/densenet.py`;
reference `python/paddle/vision/models/densenet.py`)."""

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]


class _DenseLayer(nn.Layer):
    def __init__(self, num_input, growth_rate, bn_size):
        super().__init__()
        self.norm1 = nn.BatchNorm2D(num_input)
        self.relu = nn.ReLU()
        self.conv1 = nn.Conv2D(num_input, bn_size * growth_rate, 1,
                               bias_attr=False)
        self.norm2 = nn.BatchNorm2D(bn_size * growth_rate)
        self.conv2 = nn.Conv2D(bn_size * growth_rate, growth_rate, 3,
                               padding=1, bias_attr=False)

    def forward(self, x):
        out = self.conv1(self.relu(self.norm1(x)))
        out = self.conv2(self.relu(self.norm2(out)))
        return paddle.concat([x, out], axis=1)


class _Transition(nn.Sequential):
    def __init__(self, num_input, num_output):
        super().__init__(
            nn.BatchNorm2D(num_input), nn.ReLU(),
            nn.Conv2D(num_input, num_output, 1, bias_attr=False),
            nn.AvgPool2D(2, stride=2),
        )


class DenseNet(nn.Layer):
    def __init__(self, layers=121, growth_rate=32, num_init_features=64,
                 bn_size=4, num_classes=1000):
        super().__init__()
        cfgs = {121: (6, 12, 24, 16), 161: (6, 12, 36, 24),
                169: (6, 12, 32, 32), 201: (6, 12, 48, 32),
                264: (6, 12, 64, 48)}
        block_config = cfgs[layers]
        feats = [
            nn.Conv2D(3, num_init_features, 7, stride=2, padding=3,
                      bias_attr=False),
            nn.BatchNorm2D(num_init_features), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, padding=1),
        ]
        num = num_init_features
        for i, n in enumerate(block_config):
            for _ in range(n):
                feats.append(_DenseLayer(num, growth_rate, bn_size))
                num += growth_rate
            if i != len(block_config) - 1:
                feats.append(_Transition(num, num // 2))
                num //= 2
        feats += [nn.BatchNorm2D(num), nn.ReLU()]
        self.features = nn.Sequential(*feats)
        self.avgpool = nn.AdaptiveAvgPool2D(1)
        self.classifier = nn.Linear(num, num_classes)

    def forward(self, x):
        x = self.features(x)
        x = self.avgpool(x).flatten(1)
        return self.classifier(x)


def densenet121(pretrained=False, **kwargs):
    return DenseNet(121, **kwargs)


def densenet161(pretrained=False, **kwargs):
    # the 161 variant's stock widths, overridable by explicit kwargs
    kwargs.setdefault("growth_rate", 48)
    kwargs.setdefault("num_init_features", 96)
    return DenseNet(161, **kwargs)


def densenet169(pretrained=False, **kwargs):
    return DenseNet(169, **kwargs)


def densenet201(pretrained=False, **kwargs):
    return DenseNet(201, **kwargs)


def densenet264(pretrained=False, **kwargs):
    return DenseNet(264, **kwargs)
