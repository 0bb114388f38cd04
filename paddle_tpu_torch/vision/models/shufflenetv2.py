"""ShuffleNetV2 (`paddle_tpu/vision/models/shufflenetv2.py`;
reference `python/paddle/vision/models/shufflenetv2.py`)."""

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn

__all__ = ["ShuffleNetV2", "shufflenet_v2_x0_25", "shufflenet_v2_x0_33",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "shufflenet_v2_swish"]


def _act_layer(act):
    return nn.Swish() if act == "swish" else nn.ReLU()


def channel_shuffle(x, groups):
    b, c, h, w = x.shape
    x = paddle.reshape(x, [b, groups, c // groups, h, w])
    x = paddle.transpose(x, [0, 2, 1, 3, 4])
    return paddle.reshape(x, [b, c, h, w])


class InvertedResidual(nn.Layer):
    def __init__(self, inp, oup, stride, act="relu"):
        super().__init__()
        self.stride = stride
        branch_features = oup // 2
        if stride > 1:
            self.branch1 = nn.Sequential(
                nn.Conv2D(inp, inp, 3, stride=stride, padding=1, groups=inp,
                          bias_attr=False),
                nn.BatchNorm2D(inp),
                nn.Conv2D(inp, branch_features, 1, bias_attr=False),
                nn.BatchNorm2D(branch_features), _act_layer(act),
            )
            b2_in = inp
        else:
            self.branch1 = None
            b2_in = inp // 2
        self.branch2 = nn.Sequential(
            nn.Conv2D(b2_in, branch_features, 1, bias_attr=False),
            nn.BatchNorm2D(branch_features), _act_layer(act),
            nn.Conv2D(branch_features, branch_features, 3, stride=stride,
                      padding=1, groups=branch_features, bias_attr=False),
            nn.BatchNorm2D(branch_features),
            nn.Conv2D(branch_features, branch_features, 1, bias_attr=False),
            nn.BatchNorm2D(branch_features), _act_layer(act),
        )

    def forward(self, x):
        if self.stride == 1:
            c = x.shape[1] // 2
            x1, x2 = x[:, :c], x[:, c:]
            out = paddle.concat([x1, self.branch2(x2)], axis=1)
        else:
            out = paddle.concat([self.branch1(x), self.branch2(x)], axis=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(nn.Layer):
    def __init__(self, scale=1.0, act="relu", num_classes=1000):
        super().__init__()
        if act not in ("relu", "swish"):
            raise ValueError(f"act must be relu or swish, got {act!r}")
        self.act = act
        stage_repeats = [4, 8, 4]
        channels = {0.25: [24, 24, 48, 96, 512],
                    0.33: [24, 32, 64, 128, 512],
                    0.5: [24, 48, 96, 192, 1024],
                    1.0: [24, 116, 232, 464, 1024],
                    1.5: [24, 176, 352, 704, 1024],
                    2.0: [24, 244, 488, 976, 2048]}[scale]
        self.conv1 = nn.Sequential(
            nn.Conv2D(3, channels[0], 3, stride=2, padding=1,
                      bias_attr=False),
            nn.BatchNorm2D(channels[0]), _act_layer(act),
        )
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1)
        stages = []
        inp = channels[0]
        for repeats, oup in zip(stage_repeats, channels[1:4]):
            blocks = [InvertedResidual(inp, oup, 2, act)]
            blocks += [InvertedResidual(oup, oup, 1, act)
                       for _ in range(repeats - 1)]
            stages.append(nn.Sequential(*blocks))
            inp = oup
        self.stages = nn.Sequential(*stages)
        self.conv5 = nn.Sequential(
            nn.Conv2D(inp, channels[-1], 1, bias_attr=False),
            nn.BatchNorm2D(channels[-1]), _act_layer(act),
        )
        self.avgpool = nn.AdaptiveAvgPool2D(1)
        self.fc = nn.Linear(channels[-1], num_classes)

    def forward(self, x):
        x = self.maxpool(self.conv1(x))
        x = self.stages(x)
        x = self.conv5(x)
        x = self.avgpool(x).flatten(1)
        return self.fc(x)


def _make(scale):
    def f(pretrained=False, **kwargs):
        return ShuffleNetV2(scale, **kwargs)

    return f


shufflenet_v2_x0_25 = _make(0.25)
shufflenet_v2_x0_5 = _make(0.5)
shufflenet_v2_x1_0 = _make(1.0)
shufflenet_v2_x1_5 = _make(1.5)
shufflenet_v2_x2_0 = _make(2.0)
shufflenet_v2_x0_33 = _make(0.33)


def shufflenet_v2_swish(pretrained=False, **kwargs):
    return ShuffleNetV2(1.0, act="swish", **kwargs)
