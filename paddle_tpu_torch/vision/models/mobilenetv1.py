"""MobileNetV1 (`paddle_tpu/vision/models/mobilenetv1.py`; reference
`python/paddle/vision/models/mobilenetv1.py`): 13 depthwise-separable
blocks, the depthwise convolutions as grouped `Conv2D`s (groups ==
channels)."""

from paddle_tpu_torch import nn

__all__ = ["MobileNetV1", "mobilenet_v1"]


class _DepthwiseSeparable(nn.Layer):
    def __init__(self, in_c, mid_c, out_c, stride, scale):
        super().__init__()
        in_c, mid_c, out_c = (int(c * scale) for c in (in_c, mid_c, out_c))
        self.dw = nn.Sequential(
            nn.Conv2D(in_c, mid_c, 3, stride=stride, padding=1,
                      groups=in_c, bias_attr=False),
            nn.BatchNorm2D(mid_c), nn.ReLU(),
        )
        self.pw = nn.Sequential(
            nn.Conv2D(mid_c, out_c, 1, bias_attr=False),
            nn.BatchNorm2D(out_c), nn.ReLU(),
        )

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = nn.Sequential(
            nn.Conv2D(3, int(32 * scale), 3, stride=2, padding=1,
                      bias_attr=False),
            nn.BatchNorm2D(int(32 * scale)), nn.ReLU(),
        )
        # (in, mid, out, stride) per reference block list
        cfg = [(32, 32, 64, 1), (64, 64, 128, 2), (128, 128, 128, 1),
               (128, 128, 256, 2), (256, 256, 256, 1), (256, 256, 512, 2),
               (512, 512, 512, 1), (512, 512, 512, 1), (512, 512, 512, 1),
               (512, 512, 512, 1), (512, 512, 512, 1), (512, 512, 1024, 2),
               (1024, 1024, 1024, 1)]
        self.blocks = nn.Sequential(*[
            _DepthwiseSeparable(i, m, o, s, scale) for i, m, o, s in cfg])
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(int(1024 * scale), num_classes)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)
