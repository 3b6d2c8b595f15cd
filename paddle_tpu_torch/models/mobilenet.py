"""MobileNetV1 / V2. Counterpart of `paddle_tpu/models/mobilenet.py`
(paddle's `vision/models/mobilenetv1.py` / `mobilenetv2.py`): depthwise
(groups = channels) and pointwise convolutions, with the reference's
parameter names."""
from __future__ import annotations

from .. import nn
from ..ops.manipulation import flatten


class ConvBNLayer(nn.Layer):
    def __init__(self, in_c, out_c, k, stride=1, padding=0, groups=1,
                 act=True):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride, padding=padding,
                              groups=groups, bias_attr=False)
        self.bn = nn.BatchNorm2D(out_c)
        self.act = nn.ReLU6() if act else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


class DepthwiseSeparable(nn.Layer):
    def __init__(self, in_c, out_c, stride):
        super().__init__()
        self.dw = ConvBNLayer(in_c, in_c, 3, stride=stride, padding=1,
                              groups=in_c)
        self.pw = ConvBNLayer(in_c, out_c, 1)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()

        def s(c):
            return max(8, int(c * scale))

        cfg = [(s(32), s(64), 1), (s(64), s(128), 2), (s(128), s(128), 1),
               (s(128), s(256), 2), (s(256), s(256), 1),
               (s(256), s(512), 2)] + [(s(512), s(512), 1)] * 5 + \
            [(s(512), s(1024), 2), (s(1024), s(1024), 1)]
        self.stem = ConvBNLayer(3, s(32), 3, stride=2, padding=1)
        self.blocks = nn.Sequential(*[DepthwiseSeparable(i, o, st)
                                      for i, o, st in cfg])
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(s(1024), num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten.__wrapped__(x, 1))
        return x


class InvertedResidual(nn.Layer):
    def __init__(self, in_c, out_c, stride, expand):
        super().__init__()
        hidden = int(round(in_c * expand))
        self.use_res = stride == 1 and in_c == out_c
        layers = []
        if expand != 1:
            layers.append(ConvBNLayer(in_c, hidden, 1))
        layers += [ConvBNLayer(hidden, hidden, 3, stride=stride, padding=1,
                               groups=hidden),
                   ConvBNLayer(hidden, out_c, 1, act=False)]
        self.block = nn.Sequential(*layers)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


class MobileNetV2(nn.Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True):
        super().__init__()
        cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
               (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
        in_c = max(8, int(32 * scale))
        self.stem = ConvBNLayer(3, in_c, 3, stride=2, padding=1)
        blocks = []
        for t, c, n, s in cfg:
            out_c = max(8, int(c * scale))
            for i in range(n):
                blocks.append(InvertedResidual(in_c, out_c,
                                               s if i == 0 else 1, t))
                in_c = out_c
        last = max(8, int(1280 * scale)) if scale > 1.0 else 1280
        blocks.append(ConvBNLayer(in_c, last, 1))
        self.blocks = nn.Sequential(*blocks)
        self.with_pool = with_pool
        self.num_classes = num_classes
        if with_pool:
            self.pool = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(last, num_classes)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten.__wrapped__(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    return MobileNetV2(scale=scale, **kwargs)


__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]
