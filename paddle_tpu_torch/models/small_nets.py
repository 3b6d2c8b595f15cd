"""AlexNet / SqueezeNet / ShuffleNetV2 / DenseNet / GoogLeNet / InceptionV3.

Counterpart of `paddle_tpu/models/small_nets.py` (paddle's
`vision/models/{alexnet,squeezenet,shufflenetv2,densenet,googlenet,
inceptionv3}.py`): the classes and constructors with the reference's
parameter names and geometry, NCHW.
"""
from __future__ import annotations

import torch

from .. import nn


class AlexNet(nn.Layer):
    def __init__(self, num_classes=1000):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2D(3, 64, 11, stride=4, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
            nn.Conv2D(64, 192, 5, padding=2), nn.ReLU(),
            nn.MaxPool2D(3, stride=2),
            nn.Conv2D(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2D(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2D(256, 256, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, stride=2))
        self.classifier = nn.Sequential(
            nn.Dropout(0.5), nn.Linear(256 * 6 * 6, 4096), nn.ReLU(),
            nn.Dropout(0.5), nn.Linear(4096, 4096), nn.ReLU(),
            nn.Linear(4096, num_classes))

    def forward(self, x):
        x = self.features(x)
        return self.classifier(x.reshape(x.shape[0], -1))


def alexnet(**kw):
    return AlexNet(**kw)


class _Fire(nn.Layer):
    def __init__(self, cin, squeeze, e1, e3):
        super().__init__()
        self.squeeze = nn.Conv2D(cin, squeeze, 1)
        self.expand1 = nn.Conv2D(squeeze, e1, 1)
        self.expand3 = nn.Conv2D(squeeze, e3, 3, padding=1)
        self.act = nn.ReLU()

    def forward(self, x):
        s = self.act(self.squeeze(x))
        return torch.cat([self.act(self.expand1(s)),
                          self.act(self.expand3(s))], 1)


class SqueezeNet(nn.Layer):
    def __init__(self, num_classes=1000, version="1.1"):
        super().__init__()
        if version == "1.0":
            self.features = nn.Sequential(
                nn.Conv2D(3, 96, 7, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                _Fire(96, 16, 64, 64), _Fire(128, 16, 64, 64),
                _Fire(128, 32, 128, 128),
                nn.MaxPool2D(3, stride=2),
                _Fire(256, 32, 128, 128), _Fire(256, 48, 192, 192),
                _Fire(384, 48, 192, 192), _Fire(384, 64, 256, 256),
                nn.MaxPool2D(3, stride=2),
                _Fire(512, 64, 256, 256))
        else:
            self.features = nn.Sequential(
                nn.Conv2D(3, 64, 3, stride=2), nn.ReLU(),
                nn.MaxPool2D(3, stride=2),
                _Fire(64, 16, 64, 64), _Fire(128, 16, 64, 64),
                nn.MaxPool2D(3, stride=2),
                _Fire(128, 32, 128, 128), _Fire(256, 32, 128, 128),
                nn.MaxPool2D(3, stride=2),
                _Fire(256, 48, 192, 192), _Fire(384, 48, 192, 192),
                _Fire(384, 64, 256, 256), _Fire(512, 64, 256, 256))
        self.head = nn.Sequential(nn.Dropout(0.5),
                                  nn.Conv2D(512, num_classes, 1), nn.ReLU(),
                                  nn.AdaptiveAvgPool2D(1))

    def forward(self, x):
        x = self.head(self.features(x))
        return x.reshape(x.shape[0], -1)


def squeezenet1_0(**kw):
    return SqueezeNet(version="1.0", **kw)


def squeezenet1_1(**kw):
    return SqueezeNet(**kw)


class _ShuffleUnit(nn.Layer):
    def __init__(self, cin, cout, stride, act="relu"):
        super().__init__()
        self.stride = stride
        branch = cout // 2

        def mk_act():
            return nn.Swish() if act == "swish" else nn.ReLU()

        if stride == 2:
            self.b1 = nn.Sequential(
                nn.Conv2D(cin, cin, 3, stride=2, padding=1, groups=cin),
                nn.BatchNorm2D(cin),
                nn.Conv2D(cin, branch, 1), nn.BatchNorm2D(branch), mk_act())
            c2in = cin
        else:
            self.b1 = None
            c2in = cin // 2
        self.b2 = nn.Sequential(
            nn.Conv2D(c2in, branch, 1), nn.BatchNorm2D(branch), mk_act(),
            nn.Conv2D(branch, branch, 3, stride=stride, padding=1,
                      groups=branch),
            nn.BatchNorm2D(branch),
            nn.Conv2D(branch, branch, 1), nn.BatchNorm2D(branch), mk_act())

    def forward(self, x):
        if self.stride == 2:
            out = torch.cat([self.b1(x), self.b2(x)], 1)
        else:
            half = x.shape[1] // 2
            out = torch.cat([x[:, :half], self.b2(x[:, half:])], 1)
        # channel shuffle over 2 groups
        n, c, h, w = out.shape
        return out.reshape(n, 2, c // 2, h, w).transpose(1, 2) \
            .reshape(n, c, h, w)


class ShuffleNetV2(nn.Layer):
    def __init__(self, num_classes=1000, scale=1.0, act="relu"):
        super().__init__()
        self._act = act
        stages = {0.25: [24, 48, 96, 512], 0.33: [32, 64, 128, 512],
                  0.5: [48, 96, 192, 1024], 1.0: [116, 232, 464, 1024],
                  1.5: [176, 352, 704, 1024],
                  2.0: [244, 488, 976, 2048]}[scale]
        self.stem = nn.Sequential(nn.Conv2D(3, 24, 3, stride=2, padding=1),
                                  nn.BatchNorm2D(24), nn.ReLU(),
                                  nn.MaxPool2D(3, stride=2, padding=1))
        blocks = []
        cin = 24
        for cout, reps in zip(stages[:3], (4, 8, 4)):
            blocks.append(_ShuffleUnit(cin, cout, 2, act=act))
            for _ in range(reps - 1):
                blocks.append(_ShuffleUnit(cout, cout, 1, act=act))
            cin = cout
        self.stages = nn.Sequential(*blocks)
        self.tail = nn.Sequential(nn.Conv2D(cin, stages[3], 1),
                                  nn.BatchNorm2D(stages[3]), nn.ReLU(),
                                  nn.AdaptiveAvgPool2D(1))
        self.fc = nn.Linear(stages[3], num_classes)

    def forward(self, x):
        x = self.tail(self.stages(self.stem(x)))
        return self.fc(x.reshape(x.shape[0], -1))


def shufflenet_v2_x0_25(**kw):
    return ShuffleNetV2(scale=0.25, **kw)


def shufflenet_v2_x0_33(**kw):
    return ShuffleNetV2(scale=0.33, **kw)


def shufflenet_v2_x0_5(**kw):
    return ShuffleNetV2(scale=0.5, **kw)


def shufflenet_v2_x1_0(**kw):
    return ShuffleNetV2(scale=1.0, **kw)


def shufflenet_v2_x1_5(**kw):
    return ShuffleNetV2(scale=1.5, **kw)


def shufflenet_v2_x2_0(**kw):
    return ShuffleNetV2(scale=2.0, **kw)


def shufflenet_v2_swish(**kw):
    return ShuffleNetV2(scale=1.0, act="swish", **kw)


class _DenseLayer(nn.Layer):
    def __init__(self, cin, growth, bn_size=4):
        super().__init__()
        self.fn = nn.Sequential(
            nn.BatchNorm2D(cin), nn.ReLU(),
            nn.Conv2D(cin, bn_size * growth, 1),
            nn.BatchNorm2D(bn_size * growth), nn.ReLU(),
            nn.Conv2D(bn_size * growth, growth, 3, padding=1))

    def forward(self, x):
        return torch.cat([x, self.fn(x)], 1)


class DenseNet(nn.Layer):
    def __init__(self, layers=(6, 12, 24, 16), growth=32, num_classes=1000,
                 init_features=64):
        super().__init__()
        c = init_features
        feats = [nn.Conv2D(3, c, 7, stride=2, padding=3),
                 nn.BatchNorm2D(c), nn.ReLU(),
                 nn.MaxPool2D(3, stride=2, padding=1)]
        for bi, n in enumerate(layers):
            for _ in range(n):
                feats.append(_DenseLayer(c, growth))
                c += growth
            if bi != len(layers) - 1:
                feats += [nn.BatchNorm2D(c), nn.ReLU(),
                          nn.Conv2D(c, c // 2, 1), nn.AvgPool2D(2, stride=2)]
                c //= 2
        feats += [nn.BatchNorm2D(c), nn.ReLU(), nn.AdaptiveAvgPool2D(1)]
        self.features = nn.Sequential(*feats)
        self.fc = nn.Linear(c, num_classes)

    def forward(self, x):
        x = self.features(x)
        return self.fc(x.reshape(x.shape[0], -1))


def densenet121(**kw):
    return DenseNet(layers=(6, 12, 24, 16), **kw)


def densenet161(**kw):
    return DenseNet(layers=(6, 12, 36, 24), growth=48, init_features=96, **kw)


def densenet169(**kw):
    return DenseNet(layers=(6, 12, 32, 32), **kw)


def densenet201(**kw):
    return DenseNet(layers=(6, 12, 48, 32), **kw)


def densenet264(**kw):
    return DenseNet(layers=(6, 12, 64, 48), **kw)


class _Inception(nn.Layer):
    def __init__(self, cin, c1, c3r, c3, c5r, c5, pp):
        super().__init__()
        self.b1 = nn.Sequential(nn.Conv2D(cin, c1, 1), nn.ReLU())
        self.b2 = nn.Sequential(nn.Conv2D(cin, c3r, 1), nn.ReLU(),
                                nn.Conv2D(c3r, c3, 3, padding=1), nn.ReLU())
        self.b3 = nn.Sequential(nn.Conv2D(cin, c5r, 1), nn.ReLU(),
                                nn.Conv2D(c5r, c5, 5, padding=2), nn.ReLU())
        self.b4 = nn.Sequential(nn.MaxPool2D(3, stride=1, padding=1),
                                nn.Conv2D(cin, pp, 1), nn.ReLU())

    def forward(self, x):
        return torch.cat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)], 1)


class _AuxHead(nn.Layer):
    def __init__(self, cin, num_classes):
        super().__init__()
        self.pool = nn.AdaptiveAvgPool2D(4)
        self.conv = nn.Conv2D(cin, 128, 1)
        self.act = nn.ReLU()
        self.fc1 = nn.Linear(128 * 16, 1024)
        self.drop = nn.Dropout(0.7)
        self.fc2 = nn.Linear(1024, num_classes)

    def forward(self, x):
        x = self.act(self.conv(self.pool(x)))
        x = self.fc1(x.reshape(x.shape[0], -1))
        return self.fc2(self.drop(self.act(x)))


class GoogLeNet(nn.Layer):
    """Inception v1 with two auxiliary heads; forward returns
    [out, aux1, aux2], as the reference's."""

    def __init__(self, num_classes=1000):
        super().__init__()
        self.stem = nn.Sequential(
            nn.Conv2D(3, 64, 7, stride=2, padding=3), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, padding=1),
            nn.Conv2D(64, 64, 1), nn.ReLU(),
            nn.Conv2D(64, 192, 3, padding=1), nn.ReLU(),
            nn.MaxPool2D(3, stride=2, padding=1))
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
        self.gap = nn.AdaptiveAvgPool2D(1)
        self.drop = nn.Dropout(0.4)
        self.fc = nn.Linear(1024, num_classes)
        self.aux1 = _AuxHead(512, num_classes)
        self.aux2 = _AuxHead(528, num_classes)

    def forward(self, x):
        x = self.i3b(self.i3a(self.stem(x)))
        x = self.i4a(self.pool3(x))
        a1 = self.aux1(x)
        x = self.i4d(self.i4c(self.i4b(x)))
        a2 = self.aux2(x)
        x = self.i5b(self.i5a(self.pool4(self.i4e(x))))
        out = self.fc(self.drop(self.gap(x)).reshape(x.shape[0], -1))
        return [out, a1, a2]


def googlenet(**kw):
    return GoogLeNet(**kw)


class _ConvBN(nn.Layer):
    def __init__(self, cin, cout, k, s=1, p=0):
        super().__init__()
        self.conv = nn.Conv2D(cin, cout, k, stride=s, padding=p,
                              bias_attr=False)
        self.bn = nn.BatchNorm2D(cout)
        self.act = nn.ReLU()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class _IncA(nn.Layer):
    """InceptionV3 figure-5 block (35 x 35)."""

    def __init__(self, cin, pool_ch):
        super().__init__()
        self.b1 = _ConvBN(cin, 64, 1)
        self.b5 = nn.Sequential(_ConvBN(cin, 48, 1), _ConvBN(48, 64, 5, p=2))
        self.b3 = nn.Sequential(_ConvBN(cin, 64, 1), _ConvBN(64, 96, 3, p=1),
                                _ConvBN(96, 96, 3, p=1))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _ConvBN(cin, pool_ch, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)], 1)


class _IncRedA(nn.Layer):
    """figure-10 grid reduction 35 -> 17."""

    def __init__(self, cin):
        super().__init__()
        self.b3 = _ConvBN(cin, 384, 3, s=2)
        self.b33 = nn.Sequential(_ConvBN(cin, 64, 1), _ConvBN(64, 96, 3, p=1),
                                 _ConvBN(96, 96, 3, s=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b33(x), self.pool(x)], 1)


class _IncB(nn.Layer):
    """figure-6 block (17 x 17, factorized 7 x 7)."""

    def __init__(self, cin, c7):
        super().__init__()
        self.b1 = _ConvBN(cin, 192, 1)
        self.b7 = nn.Sequential(
            _ConvBN(cin, c7, 1), _ConvBN(c7, c7, (1, 7), p=(0, 3)),
            _ConvBN(c7, 192, (7, 1), p=(3, 0)))
        self.b77 = nn.Sequential(
            _ConvBN(cin, c7, 1), _ConvBN(c7, c7, (7, 1), p=(3, 0)),
            _ConvBN(c7, c7, (1, 7), p=(0, 3)),
            _ConvBN(c7, c7, (7, 1), p=(3, 0)),
            _ConvBN(c7, 192, (1, 7), p=(0, 3)))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _ConvBN(cin, 192, 1))

    def forward(self, x):
        return torch.cat([self.b1(x), self.b7(x), self.b77(x), self.bp(x)],
                         1)


class _IncRedB(nn.Layer):
    """grid reduction 17 -> 8."""

    def __init__(self, cin):
        super().__init__()
        self.b3 = nn.Sequential(_ConvBN(cin, 192, 1),
                                _ConvBN(192, 320, 3, s=2))
        self.b7 = nn.Sequential(
            _ConvBN(cin, 192, 1), _ConvBN(192, 192, (1, 7), p=(0, 3)),
            _ConvBN(192, 192, (7, 1), p=(3, 0)), _ConvBN(192, 192, 3, s=2))
        self.pool = nn.MaxPool2D(3, stride=2)

    def forward(self, x):
        return torch.cat([self.b3(x), self.b7(x), self.pool(x)], 1)


class _IncC(nn.Layer):
    """figure-7 block (8 x 8, expanded filter bank)."""

    def __init__(self, cin):
        super().__init__()
        self.b1 = _ConvBN(cin, 320, 1)
        self.b3_stem = _ConvBN(cin, 384, 1)
        self.b3_a = _ConvBN(384, 384, (1, 3), p=(0, 1))
        self.b3_b = _ConvBN(384, 384, (3, 1), p=(1, 0))
        self.b33_stem = nn.Sequential(_ConvBN(cin, 448, 1),
                                      _ConvBN(448, 384, 3, p=1))
        self.b33_a = _ConvBN(384, 384, (1, 3), p=(0, 1))
        self.b33_b = _ConvBN(384, 384, (3, 1), p=(1, 0))
        self.bp = nn.Sequential(nn.AvgPool2D(3, stride=1, padding=1),
                                _ConvBN(cin, 192, 1))

    def forward(self, x):
        s3 = self.b3_stem(x)
        s33 = self.b33_stem(x)
        return torch.cat([self.b1(x), self.b3_a(s3), self.b3_b(s3),
                          self.b33_a(s33), self.b33_b(s33), self.bp(x)], 1)


class InceptionV3(nn.Layer):
    """299 x 299 input."""

    def __init__(self, num_classes=1000, with_pool=True):
        super().__init__()
        self.stem = nn.Sequential(
            _ConvBN(3, 32, 3, s=2), _ConvBN(32, 32, 3),
            _ConvBN(32, 64, 3, p=1), nn.MaxPool2D(3, stride=2),
            _ConvBN(64, 80, 1), _ConvBN(80, 192, 3),
            nn.MaxPool2D(3, stride=2))
        self.blocks = nn.Sequential(
            _IncA(192, 32), _IncA(256, 64), _IncA(288, 64),
            _IncRedA(288),
            _IncB(768, 128), _IncB(768, 160), _IncB(768, 160),
            _IncB(768, 192),
            _IncRedB(768),
            _IncC(1280), _IncC(2048))
        self.pool = nn.AdaptiveAvgPool2D(1)
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        x = self.pool(self.blocks(self.stem(x)))
        return self.fc(x.reshape(x.shape[0], -1))


def inception_v3(**kw):
    return InceptionV3(**kw)
