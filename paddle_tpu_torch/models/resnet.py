"""ResNet family. Counterpart of `paddle_tpu/models/resnet.py` (paddle's
`vision/models/resnet.py` and `resnext.py`): BasicBlock, BottleneckBlock,
ResNet at depth 18-152 with `width`, `groups`, `with_pool`, `num_classes`
and `data_format`, the eight constructors, and ResNeXt with its six. The
parameter names are the reference's, so a state dict moves across.

`data_format="NHWC"` is the layout to serve in on the card: the convs, the
batch norms and the pools run as channels-last views into cuDNN's NHWC
kernels (PERF.md §5: the stem's NCHW batch norm alone costs 3x NHWC's).
"""
from __future__ import annotations

import functools

from .. import nn
from ..ops.manipulation import flatten


class BasicBlock(nn.Layer):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW"):
        super().__init__()
        df = data_format
        if norm_layer is None:
            norm_layer = functools.partial(nn.BatchNorm2D, data_format=df)
        self.conv1 = nn.Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                               bias_attr=False, data_format=df)
        self.bn1 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               data_format=df)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Layer):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW"):
        super().__init__()
        df = data_format
        if norm_layer is None:
            norm_layer = functools.partial(nn.BatchNorm2D, data_format=df)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False,
                               data_format=df)
        self.bn1 = norm_layer(width)
        self.conv2 = nn.Conv2D(width, width, 3, stride=stride,
                               padding=dilation, groups=groups,
                               dilation=dilation, bias_attr=False,
                               data_format=df)
        self.bn2 = norm_layer(width)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False, data_format=df)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Layer):
    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW"):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.groups = groups
        self.base_width = width
        self.inplanes = 64
        self.dilation = 1
        self.data_format = data_format

        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False, data_format=data_format)
        self.bn1 = nn.BatchNorm2D(self.inplanes, data_format=data_format)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1,
                                    data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1),
                                                data_format=data_format)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes)

    def _make_layer(self, block, planes, blocks, stride=1):
        df = self.data_format
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False, data_format=df),
                nn.BatchNorm2D(planes * block.expansion, data_format=df))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, data_format=df)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width, data_format=df))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = flatten.__wrapped__(x, 1)
            x = self.fc(x)
        return x


def resnet18(pretrained=False, **kwargs):
    return ResNet(BasicBlock, 18, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return ResNet(BasicBlock, 34, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 50, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 101, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 152, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 50, width=128, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 101, width=128, **kwargs)


class ResNeXt(ResNet):
    """ResNet bottlenecks with grouped 3x3 convs (cardinality x
    width_per_group)."""

    def __init__(self, depth=50, cardinality=32, width_per_group=4,
                 num_classes=1000, **kw):
        super().__init__(BottleneckBlock, depth=depth, groups=cardinality,
                         width=width_per_group, num_classes=num_classes, **kw)


def _resnext(depth, card, wpg, **kw):
    return ResNeXt(depth=depth, cardinality=card, width_per_group=wpg, **kw)


def resnext50_32x4d(**kw):
    return _resnext(50, 32, 4, **kw)


def resnext50_64x4d(**kw):
    return _resnext(50, 64, 4, **kw)


def resnext101_32x4d(**kw):
    return _resnext(101, 32, 4, **kw)


def resnext101_64x4d(**kw):
    return _resnext(101, 64, 4, **kw)


def resnext152_32x4d(**kw):
    return _resnext(152, 32, 4, **kw)


def resnext152_64x4d(**kw):
    return _resnext(152, 64, 4, **kw)


__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2", "ResNeXt",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d"]
