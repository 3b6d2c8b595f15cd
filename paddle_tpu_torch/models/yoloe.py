"""PP-YOLOE-style detector (BASELINE config 4, conv-heavy inference).

Counterpart of `paddle_tpu/models/yoloe.py`: `ConvBNAct`, `CSPResStage`,
`PPYOLOEBackbone`, `PPYOLOEHead` (a list of three head maps), `PPYOLOE`
and `ppyoloe_s` / `m` / `l`, with the reference's parameter names.
`data_format="NHWC"` is the layout to serve in on the card (channels-last
cuDNN convolutions and batch norms, as `models/resnet.py`).
"""
from __future__ import annotations

import torch

from .. import nn


class ConvBNAct(nn.Layer):
    def __init__(self, in_c, out_c, k=3, stride=1, groups=1, act="silu",
                 data_format="NCHW"):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride,
                              padding=(k - 1) // 2, groups=groups,
                              bias_attr=False, data_format=data_format)
        self.bn = nn.BatchNorm2D(out_c, data_format=data_format)
        self.act = nn.Silu() if act else None

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


class CSPResStage(nn.Layer):
    def __init__(self, in_c, out_c, n_blocks, stride=2, data_format="NCHW"):
        super().__init__()
        df = data_format
        self.down = ConvBNAct(in_c, out_c, 3, stride=stride, data_format=df)
        mid = out_c // 2
        self.conv1 = ConvBNAct(out_c, mid, 1, data_format=df)
        self.conv2 = ConvBNAct(out_c, mid, 1, data_format=df)
        self.blocks = nn.Sequential(*[
            nn.Sequential(ConvBNAct(mid, mid, 3, data_format=df),
                          ConvBNAct(mid, mid, 3, data_format=df))
            for _ in range(n_blocks)])
        self.fuse = ConvBNAct(out_c, out_c, 1, data_format=df)
        self._cat_axis = -1 if df == "NHWC" else 1

    def forward(self, x):
        x = self.down(x)
        a = self.conv1(x)
        b = self.blocks(self.conv2(x))
        return self.fuse(torch.cat([a, b], self._cat_axis))


class PPYOLOEBackbone(nn.Layer):
    def __init__(self, width_mult=0.5, depth_mult=0.33, data_format="NCHW"):
        super().__init__()
        df = data_format

        def w(c):
            return max(8, int(c * width_mult))

        def d(n):
            return max(1, round(n * depth_mult))

        self.stem = nn.Sequential(
            ConvBNAct(3, w(32), 3, stride=2, data_format=df),
            ConvBNAct(w(32), w(64), 3, stride=2, data_format=df))
        self.stage1 = CSPResStage(w(64), w(128), d(3), data_format=df)
        self.stage2 = CSPResStage(w(128), w(256), d(6), data_format=df)
        self.stage3 = CSPResStage(w(256), w(512), d(3), data_format=df)
        self.out_channels = [w(128), w(256), w(512)]

    def forward(self, x):
        c3 = self.stage1(self.stem(x))
        c4 = self.stage2(c3)
        return c3, c4, self.stage3(c4)


class PPYOLOEHead(nn.Layer):
    def __init__(self, in_channels, num_classes=80, num_anchors=1,
                 data_format="NCHW"):
        super().__init__()
        self.heads = nn.LayerList([
            nn.Conv2D(c, num_anchors * (5 + num_classes), 1,
                      data_format=data_format) for c in in_channels])

    def forward(self, feats):
        return [h(f) for h, f in zip(self.heads, feats)]


class PPYOLOE(nn.Layer):
    def __init__(self, num_classes=80, width_mult=0.5, depth_mult=0.33,
                 data_format="NCHW"):
        super().__init__()
        self.backbone = PPYOLOEBackbone(width_mult, depth_mult,
                                        data_format=data_format)
        self.head = PPYOLOEHead(self.backbone.out_channels, num_classes,
                                data_format=data_format)

    def forward(self, x):
        return self.head(self.backbone(x))


def ppyoloe_s(**kw):
    return PPYOLOE(width_mult=0.5, depth_mult=0.33, **kw)


def ppyoloe_m(**kw):
    return PPYOLOE(width_mult=0.75, depth_mult=0.67, **kw)


def ppyoloe_l(**kw):
    return PPYOLOE(width_mult=1.0, depth_mult=1.0, **kw)
