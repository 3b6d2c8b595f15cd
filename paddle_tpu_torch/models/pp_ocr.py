"""PP-OCRv3-style text recognizer: conv backbone -> BiLSTM -> CTC head.

Counterpart of `paddle_tpu/models/pp_ocr.py`: `RecBackbone`,
`SequenceEncoder` (the height pooled by a mean, then a two-layer
bidirectional `nn.LSTM`, :71-85), `CTCHead`, `PPOCRRec` (NHWC only,
:96-112) with its CTC loss (:116-128) and `pp_ocrv3_rec`, with the
reference's parameter names. Each BiLSTM layer is one call of torch's fused
LSTM op (cuDNN on the card), and an exported program keeps it as one
`aten.lstm.input` node (`nn/layer/rnn.py`).
"""
from __future__ import annotations

import numpy as np

from .. import nn
from ..nn import functional as F


class _ConvBNAct(nn.Layer):
    def __init__(self, in_c, out_c, k=3, stride=1, groups=1,
                 data_format="NHWC"):
        super().__init__()
        self.conv = nn.Conv2D(in_c, out_c, k, stride=stride,
                              padding=(k - 1) // 2, groups=groups,
                              bias_attr=False, data_format=data_format)
        self.bn = nn.BatchNorm2D(out_c, data_format=data_format)
        self.act = nn.Hardswish()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class _DepthwiseSeparable(nn.Layer):
    def __init__(self, in_c, out_c, stride, data_format="NHWC"):
        super().__init__()
        self.dw = _ConvBNAct(in_c, in_c, 3, stride=stride, groups=in_c,
                             data_format=data_format)
        self.pw = _ConvBNAct(in_c, out_c, 1, data_format=data_format)

    def forward(self, x):
        return self.pw(self.dw(x))


class RecBackbone(nn.Layer):
    """MobileNetV1-style backbone: the stages' strides (2, 1) halve H only,
    so the width axis stays long for the sequence stage."""

    def __init__(self, in_channels=3, scale=0.5, data_format="NHWC"):
        super().__init__()

        def c(ch):
            return max(8, int(ch * scale))

        df = data_format
        cfg = [(64, (2, 1)), (128, (1, 1)), (128, (2, 1)), (256, (1, 1)),
               (256, (2, 1)), (512, (1, 1))]
        self.stem = _ConvBNAct(in_channels, c(32), 3, stride=2,
                               data_format=df)
        blocks = []
        in_c = c(32)
        for out_c, stride in cfg:
            blocks.append(_DepthwiseSeparable(in_c, c(out_c), stride, df))
            in_c = c(out_c)
        self.blocks = nn.Sequential(*blocks)
        self.out_channels = in_c
        self.data_format = df

    def forward(self, x):
        return self.blocks(self.stem(x))


class SequenceEncoder(nn.Layer):
    """The height pooled away, then a bidirectional LSTM over the width."""

    def __init__(self, in_channels, hidden_size=48, num_layers=2):
        super().__init__()
        self.lstm = nn.LSTM(in_channels, hidden_size, num_layers=num_layers,
                            direction="bidirect")
        self.out_channels = hidden_size * 2

    def forward(self, x):
        # [B, H', W', C] (NHWC) -> [B, W', C]
        out, _ = self.lstm(x.mean(1))
        return out


class CTCHead(nn.Layer):
    def __init__(self, in_channels, n_classes):
        super().__init__()
        self.fc = nn.Linear(in_channels, n_classes)

    def forward(self, x):
        return self.fc(x)


class PPOCRRec(nn.Layer):
    """Input [B, 32, W, 3] NHWC images; output per-position logits
    [B, W/2, n_classes], class 0 the CTC blank (only the stem strides the
    width axis)."""

    def __init__(self, n_classes=6625, scale=0.5, hidden_size=48,
                 data_format="NHWC"):
        super().__init__()
        if data_format != "NHWC":
            raise ValueError(
                "PPOCRRec is NHWC-only (the deploy layout); the sequence "
                f"neck pools the height axis: got {data_format}")
        self.backbone = RecBackbone(3, scale, data_format)
        self.neck = SequenceEncoder(self.backbone.out_channels, hidden_size)
        self.head = CTCHead(self.neck.out_channels, n_classes)
        self.n_classes = n_classes

    def forward(self, x):
        return self.head(self.neck(self.backbone(x)))

    def loss(self, logits, labels, label_lengths):
        """CTC training loss; every width position is a valid step."""
        B, T = logits.shape[0], logits.shape[1]
        return F.ctc_loss(logits.permute(1, 0, 2), labels,
                          np.full((B,), T, "int64"), label_lengths,
                          blank=0, reduction="mean")


def pp_ocrv3_rec(n_classes=6625, **kw):
    return PPOCRRec(n_classes=n_classes, **kw)
