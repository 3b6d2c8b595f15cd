"""LeNet. Counterpart of `paddle_tpu/models/lenet.py` (paddle's
`vision/models/lenet.py`): two conv + ReLU + max-pool stages on a
1 x 28 x 28 input, then three Linear layers, with the reference's
parameter names (`features.0.weight`, ..., `fc.2.bias`)."""
from __future__ import annotations

from .. import nn
from ..ops.manipulation import flatten


class LeNet(nn.Layer):
    def __init__(self, num_classes=10):
        super().__init__()
        self.num_classes = num_classes
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0),
            nn.ReLU(),
            nn.MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = nn.Sequential(
                nn.Linear(400, 120),
                nn.Linear(120, 84),
                nn.Linear(84, num_classes),
            )

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = flatten.__wrapped__(x, 1)
            x = self.fc(x)
        return x


__all__ = ["LeNet"]
