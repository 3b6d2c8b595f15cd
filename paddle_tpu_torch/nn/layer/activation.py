"""Activation layers. Counterpart of `paddle_tpu/nn/layer/activation.py`
(GELU :34, exact erf by default; Tanh :23, the ERNIE pooler's)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class Tanh(Layer):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanh(x)


__all__ = ["GELU", "Tanh"]
