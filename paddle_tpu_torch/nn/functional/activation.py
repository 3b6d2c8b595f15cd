"""Activation functionals. Counterpart of
`paddle_tpu/nn/functional/activation.py`."""
from __future__ import annotations

import torch
import torch.nn.functional as TF


def gelu(x, approximate=False, name=None):
    """Exact (erf) GELU, or the tanh form with approximate=True."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x, name=None):
    return torch.tanh(x)


__all__ = ["gelu", "tanh"]
