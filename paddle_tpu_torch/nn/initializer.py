"""Parameter initializers used by the ported layers.

Counterpart of `paddle_tpu/nn/initializer.py` (Constant, Normal, Uniform,
XavierNormal) with the same fan-in/fan-out conventions. Values are drawn
on the CPU from the package's `torch.Generator` (`core.random`), so one
seed gives one set of weights on every device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import random as rnd


def _fan_in_out(shape):
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype=torch.float32) -> torch.Tensor:
        """A new CPU tensor of `shape` and `dtype`."""
        return self._generate(tuple(int(s) for s in shape)).to(dtype)

    def _generate(self, shape) -> torch.Tensor:
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _generate(self, shape):
        return torch.full(shape, float(self.value), dtype=torch.float32)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _generate(self, shape):
        z = torch.randn(shape, generator=rnd.default_generator(),
                        dtype=torch.float32)
        return z * self.std + self.mean


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _generate(self, shape):
        u = torch.rand(shape, generator=rnd.default_generator(),
                       dtype=torch.float32)
        return u * (self.high - self.low) + self.low


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _generate(self, shape):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return torch.randn(shape, generator=rnd.default_generator(),
                           dtype=torch.float32) * std


__all__ = ["Initializer", "Constant", "Normal", "Uniform", "XavierNormal"]
