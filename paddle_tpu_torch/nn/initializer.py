"""Parameter initializers.

Counterpart of `paddle_tpu/nn/initializer.py`: Constant, Normal,
TruncatedNormal (at +-2 std), Uniform, XavierNormal / XavierUniform,
KaimingNormal / KaimingUniform (the gain from `negative_slope`;
`nonlinearity` is not read, as in the reference), Assign, Dirac,
Orthogonal and Bilinear, with the same fan-in / fan-out conventions,
`calculate_gain` and `set_global_initializer`. Values are drawn on the
CPU from the package's `torch.Generator` (`core.random`), so one seed
gives one set of weights on every device; JAX keys draw other numbers.

`init(shape, dtype)` returns a new CPU tensor; `init(param)` fills a
parameter (or any tensor) in place and returns it, the reference's call.
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
    # conv weights are OIHW: fan_in = in_ch * kh*kw, fan_out = out_ch * kh*kw
    return shape[1] * receptive, shape[0] * receptive


def _gen():
    return rnd.default_generator()


class Initializer:
    def __call__(self, shape, dtype=torch.float32, block=None):
        if isinstance(shape, torch.Tensor):
            param = shape
            with torch.no_grad():
                param.copy_(self._generate(tuple(param.shape)))
            return param
        return self._generate(tuple(int(s) for s in shape)).to(dtype)

    def _generate(self, shape) -> torch.Tensor:
        """A new f32 CPU tensor of `shape`."""
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
        z = torch.randn(shape, generator=_gen(), dtype=torch.float32)
        return z * self.std + self.mean


class TruncatedNormal(Initializer):
    """A standard normal truncated to [-2, 2], then scaled and shifted."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _generate(self, shape):
        z = torch.empty(shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(z, 0.0, 1.0, -2.0, 2.0, generator=_gen())
        return z * self.std + self.mean


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _generate(self, shape):
        u = torch.rand(shape, generator=_gen(), dtype=torch.float32)
        return u * (self.high - self.low) + self.low


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _generate(self, shape):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return torch.randn(shape, generator=_gen(),
                           dtype=torch.float32) * std


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _generate(self, shape):
        fi, fo = _fan_in_out(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)._generate(shape)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope

    def _generate(self, shape):
        fi = self.fan_in if self.fan_in is not None else _fan_in_out(shape)[0]
        std = math.sqrt(2.0 / (1 + self.negative_slope ** 2)) / math.sqrt(fi)
        return torch.randn(shape, generator=_gen(),
                           dtype=torch.float32) * std


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope

    def _generate(self, shape):
        fi = self.fan_in if self.fan_in is not None else _fan_in_out(shape)[0]
        gain = math.sqrt(2.0 / (1 + self.negative_slope ** 2))
        limit = gain * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)._generate(shape)


class Assign(Initializer):
    """The given values (a tensor, an array or a list), reshaped to the
    parameter's shape."""

    def __init__(self, value):
        self.value = value

    def _generate(self, shape):
        v = self.value
        arr = v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
        return torch.from_numpy(np.array(arr, dtype=np.float32).reshape(shape))


class Dirac(Initializer):
    """Identity convolution: 1 at the kernel's centre of [i, i] for i up
    to min(out, in)."""

    def __init__(self, groups=1):
        self.groups = groups

    def _generate(self, shape):
        out = np.zeros(shape, dtype=np.float32)
        centers = tuple(s // 2 for s in shape[2:])
        for i in range(min(shape[0], shape[1])):
            out[(i, i) + centers] = 1.0
        return torch.from_numpy(out)


class Orthogonal(Initializer):
    """Q of a QR of a normal [max(r, c), min(r, c)] draw, signs fixed by
    R's diagonal, transposed when rows < cols, times `gain`."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def _generate(self, shape):
        rows = shape[0]
        cols = int(np.prod(shape[1:]))
        a = torch.randn((max(rows, cols), min(rows, cols)), generator=_gen(),
                        dtype=torch.float32)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols]).reshape(shape).contiguous()


class Bilinear(Initializer):
    """The bilinear-upsampling stencil of a transposed conv's 4-D weight
    [C_out, C_in, kH, kW]: on [i, i] (and on every pair when C_out !=
    C_in), as the reference fills it."""

    def _generate(self, shape):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D conv weight")
        co, ci, kh, kw = shape
        f_h, f_w = (kh + 1) // 2, (kw + 1) // 2
        c_h = (kh - 1) / 2.0 if kh % 2 == 1 else f_h - 0.5
        c_w = (kw - 1) / 2.0 if kw % 2 == 1 else f_w - 0.5
        og = np.ogrid[:kh, :kw]
        filt = (1 - abs(og[0] - c_h) / f_h) * (1 - abs(og[1] - c_w) / f_w)
        w = np.zeros((co, ci, kh, kw), np.float32)
        w[range(min(co, ci)), range(min(co, ci))] = filt
        if co != ci:
            w[:, :] = filt
        return torch.from_numpy(w)


def calculate_gain(nonlinearity, param=None):
    """The reference's gain table."""
    gains = {"sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
             "conv3d": 1.0, "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
             "conv3d_transpose": 1.0, "tanh": 5.0 / 3.0,
             "relu": math.sqrt(2.0), "selu": 3.0 / 4.0}
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity not in gains:
        raise ValueError(f"unsupported nonlinearity {nonlinearity!r}")
    return gains[nonlinearity]


_GLOBAL_INITIALIZER = [None, None]   # (weight_init, bias_init)


def set_global_initializer(weight_init, bias_init=None):
    """Initializers that replace the layers' own defaults in
    `Layer.create_parameter`; a `ParamAttr.initializer` still wins."""
    _GLOBAL_INITIALIZER[0] = weight_init
    _GLOBAL_INITIALIZER[1] = bias_init


__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "Dirac", "Orthogonal", "Bilinear", "calculate_gain",
           "set_global_initializer"]
