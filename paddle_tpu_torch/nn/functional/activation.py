"""Activation functionals.

Counterpart of `paddle_tpu/nn/functional/activation.py`: the same formulas
over torch ops (elementwise work the reference leaves to XLA). `softmax`
and `log_softmax` take `dtype` and ignore it, as the reference does. The
in-place forms (`relu_`, `elu_`, `softmax_`, `tanh_`) write the result
into x's storage and return x (the reference rebinds x's value to the
result): on a leaf that needs a gradient torch raises, as for any in-place
op there.

`rrelu` (training) and `gumbel_softmax` draw from torch's generator of
the input's device, which `paddle_tpu_torch.seed` seeds: JAX keys and
torch's generators give different numbers from one seed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

_SELU_SCALE = 1.0507009873554805
_SELU_ALPHA = 1.6732632423543772


def relu(x, name=None):
    return torch.relu(x)


def relu6(x, name=None):
    return TF.relu6(x)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def tanh(x, name=None):
    return torch.tanh(x)


def silu(x, name=None):
    return TF.silu(x)


swish = silu


def mish(x, name=None):
    return x * torch.tanh(TF.softplus(x))


def hardswish(x, name=None):
    return TF.hardswish(x)


def hardsigmoid(x, name=None):
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def softsign(x, name=None):
    return x / (1 + torch.abs(x))


def log_sigmoid(x, name=None):
    return TF.logsigmoid(x)


def gelu(x, approximate=False, name=None):
    """Exact (erf) GELU, or the tanh form with approximate=True."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, x * negative_slope)


def elu(x, alpha=1.0, name=None):
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return TF.celu(x, alpha)


def selu(x, scale=_SELU_SCALE, alpha=_SELU_ALPHA, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(torch.abs(x) > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    z = x * beta
    soft = torch.logaddexp(z, torch.zeros((), dtype=z.dtype, device=z.device))
    return torch.where(z > threshold, x, soft / beta)


def prelu(x, weight, data_format="NCHW", name=None):
    """x where positive, else x * weight; a weight of more than one value
    is per channel (axis 1, or the last axis when channel-last)."""
    w = weight
    if w.numel() > 1:
        ax = 1 if data_format.upper().startswith("NC") else x.ndim - 1
        shape = [1] * x.ndim
        shape[ax] = w.numel()
        w = w.reshape(shape)
    return torch.where(x > 0, x, x * w)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=True, name=None):
    """Training: a slope drawn uniformly from [lower, upper) per element;
    otherwise the mean slope."""
    if training:
        slope = torch.empty(x.shape, dtype=torch.float32,
                            device=x.device).uniform_(lower, upper)
        return torch.where(x >= 0, x, x * slope.to(x.dtype))
    return torch.where(x >= 0, x, x * ((lower + upper) / 2.0))


def softmax(x, axis=-1, dtype=None, name=None):
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    return torch.log_softmax(x, dim=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    u = torch.empty(x.shape, dtype=torch.float32,
                    device=x.device).uniform_(1e-20, 1.0)
    g = -torch.log(-torch.log(u))
    y = torch.softmax((x + g.to(x.dtype)) / temperature, dim=axis)
    if hard:
        idx = torch.argmax(y, dim=axis, keepdim=True)
        y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = y_hard + y - y.detach()
    return y


def maxout(x, groups, axis=1, name=None):
    """Channels of `axis` split into [C // groups, groups], max over the
    second (the reference's reshape)."""
    axis = axis % x.ndim
    shp = list(x.shape)
    shp[axis:axis + 1] = [shp[axis] // groups, groups]
    return torch.amax(x.reshape(shp), dim=axis + 1)


def glu(x, axis=-1, name=None):
    return TF.glu(x, dim=axis)


def thresholded_relu(x, threshold=1.0, name=None):
    return torch.where(x > threshold, x, torch.zeros_like(x))


def _into(x, out):
    """Write `out` into x's storage and return x."""
    x.copy_(out)
    return x


def relu_(x, name=None):
    return _into(x, relu(x))


def elu_(x, alpha=1.0, name=None):
    return _into(x, elu(x, alpha))


def softmax_(x, axis=-1, dtype=None, name=None):
    return _into(x, softmax(x, axis, dtype))


def tanh_(x, name=None):
    return _into(x, tanh(x))


__all__ = ["relu", "relu6", "sigmoid", "tanh", "silu", "swish", "mish",
           "hardswish", "hardsigmoid", "tanhshrink", "softsign",
           "log_sigmoid", "gelu", "leaky_relu", "elu", "celu", "selu",
           "hardtanh", "hardshrink", "softshrink", "softplus", "prelu",
           "rrelu", "softmax", "log_softmax", "gumbel_softmax", "maxout",
           "glu", "thresholded_relu", "relu_", "elu_", "softmax_", "tanh_"]
