"""Activation layers. Counterpart of `paddle_tpu/nn/layer/activation.py`:
the argument-free ones made by `_simple` (:8-31) and one class for each
activation with arguments (PReLU owns its weight)."""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from .layers import Layer


def _simple(fname, cls_name):
    fn = getattr(F, fname)

    class _Act(Layer):
        def __init__(self, name=None):
            super().__init__()

        def forward(self, x):
            return fn(x)

    _Act.__name__ = _Act.__qualname__ = cls_name
    return _Act


ReLU = _simple("relu", "ReLU")
ReLU6 = _simple("relu6", "ReLU6")
Sigmoid = _simple("sigmoid", "Sigmoid")
Tanh = _simple("tanh", "Tanh")
Silu = _simple("silu", "Silu")
Swish = _simple("swish", "Swish")
Mish = _simple("mish", "Mish")
Hardswish = _simple("hardswish", "Hardswish")
Hardsigmoid = _simple("hardsigmoid", "Hardsigmoid")
Tanhshrink = _simple("tanhshrink", "Tanhshrink")
Softsign = _simple("softsign", "Softsign")
LogSigmoid = _simple("log_sigmoid", "LogSigmoid")


class GELU(Layer):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None):
        super().__init__()
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None):
        super().__init__()
        self.alpha = alpha

    def forward(self, x):
        return F.celu(x, self.alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None):
        super().__init__()
        self.scale, self.alpha = scale, alpha

    def forward(self, x):
        return F.selu(x, self.scale, self.alpha)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None):  # noqa: A002
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return F.hardtanh(x, self.min, self.max)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self.threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self.threshold)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self.beta, self.threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self.beta, self.threshold)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self.data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=I.Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)


class RReLU(Layer):
    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None):
        super().__init__()
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, self.training)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, self.axis)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None):
        super().__init__()
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, name=None):
        super().__init__()
        self.threshold = threshold

    def forward(self, x):
        return F.thresholded_relu(x, self.threshold)


__all__ = ["ReLU", "ReLU6", "Sigmoid", "Tanh", "Silu", "Swish", "Mish",
           "Hardswish", "Hardsigmoid", "Tanhshrink", "Softsign", "LogSigmoid",
           "GELU", "LeakyReLU", "ELU", "CELU", "SELU", "Hardtanh",
           "Hardshrink", "Softshrink", "Softplus", "PReLU", "RReLU",
           "Softmax", "LogSoftmax", "Maxout", "ThresholdedReLU"]
