"""Conv layers. Counterpart of `paddle_tpu/nn/layer/conv.py`: the weight
is OIHW ([in, out / groups, *k] for the transposes), drawn by
KaimingUniform with fan_in = in / groups * prod(k) (:28-35) unless
`weight_attr` names an initializer; the bias takes the default
initializer whatever `bias_attr` holds (but False), as in the
reference."""
from __future__ import annotations

from .. import functional as F
from .. import initializer as I
from .layers import Layer


def _ntuple(v, n):
    return [v] * n if isinstance(v, int) else list(v)


class _ConvNd(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, nd, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transpose=False, output_padding=0):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.kernel_size = _ntuple(kernel_size, nd)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.groups, self.data_format = groups, data_format
        self.output_padding = output_padding
        self._nd = nd
        if transpose:
            wshape = [in_channels, out_channels // groups] + self.kernel_size
        else:
            wshape = [out_channels, in_channels // groups] + self.kernel_size
        fan_in = in_channels // groups
        for k in self.kernel_size:
            fan_in *= k
        self.weight = self.create_parameter(
            wshape, attr=weight_attr,
            default_initializer=I.KaimingUniform(fan_in=fan_in)
            if weight_attr is None
            or getattr(weight_attr, "initializer", None) is None else None)
        self.bias = None if bias_attr is False else self.create_parameter(
            [out_channels], is_bias=True)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups, self.data_format)


class _ConvTransposeNd(_ConvNd):
    _fn = None

    def __init__(self, in_channels, out_channels, kernel_size, nd, stride,
                 padding, output_padding, groups, dilation, weight_attr,
                 bias_attr, data_format):
        super().__init__(in_channels, out_channels, kernel_size, nd, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, transpose=True,
                         output_padding=output_padding)

    def forward(self, x, output_size=None):
        return type(self)._fn(x, self.weight, self.bias, self.stride,
                              self.padding, self.output_padding, self.groups,
                              self.dilation, output_size, self.data_format)


class Conv1DTranspose(_ConvTransposeNd):
    _fn = staticmethod(F.conv1d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, output_padding, groups, dilation,
                         weight_attr, bias_attr, data_format)


class Conv2DTranspose(_ConvTransposeNd):
    _fn = staticmethod(F.conv2d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, output_padding, groups, dilation,
                         weight_attr, bias_attr, data_format)


class Conv3DTranspose(_ConvTransposeNd):
    _fn = staticmethod(F.conv3d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, output_padding, groups, dilation,
                         weight_attr, bias_attr, data_format)


__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]
