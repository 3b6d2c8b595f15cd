"""Pooling layers. Counterpart of `paddle_tpu/nn/layer/pooling.py`, with
its argument forwarding: MaxPool* pass `ceil_mode` (which the functional
does not read without a mask), AvgPool1D neither `ceil_mode` nor
`exclusive`, AvgPool2D / 3D no `exclusive` (so they always exclude the
padding), and the adaptive max pools no `data_format`."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer


class _Pool(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 data_format=None, **kw):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, \
            padding
        self.ceil_mode, self.data_format = ceil_mode, data_format


class MaxPool1D(_Pool):
    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode,
                            data_format=self.data_format or "NCL")


class MaxPool2D(_Pool):
    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode,
                            data_format=self.data_format or "NCHW")


class MaxPool3D(_Pool):
    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode,
                            data_format=self.data_format or "NCDHW")


class AvgPool1D(_Pool):
    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            data_format=self.data_format or "NCL")


class AvgPool2D(_Pool):
    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode,
                            data_format=self.data_format or "NCHW")


class AvgPool3D(_Pool):
    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            ceil_mode=self.ceil_mode,
                            data_format=self.data_format or "NCDHW")


class _AdaptivePool(Layer):
    def __init__(self, output_size, data_format=None, return_mask=False,
                 name=None):
        super().__init__()
        self.output_size, self.data_format = output_size, data_format
        self.return_mask = return_mask


class AdaptiveAvgPool1D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size,
                                     self.data_format or "NCHW")


class AdaptiveAvgPool3D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size,
                                     self.data_format or "NCDHW")


class AdaptiveMaxPool1D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool2D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool3D(_AdaptivePool):
    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, self.return_mask)


class _MaxUnPool(Layer):
    _fn = None
    _format = None

    def __init__(self, kernel_size, stride=None, padding=0, data_format=None,
                 output_size=None, name=None):
        super().__init__()
        self.args = (kernel_size, stride, padding,
                     data_format or self._format, output_size)

    def forward(self, x, indices):
        return type(self)._fn(x, indices, *self.args)


class MaxUnPool1D(_MaxUnPool):
    _fn, _format = staticmethod(F.max_unpool1d), "NCL"


class MaxUnPool2D(_MaxUnPool):
    _fn, _format = staticmethod(F.max_unpool2d), "NCHW"


class MaxUnPool3D(_MaxUnPool):
    _fn, _format = staticmethod(F.max_unpool3d), "NCDHW"


__all__ = ["MaxPool1D", "MaxPool2D", "MaxPool3D", "AvgPool1D", "AvgPool2D",
           "AvgPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
           "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
           "AdaptiveMaxPool3D", "MaxUnPool1D", "MaxUnPool2D", "MaxUnPool3D"]
