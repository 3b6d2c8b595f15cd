"""Normalisation layers. Counterpart of `paddle_tpu/nn/layer/norm.py`:
the batch norms (running statistics in the buffers `_mean` and
`_variance`, so `state_dict` keys match the reference's; SyncBatchNorm is
BatchNorm in one process, as the reference on one device), LayerNorm (eps
1e-5), RMSNorm, GroupNorm, the instance norms, LocalResponseNorm and
SpectralNorm."""
from __future__ import annotations

import numpy as np
import torch

from ...core.place import resolve_device
from .. import functional as F
from .. import initializer as I
from .layers import Layer


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self.num_features = num_features
        self.momentum, self.epsilon = momentum, epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True)
        dev = resolve_device()
        self.register_buffer("_mean", torch.zeros([num_features], device=dev))
        self.register_buffer("_variance",
                             torch.ones([num_features], device=dev))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self.momentum, epsilon=self.epsilon,
                            data_format=self.data_format,
                            use_global_stats=self.use_global_stats)

    def extra_repr(self):
        return f"num_features={self.num_features}, momentum={self.momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats, name)


class SyncBatchNorm(_BatchNormBase):
    """Batch norm over this process's batch (the reference on one device
    is the same; across cards it comes with the distributed slice)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            new = cls(layer.num_features, layer.momentum, layer.epsilon,
                      data_format=layer.data_format)
            new.weight, new.bias = layer.weight, layer.bias
            new._buffers = layer._buffers
            return new
        for name, sub in list(layer._modules.items()):
            layer._modules[name] = cls.convert_sync_batchnorm(sub)
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = list(normalized_shape)
        self.epsilon = epsilon
        self.weight = None if weight_attr is False else self.create_parameter(
            self.normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            self.normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, name=None):
        super().__init__()
        self.epsilon = epsilon
        self.weight = self.create_parameter(
            [hidden_size], default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.num_groups, self.num_channels = num_groups, num_channels
        self.epsilon, self.data_format = epsilon, data_format
        self.weight = None if weight_attr is False else self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.epsilon, self.weight,
                            self.bias, self.data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.epsilon, self.data_format = epsilon, data_format
        self.weight = None if weight_attr is False else self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self.epsilon, data_format=self.data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    """forward(weight) = weight / sigma_max(weight), sigma estimated by
    `power_iters` rounds of power iteration on the host from persistent
    u / v vectors (drawn once from numpy's RandomState(0), as in the
    reference)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 name=None, dtype="float32"):
        super().__init__()
        self._dim, self._power_iters, self._eps = dim, power_iters, eps
        h = int(weight_shape[dim])
        w = int(np.prod(weight_shape)) // h
        rng = np.random.RandomState(0)
        u = rng.randn(h).astype("float32")
        v = rng.randn(w).astype("float32")
        self._u = u / max(float(np.linalg.norm(u)), eps)
        self._v = v / max(float(np.linalg.norm(v)), eps)

    def forward(self, weight):
        from ..utils import spectral_normalize
        out, self._u, self._v = spectral_normalize(
            weight, self._u, dim=self._dim,
            n_power_iterations=self._power_iters, eps=self._eps)
        return out


__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "RMSNorm", "GroupNorm",
           "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "LocalResponseNorm", "SpectralNorm"]
