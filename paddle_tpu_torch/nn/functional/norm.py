"""Normalisation functionals.

Counterpart of `paddle_tpu/nn/functional/norm.py`: batch_norm, layer_norm
(biased variance over the trailing `normalized_shape` dims),
instance_norm, group_norm, local_response_norm and rms_norm.

batch_norm keeps the reference's running-stat rule (:18-70), which is not
torch's: paddle's `momentum` (0.9) is the weight of the old statistic,
and the running variance takes the biased batch variance (`jnp.var`),
where torch's `F.batch_norm(training=True)` would write the unbiased one
with the opposite momentum. So torch never updates the buffers here: the
batch statistics are computed and written into `running_mean` /
`running_var` in place under `no_grad`, and the normalisation runs on the
batch statistics (training) or the running ones (eval,
`use_global_stats`), through torch's fused batch norm (cuDNN on the
card). An input of another dtype than the affine parameters (an AMP
activation against fp32 parameters) gives the promoted dtype, as the
reference's jnp arithmetic does; the reference normalises in the input's
dtype and promotes at the affine step, the port promotes the input first
and normalises in one fused pass (a deviation of rounding only: the
normalised values are not rounded to bf16; ROADMAP Queue 3). Channel-last inputs
(`data_format="NHWC"`, ...) are permuted to an NCHW view of their memory
and back.

Inside `frozen_running_stats()` a training-mode batch_norm normalises with
the batch statistics and writes nothing: the reference writes the running
statistics only when its input is not a jax Tracer (:33-42), so a traced
step (`jit.TrainStep`) never updates them. `TrainStep` runs its forward
inside; the eager dygraph path updates them, as in the reference.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as TF

_STATS = threading.local()


@contextlib.contextmanager
def frozen_running_stats():
    """batch_norm in training mode leaves the running statistics as they
    are inside this block (this thread only): the counterpart of the
    reference's traced forward."""
    prev = getattr(_STATS, "frozen", False)
    _STATS.frozen = True
    try:
        yield
    finally:
        _STATS.frozen = prev


def _affine(out, weight, bias, shape):
    """out * weight + bias with type promotion (one pass when both)."""
    if weight is not None and bias is not None:
        return torch.addcmul(bias.reshape(shape), out, weight.reshape(shape))
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    cl = not data_format.upper().startswith("NC")
    if cl:
        x = x.movedim(-1, 1)
    axes = [0] + list(range(2, x.ndim))
    shape = [1, x.shape[1]] + [1] * (x.ndim - 2)
    use_batch = training and not use_global_stats
    if use_batch and running_mean is not None and \
            not getattr(_STATS, "frozen", False):
        with torch.no_grad():
            bv, bm = torch.var_mean(x, dim=axes, correction=0)
            running_mean.copy_(momentum * running_mean + (1 - momentum)
                               * bm.to(running_mean.dtype))
            running_var.copy_(momentum * running_var + (1 - momentum)
                              * bv.to(running_var.dtype))
    # the output's dtype: x's promoted with the affine parameters'
    dt = x.dtype
    for t in (weight, bias):
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    out = TF.batch_norm(
        x.to(dt), None if use_batch else running_mean.to(dt),
        None if use_batch else running_var.to(dt),
        None if weight is None else weight.to(dt),
        None if bias is None else bias.to(dt),
        training=use_batch, momentum=0.0, eps=epsilon)
    return out.movedim(1, -1) if cl else out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    """An input and parameters of different dtypes (an AMP activation
    against fp32 parameters, eager under `amp.auto_cast`) are normalised
    in the input's dtype and then scaled and shifted with type promotion,
    as the reference's jnp arithmetic does: the output takes the promoted
    dtype. (`torch.layer_norm` refuses mixed dtypes on CUDA.)"""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    shape = list(normalized_shape)
    if all(p is None or p.dtype == x.dtype for p in (weight, bias)):
        return TF.layer_norm(x, shape, weight, bias, epsilon)
    out = TF.layer_norm(x, shape, None, None, epsilon)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    """Statistics of each (sample, channel) over the spatial axes; the
    running statistics and `use_input_stats` are not read, as in the
    reference (:98-124)."""
    cl = not data_format.upper().startswith("NC")
    if cl:
        x = x.movedim(-1, 1)
    if all(t is None or t.dtype == x.dtype for t in (weight, bias)):
        out = TF.instance_norm(x, None, None, weight, bias,
                               use_input_stats=True, eps=eps)
    else:
        shape = [1, x.shape[1]] + [1] * (x.ndim - 2)
        v, m = torch.var_mean(x, dim=list(range(2, x.ndim)), keepdim=True,
                              correction=0)
        out = _affine((x - m) * torch.rsqrt(v + eps), weight, bias, shape)
    return out.movedim(1, -1) if cl else out


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    cl = not data_format.upper().startswith("NC")
    if cl:
        x = x.movedim(-1, 1)
    if all(t is None or t.dtype == x.dtype for t in (weight, bias)):
        out = TF.group_norm(x, num_groups, weight, bias, epsilon)
    else:
        shape = [1, x.shape[1]] + [1] * (x.ndim - 2)
        g = x.reshape((x.shape[0], num_groups, -1))
        v, m = torch.var_mean(g, dim=2, keepdim=True, correction=0)
        out = ((g - m) * torch.rsqrt(v + epsilon)).reshape(x.shape)
        out = _affine(out, weight, bias, shape)
    return out.movedim(1, -1) if cl else out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """x / (k + alpha * (sum of squares over `size` channels) / size) **
    beta, the window centred (half before, size - 1 - half after) on axis
    1 whatever `data_format` says, as in the reference (:165-177)."""
    half = size // 2
    c = x.shape[1]
    sq = torch.square(x)
    pad = [0, 0] * (x.ndim - 2) + [half, size - 1 - half]
    padded = TF.pad(sq, pad)
    window = sum(padded[:, i:i + c] for i in range(size))
    return x / torch.pow(k + alpha * window / size, beta)


def rms_norm(x, weight=None, epsilon=1e-6, name=None):
    out = x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True)
                          + epsilon)
    return out if weight is None else out * weight


__all__ = ["batch_norm", "layer_norm", "instance_norm", "group_norm",
           "local_response_norm", "rms_norm"]
