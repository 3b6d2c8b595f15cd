"""Pooling functionals over torch's pools.

Counterpart of `paddle_tpu/nn/functional/pooling.py` (`lax.reduce_window`
there). Kept as the reference computes it:

- padding: an int, n ints, n pairs, "SAME" (lax's rule) or "VALID". Max
  pooling pads with -inf by any amount (torch pads implicitly only up to
  half the kernel: a larger or asymmetric padding is an explicit `F.pad`).
- avg pooling sums the window and divides by the window's size, or with
  `exclusive=True` (the default) by the number of input elements in it.
- `_pool` reads neither `ceil_mode` nor `divisor_override` (:18-62): the
  output is always floor-sized. `return_mask=True` takes another routine
  that does read `ceil_mode` (:185-189), so with `ceil_mode=True` the two
  give different shapes (ROADMAP Queue 3, a kept reference defect).
- `adaptive_max_pool*` never returns a mask, whatever `return_mask` says,
  and `adaptive_max_pool2d` / `3d` read NCHW / NCDHW only.
- the `return_mask` indices are flat per (sample, channel) plane, int32:
  the contract `max_unpool` consumes.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch
import torch.nn.functional as TF

from ...core.enforce import InvalidArgumentError
from .conv import same_pads

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _tuplize(v, n):
    return (v,) * n if isinstance(v, int) else tuple(int(x) for x in v)


def _pads(padding, nd, spatial, k, s):
    """(low, high) per spatial dimension."""
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            return same_pads(spatial, k, s, (1,) * nd)
        return [(0, 0)] * nd
    if isinstance(padding, (list, tuple)) and \
            isinstance(padding[0], (list, tuple)):
        return [(int(p[0]), int(p[1])) for p in padding]
    return [(p, p) for p in _tuplize(padding, nd)]


def _flat(pads):
    return [w for lo_hi in reversed(pads) for w in lo_hi]


def _window_sum(a, nd, k, s):
    """Sum over each window (no padding), in a's dtype."""
    if nd == 1:
        return _AVG[2](a.unsqueeze(-2), (1,) + k, (1,) + s,
                       divisor_override=1).squeeze(-2)
    return _AVG[nd](a, k, s, divisor_override=1)


def _pool(x, nd, kernel, stride, padding, reducer, data_format,
          count_include_pad=False):
    cl = not data_format.upper().startswith("NC")
    if cl:
        x = x.movedim(-1, 1)
    k = _tuplize(kernel, nd)
    s = _tuplize(stride if stride is not None else kernel, nd)
    pads = _pads(padding, nd, x.shape[2:], k, s)
    native = all(lo == hi and 0 <= lo <= kk // 2
                 for (lo, hi), kk in zip(pads, k))
    if reducer == "max":
        if native:
            out = _MAX[nd](x, k, s, [lo for lo, _ in pads])
        else:
            neg = float("-inf") if x.is_floating_point() \
                else torch.iinfo(x.dtype).min
            out = _MAX[nd](TF.pad(x, _flat(pads), value=neg), k, s)
    else:
        valid = isinstance(padding, str) and padding.upper() == "VALID"
        summed = _window_sum(TF.pad(x, _flat(pads)), nd, k, s)
        if count_include_pad or valid:
            out = summed / float(np.prod(k))
        else:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                              device=x.device)
            out = summed / _window_sum(TF.pad(ones, _flat(pads)), nd, k, s)
    return out.movedim(1, -1) if cl else out


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    if return_mask:
        return _max_pool_with_mask(x, 1, kernel_size, stride, padding,
                                   ceil_mode, data_format)
    return _pool(x, 1, kernel_size, stride, padding, "max", data_format)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    if return_mask:
        return _max_pool_with_mask(x, 2, kernel_size, stride, padding,
                                   ceil_mode, data_format)
    return _pool(x, 2, kernel_size, stride, padding, "max", data_format)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    if return_mask:
        return _max_pool_with_mask(x, 3, kernel_size, stride, padding,
                                   ceil_mode, data_format)
    return _pool(x, 3, kernel_size, stride, padding, "max", data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _pool(x, 1, kernel_size, stride, padding, "avg", data_format,
                 count_include_pad=not exclusive)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _pool(x, 2, kernel_size, stride, padding, "avg", data_format,
                 count_include_pad=not exclusive)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _pool(x, 3, kernel_size, stride, padding, "avg", data_format,
                 count_include_pad=not exclusive)


_ADAPTIVE = {("avg", 1): TF.adaptive_avg_pool1d,
             ("avg", 2): TF.adaptive_avg_pool2d,
             ("avg", 3): TF.adaptive_avg_pool3d,
             ("max", 1): TF.adaptive_max_pool1d,
             ("max", 2): TF.adaptive_max_pool2d,
             ("max", 3): TF.adaptive_max_pool3d}


def _adaptive(x, nd, output_size, reducer, data_format):
    """Bins [floor(i * in / out), ceil((i + 1) * in / out)) per dimension,
    the reference's (and torch's) rule."""
    cl = not data_format.upper().startswith("NC")
    if cl:
        x = x.movedim(-1, 1)
    out = _ADAPTIVE[(reducer, nd)](x, _tuplize(output_size, nd))
    return out.movedim(1, -1) if cl else out


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, 1, output_size, "avg", "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, 2, output_size, "avg", data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, 3, output_size, "avg", data_format)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, 1, output_size, "max", "NCL")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, 2, output_size, "max", "NCHW")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive(x, 3, output_size, "max", "NCDHW")


def _max_pool_with_mask(x, nd, kernel, stride, padding, ceil_mode=False,
                        data_format="NCHW"):
    """(max pool, argmax mask) as the reference's max_pool_with_index
    (:185-231): each kernel offset is one strided slice of the -inf-padded
    input; the first maximum in offset order wins; the mask is the flat
    index into the input's spatial extent, int32. Channel-first only."""
    if not data_format.upper().startswith("NC"):
        raise InvalidArgumentError(
            "max_pool with return_mask requires a channel-first layout "
            f"(got data_format={data_format!r}), as the reference's "
            "max_poolNd_with_index op does")
    k = _tuplize(kernel, nd)
    s = _tuplize(stride if stride is not None else kernel, nd)
    p = _tuplize(padding, nd)
    spatial = tuple(x.shape[2:])
    rnd = math.ceil if ceil_mode else math.floor
    out_sp = [int(rnd((spatial[i] + 2 * p[i] - k[i]) / s[i])) + 1
              for i in range(nd)]
    neg = float("-inf") if x.is_floating_point() \
        else torch.iinfo(x.dtype).min
    ap = TF.pad(x, _flat([(p[i], p[i] + k[i] + s[i]) for i in range(nd)]),
                value=neg)
    vals, idxs = [], []
    for off in itertools.product(*[range(kk) for kk in k]):
        sl = (slice(None), slice(None)) + tuple(
            slice(off[i], off[i] + s[i] * out_sp[i], s[i]) for i in range(nd))
        vals.append(ap[sl])
        flat = np.zeros(out_sp, np.int64)
        for i in range(nd):
            coord = np.arange(out_sp[i]) * s[i] + off[i] - p[i]
            shape1 = [1] * nd
            shape1[i] = out_sp[i]
            flat = flat * spatial[i] + coord.reshape(shape1)
        idxs.append(flat)
    vstack = torch.stack(vals)                       # [K, N, C, *out]
    arg = torch.argmax(vstack, dim=0, keepdim=True)
    out = torch.gather(vstack, 0, arg)[0]
    istack = torch.from_numpy(np.stack(idxs)).to(x.device)  # [K, *out]
    mask = istack.reshape((len(idxs), 1, 1) + tuple(out_sp)).expand(
        vstack.shape)
    return out, torch.gather(mask, 0, arg)[0].to(torch.int32)


def _max_unpool(x, indices, nd, kernel_size, stride, padding, output_size):
    """Each pooled value written back at its mask index of a zero plane;
    an index outside the plane is dropped."""
    k = _tuplize(kernel_size, nd)
    s = _tuplize(stride if stride is not None else kernel_size, nd)
    p = _tuplize(padding, nd)
    in_sp = tuple(x.shape[2:])
    if output_size is not None:
        out_sp = tuple(int(v) for v in output_size)[-nd:]
    else:
        out_sp = tuple((in_sp[i] - 1) * s[i] - 2 * p[i] + k[i]
                       for i in range(nd))
    n, c = x.shape[0], x.shape[1]
    tot = int(np.prod(out_sp))
    idx = indices.reshape(n * c, -1).long()
    idx = torch.where((idx >= 0) & (idx < tot), idx,
                      torch.full_like(idx, tot))   # a column dropped below
    out = torch.zeros((n * c, tot + 1), dtype=x.dtype, device=x.device)
    out = out.scatter(1, idx, x.reshape(n * c, -1))
    return out[:, :tot].reshape((n, c) + out_sp)


def max_unpool1d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCL", output_size=None, name=None):
    return _max_unpool(x, indices, 1, kernel_size, stride, padding,
                       output_size)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    return _max_unpool(x, indices, 2, kernel_size, stride, padding,
                       output_size)


def max_unpool3d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCDHW", output_size=None, name=None):
    return _max_unpool(x, indices, 3, kernel_size, stride, padding,
                       output_size)


__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d", "max_unpool1d", "max_unpool2d",
           "max_unpool3d"]
