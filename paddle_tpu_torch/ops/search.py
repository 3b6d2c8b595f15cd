"""Search, sort and index-selection ops.

Counterpart of `paddle_tpu/ops/search.py`. Indices come back as int32,
as in the reference. `nonzero`, `masked_select` and `mode` have
data-dependent shapes (or, for `mode`, read the data on the host as the
reference does).
"""
from __future__ import annotations

import numpy as np
import torch

from ._dispatch import _t, index64, op


def _arg(tfn, x, axis, keepdim):
    a = _t(x)
    if axis is None:
        out = tfn(a.reshape(-1), 0)
        return out.reshape([1] * a.ndim) if keepdim else out
    return tfn(a, int(axis), keepdim=keepdim)


@op
def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim)


@op
def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim)


@op
def argsort(x, axis=-1, descending=False, stable=True, name=None):
    return torch.argsort(_t(x), dim=axis, descending=descending,
                         stable=stable)


@op
def sort(x, axis=-1, descending=False, stable=True, name=None):
    return torch.sort(_t(x), dim=axis, descending=descending,
                      stable=stable).values


@op
def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    return tuple(torch.topk(_t(x), int(k), int(axis), largest, True))


@op
def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    return tuple(torch.kthvalue(_t(x), int(k), int(axis), keepdim))


@op
def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along `axis` (the smallest among ties) and
    its count, as the reference's scipy.stats.mode gives them."""
    a = _t(x)
    h = a.detach().cpu().numpy()
    moved = np.moveaxis(h, axis, -1)
    flat = moved.reshape(-1, moved.shape[-1])
    vals = np.empty(flat.shape[0], h.dtype)
    counts = np.empty(flat.shape[0], np.int64)
    for i, row in enumerate(flat):
        u, c = np.unique(row, return_counts=True)
        j = int(np.argmax(c))
        vals[i], counts[i] = u[j], c[j]
    shape = moved.shape[:-1]
    vals, counts = vals.reshape(shape), counts.reshape(shape)
    if keepdim:
        vals = np.expand_dims(vals, axis)
        counts = np.expand_dims(counts, axis)
    return (torch.as_tensor(vals, device=a.device),
            torch.as_tensor(counts, device=a.device))


@op
def nonzero(x, as_tuple=False):
    a = _t(x)
    if as_tuple:
        return tuple(torch.nonzero(a, as_tuple=True))
    return torch.nonzero(a)


@op
def masked_select(x, mask, name=None):
    a = _t(x)
    return torch.masked_select(a, _t(mask, a).to(torch.bool))


@op
def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    s = _t(sorted_sequence)
    return torch.searchsorted(s, _t(values, s), right=right)


@op
def index_sample(x, index):
    a = _t(x)
    return torch.take_along_dim(a, index64(index, a), 1)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)
