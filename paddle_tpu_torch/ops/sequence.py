"""Sequence ops over (data, lengths) ragged batches.

Counterpart of `paddle_tpu/ops/sequence.py` (:1-126): sequence_mask,
sequence_pad / unpad, sequence_pool (sum / average / sqrt / max / first /
last), sequence_expand and sequence_softmax. Each op is one masked dense
torch computation on the padded layout; the ops whose output shape
depends on the data (`sequence_mask` without `maxlen`, `sequence_expand`)
read the lengths on the host, as the reference does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.dtype import convert_dtype
from ._dispatch import _t, op

__all__ = ["sequence_mask", "sequence_pad", "sequence_unpad", "sequence_pool",
           "sequence_expand", "sequence_softmax"]


def _valid(lengths, t):
    """[B, T] bool mask of the positions within each length."""
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


@op
def sequence_mask(lengths, maxlen: Optional[int] = None, dtype="float32"):
    """[B] -> [B, T] validity mask (T = max(lengths) unless given)."""
    n = _t(lengths)
    t = int(n.max()) if maxlen is None else int(maxlen)
    return _valid(n, t).to(convert_dtype(dtype))


def sequence_pad(seqs, pad_value=0.0, maxlen: Optional[int] = None):
    """list of arrays -> (padded [B, T, ...] Tensor, lengths Tensor), T
    padded to its bucket, or to `maxlen` (which must hold the longest)."""
    from ..core.lod import DEFAULT_BUCKETS, create_lod_tensor
    from ..core.tensor import Tensor
    if maxlen is not None:
        longest = max(len(s) for s in seqs)
        if longest > maxlen:
            raise ValueError(
                f"sequence_pad: maxlen={maxlen} < longest sequence "
                f"({longest}) — reference sequence_pad_op rejects this")
        buckets = (maxlen,)
    else:
        buckets = DEFAULT_BUCKETS
    lt = create_lod_tensor(seqs, buckets=buckets, pad_value=pad_value)
    return lt.data.as_subclass(Tensor), lt.lengths.as_subclass(Tensor)


def sequence_unpad(x, lengths):
    """Padded [B, T, ...] -> list of numpy arrays."""
    xv = _t(x).detach().cpu().numpy()
    lv = _t(lengths).cpu().numpy()
    return [xv[i, :int(n)] for i, n in enumerate(lv)]


@op
def sequence_pool(x, lengths, pool_type: str = "sum"):
    """Masked pooling over T: sum / average (mean) / sqrt / max / first /
    last."""
    v, n = _t(x), _t(lengths)
    pt = pool_type.lower()
    tail = (1,) * (v.ndim - 2)
    mf = _valid(n, v.shape[1]).reshape(tuple(n.shape) + (v.shape[1],)
                                       + tail)
    cnt = torch.clamp(n.reshape((-1,) + tail), min=1)
    if pt == "sum":
        return torch.sum(v * mf, dim=1)
    if pt in ("average", "mean"):
        return torch.sum(v * mf, dim=1) / cnt
    if pt == "sqrt":
        return torch.sum(v * mf, dim=1) / torch.sqrt(cnt.to(v.dtype))
    if pt == "max":
        return torch.amax(torch.where(mf, v, torch.full_like(v, -torch.inf)),
                          dim=1)
    if pt == "first":
        return v[:, 0]
    if pt == "last":
        idx = torch.clamp(n - 1, min=0).long()
        return torch.take_along_dim(
            v, idx.reshape((-1, 1) + tail), dim=1).squeeze(1)
    raise ValueError(f"unknown pool_type {pool_type!r}")


@op
def sequence_expand(x, lengths):
    """Row i of x repeated lengths[i] times -> [sum(lengths), ...]."""
    v = _t(x)
    lv = _t(lengths).cpu().numpy()
    reps = torch.as_tensor(np.repeat(np.arange(len(lv)), lv),
                           device=v.device)
    return torch.index_select(v, 0, reps)


@op
def sequence_softmax(x, lengths):
    """Masked softmax over T: padding gets probability 0 and adds nothing
    to the normaliser."""
    v, n = _t(x), _t(lengths)
    m = _valid(n, v.shape[1])
    z = torch.where(m, v, torch.full_like(v, -torch.inf))
    top = torch.amax(torch.where(torch.isfinite(z), z,
                                 torch.full_like(z, -1e30)),
                     dim=1, keepdim=True).detach()
    e = torch.where(m, torch.exp(z - top), torch.zeros_like(v))
    return e / torch.clamp(torch.sum(e, dim=1, keepdim=True), min=1e-30)
