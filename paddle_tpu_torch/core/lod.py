"""LoDTensor: ragged sequences as padded-dense data + lengths.

Counterpart of `paddle_tpu/core/lod.py` (:1-82). A ragged batch is
(`data` [B, T, ...] padded dense, `lengths` [B]) with T padded up to a
bucket boundary, so the set of padded shapes (and of exported programs
and CUDA-graph captures keyed on them) stays bounded whatever the input
lengths. Compute on it stays dense and masked (`ops/sequence.py`).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .dtype import canonical
from .place import resolve_device

DEFAULT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def bucket_length(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """The smallest bucket >= n; beyond the table, n itself."""
    for b in buckets:
        if n <= b:
            return b
    return int(n)


class LoDTensor:
    """Ragged batch: `data` [B, T, ...] padded dense + `lengths` [B]
    (int32), on the current device unless tensors on a device are given."""

    def __init__(self, data, lengths, device=None):
        dev = data.device if isinstance(data, torch.Tensor) else \
            resolve_device(device)
        data = torch.as_tensor(np.asarray(data) if not isinstance(
            data, torch.Tensor) else data, device=dev)
        # the reference's dtypes: no float64 or int64 (`core.dtype`)
        self.data = data.to(canonical(data.dtype))
        self.lengths = torch.as_tensor(
            np.asarray(lengths, np.int32) if not isinstance(
                lengths, torch.Tensor) else lengths, device=dev).to(
                    torch.int32)
        if self.data.shape[0] != self.lengths.shape[0]:
            raise ValueError(
                f"batch mismatch: data {self.data.shape[0]} vs "
                f"lengths {self.lengths.shape[0]}")

    @property
    def shape(self):
        return list(self.data.shape)

    def recursive_sequence_lengths(self) -> List[List[int]]:
        """The reference LoDTensor API (one ragged level)."""
        return [[int(v) for v in self.lengths.tolist()]]

    def lod(self) -> List[List[int]]:
        """Offset form: [0, l0, l0+l1, ...]."""
        off = np.concatenate([[0], np.cumsum(self.lengths.cpu().numpy())])
        return [[int(o) for o in off]]

    def mask(self, dtype=torch.float32):
        """[B, T] validity mask."""
        t = self.data.shape[1]
        ar = torch.arange(t, device=self.lengths.device)
        return (ar[None, :] < self.lengths[:, None]).to(dtype)

    def to_list(self) -> List[np.ndarray]:
        d = self.data.cpu().numpy()
        return [d[i, :int(n)] for i, n in
                enumerate(self.lengths.cpu().numpy())]


def create_lod_tensor(seqs: Sequence, buckets: Sequence[int] = DEFAULT_BUCKETS,
                      pad_value=0.0, device=None) -> LoDTensor:
    """A LoDTensor from a list of variable-length arrays, T padded to its
    bucket (fluid.create_lod_tensor plus the padding policy)."""
    seqs = [np.asarray(s) for s in seqs]
    if not seqs:
        raise ValueError("empty sequence list")
    lengths = [len(s) for s in seqs]
    t = bucket_length(max(lengths), buckets)
    trailing = seqs[0].shape[1:]
    out = np.full((len(seqs), t) + trailing, pad_value, seqs[0].dtype)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
    return LoDTensor(out, np.asarray(lengths, np.int32), device=device)


__all__ = ["LoDTensor", "create_lod_tensor", "bucket_length",
           "DEFAULT_BUCKETS"]
