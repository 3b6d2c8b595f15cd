"""SelectedRows — sparse row-set gradients (embedding backward).

Counterpart of `paddle_tpu/core/selected_rows.py` (Paddle's
`phi/core/selected_rows.h`: rows + value block + height), produced by the
sparse lookup's backward and consumed by the sparse optimizer rules.

The carrier: a torch `Parameter.grad` must be a tensor, so a sparse
embedding's gradient is an UNCOALESCED sparse COO tensor of shape
[height, dim] holding one entry per looked-up id (the reference's rows, in
lookup order; a `padding_idx` id keeps its entry with zero values).
Torch's autograd accumulates two such gradients by concatenating their
entries and densifies against a dense one, as `SelectedRows.__add__`
does. `SelectedRows` is the paddle-facing view: `of(p.grad)` reads the
rows and values of a sparse gradient.

`merge()` sums duplicate ids into sorted unique rows with
`index_put_(accumulate=True)` — on CUDA a sort-based, deterministic
accumulation (no float atomics).
"""
from __future__ import annotations

import numpy as np
import torch


class SelectedRows:
    __slots__ = ("rows", "values", "height")

    def __init__(self, rows, values, height: int):
        values = values if isinstance(values, torch.Tensor) \
            else torch.as_tensor(np.asarray(values))
        rows = rows if isinstance(rows, torch.Tensor) \
            else torch.as_tensor(np.asarray(rows, np.int64))
        self.rows = rows.to(device=values.device, dtype=torch.int64) \
            .reshape(-1)
        self.values = values
        self.height = int(height)
        if self.values.shape[0] != self.rows.shape[0]:
            raise ValueError(
                f"rows {self.rows.shape[0]} != values rows "
                f"{self.values.shape[0]}")

    @classmethod
    def of(cls, grad: torch.Tensor) -> "SelectedRows":
        """The rows and values of a sparse COO gradient [height, ...]
        (uncoalesced: one row per entry, duplicates kept)."""
        if not (isinstance(grad, torch.Tensor) and grad.is_sparse):
            raise TypeError(f"expected a sparse COO tensor, got "
                            f"{type(grad).__name__}")
        return cls(grad._indices()[0], grad._values(), grad.shape[0])

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    def merge(self) -> "SelectedRows":
        """Sum duplicate row ids (merge_selected_rows op role)."""
        uniq, inv = torch.unique(self.rows, return_inverse=True)
        summed = torch.zeros((uniq.shape[0],) + tuple(self.values.shape[1:]),
                             dtype=self.values.dtype,
                             device=self.values.device)
        summed.index_put_((inv,), self.values, accumulate=True)
        return SelectedRows(uniq, summed, self.height)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_put_((self.rows,), self.values, accumulate=True)

    def __add__(self, other):
        if isinstance(other, SelectedRows):
            if other.height != self.height:
                raise ValueError("SelectedRows height mismatch")
            return SelectedRows(torch.cat([self.rows, other.rows]),
                                torch.cat([self.values, other.values]),
                                self.height)
        if not isinstance(other, torch.Tensor):
            other = torch.as_tensor(np.asarray(other),
                                    device=self.values.device)
        return self.to_dense() + other

    __radd__ = __add__

    def __repr__(self):
        return (f"SelectedRows(n_rows={self.rows.shape[0]}, "
                f"height={self.height}, dim={tuple(self.values.shape[1:])})")
