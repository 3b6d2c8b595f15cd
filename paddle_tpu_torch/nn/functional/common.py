"""Common functionals: linear, embedding, dropout.

Counterpart of `paddle_tpu/nn/functional/common.py`. These are large plain
products and lookups, left to PyTorch as the JAX package left them to XLA.
`linear` is an AMP white-list op (`:17-34`).
"""
from __future__ import annotations

import torch.nn.functional as TF

from ...amp.state import maybe_cast


def linear(x, weight, bias=None, name=None):
    """y = x @ W + b with W shaped [in, out] (paddle convention). Under
    `amp.auto_cast` the operands are cast to the autocast dtype first."""
    if bias is None:
        x, weight = maybe_cast(x, weight)
    else:
        x, weight, bias = maybe_cast(x, weight, bias)
    return TF.linear(x, weight.t(), bias)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of weight [vocab, dim] looked up by integer ids; the row of
    `padding_idx` reads as zeros."""
    out = TF.embedding(x.long(), weight)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((x == padding_idx).unsqueeze(-1), 0.0)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        return x
    if axis is not None or mode != "upscale_in_train":
        raise NotImplementedError(
            "dropout: only mode='upscale_in_train' over all axes is ported")
    return TF.dropout(x, p, training=True)


__all__ = ["linear", "embedding", "dropout"]
