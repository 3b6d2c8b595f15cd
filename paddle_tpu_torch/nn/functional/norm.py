"""Normalisation functionals. Counterpart of
`paddle_tpu/nn/functional/norm.py` (layer_norm :73): biased variance over
the trailing `normalized_shape` dims."""
from __future__ import annotations

import torch.nn.functional as TF


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


__all__ = ["layer_norm"]
