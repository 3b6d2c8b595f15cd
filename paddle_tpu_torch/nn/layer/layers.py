"""nn.Layer — module base class on `torch.nn.Module`.

Counterpart of `paddle_tpu/nn/layer/layers.py` (Layer :38). Parameter
names, shapes and layouts are the JAX package's, so a state dict moves
between the two packages by name with no renaming: `create_parameter`,
`state_dict`/`set_state_dict` with paddle names, `eval()`, and
`to(dtype=)`/`bfloat16()`.

`__call__` is the Tensor API's boundary: called with a `Tensor` argument
(`paddle_tpu_torch.to_tensor`), the layer runs on plain aliases of its
arguments and its tensor outputs come back as `Tensor`; called with plain
torch tensors, as every layer calls its sublayers, it pays one type scan.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.dtype import convert_dtype, get_default_dtype
from ...core.place import resolve_device
from ...core.tensor import has_tensor, unwrap_tree, wrap_tree

__all__ = ["Layer"]


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = convert_dtype(dtype) or get_default_dtype()

    def __call__(self, *args, **kwargs):
        if has_tensor(args, kwargs):
            return wrap_tree(torch.nn.Module.__call__(
                self, *unwrap_tree(args), **unwrap_tree(kwargs)))
        return torch.nn.Module.__call__(self, *args, **kwargs)

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None) -> torch.nn.Parameter:
        """A parameter drawn on the CPU from the package generator, then
        placed on the current device (which raises when that is CUDA and
        there is none)."""
        from .. import initializer as I
        dt = convert_dtype(dtype) or self._dtype
        init = default_initializer
        if attr is not None and getattr(attr, "initializer", None) is not None:
            init = attr.initializer
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierNormal()
        data = init(shape, dt).to(resolve_device())
        trainable = attr is None or getattr(attr, "trainable", True)
        return torch.nn.Parameter(data, requires_grad=bool(trainable))

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy values by name into this layer's parameters; each value is
        cast to the parameter's dtype and device. Returns
        (missing, unexpected) key lists like the JAX package."""
        own = self.state_dict(keep_vars=True)
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        srcs = {k: _as_tensor(v) for k, v in state_dict.items() if k in own}
        for k, src in srcs.items():  # every shape checked before any copy
            if tuple(src.shape) != tuple(own[k].shape):
                raise ValueError(f"shape mismatch for {k}: "
                                 f"{tuple(src.shape)} vs "
                                 f"{tuple(own[k].shape)}")
        with torch.no_grad():
            for k, src in srcs.items():
                own[k].copy_(src.to(device=own[k].device, dtype=own[k].dtype))
        return missing, unexpected

    def to(self, device=None, dtype=None, blocking=None):
        """Paddle spelling: `to('gpu')`, `to(dtype='bfloat16')`. Casts
        floating parameters only."""
        if isinstance(device, (torch.dtype, str)) and dtype is None \
                and not _is_device_spec(device):
            device, dtype = None, device
        kw = {}
        if device is not None:
            kw["device"] = resolve_device(device)
        if dtype is not None:
            kw["dtype"] = convert_dtype(dtype)
        return super().to(**kw) if kw else self


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if arr.dtype.kind not in "biuf":
        # ml_dtypes' bfloat16 (JAX bf16 weights): torch cannot wrap it, and
        # f32 holds every bf16 value exactly
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _is_device_spec(spec) -> bool:
    if isinstance(spec, torch.dtype):
        return False
    return str(spec).lower().split(":", 1)[0] in ("cpu", "gpu", "cuda")
