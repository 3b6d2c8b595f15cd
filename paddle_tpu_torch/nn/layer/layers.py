"""nn.Layer — module base class on `torch.nn.Module`.

Counterpart of `paddle_tpu/nn/layer/layers.py` (Layer :38). Parameter
names, shapes and layouts are the JAX package's, so a state dict moves
between the two packages by name with no renaming: `create_parameter`,
`state_dict`/`set_state_dict` with paddle names, `eval()`, and
`to(dtype=)`/`bfloat16()`. Also paddle's `add_parameter`,
`add_sublayer`, `register_buffer(persistable=)`, the forward pre / post
hooks (`hook(layer, inputs)` and `hook(layer, inputs, outputs)`, a
non-None result replacing the inputs / outputs: torch's forward hooks
have that signature), `sublayers` / `named_sublayers`, `apply` and
`full_name`.

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
from ...core.tensor import (Parameter, has_tensor, to_torch, unwrap_tree,
                            wrap_tree)

__all__ = ["Layer"]


class Layer(torch.nn.Module):
    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = convert_dtype(dtype) or get_default_dtype()
        self._name_scope = name_scope or type(self).__name__.lower()

    def __call__(self, *args, **kwargs):
        if has_tensor(args, kwargs):
            return wrap_tree(torch.nn.Module.__call__(
                self, *unwrap_tree(args), **unwrap_tree(kwargs)))
        return torch.nn.Module.__call__(self, *args, **kwargs)

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None) -> Parameter:
        """A `Parameter` drawn on the CPU from the package generator, then
        placed on the current device (which raises when that is CUDA and
        there is none), as the reference's (:107-133): a
        `ParamAttr.initializer` wins, else `set_global_initializer`'s
        (which replaces the layer's own default), else the default;
        `ParamAttr.learning_rate` goes into `optimize_attr` and
        `trainable=False` gives `stop_gradient`."""
        from .. import initializer as I
        dt = convert_dtype(dtype) or self._dtype
        init = default_initializer
        if attr is not None and getattr(attr, "initializer", None) is not None:
            init = attr.initializer
        else:
            glob = I._GLOBAL_INITIALIZER[1 if is_bias else 0]
            if glob is not None:
                init = glob
        if init is None:
            init = I.Constant(0.0) if is_bias else I.XavierNormal()
        p = Parameter(init(shape, dt).to(resolve_device()))
        if attr is not None:
            lr = getattr(attr, "learning_rate", None)
            if lr is not None:
                p.optimize_attr["learning_rate"] = lr
            if getattr(attr, "trainable", True) is False:
                p.stop_gradient = True
                p.trainable = False
        return p

    # ---- paddle's registration and traversal ----
    def add_parameter(self, name, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True,
                        persistent=None):
        """paddle's `persistable` (torch's `persistent` also accepted): a
        non-persistable buffer is left out of `state_dict`."""
        if persistent is not None:
            persistable = persistent
        tensor = to_torch(tensor)
        super().register_buffer(name, tensor, persistent=persistable)
        return tensor

    def register_forward_post_hook(self, hook):
        return self.register_forward_hook(hook)

    def named_sublayers(self, prefix="", include_self=False):
        """(name, layer) in pre-order, without this layer unless
        `include_self`."""
        for name, layer in self.named_modules(prefix=prefix):
            if layer is not self or include_self:
                yield name, layer

    def sublayers(self, include_self=False):
        return [layer for _, layer in self.named_sublayers(
            include_self=include_self)]

    def apply(self, fn):
        """fn on this layer, then on each sublayer in pre-order (the
        reference's order; torch's `apply` visits children first)."""
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    def full_name(self):
        return self._name_scope

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy values by name into this layer's parameters; each value is
        cast to the parameter's dtype and device, after the layer that
        owns it has made it its own (`_own_piece`). Returns (missing,
        unexpected) key lists like the JAX package."""
        own = self.state_dict(keep_vars=True)
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        srcs = {}
        for k, v in state_dict.items():
            if k in own:
                path, _, attr = k.rpartition(".")
                owner = self.get_submodule(path) if path else self
                srcs[k] = owner._own_piece(attr, _as_tensor(v))
        for k, src in srcs.items():  # every shape checked before any copy
            if tuple(src.shape) != tuple(own[k].shape):
                raise ValueError(f"shape mismatch for {k}: "
                                 f"{tuple(src.shape)} vs "
                                 f"{tuple(own[k].shape)}")
        with torch.no_grad():
            for k, src in srcs.items():
                own[k].copy_(src.to(device=own[k].device, dtype=own[k].dtype))
        return missing, unexpected

    def _own_piece(self, name, value):
        """The part of a loaded tensor that this layer's parameter or
        buffer `name` holds: all of it here (a tensor-parallel layer keeps
        its slice)."""
        return value

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
