"""AMP autocast state, consumed by the linear and matmul functionals.

Counterpart of `paddle_tpu/amp/state.py` (:1-89). The state is this
package's own thread-local, not `torch.autocast`: under `auto_cast` the
white-list functionals (`linear`, the tied head's product) cast their
floating inputs to the autocast dtype with `maybe_cast`, and nothing else
changes dtype. With the parameters cast to bf16 as well
(`jit.functional.amp_functional_call`), layer norm and the loss then run
on bf16 inputs, as in the reference; `torch.autocast` would keep them in
fp32 and compute a different function.
"""
from __future__ import annotations

import threading

import torch

from ..core.dtype import convert_dtype

class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"


_STATE = _AmpState()


def amp_state():
    return _STATE


def amp_enabled() -> bool:
    return _STATE.enabled


def maybe_cast(*tensors):
    """Cast floating tensors to the autocast dtype when AMP is active
    (white-list op); anything else passes through."""
    if not _STATE.enabled:
        return tensors if len(tensors) > 1 else tensors[0]
    out = tuple(t.to(_STATE.dtype)
                if isinstance(t, torch.Tensor) and t.is_floating_point()
                and t.dtype != _STATE.dtype else t
                for t in tensors)
    return out if len(out) > 1 else out[0]


class auto_cast:
    """paddle.amp.auto_cast parity (context manager / decorator)."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16"):
        self.enable = enable
        self.level = level
        self.dtype = convert_dtype(dtype)

    def __enter__(self):
        self._prev = (_STATE.enabled, _STATE.dtype, _STATE.level)
        _STATE.enabled = self.enable
        _STATE.dtype = self.dtype
        _STATE.level = self.level
        return self

    def __exit__(self, *exc):
        _STATE.enabled, _STATE.dtype, _STATE.level = self._prev
        return False

    def __call__(self, fn):
        def wrapper(*a, **kw):
            with auto_cast(self.enable, level=self.level, dtype=self.dtype):
                return fn(*a, **kw)
        return wrapper


def decorate(models=None, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast model parameters to low precision (paddle.amp.decorate)."""
    dt = convert_dtype(dtype)
    items = models if isinstance(models, (list, tuple)) else [models]
    for m in items:
        if m is not None:
            m.to(dtype=dt)
    if optimizers is None:
        return models if len(items) > 1 else items[0]
    return (models, optimizers)


__all__ = ["auto_cast", "decorate", "amp_enabled", "amp_state", "maybe_cast"]
