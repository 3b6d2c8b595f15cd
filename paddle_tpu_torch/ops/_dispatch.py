"""Op dispatch of the Tensor API: paddle-named ops over torch.

Counterpart of `paddle_tpu/ops/_dispatch.py` (`run_op` :58, `unary_op`
:117, `binary_op` :128). The reference traces each op into a JAX function
and records its VJP on its own tape; here an op is a Python function over
plain torch tensors, recorded by torch's autograd. The `op` decorator is
the dispatch: the body reads its tensor arguments as plain aliases
(`_t`), and its results come back as `Tensor` in the reference's dtypes
(`core.dtype.canonical`: no int64, float64 or complex128).

FLAGS_check_nan_inf scans every floating output for NaN/Inf and raises
FloatingPointError naming the op (it syncs with the device at every op,
as the reference's scan does); FLAGS_monitor books each op's count and
host time (`monitor.record_op`). With both off, an op pays one module
attribute load and one dict lookup for them.
"""
from __future__ import annotations

import numbers
import time

import numpy as np
import torch

from .. import monitor as _monitor
from ..core import flags as _flags
from ..core.dtype import CANONICAL, canonical, convert_dtype, \
    get_default_dtype
from ..core.place import resolve_device
from ..core.tensor import Tensor, to_torch

__all__ = ["op", "unary_op", "binary_op", "make_inplace", "from_data",
           "axis_arg", "int_list", "index64"]

_FLAGS = _flags._REGISTRY
# a profiler's `hook(name, t0, t1)` around whole-program calls
# (`jit.to_static`), as the reference's; None until a profiler sets it
_PROFILE_HOOK = None
_PLAIN = torch.Tensor


def _finish(out):
    """Results as `Tensor`, 64-bit dtypes cast to the reference's 32-bit
    ones."""
    t = type(out)
    if t is _PLAIN:
        c = CANONICAL.get(out.dtype)
        return (out if c is None else out.to(c)).as_subclass(Tensor)
    if t is Tensor:
        return out
    if isinstance(out, tuple):
        return tuple(_finish(o) for o in out)
    if t is list:
        return [_finish(o) for o in out]
    return out


def _check_nan_inf(name, out) -> None:
    seq = out if isinstance(out, (tuple, list)) else (out,)
    for i, o in enumerate(seq):
        if isinstance(o, torch.Tensor) and o.is_floating_point() and \
                not bool(torch.isfinite(to_torch(o)).all()):
            raise FloatingPointError(
                f"Operator {name} output {i} contains NaN/Inf "
                "(FLAGS_check_nan_inf=True)")


def op(fn):
    """An op of the Tensor API: `fn` computes on plain tensors; its
    outputs come back as `Tensor`."""
    name = fn.__name__

    def run(*args, **kwargs):
        if not _monitor._ENABLED and not _FLAGS["check_nan_inf"]:
            return _finish(fn(*args, **kwargs))
        t0 = time.perf_counter()
        out = _finish(fn(*args, **kwargs))
        if _monitor._ENABLED:
            _monitor.record_op(name, time.perf_counter() - t0)
        if _FLAGS["check_nan_inf"]:
            _check_nan_inf(name, out)
        return out

    run.__name__ = run.__qualname__ = name
    run.__doc__ = fn.__doc__
    run.__wrapped__ = fn
    return run


def from_data(data, dtype=None, device=None) -> torch.Tensor:
    """A plain tensor from Python or numpy data (or a tensor), by the
    reference's dtype rule: float64 data takes the default float dtype,
    int64 int32; an explicit 64-bit dtype is narrowed the same way."""
    dt = convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        t = to_torch(data)
        if dt is None:
            dt = get_default_dtype() if t.dtype == torch.float64 \
                else canonical(t.dtype)
        return t.to(device=device, dtype=canonical(dt))
    a = np.asarray(data)
    if dt is None:
        if a.dtype == np.float64:
            dt = get_default_dtype()
        elif a.dtype.kind not in "biufc":
            raise TypeError(f"to_tensor: unsupported data of dtype {a.dtype}")
        else:
            dt = canonical(convert_dtype(a.dtype))
    else:
        dt = canonical(dt)
    if dt == torch.bfloat16:
        return torch.tensor(a.astype(np.float32), device=device).to(dt)
    return torch.tensor(a, device=device).to(dt)


def _t(x, like=None) -> torch.Tensor:
    """A plain tensor for an op's tensor argument: a `Tensor` as its
    alias, a torch tensor as it is, other data by `from_data` on `like`'s
    device (else the current device)."""
    if type(x) is Tensor:
        return x.as_subclass(_PLAIN)
    if isinstance(x, _PLAIN):
        return x
    dev = like.device if like is not None else resolve_device()
    return from_data(x, device=dev)


def _weak(v, like) -> torch.Tensor:
    """A Python scalar as a 0-d tensor that takes part in type promotion
    as JAX's weakly typed scalars do: it keeps the other operand's dtype
    within its kind."""
    dt = torch.bool if isinstance(v, bool) else \
        torch.int32 if isinstance(v, numbers.Integral) else \
        torch.complex64 if isinstance(v, complex) else torch.float32
    return torch.tensor(v, dtype=dt, device=like.device)


def _is_scalar(v) -> bool:
    return isinstance(v, (bool, int, float, complex, np.generic))


def _operand(v, like, scalar_ok):
    if _is_scalar(v):
        v = v.item() if isinstance(v, np.generic) else v  # tpu-lint: disable=host-sync (a numpy scalar, never a device value)
        return v if scalar_ok else _weak(v, like)
    return _t(v, like)


def binary_op(tfn, name, scalar_ok=True):
    """x op y; a Python scalar on either side promotes like JAX's weakly
    typed scalars (passed to torch as a scalar where `scalar_ok`)."""
    def fn(x, y, name=None):
        tx, ty = isinstance(x, torch.Tensor), isinstance(y, torch.Tensor)
        if tx:
            a = _t(x)
            return tfn(a, _operand(y, a, scalar_ok))
        if ty:
            b = _t(y)
            return tfn(_operand(x, b, False), b)
        a = _t(x)
        return tfn(a, _operand(y, a, scalar_ok))

    fn.__name__ = name
    return op(fn)


def unary_op(tfn, name):
    def fn(x, name=None):
        return tfn(_t(x))

    fn.__name__ = name
    return op(fn)


def _inplace(x, result) -> Tensor:
    """Write `result` into x's storage (the reference rebinds x's value):
    on a leaf that needs a gradient, torch raises, as for any in-place op
    there with autograd on; under `no_grad` it is an ordinary write."""
    to_torch(x).copy_(to_torch(result))
    return x


def make_inplace(fn):
    """The `op_` form of an op: computed, then written into x."""
    def f(x, *args, **kwargs):
        return _inplace(x, fn(x, *args, **kwargs))

    f.__name__ = f.__qualname__ = fn.__name__ + "_"
    return f


def axis_arg(axis):
    """An axis argument as an int, a tuple of ints or None."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = to_torch(axis).tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def int_list(v):
    """A shape-like argument (ints, a list, a tensor) as a list of ints."""
    if isinstance(v, torch.Tensor):
        v = to_torch(v).reshape(-1).tolist()
    if isinstance(v, (numbers.Integral, np.integer)):
        return [int(v)]
    return [int(to_torch(s).item()) if isinstance(s, torch.Tensor) else int(s)
            for s in v]


def index64(x, like=None) -> torch.Tensor:
    """An index argument as the int64 tensor torch's gathers take."""
    return _t(x, like).to(torch.int64)
