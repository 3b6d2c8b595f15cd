"""Tensor creation ops.

Counterpart of `paddle_tpu/ops/creation.py` (to_tensor :16, zeros, ones,
full, arange, linspace, eye, tril/triu, assign, ...). A creation op with
no tensor argument places its result on the current device
(`set_device`); `to_tensor(..., place=)` honours `place`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import canonical, convert_dtype, get_default_dtype
from ..core.place import resolve_device
from ..core.tensor import Tensor
from ._dispatch import _t, from_data, int_list, op

__all__ = ["to_tensor", "zeros", "ones", "full", "empty", "zeros_like",
           "ones_like", "full_like", "empty_like", "arange", "linspace",
           "eye", "diag", "diagflat", "tril", "triu", "meshgrid", "assign",
           "clone", "numel", "create_parameter", "clip_by_norm", "complex",
           "is_complex", "is_floating_point", "is_integer"]


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """A new Tensor (never a view of `data`) on `place`, else on the
    current device, by the reference's dtype rule (`core/dtype.py`)."""
    dev = resolve_device(place)
    t = from_data(data, dtype, dev)
    if isinstance(data, torch.Tensor):
        t = t.detach()
        if t.data_ptr() == data.data_ptr():
            t = t.clone()
    out = t.as_subclass(Tensor)
    if not stop_gradient:
        out.stop_gradient = False
    return out


def _float(dtype):
    return canonical(convert_dtype(dtype)) if dtype is not None \
        else get_default_dtype()


@op
def zeros(shape, dtype=None, name=None):
    return torch.zeros(int_list(shape), dtype=_float(dtype),
                       device=resolve_device())


@op
def ones(shape, dtype=None, name=None):
    return torch.ones(int_list(shape), dtype=_float(dtype),
                      device=resolve_device())


def _fill_dtype(fill_value, dtype):
    if dtype is not None:
        return canonical(convert_dtype(dtype))
    if isinstance(fill_value, torch.Tensor):
        return canonical(fill_value.dtype)
    if isinstance(fill_value, bool):
        return torch.bool
    if isinstance(fill_value, (int, np.integer)):
        return torch.int32
    return get_default_dtype()


@op
def full(shape, fill_value, dtype=None, name=None):
    dt = _fill_dtype(fill_value, dtype)
    out = torch.empty(int_list(shape), dtype=dt, device=resolve_device())
    if isinstance(fill_value, torch.Tensor):
        return out.copy_(_t(fill_value).expand(out.shape))
    return out.fill_(fill_value)


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def _like_dtype(a, dtype):
    return a.dtype if dtype is None else canonical(convert_dtype(dtype))


@op
def zeros_like(x, dtype=None, name=None):
    a = _t(x)
    return torch.zeros(a.shape, dtype=_like_dtype(a, dtype), device=a.device)


@op
def ones_like(x, dtype=None, name=None):
    a = _t(x)
    return torch.ones(a.shape, dtype=_like_dtype(a, dtype), device=a.device)


@op
def full_like(x, fill_value, dtype=None, name=None):
    a = _t(x)
    out = torch.empty(a.shape, dtype=_like_dtype(a, dtype), device=a.device)
    if isinstance(fill_value, torch.Tensor):
        return out.copy_(_t(fill_value).expand(out.shape))
    return out.fill_(fill_value)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def _scalar(v):
    return _t(v).item() if isinstance(v, torch.Tensor) else v


@op
def arange(start=0, end=None, step=1, dtype=None, name=None):
    if end is None:
        start, end = 0, start
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if dtype is None:
        dt = torch.float32 if any(isinstance(v, float)
                                  for v in (start, end, step)) \
            else torch.int32
    else:
        dt = canonical(convert_dtype(dtype))
    return torch.arange(start, end, step, dtype=dt, device=resolve_device())


@op
def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(_scalar(start), _scalar(stop), int(num),
                          dtype=_float(dtype), device=resolve_device())


@op
def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return torch.eye(n, m, dtype=_float(dtype), device=resolve_device())


@op
def diag(x, offset=0, padding_value=0, name=None):
    a = _t(x)
    d = torch.diag(a, offset)
    if padding_value != 0 and a.ndim == 1:
        mask = torch.diag(torch.ones_like(a, dtype=torch.bool), offset)
        d = torch.where(mask, d, torch.full_like(d, padding_value))
    return d


@op
def diagflat(x, offset=0, name=None):
    return torch.diagflat(_t(x), offset)


@op
def tril(x, diagonal=0, name=None):
    return torch.tril(_t(x), diagonal)


@op
def triu(x, diagonal=0, name=None):
    return torch.triu(_t(x), diagonal)


@op
def meshgrid(*args, **kwargs):
    seq = args[0] if len(args) == 1 and isinstance(args[0], (list, tuple)) \
        else args
    return list(torch.meshgrid(*[_t(a) for a in seq], indexing="ij"))


def assign(x, output=None):
    """A copy of x (on the autograd graph); with `output`, written into
    it and returned."""
    out = _assign(x)
    if output is None:
        return out
    _t(output).copy_(_t(out))
    return output


@op
def _assign(x):
    return _t(x).clone()


def clone(x, name=None):
    return assign(x)


@op
def numel(x, name=None):
    a = _t(x)
    return torch.tensor(a.numel(), dtype=torch.int32, device=a.device)


def create_parameter(shape, dtype=None, name=None, default_initializer=None,
                     attr=None):
    """A `Parameter` named `name` on the current device: zeros, or drawn
    by `default_initializer` (a `nn.initializer`); `attr` is not read, as
    in the reference."""
    from ..core.tensor import Parameter
    dt = _float(dtype)
    shp = int_list(shape)
    data = torch.zeros(shp, dtype=dt) if default_initializer is None \
        else default_initializer(shp, dt)
    return Parameter(data.to(resolve_device()), name=name)


@op
def clip_by_norm(x, max_norm, name=None):
    a = _t(x)
    n = torch.sqrt(torch.sum(a * a))
    return torch.where(n > max_norm,
                       a * (max_norm / torch.clamp(n, min=1e-12)), a)


@op
def complex(real, imag, name=None):
    return torch.complex(_t(real), _t(imag))


def is_complex(x):
    return _t(x).is_complex()


def is_floating_point(x):
    return _t(x).is_floating_point()


def is_integer(x):
    a = _t(x)
    return not a.is_floating_point() and not a.is_complex() and \
        a.dtype != torch.bool

