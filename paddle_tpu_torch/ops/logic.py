"""Comparison, logical and bitwise ops.

Counterpart of `paddle_tpu/ops/logic.py`. Every output is boolean or
integer, so none is differentiable.
"""
from __future__ import annotations

import torch

from ..core.tensor import Tensor
from ._dispatch import _t, axis_arg, binary_op, op, unary_op

equal = binary_op(torch.eq, "equal")
not_equal = binary_op(torch.ne, "not_equal")
less_than = binary_op(torch.lt, "less_than")
less_equal = binary_op(torch.le, "less_equal")
greater_than = binary_op(torch.gt, "greater_than")
greater_equal = binary_op(torch.ge, "greater_equal")

logical_and = binary_op(torch.logical_and, "logical_and", scalar_ok=False)
logical_or = binary_op(torch.logical_or, "logical_or", scalar_ok=False)
logical_xor = binary_op(torch.logical_xor, "logical_xor", scalar_ok=False)

bitwise_and = binary_op(torch.bitwise_and, "bitwise_and")
bitwise_or = binary_op(torch.bitwise_or, "bitwise_or")
bitwise_xor = binary_op(torch.bitwise_xor, "bitwise_xor")
bitwise_left_shift = binary_op(torch.bitwise_left_shift,
                               "bitwise_left_shift")
bitwise_right_shift = binary_op(torch.bitwise_right_shift,
                                "bitwise_right_shift")

_logical_not = unary_op(torch.logical_not, "logical_not")
_bitwise_not = unary_op(torch.bitwise_not, "bitwise_not")


def logical_not(x, out=None, name=None):
    return _logical_not(x)


def bitwise_not(x, out=None, name=None):
    return _bitwise_not(x)


@op
def equal_all(x, y, name=None):
    a = _t(x)
    b = _t(y, a)
    same = a.shape == b.shape and bool(torch.equal(a, b.to(a.dtype)))
    return torch.tensor(same, device=a.device)


@op
def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a = _t(x)
    return torch.tensor(torch.allclose(a, _t(y, a), rtol, atol, equal_nan),
                        device=a.device)


@op
def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    a = _t(x)
    return torch.isclose(a, _t(y, a), rtol, atol, equal_nan)


def _reduce_bool(tfn, x, axis, keepdim):
    a = _t(x)
    ax = axis_arg(axis)
    if ax is None:
        out = tfn(a)
        return out.reshape([1] * a.ndim) if keepdim else out
    return tfn(a, dim=ax, keepdim=keepdim)


@op
def all(x, axis=None, keepdim=False, name=None):
    return _reduce_bool(torch.all, x, axis, keepdim)


@op
def any(x, axis=None, keepdim=False, name=None):
    return _reduce_bool(torch.any, x, axis, keepdim)


@op
def is_empty(x, name=None):
    a = _t(x)
    return torch.tensor(a.numel() == 0, device=a.device)


def is_tensor(x):
    return isinstance(x, Tensor)


def in_dynamic_mode():
    return True
