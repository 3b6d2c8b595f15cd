"""The Tensor API's op namespace (the `paddle.tensor` equivalent).

Counterpart of `paddle_tpu/ops/__init__.py`: gathers the op modules and
binds the paddle method surface onto `Tensor` from the same `_METHODS`
list (:29-71), plus the `rsub` and `item_` aliases. `ops/sequence.py`
(the ragged-batch ops over `core/lod.py`) is a module of its own here, as
in the reference, not part of the top-level namespace. Not ported:
`core/selected_rows.py` and `ops/lazy.py`.
"""
from __future__ import annotations

import builtins
import sys

from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .random import (  # noqa: F401
    uniform, uniform_, normal, gaussian, standard_normal, randn, rand,
    randint, randint_like, randperm, bernoulli, multinomial, poisson,
    exponential_, shuffle,
)

from ..core import tensor as _tensor_mod
from ..core.tensor import Tensor
from . import _dispatch

_tensor_mod._ops = sys.modules[__name__]

_METHODS = [
    # math
    "add", "subtract", "multiply", "divide", "floor_divide", "remainder",
    "mod", "pow", "maximum", "minimum", "fmax", "fmin", "atan2", "abs",
    "sqrt", "rsqrt", "square", "exp", "expm1", "log", "log2", "log10",
    "log1p", "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
    "tanh", "asinh", "acosh", "atanh", "floor", "ceil", "round", "trunc",
    "frac", "sign", "reciprocal", "neg", "erf", "erfinv", "lgamma",
    "digamma", "scale", "clip", "lerp", "matmul", "mm", "dot", "outer",
    "inner", "addmm", "bmm", "t", "kron", "trace", "mv",
    "sum", "mean", "prod", "max", "min", "amax", "amin", "std", "var",
    "median", "quantile", "nanmean", "nansum", "logsumexp", "cumsum",
    "cumprod", "cummax", "cummin", "diff", "isnan", "isinf", "isfinite",
    "nan_to_num",
    "add_", "subtract_", "multiply_", "divide_", "scale_", "clip_", "exp_",
    "sqrt_", "rsqrt_", "floor_", "ceil_", "round_", "reciprocal_", "tanh_",
    "abs_",
    # manipulation
    "cast", "reshape", "reshape_", "transpose", "swapaxes", "moveaxis",
    "flatten", "squeeze", "unsqueeze", "squeeze_", "unsqueeze_", "split",
    "chunk", "unbind", "gather", "gather_nd", "index_select",
    "take_along_axis", "put_along_axis", "scatter", "scatter_",
    "scatter_nd_add", "tile", "expand", "expand_as", "broadcast_to", "flip",
    "roll", "rot90", "pad", "repeat_interleave", "unique", "masked_fill",
    "fill_", "fill_diagonal_", "index_put", "as_complex", "as_real",
    # logic
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "logical_and", "logical_or", "logical_xor",
    "logical_not", "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "equal_all", "allclose", "isclose", "all", "any", "is_empty",
    # search
    "argmax", "argmin", "argsort", "sort", "topk", "kthvalue", "mode",
    "nonzero", "masked_select", "index_sample", "bucketize",
    # linalg
    "norm", "dist", "inv", "pinv", "det", "cholesky", "solve", "qr", "svd",
    "eig", "eigh", "matrix_power", "cross", "histogram", "bincount",
    # creation-ish
    "tril", "triu", "diag",
    # random inplace
    "uniform_", "exponential_",
]


def _shape_args(args):
    """paddle's one list (`reshape([2, 3])`) or torch's ints
    (`reshape(2, 3)`)."""
    if len(args) == 1 and not isinstance(args[0], int):
        return args[0]
    return list(args)


def _reshape(self, *shape, name=None):
    return reshape(self, _shape_args(shape))  # noqa: F405


def _expand(self, *shape, name=None):
    return expand(self, _shape_args(shape))  # noqa: F405


def _tile(self, *repeat_times, name=None):
    return tile(self, _shape_args(repeat_times))  # noqa: F405


def _transpose(self, *perm, name=None):
    """paddle's permutation list, or torch's two axes to swap."""
    if len(perm) == 2 and builtins.all(isinstance(p, int) for p in perm):
        return swapaxes(self, *perm)  # noqa: F405
    return transpose(self, _shape_args(perm))  # noqa: F405


_ADAPTERS = {"reshape": _reshape, "expand": _expand, "tile": _tile,
             "transpose": _transpose}

_g = globals()
for _name in _METHODS:
    if _name in _g and _name not in vars(Tensor):
        setattr(Tensor, _name, _ADAPTERS.get(_name, _g[_name]))

Tensor.rsub = lambda self, y: subtract(y, self)  # noqa: E731,F405
Tensor.item_ = Tensor.item

# the op names: functions of the op modules, not their helpers
__all__ = sorted(
    n for n, v in list(globals().items())
    if not n.startswith("_") and callable(v) and not isinstance(v, type)
    and getattr(v, "__module__", "").startswith(__name__)
    and n not in _dispatch.__all__)
