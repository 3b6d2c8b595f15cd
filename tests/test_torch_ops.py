"""The port's op corpus (`paddle_tpu_torch.ops`) against the JAX package's
(`paddle_tpu.ops`), one case per op name, on the CPU.

Each case takes the same seeded numpy inputs through both packages' top
level functions and holds values, shapes and dtypes to the reference (fp32
within 1e-5 unless the case states otherwise; integer and boolean results
exactly). For a differentiable op it also holds the gradients of
`sum(op(...))` (the first output of a tuple) to the reference's tape,
within 1e-5. Inputs are shaped like `tests/op_test.py`'s. Decompositions
unique only up to signs (svd, qr, eig, eigh) compare their products. The
random ops compare shapes, dtypes, support and moments, and repeat bit for
bit under one seed.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.ops as jops
from paddle_tpu.core import autograd as jautograd
import paddle_tpu_torch as pt
from paddle_tpu_torch.core.dtype import dtype_name

# the reference's op modules; the deferred sequence_* ops (ops/sequence.py)
# and the lazy executor are not part of this slice
_OP_MODULES = ("creation", "math", "manipulation", "logic", "search",
               "linalg", "random", "_dispatch")
_HELPERS = {"binary_op", "unary_op", "run_op", "nondiff_op", "inplace_from",
            "to_arr", "ensure_tensor"}


def _reference_ops():
    names = {}
    for n in dir(jops):
        v = getattr(jops, n)
        mod = getattr(v, "__module__", "") or ""
        fam = mod.rsplit(".", 1)[-1]
        if n.startswith("_") or n in _HELPERS or not callable(v) or \
                not mod.startswith("paddle_tpu.ops") or fam not in _OP_MODULES:
            continue
        names[n] = "math" if fam == "_dispatch" else fam
    return names


OPS = _reference_ops()


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture(autouse=True)
def _fresh_reference_op_cache():
    """Each test starts from an empty reference op cache: it keys a
    closure's constants by value and 2 == 2.0, so an int op after the same
    float op earlier in the process would return the float entry's dtype
    (see test_torch_tensor.py)."""
    jautograd._JIT_CACHE.clear()


# ---- case specification ----------------------------------------------------
class C:
    """args: ndarrays become tensors (lists/tuples of ndarrays become lists
    of tensors), anything else is passed as it is. grad: the positions of
    the arguments to differentiate sum(out) by. post: maps each package's
    numpy outputs before the comparison."""

    def __init__(self, *args, kw=None, grad=(), tol=1e-5, post=None,
                 inplace=False):
        self.args, self.kw, self.grad, self.tol = args, kw or {}, grad, tol
        self.post, self.inplace = post, inplace


def _rng(seed=0):
    return np.random.default_rng(seed)


def u(*shape, lo=-1.0, hi=1.0, seed=0):
    return _rng(seed).uniform(lo, hi, shape).astype(np.float32)


def n_(*shape, seed=0):
    return _rng(seed).standard_normal(shape).astype(np.float32)


def i32(*shape, lo=0, hi=5, seed=0):
    return _rng(seed).integers(lo, hi, shape).astype(np.int32)


def spd(n=4, seed=0):
    a = n_(n, n, seed=seed)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


X = n_(3, 4)
Y = n_(3, 4, seed=1)
POS = u(3, 4, lo=0.5, hi=2.0)
UNIT = u(3, 4, lo=-0.9, hi=0.9)
GT1 = u(3, 4, lo=1.1, hi=3.0)
PROB = u(3, 4, lo=0.1, hi=0.9)
SQ = n_(4, 4)


def _unary(arr=X, grad=(0,), tol=1e-5):
    return [C(arr, grad=grad, tol=tol)]


def _binary(a=X, b=Y, grad=(0, 1), tol=1e-5):
    return [C(a, b, grad=grad, tol=tol), C(a, 2.0, grad=(0,), tol=tol)]


def _recon_svd(outs):
    u_, s, v = outs
    return [u_ @ np.diag(s) @ v.T, s]


def _recon_qr(outs):
    q, r = outs
    return [q @ r, np.abs(np.diag(r))]


def _recon_eigh(outs):
    w, v = outs
    return [w, v @ np.diag(w) @ v.T]


def _sorted_complex(outs):
    w = outs[0] if isinstance(outs, (list, tuple)) else outs
    w = np.asarray(w)
    return [np.sort_complex(w.astype(np.complex128))]


CASES = {
    # ---- creation ----
    "to_tensor": [C([[1, 2], [3, 4]]), C(X), C([1.5, 2.5]),
                  C(i32(3).astype(np.int64)), C(X.astype(np.float64)),
                  C([[1, 2]], kw={"dtype": "float32"})],
    "zeros": [C([2, 3]), C([2, 3], kw={"dtype": "int32"})],
    "ones": [C([2, 3]), C(4, kw={"dtype": "bool"})],
    "full": [C([2, 3], 1.5), C([2], 7), C([2, 2], 2.0, kw={"dtype": "int32"})],
    "empty": [C([2, 3])],
    "zeros_like": [C(X), C(i32(3, 2))],
    "ones_like": [C(X), C(X, kw={"dtype": "int32"})],
    "full_like": [C(X, 3.0), C(i32(2, 2), 4)],
    "empty_like": [C(X)],
    "arange": [C(5), C(1, 10, 2), C(0.0, 1.0, 0.25), C(0, 6, kw={"dtype": "float32"})],
    "linspace": [C(0.0, 1.0, 7)],
    "eye": [C(3), C(3, 4)],
    "diag": [C(u(4), grad=(0,)), C(X, grad=(0,)), C(u(3), 1, grad=(0,)),
             C(u(3), kw={"padding_value": 9})],
    "diagflat": [C(u(3), grad=(0,)), C(u(2, 2), 1, grad=(0,))],
    "tril": [C(X, grad=(0,)), C(X, 1, grad=(0,))],
    "triu": [C(X, grad=(0,)), C(X, -1, grad=(0,))],
    "meshgrid": [C(u(3), u(4, seed=1)), C([u(2), u(3, seed=1)])],
    "assign": [C(X, grad=(0,))],
    "clone": [C(X, grad=(0,))],
    "numel": [C(X)],
    "create_parameter": [C([2, 3]), C([4], kw={"dtype": "float32"})],
    "clip_by_norm": [C(X, 1.0, grad=(0,)), C(X * 0.01, 1.0, grad=(0,))],
    "complex": [C(X, Y)],
    "is_complex": [C(X)],
    "is_floating_point": [C(X), C(i32(3))],
    "is_integer": [C(X), C(i32(3))],
    # ---- math: binary ----
    "add": _binary(), "subtract": _binary(), "multiply": _binary(),
    "divide": _binary(b=POS), "elementwise_add": _binary(),
    "elementwise_sub": _binary(), "elementwise_mul": _binary(),
    "elementwise_div": _binary(b=POS),
    "floor_divide": [C(X * 5, POS), C(i32(3, 4, hi=20), i32(3, 4, lo=1, seed=1)),
                     C(i32(3, 4, hi=20), 3)],
    "remainder": [C(X * 5, POS, grad=(0,)), C(i32(3, 4, hi=20), 3)],
    "mod": [C(X * 5, POS, grad=(0,))],
    "floor_mod": [C(X * 5, POS, grad=(0,))],
    "pow": [C(POS, Y, grad=(0, 1)), C(X, 2.0, grad=(0,)), C(i32(3, 4), 2),
            C(2.0, X, grad=(1,))],
    "maximum": _binary(), "minimum": _binary(), "fmax": _binary(),
    "fmin": _binary(), "atan2": _binary(),
    "heaviside": [C(X, Y)],
    "hypot": [C(X, Y, grad=(0, 1))],
    "logaddexp": _binary(),
    "nextafter": [C(X, Y)],
    "copysign": [C(X, Y, grad=(0,))],
    "gcd": [C(i32(3, 4, lo=1, hi=30), i32(3, 4, lo=1, hi=30, seed=1))],
    "lcm": [C(i32(3, 4, lo=1, hi=12), i32(3, 4, lo=1, hi=12, seed=1))],
    # ---- math: unary ----
    "abs": _unary(), "sqrt": _unary(POS), "rsqrt": _unary(POS),
    "square": _unary(), "exp": _unary(), "expm1": _unary(), "log": _unary(POS),
    "log2": _unary(POS), "log10": _unary(POS), "log1p": _unary(POS),
    "sin": _unary(), "cos": _unary(), "tan": _unary(), "asin": _unary(UNIT),
    "acos": _unary(UNIT), "atan": _unary(), "sinh": _unary(),
    "cosh": _unary(), "tanh": _unary(), "asinh": _unary(), "acosh": _unary(GT1),
    "atanh": _unary(UNIT), "floor": _unary(X * 3), "ceil": _unary(X * 3),
    "round": _unary(X * 3), "trunc": _unary(X * 3), "frac": _unary(X * 3),
    "sign": _unary(), "reciprocal": _unary(POS), "neg": _unary(),
    "erf": _unary(), "erfinv": _unary(UNIT, tol=2e-5), "lgamma": _unary(POS),
    "digamma": _unary(POS, tol=2e-5), "deg2rad": _unary(),
    "rad2deg": _unary(tol=1e-4), "logit": _unary(PROB), "signbit": [C(X)],
    "angle": [C(X)], "conj": [C(X, grad=(0,))], "real": [C(X, grad=(0,))],
    "imag": [C(X)],
    "isnan": [C(np.array([1.0, np.nan, np.inf], np.float32))],
    "isinf": [C(np.array([1.0, np.nan, -np.inf], np.float32))],
    "isfinite": [C(np.array([1.0, np.nan, np.inf], np.float32))],
    "nan_to_num": [C(np.array([1.0, np.nan, np.inf, -np.inf], np.float32)),
                   C(np.array([np.nan, np.inf], np.float32),
                     kw={"nan": 2.0, "posinf": 9.0})],
    "scale": [C(X, 2.0, 1.0, grad=(0,)), C(X, 2.0, 1.0, False, grad=(0,)),
              C(i32(3, 2), 2.0, 1.0)],
    "clip": [C(X, -0.5, 0.5, grad=(0,)), C(X, None, 0.2, grad=(0,))],
    "lerp": [C(X, Y, 0.3, grad=(0, 1)), C(X, Y, PROB, grad=(0, 1, 2))],
    "stanh": _unary(),
    "multiplex": [C([X, Y], np.array([[1], [0], [1]], np.int32), grad=(0,))],
    "matmul": [C(X, n_(4, 5, seed=1), grad=(0, 1)),
               C(n_(2, 3, 4), n_(2, 4, 5, seed=1), grad=(0, 1)),
               C(X, Y, kw={"transpose_y": True}, grad=(0, 1))],
    "mm": [C(X, n_(4, 2, seed=1), grad=(0, 1))],
    "dot": [C(u(4), u(4, seed=1), grad=(0, 1)), C(X, Y, grad=(0, 1))],
    "outer": [C(u(3), u(4, seed=1), grad=(0, 1))],
    "inner": [C(X, Y, grad=(0, 1))],
    "addmm": [C(n_(3, 5), X, n_(4, 5, seed=1), kw={"beta": 0.5, "alpha": 2.0},
                grad=(0, 1, 2))],
    "bmm": [C(n_(2, 3, 4), n_(2, 4, 5, seed=1), grad=(0, 1))],
    "t": [C(X, grad=(0,))],
    "kron": [C(n_(2, 2), n_(2, 3, seed=1), grad=(0, 1))],
    "trace": [C(SQ, grad=(0,)), C(n_(2, 3, 3), 1, 1, 2, grad=(0,))],
    "mv": [C(X, u(4), grad=(0, 1))],
    # ---- math: reductions ----
    "sum": [C(X, grad=(0,)), C(X, 1, grad=(0,)), C(X, [0, 1], kw={"keepdim": True}, grad=(0,)),
            C(i32(3, 4)), C(X > 0)],
    "mean": [C(X, grad=(0,)), C(X, 0, grad=(0,)), C(X, -1, kw={"keepdim": True}, grad=(0,))],
    "prod": [C(POS, grad=(0,)), C(POS, 1, grad=(0,)), C(i32(2, 3, lo=1))],
    "max": [C(X, grad=(0,)), C(X, 1, grad=(0,)), C(X, kw={"keepdim": True}, grad=(0,))],
    "min": [C(X, grad=(0,)), C(X, 0, True, grad=(0,))],
    "amax": [C(X, 1, grad=(0,))], "amin": [C(X, [0, 1], grad=(0,))],
    "std": [C(X, grad=(0,)), C(X, 1, False, grad=(0,))],
    "var": [C(X, grad=(0,)), C(X, 0, True, True, grad=(0,))],
    "median": [C(X, grad=(0,)), C(X, 1, grad=(0,)), C(n_(3, 5), 1, True, grad=(0,))],
    "quantile": [C(X, 0.3, grad=(0,)), C(X, [0.25, 0.75], 1, grad=(0,))],
    "nanmean": [C(np.array([[1.0, np.nan], [3.0, 4.0]], np.float32), 1)],
    "nansum": [C(np.array([[1.0, np.nan], [3.0, 4.0]], np.float32)),
               C(np.array([[1.0, np.nan], [3.0, 4.0]], np.float32), 0)],
    "nanmedian": [C(np.array([[1.0, np.nan, 2.0, 5.0], [3.0, 4.0, 0.5, 1.0]],
                             np.float32), 1)],
    "logsumexp": [C(X, grad=(0,)), C(X, 1, grad=(0,))],
    "logcumsumexp": [C(X, 1, grad=(0,)), C(u(5), grad=(0,))],
    "cumsum": [C(X, grad=(0,)), C(X, 1, grad=(0,)), C(i32(3, 4), 0)],
    "cumprod": [C(POS, 1, grad=(0,)), C(POS, grad=(0,))],
    "cummax": [C(X, 1, grad=(0,)), C(u(6))],
    "cummin": [C(X, 0, grad=(0,))],
    "diff": [C(X, grad=(0,)), C(X, 1, 0, grad=(0,)),
             C(u(4), kw={"prepend": u(2, seed=3)}, grad=(0,))],
    "count_nonzero": [C(np.array([[0, 1, 2], [0, 0, 3]], np.float32)),
                      C(np.array([[0, 1, 2], [0, 0, 3]], np.float32), 1)],
    "cdist": [C(n_(3, 4), n_(5, 4, seed=1), grad=(0, 1)),
              C(n_(3, 4), n_(5, 4, seed=1), 1.0, grad=(0, 1), tol=2e-5)],
    "broadcast_shape": [C([3, 1, 4], [2, 1])],
    "add_n": [C([X, Y, POS], grad=(0,))],
    "renorm": [C(X, 2.0, 0, 1.0, grad=(0,))],
    "increment": [C(u(1), 2.0)],
    # ---- math: in place ----
    **{nm: [C(*args, inplace=True)] for nm, args in {
        "add_": (X, Y), "subtract_": (X, Y), "multiply_": (X, Y),
        "divide_": (X, POS), "scale_": (X, 2.0, 1.0),
        "clip_": (X, -0.3, 0.3), "exp_": (X,), "sqrt_": (POS,),
        "rsqrt_": (POS,), "floor_": (X * 3,), "ceil_": (X * 3,),
        "round_": (X * 3,), "reciprocal_": (POS,), "tanh_": (X,),
        "abs_": (X,)}.items()},
    # ---- manipulation ----
    "cast": [C(X, "int32"), C(X * 3, "float16", grad=(0,)), C(i32(3), "float32"),
             C(X, "bool"), C(X, "int64"), C(X, "float64")],
    "reshape": [C(X, [2, 6], grad=(0,)), C(X, [-1, 3], grad=(0,)),
                C(n_(2, 3, 4), [0, -1], grad=(0,))],
    "reshape_": [C(X, [4, 3], inplace=True)],
    "transpose": [C(n_(2, 3, 4), [2, 0, 1], grad=(0,))],
    "swapaxes": [C(n_(2, 3, 4), 0, 2, grad=(0,))],
    "moveaxis": [C(n_(2, 3, 4), 0, -1, grad=(0,))],
    "flatten": [C(n_(2, 3, 4), grad=(0,)), C(n_(2, 3, 4), 1, grad=(0,))],
    "squeeze": [C(n_(1, 3, 1), grad=(0,)), C(n_(1, 3, 1), 0, grad=(0,)),
                C(n_(1, 3, 1), [1, 2], grad=(0,)), C(n_(2, 3), 0)],
    "unsqueeze": [C(X, 0, grad=(0,)), C(X, [0, 3], grad=(0,)), C(X, -1)],
    "squeeze_": [C(n_(1, 3), 0, inplace=True)],
    "unsqueeze_": [C(X, 1, inplace=True)],
    "concat": [C([X, Y], grad=(0,)), C([X, Y], 1)],
    "stack": [C([X, Y], grad=(0,)), C([X, Y], 2)],
    "split": [C(n_(6, 4), 3, grad=(0,)), C(n_(4, 6), [2, -1, 1], 1, grad=(0,))],
    "chunk": [C(n_(6, 4), 2, grad=(0,))],
    "unbind": [C(X, grad=(0,)), C(X, 1)],
    "slice": [C(n_(4, 5), [0, 1], [1, 0], [3, 4], grad=(0,))],
    "strided_slice": [C(n_(6, 5), [0, 1], [0, 4], [6, 0], [2, -1], grad=(0,))],
    "gather": [C(n_(5, 3), np.array([3, 0, 3], np.int32), grad=(0,)),
               C(n_(3, 5), np.array([1, 4], np.int32), 1, grad=(0,))],
    "gather_nd": [C(n_(3, 4, 2), np.array([[0, 1], [2, 3]], np.int32), grad=(0,))],
    "index_select": [C(X, np.array([2, 0], np.int32), grad=(0,)),
                     C(X, np.array([3, 1], np.int32), 1, grad=(0,))],
    "take_along_axis": [C(X, np.array([[0], [2], [3]], np.int32), 1, grad=(0,))],
    "put_along_axis": [C(X, np.array([[0], [2], [3]], np.int32), 9.0, 1),
                       C(X, np.array([[0], [2], [3]], np.int32),
                         np.ones((3, 1), np.float32), 1, "add", grad=(0, 2))],
    "scatter": [C(n_(4, 3), np.array([2, 0], np.int32), n_(2, 3, seed=2),
                  grad=(0, 2)),
                C(n_(4, 3), np.array([2, 0], np.int32), n_(2, 3, seed=2), False,
                  grad=(0, 2))],
    "scatter_": [C(n_(4, 3), np.array([1, 3], np.int32), n_(2, 3, seed=2),
                   inplace=True)],
    "scatter_nd_add": [C(n_(3, 4), np.array([[1], [1], [0]], np.int32),
                         n_(3, 4, seed=2), grad=(0, 2))],
    "scatter_nd": [C(np.array([[1], [3]], np.int32), n_(2, 3), [4, 3], grad=(1,))],
    "tile": [C(X, [2, 1], grad=(0,)), C(u(3), [2, 2])],
    "expand": [C(n_(1, 4), [3, 4], grad=(0,)), C(n_(3, 1), [2, -1, 5])],
    "expand_as": [C(n_(1, 4), X, grad=(0,))],
    "broadcast_to": [C(n_(3, 1), [3, 4], grad=(0,))],
    "broadcast_tensors": [C([n_(3, 1), n_(1, 4, seed=1)])],
    "flip": [C(X, 0, grad=(0,)), C(X, [0, 1])],
    "roll": [C(X, 1, 1, grad=(0,)), C(X, 2)],
    "rot90": [C(X, grad=(0,)), C(X, 2, [0, 1])],
    "where": [C(X > 0, X, Y, grad=(1, 2)), C(X > 0, X, 0.0, grad=(1,)),
              C(X > 0.5)],
    "pad": [C(n_(1, 2, 3, 3), [1, 1, 2, 0], grad=(0,)),
            C(X, [1, 0, 0, 2], kw={"value": 3.0}),
            C(n_(1, 2, 4, 4), [1, 2, 1, 0], "reflect", grad=(0,)),
            C(n_(1, 2, 4), [2, 1], "replicate", grad=(0,)),
            C(n_(1, 2, 4), [1, 1], "circular"),
            C(n_(1, 3, 3, 2), [1, 0, 1, 1], "reflect", kw={"data_format": "NHWC"})],
    "repeat_interleave": [C(X, 2, grad=(0,)), C(X, 2, 1)],
    "unique": [C(i32(10, hi=4)),
               C(i32(10, hi=4), True, True, True)],
    "unique_consecutive": [C(np.array([1, 1, 2, 2, 3, 1], np.int32))],
    "masked_fill": [C(X, X > 0, 0.0, grad=(0,)), C(X, X < 0, np.float32(2.0))],
    "fill_": [C(X, 2.5, inplace=True)],
    "fill_diagonal_": [C(n_(3, 3), 1.0, inplace=True)],
    "index_put": [C(n_(4, 3), (np.array([0, 2], np.int32),), n_(2, 3, seed=2),
                    grad=(0, 2)),
                  C(n_(4, 3), (np.array([1, 1], np.int32), np.array([0, 2], np.int32)),
                    u(2, seed=3), True, grad=(0, 2))],
    "as_complex": [C(n_(3, 2))],
    "as_real": [C(n_(3, 2))],
    "shard_index": [C(i32(6, 1, hi=20), 20, 2, 1)],
    "getitem": [C(n_(4, 5), (slice(1, 3), 2), grad=(0,)),
                C(n_(4, 5), (slice(None, None, -1), slice(0, 5, 2)), grad=(0,)),
                C(n_(4, 5), [0, 2], grad=(0,)),
                C(n_(3, 4), (Ellipsis, None, 1), grad=(0,)),
                C(n_(4, 5), (slice(3, 0, -2),), grad=(0,))],
    "setitem_": [C(n_(4, 5), (slice(1, 3), 2), 7.0, inplace=True),
                 C(n_(4, 5), 0, u(5, seed=3), inplace=True)],
    "diagonal": [C(n_(3, 4), grad=(0,)), C(n_(2, 3, 3), 1, 1, 2, grad=(0,))],
    "take": [C(n_(3, 4), np.array([0, 5, -1], np.int32), grad=(0,)),
             C(n_(3, 4), np.array([13, -20], np.int32), "wrap"),
             C(n_(3, 4), np.array([13, -20], np.int32), "clip")],
    "unstack": [C(X, grad=(0,)), C(X, 1)],
    "crop": [C(n_(4, 5), [2, 3], [1, 1], grad=(0,)), C(n_(4, 5), [-1, 2], [2, 0])],
    "reverse": [C(X, 0, grad=(0,))],
    "shape": [C(n_(2, 3, 4))],
    "tolist": [C(X), C(i32(2, 3))],
    # ---- logic ----
    **{nm: [C(X, Y), C(X, 0.0)] for nm in (
        "equal", "not_equal", "less_than", "less_equal", "greater_than",
        "greater_equal")},
    **{nm: [C(X > 0, Y > 0), C(X, Y > 0)] for nm in (
        "logical_and", "logical_or", "logical_xor")},
    **{nm: [C(i32(3, 4, hi=16), i32(3, 4, hi=16, seed=1)), C(X > 0, Y > 0)]
       for nm in ("bitwise_and", "bitwise_or", "bitwise_xor")},
    "bitwise_left_shift": [C(i32(3, 4, hi=16), i32(3, 4, hi=4, seed=1))],
    "bitwise_right_shift": [C(i32(3, 4, hi=64), i32(3, 4, hi=4, seed=1))],
    "logical_not": [C(X > 0), C(X)],
    "bitwise_not": [C(i32(3, 4, hi=16)), C(X > 0)],
    "equal_all": [C(X, X), C(X, Y), C(X, n_(3, 3))],
    "allclose": [C(X, X + 1e-9), C(X, Y)],
    "isclose": [C(X, X + np.float32(1e-7) * (X > 0)), C(X, Y)],
    "all": [C(X > -1), C(X > 0, 1), C(X > 0, [0, 1], True)],
    "any": [C(X > 1), C(X > 0, 0)],
    "is_empty": [C(X), C(np.zeros((0, 3), np.float32))],
    "is_tensor": [C(X)],
    "in_dynamic_mode": [C()],
    # ---- search ----
    "argmax": [C(X), C(X, 1), C(X, 0, True), C(X, kw={"keepdim": True})],
    "argmin": [C(X), C(X, 1)],
    "argsort": [C(X), C(X, 0), C(X, -1, True)],
    "sort": [C(X, grad=(0,)), C(X, 0, True, grad=(0,))],
    "topk": [C(X, 2, grad=(0,)), C(X, 2, 0, False, grad=(0,))],
    "kthvalue": [C(X, 2, grad=(0,)), C(X, 1, 0, True, grad=(0,))],
    "mode": [C(np.array([[1, 2, 2, 3], [4, 4, 1, 1]], np.float32)),
             C(np.array([[1, 2, 2, 3], [4, 4, 1, 1]], np.float32), 0, True)],
    "nonzero": [C(np.array([[0, 1], [2, 0]], np.float32)),
                C(np.array([0, 3, 0, 4], np.float32), True)],
    "masked_select": [C(X, X > 0, grad=(0,))],
    "searchsorted": [C(np.array([1.0, 3.0, 5.0, 7.0], np.float32),
                       np.array([0.5, 3.0, 6.0], np.float32)),
                     C(np.array([1.0, 3.0, 5.0, 7.0], np.float32),
                       np.array([3.0, 7.0], np.float32), kw={"right": True})],
    "index_sample": [C(X, np.array([[0, 1], [3, 3], [2, 0]], np.int32), grad=(0,))],
    "bucketize": [C(np.array([0.5, 3.0, 6.0], np.float32),
                    np.array([1.0, 3.0, 5.0, 7.0], np.float32))],
    # ---- linalg ----
    "norm": [C(X, grad=(0,)), C(X, 2, 1, grad=(0,)), C(X, 1, 0, grad=(0,)),
             C(X, float("inf"), 1), C(X, "fro", [0, 1], grad=(0,)),
             C(X, 3, grad=(0,)), C(X, kw={"keepdim": True})],
    "vector_norm": [C(X, grad=(0,)), C(X, 1.0, 1, grad=(0,))],
    "dist": [C(X, Y, grad=(0, 1)), C(X, Y, 1, grad=(0, 1)),
             C(X, Y, float("inf"))],
    "cond": [C(spd(), tol=1e-4)],
    "inv": [C(spd(), grad=(0,))],
    "inverse": [C(spd(), grad=(0,))],
    "pinv": [C(n_(4, 3), tol=1e-4)],
    "det": [C(SQ, grad=(0,), tol=1e-4)],
    "slogdet": [C(spd(), grad=(0,), tol=1e-4)],
    "cholesky": [C(spd(), grad=(0,), tol=2e-5), C(spd(), True, tol=2e-5)],
    "cholesky_solve": [C(n_(4, 2), np.linalg.cholesky(spd()).astype(np.float32),
                         grad=(0,), tol=1e-4)],
    "solve": [C(spd(), n_(4, 2), grad=(0, 1), tol=1e-4)],
    "triangular_solve": [C(np.triu(spd()), n_(4, 2), grad=(1,), tol=1e-4),
                         C(np.tril(spd()), n_(4, 2), False, tol=1e-4),
                         C(np.triu(spd()), n_(4, 2), True, True, tol=1e-4)],
    "lstsq": [C(n_(5, 3), n_(5, 2, seed=1), tol=1e-4)],
    "qr": [C(n_(4, 3), post=_recon_qr, tol=1e-4)],
    "svd": [C(n_(4, 3), post=_recon_svd, tol=1e-4)],
    "eig": [C(spd(), post=_sorted_complex, tol=1e-3)],
    "eigh": [C(spd(), post=_recon_eigh, tol=1e-4)],
    "eigvals": [C(spd(), post=_sorted_complex, tol=1e-3)],
    "eigvalsh": [C(spd(), tol=1e-4)],
    "matrix_rank": [C(SQ), C(n_(4, 2) @ n_(2, 4, seed=1))],
    "matrix_power": [C(SQ * 0.5, 3, grad=(0,))],
    "multi_dot": [C([n_(2, 3), n_(3, 4, seed=1), n_(4, 2, seed=2)], grad=(0,))],
    "cross": [C(n_(3, 4), n_(3, 4, seed=1), grad=(0, 1)),
              C(n_(2, 3), n_(2, 3, seed=1), 1)],
    "householder_product": [C(n_(4, 3), u(3, seed=1), grad=(0, 1), tol=1e-4)],
    "corrcoef": [C(n_(3, 6), grad=(0,), tol=1e-4)],
    "cov": [C(n_(3, 6), grad=(0,)), C(n_(6, 3), False, False)],
    "einsum": [C("ij,jk->ik", X, n_(4, 2, seed=1), grad=(1, 2)),
               C("bij->bji", n_(2, 3, 4), grad=(1,))],
    "histogram": [C(u(50), 5), C(u(50), 4, -1.0, 1.0)],
    "bincount": [C(i32(20, hi=6)), C(i32(20, hi=6), u(20, seed=2), 8)],
    "tensordot": [C(n_(2, 3, 4), n_(3, 4, 5, seed=1), 2, grad=(0, 1)),
                  C(n_(2, 3), n_(3, 2, seed=1), [[1], [0]], grad=(0,))],
    "rank": [C(n_(2, 3, 4))],
}

# the random ops are held by distribution and reproducibility, below
RANDOM = {"uniform", "uniform_", "normal", "gaussian", "standard_normal",
          "randn", "rand", "randint", "randint_like", "randperm",
          "bernoulli", "multinomial", "poisson", "exponential_", "shuffle"}


# ---- harness ---------------------------------------------------------------
def _is_array_seq(v):
    return isinstance(v, (list, tuple)) and v and \
        all(isinstance(e, np.ndarray) for e in v)


def _make(pkg, args, grad=()):
    """Arguments for `pkg`: ndarrays as tensors (those at `grad` positions
    with stop_gradient=False); returns (args, leaves)."""
    out, leaves = [], []
    for i, a in enumerate(args):
        if isinstance(a, np.ndarray):
            t = pkg.to_tensor(a, stop_gradient=i not in grad)
            leaves.append(t if i in grad else None)
            out.append(t)
        elif _is_array_seq(a):
            ts = [pkg.to_tensor(e, stop_gradient=i not in grad) for e in a]
            leaves.append(ts[0] if i in grad else None)
            out.append(type(a)(ts))
        else:
            leaves.append(None)
            out.append(a)
    return out, leaves


def _np(o):
    if isinstance(o, torch.Tensor):
        t = o.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    if hasattr(o, "_value"):
        return np.asarray(o._value)
    return o


def _dtype(o):
    if isinstance(o, torch.Tensor):
        return dtype_name(o.dtype)
    if hasattr(o, "_value"):
        return np.dtype(o._value.dtype).name
    return None


def _flat(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def _compare(name, got, want, tol, post=None):
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w), f"{name}: {len(g)} outputs vs {len(w)}"
    if post is not None:
        g = post([_np(o) for o in g])
        w = post([_np(o) for o in w])
        for a, b in zip(g, w):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=tol, atol=tol, err_msg=name)
        return
    for k, (a, b) in enumerate(zip(g, w)):
        if isinstance(b, (list, tuple)) and not hasattr(b, "_value"):
            _compare(f"{name}[{k}]", a, b, tol)
            continue
        assert _dtype(a) == _dtype(b), \
            f"{name} output {k}: dtype {_dtype(a)} vs {_dtype(b)}"
        an, bn = _np(a), _np(b)
        if isinstance(bn, np.ndarray):
            assert list(np.shape(an)) == list(bn.shape), \
                f"{name} output {k}: shape {np.shape(an)} vs {bn.shape}"
            if bn.dtype.kind in "fc":
                np.testing.assert_allclose(an, bn, rtol=tol, atol=tol,
                                           err_msg=f"{name} output {k}")
            else:
                np.testing.assert_array_equal(an, bn,
                                              err_msg=f"{name} output {k}")
        else:
            assert an == bn, f"{name} output {k}: {an!r} vs {bn!r}"


def _sum_first(pkg, out):
    o = _flat(out)[0]
    return pkg.sum(o.astype("float32") if _dtype(o) != "float32" else o)


def _run_case(name, case):
    if case.inplace:
        jargs, _ = _make(paddle, case.args)
        targs, _ = _make(pt, case.args)
        jr = getattr(paddle, name)(*jargs, **case.kw)
        tr = getattr(pt, name)(*targs, **case.kw)
        assert tr is targs[0] or name == "setitem_", \
            f"{name} returned a new tensor"
        _compare(name, targs[0], jargs[0], case.tol)
        del jr
        return
    jargs, jleaves = _make(paddle, case.args, case.grad)
    targs, tleaves = _make(pt, case.args, case.grad)
    want = getattr(paddle, name)(*jargs, **case.kw)
    got = getattr(pt, name)(*targs, **case.kw)
    _compare(name, got, want, case.tol, case.post)
    if not case.grad:
        return
    _sum_first(paddle, want).backward()
    _sum_first(pt, got).backward()
    for i in case.grad:
        jl, tl = jleaves[i], tleaves[i]
        jg = jl.gradient()
        tg = tl.gradient()
        if jg is None or tg is None:   # no path back: none, or zeros
            assert not np.any(jg) and not np.any(tg), \
                f"{name}: gradient of arg {i}: {tg} vs {jg}"
            continue
        np.testing.assert_allclose(tg, jg, rtol=case.tol, atol=case.tol,
                                   err_msg=f"{name} grad of arg {i}")


_PARAMS = [pytest.param(fam, nm, id=f"{fam}-{nm}")
           for nm, fam in sorted(OPS.items(), key=lambda kv: (kv[1], kv[0]))
           if nm not in RANDOM]


@pytest.mark.parametrize("family,name", _PARAMS)
def test_op_matches_the_reference(family, name):
    assert name in CASES, f"no case for {family} op {name}"
    for case in CASES[name]:
        _run_case(name, case)


def test_every_reference_op_is_exported_with_a_case():
    missing = sorted(n for n in OPS if not hasattr(pt, n))
    assert not missing, f"ops the port does not export: {missing}"
    uncovered = sorted(n for n in OPS if n not in CASES and n not in RANDOM)
    assert not uncovered, f"ops without a case: {uncovered}"
    assert RANDOM <= set(OPS)


# ---- random ----------------------------------------------------------------
def _draw(name):
    x = pt.to_tensor(PROB)
    return {
        "uniform": lambda: pt.uniform([4000], min=-2.0, max=3.0),
        "uniform_": lambda: pt.uniform_(pt.zeros([4000]), 0.0, 2.0),
        "normal": lambda: pt.normal(1.0, 2.0, [4000]),
        "gaussian": lambda: pt.gaussian([4000], 0.5, 0.5),
        "standard_normal": lambda: pt.standard_normal([4000]),
        "randn": lambda: pt.randn([4000]),
        "rand": lambda: pt.rand([4000]),
        "randint": lambda: pt.randint(2, 9, [4000]),
        "randint_like": lambda: pt.randint_like(pt.zeros([4000]), 0, 4),
        "randperm": lambda: pt.randperm(50),
        "bernoulli": lambda: pt.bernoulli(pt.full([4000], 0.3)),
        "multinomial": lambda: pt.multinomial(x, 2),
        "poisson": lambda: pt.poisson(pt.full([4000], 3.0)),
        "exponential_": lambda: pt.exponential_(pt.zeros([4000]), 2.0),
        "shuffle": lambda: pt.shuffle(pt.arange(20)),
    }[name]()


def _ref_draw(name):
    x = paddle.to_tensor(PROB)
    return {
        "uniform": lambda: paddle.uniform([4000], min=-2.0, max=3.0),
        "uniform_": lambda: paddle.uniform_(paddle.zeros([4000]), 0.0, 2.0),
        "normal": lambda: paddle.normal(1.0, 2.0, [4000]),
        "gaussian": lambda: paddle.gaussian([4000], 0.5, 0.5),
        "standard_normal": lambda: paddle.standard_normal([4000]),
        "randn": lambda: paddle.randn([4000]),
        "rand": lambda: paddle.rand([4000]),
        "randint": lambda: paddle.randint(2, 9, [4000]),
        "randint_like": lambda: paddle.randint_like(paddle.zeros([4000]), 0, 4),
        "randperm": lambda: paddle.randperm(50),
        "bernoulli": lambda: paddle.bernoulli(paddle.full([4000], 0.3)),
        "multinomial": lambda: paddle.multinomial(x, 2),
        "poisson": lambda: paddle.poisson(paddle.full([4000], 3.0)),
        "exponential_": lambda: paddle.exponential_(paddle.zeros([4000]), 2.0),
        "shuffle": lambda: paddle.shuffle(paddle.arange(20)),
    }[name]()


# mean and std within 0.1 of the reference's draw (4000 samples: the
# standard error of a mean is < 0.05 for every distribution here)
@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_op_matches_the_reference_in_distribution(name):
    pt.seed(3)
    paddle.seed(3)
    got, want = _draw(name), _ref_draw(name)
    g, w = _np(got), _np(want)
    assert _dtype(got) == _dtype(want), f"{name}: {_dtype(got)} vs {_dtype(want)}"
    assert g.shape == w.shape
    if name in ("randperm", "shuffle"):
        assert sorted(g.tolist()) == sorted(w.tolist())
        return
    if name == "multinomial":   # without replacement: distinct per row
        assert all(len(set(r)) == 2 for r in g.tolist())
        assert g.min() >= 0 and g.max() < PROB.shape[1]
        return
    support = {"uniform": (-2.0, 3.0), "uniform_": (0.0, 2.0),
               "rand": (0.0, 1.0), "randint": (2, 8), "randint_like": (0, 3),
               "bernoulli": (0, 1), "poisson": (0, np.inf),
               "exponential_": (0.0, np.inf)}
    if name in support:
        lo, hi = support[name]
        assert g.min() >= lo and g.max() <= hi, (name, g.min(), g.max())
    if name in ("randint", "randint_like", "bernoulli", "poisson"):
        np.testing.assert_array_equal(g, np.round(g))
    assert abs(g.mean() - w.mean()) < 0.1, (g.mean(), w.mean())
    assert abs(g.std() - w.std()) < 0.1, (g.std(), w.std())
    pt.seed(3)
    again = _np(_draw(name))
    np.testing.assert_array_equal(again, g)


def test_random_ops_draw_from_the_ports_generators_not_torchs():
    pt.seed(5)
    a = _np(pt.rand([8]))
    pt.seed(5)
    torch.rand(100)             # torch's global generator moves on
    torch.manual_seed(123)
    b = _np(pt.rand([8]))
    np.testing.assert_array_equal(a, b)
    state = pt.get_rng_state()
    c = _np(pt.randn([8]))
    pt.set_rng_state(state)
    np.testing.assert_array_equal(_np(pt.randn([8])), c)


# ---- scalars and dtypes at the op layer ------------------------------------
@pytest.mark.parametrize("expr", [
    "x + 1", "x + 1.5", "x * 2", "x / 2", "x // 2", "x % 3", "x ** 2",
    "2 - x", "1.5 / xf", "xf + 1", "xf * 2.0", "-x", "x > 1", "x == 2",
    "xf.sum()", "x.sum()", "x.mean()", "x.max()", "xf.argmax()", "x.cumsum()",
    "x.astype('float32') + x", "xf.astype('int64')", "x.prod()",
])
def test_operator_dtypes_match_the_reference(expr):
    a = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    af = a.astype(np.float32) / 3
    env_j = {"x": paddle.to_tensor(a), "xf": paddle.to_tensor(af)}
    env_t = {"x": pt.to_tensor(a), "xf": pt.to_tensor(af)}
    want = eval(expr, {}, env_j)
    got = eval(expr, {}, env_t)
    assert isinstance(got, pt.Tensor)
    _compare(expr, got, want, 1e-6)
