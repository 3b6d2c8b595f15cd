"""Elementwise, reduction and product ops.

Counterpart of `paddle_tpu/ops/math.py`: the same names, arguments and
results (dtypes by `core/dtype.py`'s rule: a sum of int32 is int32), on
torch's ops. Where torch's function differs from the reference's formula
(`lerp`, `median` of an even count, `renorm`), the reference's formula is
computed.
"""
from __future__ import annotations

import functools
import operator

import torch

from ..amp.state import maybe_cast
from ..core.dtype import canonical, convert_dtype, get_default_dtype
from ._dispatch import (_inplace, _t, axis_arg, binary_op, make_inplace, op,
                        unary_op)

# ---- binary elementwise ----
add = binary_op(torch.add, "add")
subtract = binary_op(torch.sub, "subtract")
multiply = binary_op(torch.mul, "multiply")
divide = binary_op(torch.true_divide, "divide")
floor_divide = binary_op(torch.floor_divide, "floor_divide")
remainder = binary_op(torch.remainder, "remainder")
mod = remainder
floor_mod = remainder
pow = binary_op(torch.pow, "pow")
maximum = binary_op(torch.maximum, "maximum", scalar_ok=False)
minimum = binary_op(torch.minimum, "minimum", scalar_ok=False)
fmax = binary_op(torch.fmax, "fmax", scalar_ok=False)
fmin = binary_op(torch.fmin, "fmin", scalar_ok=False)
atan2 = binary_op(torch.atan2, "atan2", scalar_ok=False)
heaviside = binary_op(torch.heaviside, "heaviside", scalar_ok=False)
hypot = binary_op(lambda a, b: torch.sqrt(a * a + b * b), "hypot")
logaddexp = binary_op(torch.logaddexp, "logaddexp", scalar_ok=False)
nextafter = binary_op(torch.nextafter, "nextafter", scalar_ok=False)
copysign = binary_op(torch.copysign, "copysign", scalar_ok=False)
gcd = binary_op(torch.gcd, "gcd", scalar_ok=False)
lcm = binary_op(torch.lcm, "lcm", scalar_ok=False)

elementwise_add = add
elementwise_sub = subtract
elementwise_mul = multiply
elementwise_div = divide

# ---- unary elementwise ----
abs = unary_op(torch.abs, "abs")
sqrt = unary_op(torch.sqrt, "sqrt")
rsqrt = unary_op(torch.rsqrt, "rsqrt")
square = unary_op(torch.square, "square")
exp = unary_op(torch.exp, "exp")
expm1 = unary_op(torch.expm1, "expm1")
log = unary_op(torch.log, "log")
log2 = unary_op(torch.log2, "log2")
log10 = unary_op(torch.log10, "log10")
log1p = unary_op(torch.log1p, "log1p")
sin = unary_op(torch.sin, "sin")
cos = unary_op(torch.cos, "cos")
tan = unary_op(torch.tan, "tan")
asin = unary_op(torch.asin, "asin")
acos = unary_op(torch.acos, "acos")
atan = unary_op(torch.atan, "atan")
sinh = unary_op(torch.sinh, "sinh")
cosh = unary_op(torch.cosh, "cosh")
tanh = unary_op(torch.tanh, "tanh")
asinh = unary_op(torch.asinh, "asinh")
acosh = unary_op(torch.acosh, "acosh")
atanh = unary_op(torch.atanh, "atanh")
floor = unary_op(torch.floor, "floor")
ceil = unary_op(torch.ceil, "ceil")
round = unary_op(torch.round, "round")
trunc = unary_op(torch.trunc, "trunc")
frac = unary_op(lambda a: a - torch.trunc(a), "frac")
sign = unary_op(torch.sign, "sign")
reciprocal = unary_op(lambda a: 1.0 / a, "reciprocal")
neg = unary_op(torch.neg, "neg")
erf = unary_op(torch.erf, "erf")
erfinv = unary_op(torch.erfinv, "erfinv")
lgamma = unary_op(torch.lgamma, "lgamma")
digamma = unary_op(torch.digamma, "digamma")
angle = unary_op(torch.angle, "angle")
conj = unary_op(lambda a: torch.conj(a).resolve_conj().clone(), "conj")
real = unary_op(lambda a: torch.real(a).clone(), "real")
imag = unary_op(lambda a: torch.imag(a).clone() if a.is_complex()
                else torch.zeros_like(a), "imag")
deg2rad = unary_op(torch.deg2rad, "deg2rad")
rad2deg = unary_op(torch.rad2deg, "rad2deg")
logit = unary_op(torch.logit, "logit")
signbit = unary_op(torch.signbit, "signbit")


@op
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    a = _t(x)

    def like(v):   # the reference casts scale and bias to x's dtype
        if isinstance(v, torch.Tensor):
            return _t(v).to(a.dtype)
        return v if a.is_floating_point() else int(v)

    s, b = like(scale), like(bias)
    if bias_after_scale:
        return a * s + b
    return (a + b) * s


@op
def clip(x, min=None, max=None, name=None):
    a = _t(x)
    lo = _t(min, a) if isinstance(min, torch.Tensor) else min
    hi = _t(max, a) if isinstance(max, torch.Tensor) else max
    return torch.clamp(a, lo, hi)


@op
def lerp(x, y, weight, name=None):
    a, b = _t(x), _t(y)
    w = _t(weight, a) if isinstance(weight, torch.Tensor) else weight
    return a + w * (b - a)


@op
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * _t(x))


@op
def multiplex(inputs, index, name=None):
    arrs = [_t(t) for t in inputs]
    ind = _t(index, arrs[0]).reshape(-1).long()
    stacked = torch.stack(arrs, 0)
    return stacked[ind, torch.arange(arrs[0].shape[0], device=ind.device)]


# ---- matmul family ----
@op
def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    a, b = maybe_cast(_t(x), _t(y))
    if transpose_x and a.ndim > 1:
        a = a.transpose(-1, -2)
    if transpose_y and b.ndim > 1:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


mm = matmul


@op
def dot(x, y, name=None):
    return torch.sum(_t(x) * _t(y), -1)


@op
def outer(x, y, name=None):
    return torch.outer(_t(x).reshape(-1), _t(y).reshape(-1))


@op
def inner(x, y, name=None):
    return torch.inner(_t(x), _t(y))


@op
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return beta * _t(input) + alpha * torch.matmul(_t(x), _t(y))


def bmm(x, y, name=None):
    return matmul(x, y)


@op
def t(x, name=None):
    a = _t(x)
    if a.ndim > 2:
        raise ValueError("t() expects ndim<=2")
    return a.t()


@op
def kron(x, y, name=None):
    return torch.kron(_t(x), _t(y))


@op
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(_t(x), offset, axis1, axis2).sum(-1)


@op
def mv(x, vec, name=None):
    return torch.matmul(_t(x), _t(vec))


# ---- reductions ----
def _dims(a, ax):
    """torch's `dim` for a reference axis (None = every axis)."""
    return tuple(range(a.ndim)) if ax is None else ax


def _keep_all(out, a, ax, keepdim):
    """A full reduction with keepdim keeps every axis as size 1."""
    if keepdim and ax is None:
        return out.reshape([1] * a.ndim)
    return out


@op
def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    a, ax = _t(x), axis_arg(axis)
    dt = canonical(convert_dtype(dtype)) if dtype is not None else \
        torch.int32 if not a.is_floating_point() and not a.is_complex() \
        else None
    out = torch.sum(a, dim=_dims(a, ax), keepdim=keepdim)
    return out if dt is None else out.to(dt)


def _inexact(a):
    return a if a.is_floating_point() or a.is_complex() else \
        a.to(get_default_dtype())


@op
def mean(x, axis=None, keepdim=False, name=None):
    a, ax = _inexact(_t(x)), axis_arg(axis)
    return torch.mean(a, dim=_dims(a, ax), keepdim=keepdim)


@op
def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    a, ax = _t(x), axis_arg(axis)
    if dtype is not None:
        a = a.to(canonical(convert_dtype(dtype)))
    if ax is None:
        return _keep_all(torch.prod(a), a, ax, keepdim)
    out = a
    for d in sorted([d % a.ndim for d in
                     (ax if isinstance(ax, tuple) else (ax,))], reverse=True):
        out = torch.prod(out, d, keepdim=keepdim)
    return out


@op
def max(x, axis=None, keepdim=False, name=None):
    a, ax = _t(x), axis_arg(axis)
    if ax is None:
        return _keep_all(torch.amax(a, dim=_dims(a, ax)), a, ax, keepdim)
    return torch.amax(a, dim=ax, keepdim=keepdim)


@op
def min(x, axis=None, keepdim=False, name=None):
    a, ax = _t(x), axis_arg(axis)
    if ax is None:
        return _keep_all(torch.amin(a, dim=_dims(a, ax)), a, ax, keepdim)
    return torch.amin(a, dim=ax, keepdim=keepdim)


amax = max
amin = min


@op
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    a, ax = _inexact(_t(x)), axis_arg(axis)
    return torch.std(a, dim=_dims(a, ax), correction=int(bool(unbiased)),
                     keepdim=keepdim)


@op
def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    a, ax = _inexact(_t(x)), axis_arg(axis)
    return torch.var(a, dim=_dims(a, ax), correction=int(bool(unbiased)),
                     keepdim=keepdim)


def _quantile(qfn, a, q, ax, keepdim):
    """torch's (nan)quantile over one axis, several or all (the axes moved
    last and flattened), with the reference's keepdim shape."""
    qt = torch.as_tensor(q, dtype=a.dtype, device=a.device)
    if ax is None:
        out = qfn(a.reshape(-1), qt, dim=0)
        if keepdim:
            out = out.reshape(out.shape + (1,) * a.ndim)
        return out
    axes = sorted(d % a.ndim for d in (ax if isinstance(ax, tuple) else (ax,)))
    rest = [d for d in range(a.ndim) if d not in axes]
    b = a.permute(rest + axes).reshape([a.shape[d] for d in rest] + [-1])
    out = qfn(b, qt, dim=-1)
    if keepdim:
        shape = list(out.shape[:qt.ndim]) + [
            1 if d in axes else a.shape[d] for d in range(a.ndim)]
        out = out.reshape(shape)
    return out


@op
def median(x, axis=None, keepdim=False, name=None):
    a = _inexact(_t(x))
    return _quantile(torch.quantile, a, 0.5, axis_arg(axis), keepdim)


@op
def quantile(x, q, axis=None, keepdim=False, name=None):
    a = _inexact(_t(x))
    return _quantile(torch.quantile, a, q, axis_arg(axis), keepdim)


@op
def nanmedian(x, axis=None, keepdim=False, name=None):
    a = _inexact(_t(x))
    return _quantile(torch.nanquantile, a, 0.5, axis_arg(axis), keepdim)


@op
def nanmean(x, axis=None, keepdim=False, name=None):
    a, ax = _inexact(_t(x)), axis_arg(axis)
    return torch.nanmean(a, dim=_dims(a, ax), keepdim=keepdim)


@op
def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    a, ax = _t(x), axis_arg(axis)
    out = torch.nansum(a, dim=_dims(a, ax), keepdim=keepdim)
    return out if dtype is None else out.to(convert_dtype(dtype))


@op
def logsumexp(x, axis=None, keepdim=False, name=None):
    a, ax = _inexact(_t(x)), axis_arg(axis)
    return torch.logsumexp(a, dim=_dims(a, ax), keepdim=keepdim)


@op
def cumsum(x, axis=None, dtype=None, name=None):
    a = _t(x)
    dt = convert_dtype(dtype)
    if axis is None:
        return torch.cumsum(a.reshape(-1), 0, dtype=dt)
    return torch.cumsum(a, int(axis), dtype=dt)


@op
def cumprod(x, dim=None, dtype=None, name=None):
    a = _t(x)
    dt = convert_dtype(dtype)
    if dim is None:
        return torch.cumprod(a.reshape(-1), 0, dtype=dt)
    return torch.cumprod(a, int(dim), dtype=dt)


def _cum_extreme(x, axis, tfn):
    a = _t(x)
    if axis is None:
        return tuple(tfn(a.reshape(-1), 0))
    return tuple(tfn(a, int(axis)))


@op
def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, torch.cummax)


@op
def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, torch.cummin)


@op
def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    a = _t(x)
    pre = None if prepend is None else _t(prepend, a)
    app = None if append is None else _t(append, a)
    return torch.diff(a, n, axis, pre, app)


# ---- nan/inf checks ----
isnan = unary_op(torch.isnan, "isnan")
isinf = unary_op(torch.isinf, "isinf")
isfinite = unary_op(torch.isfinite, "isfinite")


@op
def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(_t(x), nan, posinf, neginf)


# ---- in-place forms (paddle's `op_` spelling) ----
add_ = make_inplace(add)
subtract_ = make_inplace(subtract)
multiply_ = make_inplace(multiply)
divide_ = make_inplace(divide)
scale_ = make_inplace(scale)
clip_ = make_inplace(clip)
exp_ = make_inplace(exp)
sqrt_ = make_inplace(sqrt)
rsqrt_ = make_inplace(rsqrt)
floor_ = make_inplace(floor)
ceil_ = make_inplace(ceil)
round_ = make_inplace(round)
reciprocal_ = make_inplace(reciprocal)
tanh_ = make_inplace(tanh)
abs_ = make_inplace(abs)


@op
def logcumsumexp(x, axis=None, dtype=None, name=None):
    a = _t(x)
    if dtype is not None:
        a = a.to(convert_dtype(dtype))
    if axis is None:
        return torch.logcumsumexp(a.reshape(-1), 0)
    return torch.logcumsumexp(a, int(axis))


@op
def count_nonzero(x, axis=None, keepdim=False, name=None):
    a, ax = _t(x), axis_arg(axis)
    out = torch.count_nonzero(a, dim=_dims(a, ax))
    if keepdim:
        dims = _dims(a, ax)
        dims = dims if isinstance(dims, tuple) else (dims,)
        out = out.reshape([1 if d in {e % a.ndim for e in dims} else s
                           for d, s in enumerate(a.shape)])
    return out.to(torch.int32)


@op
def cdist(x, y, p=2.0, name=None, **kw):
    """Pairwise p-norm distances of row vectors ([..., M, D] x [..., N, D]
    -> [..., M, N]), by the reference's formula."""
    a, b = _t(x), _t(y)
    d = a[..., :, None, :] - b[..., None, :, :]
    if p == 2.0:
        sq = torch.sum(d * d, -1)
        return torch.where(sq > 0, torch.sqrt(torch.clamp(sq, min=1e-30)),
                           torch.zeros_like(sq))
    if p == float("inf"):
        return torch.amax(torch.abs(d), -1)
    if p == 0.0:
        return torch.sum((d != 0).to(a.dtype), -1)
    return torch.sum(torch.abs(d) ** p, -1) ** (1.0 / p)


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


@op
def add_n(inputs, name=None):
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    return functools.reduce(operator.add, [_t(t) for t in inputs])


def increment(x, value=1.0, name=None):
    """x + value, also written into x (the reference's loop counter)."""
    out = add(x, value)
    with torch.no_grad():
        _inplace(x, out)
    return out


@op
def renorm(x, p, axis, max_norm, name=None):
    a = _t(x)
    axes = tuple(i for i in range(a.ndim) if i != axis)
    af = a.float()
    norm = torch.sum(torch.abs(af) ** p, dim=axes, keepdim=True) ** (1.0 / p)
    factor = torch.where(norm > max_norm, max_norm / (norm + 1e-7),
                         torch.ones_like(norm))
    return (af * factor).to(a.dtype)

