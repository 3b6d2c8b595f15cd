"""Linear algebra and einsum.

Counterpart of `paddle_tpu/ops/linalg.py`, on `torch.linalg` (cuSOLVER and
cuBLAS on the card: the reference leaves these to XLA, not to a Pallas
kernel). Decompositions that are unique only up to signs or phases (`svd`,
`qr`, `eig`, `eigh`) may differ from the reference's factors by those;
their products agree. `svd` returns V, not V^H, as the reference does.
"""
from __future__ import annotations

import builtins

import torch

from ._dispatch import _t, axis_arg, index64, op
from .math import bmm, dot, matmul, mv, t  # noqa: F401  (paddle.linalg)


def _pnorm(flat, p):
    if p == "fro" or p == 2:
        return torch.sqrt(torch.sum(flat * flat))
    if p == float("inf"):
        return torch.amax(torch.abs(flat))
    if p == float("-inf"):
        return torch.amin(torch.abs(flat))
    if p == 1:
        return torch.sum(torch.abs(flat))
    if p == 0:
        return torch.sum((flat != 0).to(flat.dtype))
    return torch.pow(torch.sum(torch.pow(torch.abs(flat), p)), 1.0 / p)


@op
def norm(x, p=None, axis=None, keepdim=False, name=None):
    a = _t(x)
    ax = axis_arg(axis)
    if p is None:
        p = "fro" if ax is None or isinstance(ax, tuple) else 2
    if ax is None:
        out = _pnorm(a.reshape(-1), p)
        return out.reshape([1] * a.ndim) if keepdim and p in ("fro", 2) \
            else out
    if p == "fro":
        return torch.sqrt(torch.sum(a * a, dim=ax, keepdim=keepdim))
    if isinstance(ax, tuple):
        return torch.linalg.matrix_norm(a, p, ax, keepdim)
    return torch.linalg.vector_norm(a, p, ax, keepdim)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return norm(x, p, axis, keepdim)


@op
def dist(x, y, p=2, name=None):
    return _pnorm((_t(x) - _t(y)).reshape(-1), p)


@op
def cond(x, p=None, name=None):
    return torch.linalg.cond(_t(x), p)


@op
def inv(x, name=None):
    return torch.linalg.inv(_t(x))


@op
def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(_t(x), rtol=rcond, hermitian=hermitian)


@op
def det(x, name=None):
    return torch.linalg.det(_t(x))


@op
def slogdet(x, name=None):
    return tuple(torch.linalg.slogdet(_t(x)))


@op
def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(_t(x), upper=upper)


@op
def cholesky_solve(x, y, upper=False, name=None):
    return torch.cholesky_solve(_t(x), _t(y), upper)


@op
def solve(x, y, name=None):
    return torch.linalg.solve(_t(x), _t(y))


@op
def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    a = _t(x)
    if transpose:
        a, upper = a.mT, not upper
    return torch.linalg.solve_triangular(a, _t(y), upper=upper,
                                         unitriangular=unitriangular)


@op
def lstsq(x, y, rcond=None, driver=None, name=None):
    a = _t(x)
    return tuple(torch.linalg.lstsq(a, _t(y), rcond=rcond,
                                    driver=driver or
                                    ("gelsd" if a.device.type == "cpu"
                                     else "gels")))


@op
def qr(x, mode="reduced", name=None):
    return tuple(torch.linalg.qr(_t(x), mode=mode))


@op
def svd(x, full_matrices=False, name=None):
    u, s, vh = torch.linalg.svd(_t(x), full_matrices=full_matrices)
    return u, s, vh.mH


@op
def eig(x, name=None):
    return tuple(torch.linalg.eig(_t(x)))


@op
def eigh(x, UPLO="L", name=None):
    return tuple(torch.linalg.eigh(_t(x), UPLO))


@op
def eigvals(x, name=None):
    return torch.linalg.eigvals(_t(x))


@op
def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(_t(x), UPLO)


@op
def matrix_rank(x, tol=None, hermitian=False, name=None):
    return torch.linalg.matrix_rank(_t(x), rtol=tol, hermitian=hermitian)


@op
def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(_t(x), n)


@op
def multi_dot(x, name=None):
    return torch.linalg.multi_dot([_t(a) for a in x])


@op
def cross(x, y, axis=9, name=None):
    a = _t(x)
    ax = axis if axis != 9 else next(
        (i for i, s in enumerate(a.shape) if s == 3), -1)
    return torch.linalg.cross(a, _t(y, a), dim=ax)


@op
def householder_product(x, tau, name=None):
    return torch.linalg.householder_product(_t(x), _t(tau))


@op
def corrcoef(x, rowvar=True, name=None):
    a = _t(x)
    return torch.corrcoef(a if rowvar else a.mT)


@op
def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    a = _t(x)
    return torch.cov(a if rowvar else a.mT, correction=1 if ddof else 0)


@op
def einsum(equation, *operands):
    return torch.einsum(equation, *[_t(o) for o in operands])


@op
def histogram(input, bins=100, min=0, max=0, name=None):
    a = _t(input)
    lo, hi = (float(a.min()), float(a.max())) if min == 0 and max == 0 \
        else (float(min), float(max))
    return torch.histc(a.float(), bins, lo, hi)


@op
def bincount(x, weights=None, minlength=0, name=None):
    a = _t(x)
    w = None if weights is None else _t(weights, a)
    out = torch.bincount(index64(a), w, minlength)
    return out if w is None else out.to(w.dtype)


def inverse(x, name=None):
    return inv(x)


@op
def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, (list, tuple)):
        if builtins.all(isinstance(a, int) for a in axes):
            axes = (list(axes), list(axes))
        else:
            axes = tuple(list(a) if isinstance(a, (list, tuple)) else [a]
                         for a in axes)
    return torch.tensordot(_t(x), _t(y), dims=axes)


@op
def rank(x, name=None):
    a = _t(x)
    return torch.tensor(a.ndim, dtype=torch.int32, device=a.device)
