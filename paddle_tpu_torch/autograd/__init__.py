"""paddle.autograd: PyLayer and the functional jacobian / hessian / vjp /
jvp.

Counterpart of `paddle_tpu/autograd/__init__.py`. `PyLayer` runs on
`torch.autograd.Function` (one Function class per PyLayer subclass), with
paddle's context (`ctx.save_for_backward(...)`, `ctx.saved_tensor()`);
the functional transforms run on `torch.autograd.functional`. The user's
functions see `Tensor` arguments and may return `Tensor`s.
"""
from __future__ import annotations

import torch
import torch.autograd.functional as AF

from ..core.autograd import backward, no_grad  # noqa: F401
from ..core.tensor import Tensor, to_torch, unwrap_tree, wrap_tree

__all__ = ["PyLayer", "PyLayerContext", "backward", "no_grad", "jacobian",
           "hessian", "vjp", "jvp"]


class PyLayerContext:
    def __init__(self):
        self._saved = ()
        self.materialize_grads = True

    def save_for_backward(self, *tensors):
        self._saved = tensors

    def saved_tensor(self):
        """A method, as paddle's ctx.saved_tensor() is called."""
        return self._saved

    saved_tensors = saved_tensor


def _function_for(layer):
    """The torch.autograd.Function that runs `layer`'s forward and
    backward. Its inputs are every argument; the backward's results go to
    the tensor arguments in order, None to the rest."""

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(fctx, kwargs, *args):
            pctx = PyLayerContext()
            fctx.pctx = pctx
            fctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
            out = layer.forward(pctx, *wrap_tree(args), **kwargs)
            fctx.multi = isinstance(out, (list, tuple))
            outs = list(out) if fctx.multi else [out]
            return tuple(unwrap_tree(o) for o in outs)

        @staticmethod
        def backward(fctx, *grads):
            gin = layer.backward(fctx.pctx, *wrap_tree(grads))
            gin = list(gin) if isinstance(gin, (list, tuple)) else [gin]
            it = iter(gin)
            res = [to_torch(next(it, None)) if t else None
                   for t in fctx.is_tensor]
            return (None, *res)

    _Fn.__name__ = layer.__name__ + "Function"
    return _Fn


class PyLayer:
    """A user-defined forward and backward, as in paddle:

        class Exp(PyLayer):
            @staticmethod
            def forward(ctx, x):
                y = pt.exp(x); ctx.save_for_backward(y); return y
            @staticmethod
            def backward(ctx, dy):
                (y,) = ctx.saved_tensor(); return dy * y
    """

    _fn = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls._fn = _function_for(cls)

    @classmethod
    def apply(cls, *args, **kwargs):
        outs = cls._fn.apply(kwargs, *unwrap_tree(args))
        outs = [wrap_tree(o) for o in outs]
        return tuple(outs) if len(outs) > 1 else outs[0]

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *args):
        raise NotImplementedError


def _functional(func):
    """func over `Tensor`s as a function of plain tensors."""
    def fn(*arrays):
        return unwrap_tree(func(*[a.as_subclass(Tensor) for a in arrays]))
    return fn


def _plain(xs):
    seq = xs if isinstance(xs, (list, tuple)) else [xs]
    return tuple(to_torch(x).detach() for x in seq)


def jacobian(func, xs, create_graph=False, allow_unused=False):
    jac = AF.jacobian(_functional(func), _plain(xs), create_graph=create_graph)
    if not isinstance(xs, (list, tuple)):
        return wrap_tree(jac[0])
    return wrap_tree(tuple(jac))


def hessian(func, xs, create_graph=False, allow_unused=False):
    h = AF.hessian(_functional(func), _plain(xs), create_graph=create_graph)
    if not isinstance(xs, (list, tuple)):
        return wrap_tree(h[0][0])
    return wrap_tree(tuple(tuple(row) for row in h))


def vjp(func, xs, v=None):
    ins = _plain(xs)
    fn = _functional(func)
    if v is None:
        with torch.no_grad():
            v = torch.ones_like(fn(*ins))
    out, grads = AF.vjp(fn, ins, to_torch(v))
    grads = wrap_tree(list(grads))
    return wrap_tree(out), (grads if isinstance(xs, (list, tuple))
                            else grads[0])


def jvp(func, xs, v=None):
    ins = _plain(xs)
    tangents = tuple(torch.ones_like(a) for a in ins) if v is None else \
        _plain(v)
    out, tangent = AF.jvp(_functional(func), ins, tangents)
    return wrap_tree(out), wrap_tree(tangent)
