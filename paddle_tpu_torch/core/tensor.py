"""paddle_tpu_torch.Tensor — the paddle-style tensor, a subclass of
`torch.Tensor`.

Counterpart of `paddle_tpu/core/tensor.py` (Tensor :34). `to_torch`,
`unwrap_tree`, `wrap_tree` and `api` are the boundary's helpers. The reference's
Tensor holds a `jax.Array` and carries paddle's method surface. Here the
paddle Tensor IS a torch tensor (`as_subclass`: zero-copy, on the autograd
graph), so torch's autograd, devices and kernels serve it, but it is a type
of its own and not `torch.Tensor` with paddle methods bound onto it: 185 of
the paddle Tensor's public names are also torch's, many with another
meaning (`split(3)` gives 3 pieces in paddle and pieces of 3 in torch;
`max(axis)` and `sort(axis)` give values, not (values, indices);
`transpose(perm)` is torch's `permute`; `gather(index, axis)` is
`index_select`; `shape` is a list and `size` an int). Bound onto
`torch.Tensor` they would break torch itself and every ported layer.

The boundary. `__torch_function__` turns every `Tensor` argument of a
torch call into a plain `torch.Tensor` alias, calls the function with the
subclass dispatch disabled and wraps tensor results back: torch's own
Python code never meets a paddle-named method. The port's modules compute
on plain tensors; `Tensor` appears only at the API's edges, where
`api()`-wrapped entry points (`nn.Layer.__call__`, the public
`nn.functional` functions, `jit.TrainStep`, `inference.Predictor.run`,
the serving engines' `submit`) unwrap `Tensor` arguments and wrap their
outputs, only when an argument is a `Tensor`: a caller passing plain torch
tensors pays one `type(a) is Tensor` scan and sees no change.

Methods that accept both the paddle and the torch call form, where the two
cannot be mistaken: `reshape([2, 3])` / `reshape(2, 3)`,
`transpose([1, 0, 2])` / `transpose(0, 1)`, `expand([2, 3])` /
`expand(2, 3)`, `tile([2, 1])` / `tile(2, 1)`. Every other paddle name
has paddle's meaning only.

`dtype` stays torch's `torch.dtype` (overriding it would break torch's
internals); `paddle_tpu_torch.float32` and the other dtype names are
aliases of torch's, and `core.dtype.dtype_name` gives the paddle name.

`Parameter` (the reference's :285-297) is a subclass of
`torch.nn.Parameter`, not of `Tensor`: the optimizer's `_foreach` rules,
TrainStep's `split_state` and the CUDA graphs rely on parameters being
`torch.nn.Parameter`s, and it keeps that class's disabled
`__torch_function__`, so torch's own code (and paddle's `split` / `max`
nowhere) sees it as a plain tensor. It adds paddle's surface: `name`,
`stop_gradient` (read and written as `not requires_grad`), `trainable`,
`optimize_attr` (the learning-rate scale), `regularizer`, `need_clip`,
`persistable` and `gradient()`.
"""
from __future__ import annotations

import numpy as np
import torch

from .place import CPUPlace, CUDAPlace

_DISABLE = torch._C.DisableTorchFunctionSubclass
_PLAIN = torch.Tensor
_ops = None  # the ops module, set when `paddle_tpu_torch.ops` is imported

# torch methods that must act on the object itself and not on an alias of
# it: autograd metadata (an alias of a leaf is a view, not the leaf), hooks
# and in-place changes of shape. Attribute access (`__get__`, `__set__`) is
# direct too.
_DIRECT = {
    torch.Tensor.requires_grad_, torch.Tensor.retain_grad,
    torch.Tensor.register_hook, torch.Tensor.squeeze_,
    torch.Tensor.unsqueeze_, torch.Tensor.set_, torch.Tensor.resize_,
    torch.Tensor.as_strided_, torch.Tensor.t_, torch.Tensor.transpose_,
}
_ATTR = {"__get__", "__set__", "__delete__"}


def to_torch(x):
    """A plain `torch.Tensor` for a `Tensor` (an alias: same storage, on
    the autograd graph); anything else unchanged."""
    return x.as_subclass(_PLAIN) if type(x) is Tensor else x


def unwrap_tree(x):
    """`to_torch` through lists, tuples and dicts."""
    t = type(x)
    if t is Tensor:
        return x.as_subclass(_PLAIN)
    if t is list or t is tuple:
        return t(unwrap_tree(v) for v in x)
    if t is dict:
        return {k: unwrap_tree(v) for k, v in x.items()}
    return x


def wrap_tree(x):
    """`wrap` through lists, tuples (named and struct-sequence ones too)
    and dicts."""
    t = type(x)
    if t is _PLAIN or t is torch.nn.Parameter or t is Parameter:
        return x.as_subclass(Tensor)
    if t is list:
        return [wrap_tree(v) for v in x]
    if t is tuple:
        return tuple(wrap_tree(v) for v in x)
    if isinstance(x, tuple):
        vals = [wrap_tree(v) for v in x]
        return t(*vals) if hasattr(t, "_fields") else t(vals)
    if t is dict:
        return {k: wrap_tree(v) for k, v in x.items()}
    return x


def has_tensor(args, kwargs=None) -> bool:
    """Whether a `Tensor` is among the arguments (top level, or one level
    into a list or tuple)."""
    for a in args:
        t = type(a)
        if t is Tensor:
            return True
        if (t is list or t is tuple) and any(type(v) is Tensor for v in a):
            return True
    if kwargs:
        return has_tensor(tuple(kwargs.values()))
    return False


def api(fn):
    """Decorate an entry point of the port: with a `Tensor` among its
    arguments it runs on plain aliases and its tensor outputs come back as
    `Tensor`; with none it is called as it is."""
    def entry(*args, **kwargs):
        if has_tensor(args, kwargs):
            return wrap_tree(fn(*unwrap_tree(args), **unwrap_tree(kwargs)))
        return fn(*args, **kwargs)

    entry.__name__ = getattr(fn, "__name__", "entry")
    entry.__qualname__ = getattr(fn, "__qualname__", entry.__name__)
    entry.__doc__ = fn.__doc__
    entry.__wrapped__ = fn
    return entry


class Tensor(torch.Tensor):
    """The paddle Tensor: `paddle_tpu_torch.to_tensor(...)` makes one."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in _DIRECT or getattr(func, "__name__", None) in _ATTR:
            with _DISABLE():
                return wrap_tree(func(*args, **(kwargs or {})))
        a = unwrap_tree(args)
        kw = unwrap_tree(kwargs) if kwargs else {}
        with _DISABLE():
            out = func(*a, **kw)
        if a and out is a[0] and type(args[0]) is Tensor:
            return args[0]       # an in-place method returns its tensor
        return wrap_tree(out)

    # ---- metadata ----
    @property
    def shape(self):
        with _DISABLE():
            return list(_PLAIN.shape.__get__(self))

    @property
    def size(self):
        with _DISABLE():
            return _PLAIN.numel(self)

    @property
    def place(self):
        with _DISABLE():
            dev = _PLAIN.device.__get__(self)
        if dev.type == "cuda":
            return CUDAPlace(dev.index or 0)
        return CPUPlace(0)

    @property
    def stop_gradient(self) -> bool:
        with _DISABLE():
            return not _PLAIN.requires_grad.__get__(self)

    @stop_gradient.setter
    def stop_gradient(self, value):
        with _DISABLE():
            _PLAIN.requires_grad_(self, not value)

    @property
    def grad(self):
        with _DISABLE():
            g = _PLAIN.grad.__get__(self)
        return None if g is None else g.as_subclass(Tensor)

    @grad.setter
    def grad(self, value):
        with _DISABLE():
            _PLAIN.grad.__set__(self, to_torch(value))

    # ---- conversion ----
    def numpy(self) -> np.ndarray:
        """A host copy; bf16 (which numpy lacks) widens exactly to f32."""
        t = self.as_subclass(_PLAIN).detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def tolist(self):
        return self.numpy().tolist()

    def item(self, *idx):
        return self.numpy().item(*idx)

    def astype(self, dtype) -> "Tensor":
        return _ops.cast(self, dtype)

    def cast(self, dtype) -> "Tensor":
        return _ops.cast(self, dtype)

    def clone(self) -> "Tensor":
        return _ops.assign(self)

    def detach(self) -> "Tensor":
        return self.as_subclass(_PLAIN).detach().as_subclass(Tensor)

    def cpu(self) -> "Tensor":
        return self.as_subclass(_PLAIN).cpu().as_subclass(Tensor)

    def pin_memory(self) -> "Tensor":
        return self

    def numel(self) -> int:
        return self.size

    def block_until_ready(self) -> "Tensor":
        if self.is_cuda:
            torch.cuda.current_stream(self.device).synchronize()
        return self

    # ---- autograd ----
    def backward(self, grad_tensor=None, retain_graph: bool = False):
        """Gradients into the `.grad` of every leaf this tensor depends on
        (accumulating). A tensor with stop_gradient=True has nothing to
        send back, as in the reference."""
        if self.stop_gradient:
            return
        torch.autograd.backward(self.as_subclass(_PLAIN),
                                to_torch(grad_tensor),
                                retain_graph=retain_graph)

    def gradient(self):
        g = self.grad
        return None if g is None else g.numpy()

    def clear_grad(self):
        self.grad = None

    clear_gradient = clear_grad

    def register_hook(self, hook):
        """hook(grad) sees the gradient as a `Tensor`; a tensor it returns
        replaces the gradient."""
        def plain_hook(g):
            r = hook(g.as_subclass(Tensor))
            return None if r is None else to_torch(r)

        with _DISABLE():
            return _PLAIN.register_hook(self, plain_hook)

    def set_value(self, value) -> "Tensor":
        """Replace the values in place, keeping shape and dtype; not
        recorded by autograd."""
        src = value if isinstance(value, torch.Tensor) else \
            torch.as_tensor(np.asarray(value))
        if list(src.shape) != self.shape:
            raise ValueError(f"set_value shape mismatch: {list(src.shape)} "
                             f"vs {self.shape}")
        with torch.no_grad():
            self.as_subclass(_PLAIN).copy_(to_torch(src))
        return self

    def zero_(self) -> "Tensor":
        with torch.no_grad():
            self.as_subclass(_PLAIN).zero_()
        return self

    def get_tensor(self):
        return self

    # ---- indexing ----
    def __getitem__(self, idx):
        return _ops.getitem(self, idx)

    def __setitem__(self, idx, value):
        _ops.setitem_(self, idx, value)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # ---- arithmetic and comparison, with the reference's dtypes ----
    def __add__(self, o):
        return _ops.add(self, o)

    def __radd__(self, o):
        return _ops.add(o, self)

    def __sub__(self, o):
        return _ops.subtract(self, o)

    def __rsub__(self, o):
        return _ops.subtract(o, self)

    def __mul__(self, o):
        return _ops.multiply(self, o)

    def __rmul__(self, o):
        return _ops.multiply(o, self)

    def __truediv__(self, o):
        return _ops.divide(self, o)

    def __rtruediv__(self, o):
        return _ops.divide(o, self)

    def __floordiv__(self, o):
        return _ops.floor_divide(self, o)

    def __rfloordiv__(self, o):
        return _ops.floor_divide(o, self)

    def __mod__(self, o):
        return _ops.remainder(self, o)

    def __rmod__(self, o):
        return _ops.remainder(o, self)

    def __pow__(self, o):
        return _ops.pow(self, o)

    def __rpow__(self, o):
        return _ops.pow(o, self)

    def __matmul__(self, o):
        return _ops.matmul(self, o)

    def __rmatmul__(self, o):
        return _ops.matmul(o, self)

    def __neg__(self):
        return _ops.neg(self)

    def __abs__(self):
        return _ops.abs(self)

    def __invert__(self):
        return _ops.logical_not(self) if self.dtype == torch.bool \
            else _ops.bitwise_not(self)

    def __and__(self, o):
        return _ops.bitwise_and(self, o)

    def __or__(self, o):
        return _ops.bitwise_or(self, o)

    def __xor__(self, o):
        return _ops.bitwise_xor(self, o)

    def __eq__(self, o):
        return _ops.equal(self, o)

    def __ne__(self, o):
        return _ops.not_equal(self, o)

    def __lt__(self, o):
        return _ops.less_than(self, o)

    def __le__(self, o):
        return _ops.less_equal(self, o)

    def __gt__(self, o):
        return _ops.greater_than(self, o)

    def __ge__(self, o):
        return _ops.greater_equal(self, o)

    __hash__ = torch.Tensor.__hash__

    def __repr__(self):
        body = np.array2string(self.numpy(), precision=4, separator=", ")
        return (f"Tensor(shape={self.shape}, dtype="
                f"{str(self.dtype).replace('torch.', '')}, place="
                f"{self.place}, stop_gradient={self.stop_gradient},\n"
                f"       {body})")

    __str__ = __repr__


def _rebuild_parameter(data, requires_grad, state):
    p = Parameter(data, requires_grad)
    p.__dict__.update(state)
    return p


class Parameter(torch.nn.Parameter):
    """A trainable tensor with paddle's parameter surface. `Parameter(data,
    requires_grad=True)` is `torch.nn.Parameter`'s call; `name` and
    `trainable` are the reference's keywords (`trainable=False` gives
    `stop_gradient=True`)."""

    def __new__(cls, data=None, requires_grad=True, name=None,
                trainable=None):
        if data is None:
            data = torch.empty(0)
        if trainable is not None:
            requires_grad = bool(trainable)
        p = torch.Tensor._make_subclass(cls, to_torch(data).detach(),
                                        requires_grad)
        p._pname = name
        p.trainable = requires_grad
        p.optimize_attr = {"learning_rate": 1.0}
        p.regularizer = None
        p.need_clip = True
        p.persistable = True
        return p

    def __init__(self, *args, **kwargs):
        pass

    @property
    def name(self):
        return self.__dict__.get("_pname")

    @name.setter
    def name(self, value):
        self._pname = value

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        self.requires_grad_(not value)

    def gradient(self):
        """The gradient as a host numpy array (bf16 widened to f32), or
        None."""
        g = self.grad
        if g is None:
            return None
        g = g.detach()
        return (g.float() if g.dtype == torch.bfloat16 else g).cpu().numpy()

    def clear_grad(self):
        self.grad = None

    clear_gradient = clear_grad

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        import copy
        result = type(self)(self.data.clone(memory_format=torch.
                                            preserve_format),
                            self.requires_grad)
        memo[id(self)] = result
        result.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return result

    def __reduce_ex__(self, proto):
        return (_rebuild_parameter,
                (self.data, self.requires_grad, dict(self.__dict__)))


__all__ = ["Tensor", "Parameter", "to_torch", "unwrap_tree", "wrap_tree",
           "has_tensor", "api"]
