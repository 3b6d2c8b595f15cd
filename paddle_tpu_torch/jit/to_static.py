"""@to_static: a Layer or function run as one exported program per input
signature.

Counterpart of `paddle_tpu/jit/to_static.py` (:33-326). The function is
first rewritten by `jit.dy2static`, so Python `if` / `while` / `for` over
tensors lower to the `cond` / `while_loop` operators. Each novel
signature is exported once (`torch.export` of the Layer's functional
call with its parameters and buffers as arguments, the export under
`jit.save`: `save_load.export_program`). The signature is the shapes,
dtypes and devices of the inputs, parameters and buffers, every
sublayer's `training` flag (reference :177-181), the keyword constants
and the AMP state: a program exported under `amp.auto_cast` casts to
the low dtype inside, so it is not replayed outside it (the reference
keys no AMP state and replays its autocast trace there; a test pins the
difference).

A call runs the exported program:
  - when it needs gradients (grad mode on and a parameter or input that
    requires grad), eagerly under autograd, so `loss.backward()` crosses
    the static boundary, as the reference's one tape node does
    (:225-256, :280-284); the flash operators' registered backward
    serves the attention inside;
  - otherwise, on a CUDA device, as one CUDA-graph replay per signature
    (`save_load.capture`, the machinery of `TranslatedLayer`). The graph
    reads the parameters' and buffers' own storage, which the optimizers
    update in place; a parameter whose storage changed forces a new
    capture. A program holding a `cond` / `while_loop` node or a host
    callback (`static.nn.py_func`) runs eagerly instead: the operators
    read their predicate on the host. Dropout inside a replay draws fresh
    bits each time (the default CUDA generator is registered with every
    capture). A replay returns copies of the graph's outputs, as the
    reference returns fresh arrays;
  - on the CPU, eagerly.

The reference's bookkeeping is kept: the `ExecutableLedger("to_static")`
retrace counters, `jit.to_static.calls` / `.cache_miss` / `.dur`,
FLAGS_check_nan_inf (:270), the profile hook (:273), `program()` and the
default program each novel signature publishes (:215-221), `release()`.
The persistent compile cache (:190-192, :236-246; off by default in the
reference) waits for the compile-cache slice.
"""
from __future__ import annotations

import contextlib
import functools
import time

import torch
import torch.utils._pytree as pytree

from .. import monitor as _monitor
from ..amp.state import amp_state
from ..core import executable as _exe
from ..core import flags as _flags
from ..core.place import resolve_device
from ..core.tensor import has_tensor, to_torch, wrap_tree
from ..ops import _dispatch as _dsp
from .functional import split_state
from .input_spec import InputSpec  # noqa: F401  (re-export)
from .save_load import _nbytes, _Program, capture, export_program

__all__ = ["StaticFunction", "to_static", "declarative", "not_to_static",
           "forward_as"]


@contextlib.contextmanager
def forward_as(layer, fn):
    """`layer.forward` is `fn` inside the block (nothing changes when
    either is None): an export of a to_static'd Layer traces the rewritten
    forward, not the StaticFunction that replaced it."""
    if layer is None or fn is None:
        yield
        return
    d = layer.__dict__
    had, saved = "forward" in d, d.get("forward")
    d["forward"] = fn
    try:
        yield
    finally:
        if had:
            d["forward"] = saved
        else:
            d.pop("forward", None)


def _plain(t: torch.Tensor) -> torch.Tensor:
    return t.detach().as_subclass(torch.Tensor)


@contextlib.contextmanager
def _closed_over_params_as_constants():
    """Inside the block every Layer called reads its parameters as plain
    detached aliases: a function's export then holds the parameters of
    the Layers it closes over as constants (the reference's closed-over
    arrays), which torch.export cannot do with the port's `Parameter`
    subclass. The aliases share storage, so in-place updates show."""
    swapped = []

    def pre(module, args):
        for name, p in list(module._parameters.items()):
            if p is not None and type(p) is not torch.Tensor:
                # made with the trace's modes off: they cannot take the
                # subclass
                from torch.utils._python_dispatch import \
                    _disable_current_modes
                with torch._C.DisableTorchFunction(), \
                        _disable_current_modes():
                    alias = p.detach()
                swapped.append((module, name, p))
                module._parameters[name] = alias

    handle = torch.nn.modules.module.register_module_forward_pre_hook(pre)
    try:
        yield
    finally:
        handle.remove()
        for module, name, p in reversed(swapped):
            module._parameters[name] = p


_HOST_OPS = ("higher_order.cond", "higher_order.while_loop",
             "paddle_tpu_torch.py_func")


class _Capture:
    """One signature's program: the `_Program` exported, the export, its
    module, whether a CUDA graph can hold it, and its graphs by the
    storage of the state they read."""

    def __init__(self, program, exported):
        from ..static.program import op_names
        self.program = program
        self.exported = exported
        self.module = exported.module()
        self.capturable = not any(n in _HOST_OPS
                                  for n in op_names(exported.graph_module))
        self.replays = {}
        self.out_spec = None


class StaticFunction:
    """A function or Layer forward run as exported programs."""

    def __init__(self, function, layer=None, input_spec=None):
        try:
            from .dy2static import ast_transform
            self._function = ast_transform(function)
        except Exception:  # source unavailable / exotic callable: as is
            self._function = function
        self._layer = layer
        self._input_spec = input_spec
        self._programs = {}
        self._last_program = None
        self._current = None
        # only a NOVEL signature is a retrace: alternating between two
        # known signatures (the serving engine's batch buckets) replays
        self._ledger = _exe.ExecutableLedger("to_static")
        try:
            functools.update_wrapper(self, function)
        except Exception:
            pass

    @property
    def layer(self):
        return self._layer

    def release(self) -> None:
        """Drop every exported program and CUDA graph (and their memory
        pools); the next call of each signature exports anew."""
        self._programs.clear()
        self._ledger.clear()
        self._last_program = None
        self._current = None

    # ---- the program of a signature ----
    def _state(self):
        layer = self._layer
        if layer is None:
            return [], [], [], [], True
        trainable, frozen = split_state(layer)
        training = tuple(m.training for m in layer.modules())
        return (list(trainable), list(frozen), list(trainable.values()),
                list(frozen.values()), training)

    def _export(self, pnames, bnames, params, buffers, inputs, kwargs):
        program = _Program(self._layer, pnames, bnames,
                           fn=self._function if self._layer is None
                           else None, kwargs=kwargs)
        closure = _closed_over_params_as_constants() \
            if self._layer is None else contextlib.nullcontext()
        with forward_as(self._layer, self._function), closure:
            ep = export_program(program, [_plain(t) for t in
                                          params + buffers + inputs])
        return _Capture(program, ep)

    def _publish(self, cap, params, buffers, inputs, amp):
        """The capture as the default Program: arguments (params...,
        inputs...), the buffers bound, as the reference's (:215-221). Its
        function is the Python forward under the capture's AMP state, so
        a pass re-traces the model, as the reference's re-lowers `pure`."""
        from ..amp.state import auto_cast
        from ..static.program import Program, _set_default_program
        program, n_p, bufs = cap.program, len(params), list(buffers)
        layer, forward = self._layer, self._function

        def fn(*arrs):
            with forward_as(layer, forward), auto_cast(
                    enable=amp[0], dtype=amp[1], level=amp[2]):
                return program(*arrs[:n_p], *bufs, *arrs[n_p:])

        specs = [InputSpec.from_tensor(t) for t in params + inputs]
        devices = [t.device for t in params + inputs]
        self._last_program = Program(
            fn, specs, exported=cap.exported, devices=devices,
            name=getattr(self._function, "__name__", "main"),
            bound=(n_p, bufs))
        _set_default_program(self._last_program)

    # ---- a call ----
    def __call__(self, *args, **kwargs):
        if any(isinstance(v, torch.Tensor) for v in kwargs.values()):
            raise ValueError("to_static: pass Tensor arguments positionally")
        try:
            kw_key = tuple(sorted(kwargs.items()))
            hash(kw_key)
        except TypeError:
            raise ValueError("to_static kwargs must be hashable (static) "
                             "values")
        wrap = has_tensor(args)
        pnames, bnames, params, buffers, training = self._state()
        state = params + buffers
        device = next((a.device for a in args
                       if isinstance(a, torch.Tensor)), None) or \
            (state[0].device if state else resolve_device())
        inputs = [to_torch(a) if isinstance(a, torch.Tensor)
                  else _dsp.from_data(a, device=device) for a in args]
        st = amp_state()
        amp = (st.enabled, st.dtype, st.level)
        sig = tuple((tuple(t.shape), t.dtype, t.device) for t in inputs)
        key = (sig, tuple((tuple(t.shape), t.dtype, t.device)
                          for t in state), training, amp, kw_key)
        novel = self._ledger.note(key, detail=[
            f"{list(s)}:{d}" for s, d, _ in sig])
        record = torch.is_grad_enabled() and any(
            t.requires_grad for t in params + inputs)
        t0 = time.time()
        with _exe.booking("to_static") as bk:
            cap = self._programs.get(key)
            if cap is None:
                if _monitor._ENABLED:
                    _monitor.count("jit.to_static.cache_miss")
                cap = self._programs[key] = self._export(
                    pnames, bnames, params, buffers, inputs, kwargs)
            if novel:
                bk.compiled()
            if self._current != key:
                self._publish(cap, params, buffers, inputs, amp)
                self._current = key
            if not record and device.type == "cuda" and cap.capturable:
                out = self._replay(cap, state, inputs, device, bk)
            else:
                out = cap.module(*state, *inputs)
        if _flags.flag("check_nan_inf"):
            _dsp._check_nan_inf("static_program", pytree.tree_leaves(out))
        if _dsp._PROFILE_HOOK is not None:
            _dsp._PROFILE_HOOK("static_program", t0, time.time())
        if _monitor._ENABLED:
            _monitor.count("jit.to_static.calls")
            _monitor.observe("jit.to_static.dur", time.time() - t0)
        return wrap_tree(out) if wrap else out

    def _replay(self, cap, state, inputs, device, bk):
        """One CUDA-graph replay of the capture for this storage of the
        state; captured (once) at the first call of a storage."""
        ptrs = tuple(t.data_ptr() for t in state)
        rep = cap.replays.get(ptrs)
        with torch.no_grad():
            if rep is None:
                cap.replays.clear()     # a moved state frees the old pool
                module = cap.module

                def run(ins):
                    leaves, spec = pytree.tree_flatten(
                        module(*state, *ins))
                    cap.out_spec = spec
                    return leaves

                bk.compiled()
                outs, rep = capture(run, inputs, device, _nbytes(state),
                                    "to_static: capturing the program")
                cap.replays[ptrs] = rep
            else:
                for s, a in zip(rep.inputs, inputs):
                    s.copy_(a)
                rep.graph.replay()
                outs = [o.clone() for o in rep.outputs]
        return pytree.tree_unflatten(outs, cap.out_spec)

    def captures(self):
        """The CUDA-graph captures of every signature (each a
        `save_load._Replay`: static inputs, outputs, memory breakdown)."""
        return [rep for cap in self._programs.values()
                for rep in cap.replays.values()]

    def program(self, *args):
        """The Program of the most recent call; with args, the program of
        a call with those."""
        if args:
            self(*args)
        if self._last_program is None:
            raise RuntimeError("call the @to_static function once (or pass "
                               "example args) to capture its program")
        return self._last_program


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, **kwargs):
    """Decorator / wrapper of a Layer (its forward is replaced), a Layer's
    bound forward, or a function of tensors."""

    def decorate(obj):
        from ..nn.layer.layers import Layer
        if isinstance(obj, Layer):
            static = StaticFunction(obj.forward, layer=obj,
                                    input_spec=input_spec)
            obj.forward = static
            return obj
        if hasattr(obj, "__self__") and isinstance(obj.__self__, Layer):
            return StaticFunction(obj.__func__.__get__(obj.__self__),
                                  layer=obj.__self__, input_spec=input_spec)
        return StaticFunction(obj, layer=None, input_spec=input_spec)

    if function is not None:
        return decorate(function)
    return decorate


declarative = to_static


def not_to_static(fn):
    fn._not_to_static = True
    return fn
