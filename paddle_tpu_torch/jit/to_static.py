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
retrace counters and its cache of each signature's program,
`jit.to_static.calls` / `.cache_miss` / `.dur`, FLAGS_check_nan_inf
(:270), the profile hook (:273), `program()` and the default program each
novel signature publishes (:215-221), `release()`, and FLAGS_lint's
trace-time hook (:205-208) at each novel signature's export.

The persistent compile cache (:190-192, :236-246; `core/compile_cache.py`,
off by default as in the reference): with FLAGS_compile_cache_dir set, a
novel signature's export goes through `core.executable.acquire`, keyed on
the signature above (device kinds, not indices) plus the parameter and
buffer names, the function's qualname, dy2static-rewritten source and
closure, every sublayer's non-tensor attributes and hooks (`_Describer`)
and the source files of its classes. A later process loads the program
instead of exporting it, moved onto the call's devices; the loaded
program serves grad calls (eagerly, under autograd) and CUDA-graph
replays alike. A program that holds tensor constants (a function closing
over Layers), calls `static.nn.py_func` or is keyed on a value with no
description that holds across processes is exported afresh in every
process (`export_skips`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import functools
import hashlib
import inspect
import time
import types

import numpy as np
import torch
import torch.utils._pytree as pytree

from .. import analysis as _analysis
from .. import monitor as _monitor
from ..amp.state import amp_state
from ..core import executable as _exe
from ..core import flags as _flags
from ..core.place import resolve_device
from ..core.tensor import has_tensor, to_torch, wrap_tree
from ..ops import _dispatch as _dsp
from .functional import split_state
from .input_spec import InputSpec  # noqa: F401  (re-export)
from .save_load import (_nbytes, _Program, capture, export_program,
                        program_bytes, program_from_bytes)

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


class _Unkeyable(Exception):
    """A value with no description that is the same in every process: the
    program keyed on it is exported afresh in each process, never
    persisted (an `export_skip`)."""


# a Module's own bookkeeping: its tensors and children are keyed by name
# and signature, its hooks by `_Describer.hooks`; state-dict hooks change
# no program
_MODULE_BOOKKEEPING = frozenset({
    "_parameters", "_buffers", "_modules", "_non_persistent_buffers_set",
    "_state_dict_hooks", "_state_dict_pre_hooks",
    "_load_state_dict_pre_hooks", "_load_state_dict_post_hooks",
    "_forward_hooks", "_forward_hooks_with_kwargs",
    "_forward_hooks_always_called", "_forward_pre_hooks",
    "_forward_pre_hooks_with_kwargs", "_backward_hooks",
    "_backward_pre_hooks"})
_PRIMITIVES = (bool, int, float, complex, str, bytes, type(None))
_BY_REPR = (torch.dtype, torch.layout, torch.memory_format, enum.Enum)
_BY_NAME = (types.BuiltinFunctionType, types.BuiltinMethodType,
            types.MethodWrapperType, types.WrapperDescriptorType,
            types.MethodDescriptorType, np.ufunc)
_BY_STR = (torch._ops.OpOverload, torch._ops.OpOverloadPacket)
_DEPTH = 12


def _qualname(v) -> str:
    return f"{getattr(v, '__module__', None)}." \
        f"{getattr(v, '__qualname__', getattr(v, '__name__', repr(v)))}"


def _source(v) -> str:
    """A function's dy2static rewrite when it has one, else its source,
    else (no source: `python -c`) its code."""
    src = getattr(v, "__dy2static_source__", None)
    if src is not None:
        return src
    try:
        return inspect.getsource(v)
    except (OSError, TypeError):
        code = getattr(v, "__code__", None)
        return "" if code is None else \
            repr((code.co_code, code.co_consts, code.co_names))


class _Describer:
    """Descriptions of the values a program depends on that are the same
    in every process that builds the same program: configuration its
    shapes do not show (sizes, epsilons, the activation a Layer holds, a
    function a closure holds, hooks). Layers of the keyed tree are named
    by their path; anything else without such a description raises
    `_Unkeyable`."""

    def __init__(self, layer=None):
        self.paths = {} if layer is None else {
            id(m): name for name, m in layer.named_modules()}
        self._stack = set()

    def layer(self, m, depth=0) -> str:
        """A Layer's class, its attributes and hooks (not its children)."""
        attrs = {k: v for k, v in vars(m).items()
                 if k not in _MODULE_BOOKKEEPING}
        return f"{_qualname(type(m))} {self(attrs, depth)} " \
            f"{self.hooks(m, depth)}"

    def hooks(self, m, depth=0) -> str:
        """A Layer's hooks in order, each with whether it takes kwargs and
        runs always (the handles' ids differ from process to process)."""
        always = getattr(m, "_forward_hooks_always_called", {})
        out = []
        for name, kw in (("_forward_pre_hooks",
                          "_forward_pre_hooks_with_kwargs"),
                         ("_forward_hooks", "_forward_hooks_with_kwargs"),
                         ("_backward_pre_hooks", ""),
                         ("_backward_hooks", "")):
            side = getattr(m, kw, {}) if kw else {}
            out += [(name, self(fn, depth), hid in side, hid in always)
                    for hid, fn in getattr(m, name, {}).items()]
        return repr(out) if out else ""

    def __call__(self, v, depth=0) -> str:
        if isinstance(v, _PRIMITIVES) or isinstance(v, _BY_REPR):
            return repr(v)
        if depth > _DEPTH:
            raise _Unkeyable(f"a value nested deeper than {_DEPTH}")
        if id(v) in self._stack:
            return f"<cycle {_qualname(type(v))}>"
        self._stack.add(id(v))
        try:
            return self._describe(v, depth + 1)
        finally:
            self._stack.discard(id(v))

    def _describe(self, v, depth) -> str:
        if isinstance(v, torch.device):
            # the index is not keyed: a loaded program is moved onto the
            # call's device (`_loads`)
            return f"device({v.type})"
        if isinstance(v, (list, tuple)):
            return f"{type(v).__name__}[" + ", ".join(
                self(x, depth) for x in v) + "]"
        if isinstance(v, (set, frozenset)):
            return "set{" + ", ".join(sorted(self(x, depth)
                                             for x in v)) + "}"
        if isinstance(v, dict):
            return "{" + ", ".join(f"{self(k, depth)}: {self(x, depth)}"
                                   for k, x in v.items()) + "}"
        if isinstance(v, torch.Tensor):
            # read by the program, it is a constant: not persisted
            return f"tensor{tuple(v.shape)}:{v.dtype}"
        if isinstance(v, np.ndarray):
            return f"ndarray{v.shape}:{v.dtype}:" + hashlib.sha256(
                np.ascontiguousarray(v).tobytes()).hexdigest()
        if isinstance(v, np.generic):
            return repr(v)
        if isinstance(v, torch.nn.Module):
            if id(v) in self.paths:
                return f"<layer {self.paths[id(v)]!r}>"
            return "<layer " + "; ".join(self.layer(m, depth)
                                         for m in v.modules()) + ">"
        if isinstance(v, StaticFunction):
            return f"to_static({self(v._function, depth)})"
        if isinstance(v, functools.partial):
            return f"partial({self(v.func, depth)}, {self(v.args, depth)}," \
                f" {self(v.keywords, depth)})"
        if isinstance(v, types.MethodType):
            return f"method({self(v.__func__, depth)} of " \
                f"{self(v.__self__, depth)})"
        if isinstance(v, types.FunctionType):
            src = _source(v)
            # a dy2static rewrite closes over dy2static's own machinery:
            # the closure and defaults that matter are its original's
            v = getattr(v, "__dy2static_original__", v)
            cells = [self(_cell(c), depth) for c in v.__closure__ or ()]
            # the qualname, not the module: the same source in another
            # file is the same program
            return f"function {v.__qualname__}\n{src}\n" \
                f"defaults {self(v.__defaults__, depth)} " \
                f"{self(v.__kwdefaults__, depth)} closure {cells}"
        if isinstance(v, type):
            try:
                return f"class {_qualname(v)}\n{inspect.getsource(v)}"
            except (OSError, TypeError):    # a class defined in C
                return f"class {_qualname(v)}"
        if isinstance(v, _BY_NAME):
            return _qualname(v)
        if isinstance(v, _BY_STR):
            return f"op {v}"
        if isinstance(v, types.ModuleType):
            return f"module {v.__name__}"
        if dataclasses.is_dataclass(v) or isinstance(
                v, types.SimpleNamespace) or (
                type(v).__module__.startswith("paddle_tpu_torch.") and
                hasattr(v, "__dict__")):
            return f"{_qualname(type(v))}({self(vars(v), depth)})"
        raise _Unkeyable(f"a {_qualname(type(v))}")


def _cell(c):
    try:
        return c.cell_contents
    except ValueError:          # an empty cell
        return None


# ---- the compile cache's rules for to_static's programs ----

def _loads(blob, args):
    """The cached program for a call with `args`, on the call's devices
    (an entry written on `cuda:0` serves a rank on `cuda:1`: the key holds
    device kinds only), or None when its placeholders do not take `args`
    (shape, dtype, device)."""
    from torch.export.passes import move_to_device_pass
    exported = program_from_bytes(blob)
    vals = [n.meta.get("val") for n in exported.graph.nodes
            if n.op == "placeholder"]
    if len(vals) != len(args) or any(v is None for v in vals):
        return None
    moves = {}
    for v, a in zip(vals, args):
        if v.device != a.device and moves.setdefault(
                str(v.device), str(a.device)) != str(a.device):
            return None         # one device of the program, two of the call
    if moves:
        exported = move_to_device_pass(exported, moves)
        vals = [n.meta.get("val") for n in exported.graph.nodes
                if n.op == "placeholder"]
    fits = all(tuple(v.shape) == tuple(a.shape) and v.dtype == a.dtype
               and v.device == a.device for v, a in zip(vals, args))
    return exported if fits else None


def _not_persistable(exported):
    """Why `exported` must not outlive this process, or None: tensor
    constants (a function's export closing over Layers aliases their live
    storage here; a loaded copy would freeze the saver's values), or a
    `static.nn.py_func` node (it names a function of this process's
    registry)."""
    if exported.constants or exported.state_dict:
        return f"the program holds tensor constants " \
            f"{sorted(exported.constants)[:4]}"
    from ..static.program import op_names
    if "paddle_tpu_torch.py_func" in op_names(exported.graph_module):
        return "the program calls a py_func of this process"
    return None


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
        self._last_program = None
        # only a NOVEL signature is a retrace: alternating between two
        # known signatures (the serving engine's batch buckets) replays.
        # The ledger keeps each signature's `_Capture`; its `current_sig`
        # is the published program's.
        self._ledger = _exe.ExecutableLedger("to_static")
        try:
            functools.update_wrapper(self, function)
        except Exception:
            pass

    @property
    def layer(self):
        return self._layer

    @property
    def _programs(self):
        """Signature -> `_Capture` of every program built so far."""
        return dict(self._ledger.items())

    def release(self) -> None:
        """Drop every exported program and CUDA graph (and their memory
        pools); the next call of each signature exports anew (or loads its
        program from the compile cache)."""
        self._ledger.clear()
        self._last_program = None

    # ---- the program of a signature ----
    def _state(self):
        layer = self._layer
        if layer is None:
            return [], [], [], [], True
        trainable, frozen = split_state(layer)
        training = tuple(m.training for m in layer.modules())
        return (list(trainable), list(frozen), list(trainable.values()),
                list(frozen.values()), training)

    def _export(self, pnames, bnames, params, buffers, inputs, kwargs,
                key):
        """(`_Capture`, source) of a novel signature: exported afresh, or
        loaded from the compile cache (source "disk")."""
        program = _Program(self._layer, pnames, bnames,
                           fn=self._function if self._layer is None
                           else None, kwargs=kwargs)
        args = [_plain(t) for t in params + buffers + inputs]

        def build():
            closure = _closed_over_params_as_constants() \
                if self._layer is None else contextlib.nullcontext()
            with forward_as(self._layer, self._function), closure:
                return export_program(program, args)

        ep, source = _exe.acquire(
            "to_static", build,
            lambda: self._key_material(pnames, bnames, key),
            dumps=program_bytes, loads=lambda blob: _loads(blob, args),
            not_persistable=_not_persistable,
            label=getattr(self._function, "__name__", "to_static"))
        return _Capture(program, ep), source

    def _key_material(self, pnames, bnames, key) -> str:
        """What the compile cache keys this signature's program on, beside
        what `compile_cache.cache_key` adds (the port's sources, topology,
        versions, flags): the signature with device kinds, the parameter
        and buffer names, the function with its closure, and every
        sublayer's attributes and hooks (`_Describer`) and the source
        files of their classes. Raises `_Unkeyable` (the program is then
        not persisted) for a value with no stable description. Blind to a
        helper changed in a user file that defines no module class, or a
        global a function reads (ROADMAP.md Queue 3 item 6)."""
        sig, state_sig, training, amp, kw_key = key

        def kinds(sigs):
            return [(shape, str(dtype), dev.type)
                    for shape, dtype, dev in sigs]

        describe = _Describer(self._layer)
        parts = [repr(kinds(sig)), repr(kinds(state_sig)), repr(training),
                 repr(amp), describe(kw_key), repr(pnames), repr(bnames),
                 describe(self._function)]
        hooks = [getattr(torch.nn.modules.module, name) for name in (
            "_global_forward_pre_hooks", "_global_forward_hooks",
            "_global_backward_pre_hooks", "_global_backward_hooks")]
        if any(hooks):
            parts.append(describe([list(h.values()) for h in hooks]))
        if self._layer is not None:
            files = set()
            for m in self._layer.modules():
                parts.append(describe.layer(m))
                try:
                    files.add(inspect.getsourcefile(type(m)))
                except TypeError:       # a class defined in C
                    pass
            for path in sorted(p for p in files if p):
                with open(path, encoding="utf-8") as f:
                    parts.append(f.read())
        return "\n".join(parts)

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
            cap = self._ledger.get(key)
            source = "memory"
            if cap is None:
                if _monitor._ENABLED:
                    _monitor.count("jit.to_static.cache_miss")
                if _analysis._ENABLED:
                    # trace-time tpu-lint: the novel-signature block only,
                    # so the steady-state call never reaches this check
                    _analysis.lint_traced(self._function, "to_static")
                cap, source = self._export(pnames, bnames, params, buffers,
                                           inputs, kwargs, key)
                self._ledger.put(key, cap)
            if novel and source != "disk":
                bk.compiled()
            if self._ledger.current_sig != key:
                self._publish(cap, params, buffers, inputs, amp)
                self._ledger.current_sig = key
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
        return [rep for _, cap in self._ledger.items()
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
