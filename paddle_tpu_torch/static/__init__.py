"""paddle.static counterpart: all 47 of the namespace's names.

Counterpart of `paddle_tpu/static/__init__.py` (:1-517). The static graph
is an exported program (`static.Program`, from `jit.to_static` or
`Program.from_callable`); this module keeps the static-mode surface over
it: InputSpec / `data`, `Executor`, control flow (`static.nn`), the
passes, inference-model save / load, the legacy scope of `static.nn`'s
builders with its serialisation, the guards, and the fluid helpers
(`append_backward`, `gradients`, `Print`, `ExponentialMovingAverage`,
`accuracy`, `auc`).

Deviations from the reference, each pinned by a test: `name_scope`,
`xpu_places`, `npu_places` and `mlu_places` work (the reference's raise:
`unique_name` has no `guard`, and its `Place` takes one argument);
`serialize_persistables` writes bf16 state as float32 arrays.
"""
from __future__ import annotations

import contextlib as _ctx
import pickle

import numpy as np
import torch

from ..core.place import CPUPlace, CUDAPlace, Place, resolve_device
from ..core.tensor import Parameter, Tensor, to_torch
from ..jit.input_spec import InputSpec  # noqa: F401
from . import nn  # noqa: F401
from . import passes  # noqa: F401
from .passes import apply_pass, list_passes, register_pass  # noqa: F401
from .program import Program, default_main_program  # noqa: F401
from .nn import py_func  # noqa: F401

# the static Variable's role is played by Tensor
Variable = Tensor

_STATIC_MODE = [False]


def _np(t) -> np.ndarray:
    """A host array of a tensor (bf16 as float32)."""
    t = to_torch(t).detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         **kwargs):
    """`jit.save` of `layer=` at `input_spec=` (else the feed vars): the
    program is the Layer's export."""
    layer = kwargs.get("layer")
    if layer is not None:
        from ..jit.save_load import save as jsave
        return jsave(layer, path_prefix,
                     input_spec=kwargs.get("input_spec", feed_vars))
    raise NotImplementedError(
        "static save: call paddle_tpu_torch.jit.save(layer, path, "
        "input_spec) — programs are captured from Layers, not from a "
        "global default program")


def load_inference_model(path_prefix, executor=None, **kwargs):
    """(the loaded program, feed names, fetch names)."""
    from ..jit.save_load import load as jload
    tl = jload(path_prefix)
    feed_names = [f"input_{i}" for i in range(len(tl._meta["input_specs"]))]
    return tl, feed_names, ["output_0"]


class Executor:
    """Runs Programs, TranslatedLayers and @to_static functions; results
    come back as numpy arrays (reference `Executor.run`,
    `fluid/executor.py:611`)."""

    def __init__(self, place=None):
        self.place = place

    def run(self, program=None, feed=None, fetch_list=None, **kwargs):
        args = list(feed.values()) if isinstance(feed, dict) else (feed or [])
        if isinstance(program, Program):
            out = program.run(*args)
        elif callable(program):
            out = program(*args)
        else:
            raise NotImplementedError(
                "Executor.run expects a Program or a callable")
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [_np(o) if isinstance(o, torch.Tensor) else np.asarray(o)
                for o in outs]

    def train_from_dataset(self, program, dataset, fetch_list=None,
                           print_period=100, debug=False):
        """The dataset-driven training loop (reference `executor.py:1731`):
        `program` takes a batch and returns the loss; returns the losses."""
        losses = []
        for i, batch in enumerate(dataset):
            loss = program(batch)
            losses.append(float(loss))
            if debug and print_period and (i + 1) % print_period == 0:
                print(f"[train_from_dataset] batch {i + 1} "
                      f"loss {losses[-1]:.6f}")
        return losses


def default_startup_program():
    """Parameters are initialised at construction, so the startup
    program is empty."""
    return Program(lambda: (), [], name="startup")


def data(name, shape, dtype="float32", lod_level=0):
    return InputSpec(shape, dtype, name)


# ---- legacy fluid-static surface ----

class Scope:
    """Variable scope: name -> value over `static.nn`'s layer scope."""

    def __init__(self):
        self._store = nn._LAYER_SCOPE

    def var(self, name):
        return self._store.get(name)

    def find_var(self, name):
        return self._store.get(name)


_GLOBAL_SCOPE = Scope()


def global_scope():
    return _GLOBAL_SCOPE


@_ctx.contextmanager
def scope_guard(scope):
    """One live scope: the guard yields it (programs run at once, so no
    state is deferred)."""
    yield scope


@_ctx.contextmanager
def program_guard(main_program, startup_program=None):
    """Ops written inside run eagerly; programs are captured by
    to_static, so the guard collects nothing."""
    yield


@_ctx.contextmanager
def name_scope(prefix=None):
    """A naming block for the ops inside: names carry no meaning in an
    exported program, so it only yields."""
    yield prefix or "name_scope"


@_ctx.contextmanager
def ipu_shard_guard(index=-1, stage=-1):
    """IPU pipeline-shard annotation: no IPU backend."""
    yield


class IpuStrategy:
    """An IPU config carrier, accepted and recorded (no IPU backend)."""

    def __init__(self):
        self._opts = {}

    def set_graph_config(self, **kw):
        self._opts.update(kw)

    def set_pipelining_config(self, **kw):
        self._opts.update(kw)

    def set_precision_config(self, **kw):
        self._opts.update(kw)


class IpuCompiledProgram:
    def __init__(self, program=None, scope=None, ipu_strategy=None):
        self._program = program

    def compile(self, feed_list=None, fetch_list=None):
        return self._program


class BuildStrategy:
    """Graph-build knobs, carried: the export and torch's kernels own the
    fusion and memory choices they toggled."""

    def __init__(self):
        self.enable_inplace = True
        self.fuse_elewise_add_act_ops = True
        self.memory_optimize = True
        self.reduce_strategy = None


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 10


class CompiledProgram:
    """Wraps a Program or callable; with_data_parallel returns it (data
    parallelism is `parallel.DataParallel` / `SPMDTrainStep`)."""

    def __init__(self, program, build_strategy=None):
        self._program = program
        self._build_strategy = build_strategy or BuildStrategy()

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        return self

    def __call__(self, *args, **kw):
        return self._program(*args, **kw)


class ParallelExecutor(CompiledProgram):
    """Superseded by CompiledProgram, as in the reference."""

    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 build_strategy=None, exec_strategy=None, scope=None,
                 share_vars_from=None):
        super().__init__(main_program, build_strategy)


def _leaves_of(loss):
    """The leaf tensors that need gradients behind `loss`'s graph."""
    leaves, seen, stack = [], set(), [loss.grad_fn]
    visited = set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in visited:
            continue
        visited.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None and id(var) not in seen:
            seen.add(id(var))
            leaves.append(var)
        stack.extend(f for f, _ in fn.next_functions)
    return leaves


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """`loss.backward()`; returns (param, grad) pairs, for every trainable
    leaf behind the loss when parameter_list is omitted (the reference's
    default)."""
    params = parameter_list
    if params is None:
        params = _leaves_of(to_torch(loss))
    loss.backward()
    return [(p, p.grad) for p in params if not isinstance(p, str)]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """fluid gradients -> autograd.grad."""
    from ..core.autograd import grad
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    return grad(targets, inputs, grad_outputs=target_gradients,
                allow_unused=True)


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """Debug print: prints the value on the host and passes it through."""
    head = message or "Print"
    arr = _np(input) if isinstance(input, torch.Tensor) else \
        np.asarray(input)
    print(f"[{head}] shape={getattr(arr, 'shape', '?')} "
          f"dtype={getattr(arr, 'dtype', '?')}\n{arr if summarize else ''}")
    return input


class WeightNormParamAttr:
    """Carries the dim; consumers apply nn.utils.weight_norm."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        self.dim = dim
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.trainable = trainable
        self.need_clip = need_clip


class ExponentialMovingAverage:
    """EMA of trainable parameters: update() folds the current weights in
    (decay min(decay, (1 + t) / (10 + t)), the reference's threshold);
    apply() / restore() swap the shadow weights in and out, in place. The
    shadows are float32 tensors on the parameters' devices."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._step = 0
        self._shadow = {}
        self._backup = {}
        self._params = []

    def _tracked(self, params=None):
        if params is not None:
            self._params = list(params)
        if not self._params:
            raise ValueError("EMA.update: pass params on first call")
        return self._params

    @staticmethod
    def _key(p):
        return getattr(p, "name", None) or str(id(p))

    def update(self, params=None):
        self._step += 1
        d = min(self._decay, (1 + self._step) / (10 + self._step))
        with torch.no_grad():
            for p in self._tracked(params):
                cur = to_torch(p).detach().float()
                prev = self._shadow.get(self._key(p))
                self._shadow[self._key(p)] = cur.clone() if prev is None \
                    else d * prev + (1 - d) * cur

    def apply(self, executor=None, need_restore=True):
        with torch.no_grad():
            for p in self._tracked():
                k = self._key(p)
                if k in self._shadow:
                    self._backup[k] = to_torch(p).detach().clone()
                    to_torch(p).copy_(self._shadow[k].to(p.dtype))
        return _ctx.nullcontext()

    def restore(self, executor=None):
        with torch.no_grad():
            for p in self._tracked():
                k = self._key(p)
                if k in self._backup:
                    to_torch(p).copy_(self._backup.pop(k))


# ---- program / persistables serialisation (static/io.py role) ----

def serialize_program(feed_vars, fetch_vars, **kwargs):
    prog = default_main_program()
    return pickle.dumps({"name": prog.name if prog else "main",
                         "feeds": [getattr(v, "name", None) for v in feed_vars],
                         "fetches": [getattr(v, "name", None)
                                     for v in fetch_vars]})


def serialize_persistables(feed_vars, fetch_vars, executor=None, **kwargs):
    """The legacy scope's state, pickled: {key: {name: array}} for a
    Layer, {key: array} for a bare parameter."""
    state = {}
    for key, layer in nn._LAYER_SCOPE.items():
        if isinstance(layer, torch.nn.Module):
            state[key] = {k: _np(v) for k, v in layer.state_dict().items()}
        elif isinstance(layer, torch.Tensor):
            state[key] = _np(layer)
    return pickle.dumps(state)


def save_to_file(path, content):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()


def deserialize_program(data):
    return pickle.loads(data)


def _copy_into(t, v):
    with torch.no_grad():
        to_torch(t).copy_(torch.as_tensor(np.asarray(v)).to(t.dtype))


def deserialize_persistables(program, data, executor=None):
    """Copy pickled state into the scope's Layers and parameters, in
    place; keys the scope lacks are skipped."""
    state = pickle.loads(data)
    for key, val in state.items():
        layer = nn._LAYER_SCOPE.get(key)
        if layer is None:
            continue
        if isinstance(val, dict) and isinstance(layer, torch.nn.Module):
            sd = layer.state_dict(keep_vars=True)
            for k, v in val.items():
                if k in sd:
                    _copy_into(sd[k], v)
        elif isinstance(layer, torch.Tensor):
            _copy_into(layer, val)
    return state


def save(program, model_path, protocol=4, **configs):
    """static.save: the legacy scope's persistables to
    `{model_path}.pdparams`."""
    save_to_file(model_path + ".pdparams", serialize_persistables([], []))


def load(program, model_path, executor=None, var_list=None):
    deserialize_persistables(program,
                             load_from_file(model_path + ".pdparams"))


def normalize_program(program, feed_vars, fetch_vars, **kwargs):
    """Inference normalisation; as in the reference the program comes
    back as it is (its `prune(feed, fetch)` call does not fit
    `Program.prune(fetch_ids)`)."""
    if hasattr(program, "prune"):
        try:
            return program.prune(feed_vars, fetch_vars)
        except Exception:
            return program
    return program


def load_program_state(model_path, var_list=None):
    return pickle.loads(load_from_file(model_path + ".pdparams"))


def set_program_state(program, state_dict):
    deserialize_persistables(program, pickle.dumps(state_dict))


class _DevicePlace(Place):
    """A place of a device kind the port does not run on (xpu, npu, mlu):
    named, never resolved to a torch device."""

    def __init__(self, kind, device_id=0):
        super().__init__(device_id)
        self.device_type = kind

    def torch_device(self):
        from ..core.enforce import UnavailableError
        raise UnavailableError(f"no {self.device_type} backend in the port")


def cpu_places(device_count=None):
    import os
    n = device_count or int(os.environ.get("CPU_NUM", 1))
    return [CPUPlace(i) for i in range(n)]


def cuda_places(device_ids=None):
    ids = device_ids if device_ids is not None else [0]
    return [CUDAPlace(i) for i in ids]


def xpu_places(device_ids=None):
    return [_DevicePlace("xpu", i) for i in (device_ids or [0])]


def npu_places(device_ids=None):
    return [_DevicePlace("npu", i) for i in (device_ids or [0])]


def mlu_places(device_ids=None):
    return [_DevicePlace("mlu", i) for i in (device_ids or [0])]


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A named global variable filled with `value`: a Parameter that needs
    no gradient (torch's tensor keeps `name` read-only; the Parameter
    carries paddle's `name` and `persistable`)."""
    from ..core.dtype import convert_dtype
    t = Parameter(torch.full(tuple(shape), value, dtype=convert_dtype(dtype),
                             device=torch.device("cpu") if force_cpu
                             else resolve_device()),
                  requires_grad=False, name=name)
    t.persistable = persistable
    return t


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """A Parameter in the legacy scope (`param:{name}`): from
    `default_initializer(shape, dtype)` if given, else uniform(+-1/sqrt(
    fan_in)) from RandomState(0), as the reference's."""
    from ..core.dtype import convert_dtype
    dt = convert_dtype(dtype)
    if default_initializer is not None:
        v = to_torch(default_initializer(tuple(shape), dt))
    else:
        k = 1.0 / max(np.sqrt(np.prod(shape[:-1]) or 1), 1)
        v = torch.from_numpy(np.random.RandomState(0).uniform(
            -k, k, tuple(shape)).astype(np.float32)).to(dt)
    p = Parameter(v.to(resolve_device()), name=name)
    nn._LAYER_SCOPE[f"param:{name or id(p)}"] = p
    return p


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy of a batch, a float32 scalar (the port's copy of the
    reference's `metric.accuracy`, :156-163)."""
    pred = _np(input)
    lab = _np(label).reshape(-1)
    order = np.argsort(-pred, axis=-1)[:, :k]
    ok = (order == lab[:, None]).any(-1).mean()
    dev = to_torch(input).device
    return torch.tensor(np.float32(ok), device=dev).as_subclass(Tensor)


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1):
    """Batch AUC: (auc, batch_auc, states), the exact batch AUC twice and
    no states, as the reference's."""
    p = _np(input)
    y = _np(label).reshape(-1)
    score = p[:, 1] if p.ndim == 2 and p.shape[1] == 2 else p.reshape(-1)
    order = np.argsort(-score)
    y_sorted = y[order]
    pos = y_sorted.sum()
    neg = len(y_sorted) - pos
    if pos == 0 or neg == 0:
        val = 0.0
    else:
        ranks = np.empty(len(score))
        ranks[np.argsort(score)] = np.arange(1, len(score) + 1)
        val = float((ranks[y == 1].sum() - pos * (pos + 1) / 2) / (pos * neg))
    a = torch.tensor(val, dtype=torch.float32,
                     device=to_torch(input).device).as_subclass(Tensor)
    return a, a, []


def device_guard(device=None):
    return _ctx.nullcontext()


__all__ = [
    "append_backward", "gradients", "Executor", "global_scope",
    "scope_guard", "BuildStrategy", "CompiledProgram", "ipu_shard_guard",
    "IpuCompiledProgram", "IpuStrategy", "Print", "py_func",
    "ExecutionStrategy", "name_scope", "ParallelExecutor", "program_guard",
    "WeightNormParamAttr", "ExponentialMovingAverage",
    "default_main_program", "default_startup_program", "Program", "data",
    "InputSpec", "save", "load", "save_inference_model",
    "load_inference_model", "serialize_program", "serialize_persistables",
    "save_to_file", "deserialize_program", "deserialize_persistables",
    "load_from_file", "normalize_program", "load_program_state",
    "set_program_state", "cpu_places", "cuda_places", "xpu_places",
    "npu_places", "mlu_places", "Variable", "create_global_var",
    "accuracy", "auc", "device_guard", "create_parameter"]
