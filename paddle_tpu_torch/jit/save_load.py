"""jit.save / jit.load: a Layer's inference program and weights on disk.

Counterpart of `paddle_tpu/jit/save_load.py` (save :25-159, TranslatedLayer
:162-193, load :196-225). The reference exports `pure(params, buffers,
*inputs)` with `jax.export` as StableHLO; the port exports the same calling
convention with `torch.export.export`: a module whose forward takes the
parameter and buffer tensors as arguments and runs the Layer through
`jit.functional.functional_call` in eval mode. Loading needs no Python
model code.

  - `{path}.pdmodel`: the exported graph, no weights (`torch.export.save`,
    with the example inputs dropped);
  - `{path}.pdiparams.npz`: the weights in the reference's npz layout,
    `p::{name}` and `b::{name}`, bf16 as raw 2-byte void;
  - `{path}.pdmodel.json`: the reference's meta keys (input specs, names,
    dtypes, `quantized`, `precision`, the version stamps).

So for the same weights both packages write the same `.pdiparams.npz` and
the same meta apart from the version fields. Shapes are static: a `-1` in
an input spec exports as 1, as in the reference.

The program is exported on the device of the Layer's parameters, and the
port's dispatch rules are read then: `scaled_dot_product_attention` takes
the flash kernel only for CUDA inputs, so an artifact exported on the CPU
holds the einsum path wherever it is loaded. `load` moves a program to the
device it is asked for (`torch.export.passes.move_to_device_pass`); export
on the device that serves, as the reference's artifact is specific to its
backend too.
"""
from __future__ import annotations

import io
import json
import os
import warnings
import zipfile

import numpy as np
import torch

from ..core.dtype import convert_dtype, dtype_name
from ..core.enforce import UnimplementedError
from ..core.place import resolve_device
from ..core.tensor import api
from ..framework.version import (FRAMEWORK_VERSION,
                                 GLOBAL_OP_VERSION_REGISTRY, is_compatible)
from .functional import functional_call, split_state
from .input_spec import InputSpec

_BF16_PRECISIONS = ("bfloat16", "float16", "half", "bf16", "fp16")
_INT8_PRECISIONS = ("int8", "int8_weight_only")
_PRECISIONS = (None, "float32") + _BF16_PRECISIONS + _INT8_PRECISIONS


class _Program(torch.nn.Module):
    """forward(*params, *buffers, *inputs) -> the Layer's output: the
    reference's `pure`. The Layer is held outside the module tree, so the
    exported program lifts none of its state: every weight is an argument.
    With int8 weights the dequantization `q.to(bf16) * scale.to(bf16)` is
    part of the program, as in the reference (:101-113). With no Layer
    (`jit.to_static` of a plain function), forward(*inputs) is `fn`'s
    call. `kwargs` are constants of the program."""

    def __init__(self, model, pnames, bnames, qmask=(), n_model_buffers=None,
                 fn=None, kwargs=None):
        super().__init__()
        self.__dict__["_model"] = model
        self.__dict__["_fn"] = fn
        n_mb = len(bnames) if n_model_buffers is None else n_model_buffers
        self._pnames, self._bnames = pnames, bnames[:n_mb]
        self._qmask, self._nb = qmask, len(bnames)
        self._n_model_buffers = n_mb
        self._kwargs = dict(kwargs or {})

    def forward(self, *flat):
        if self._model is None:
            return self._fn(*flat, **self._kwargs)
        n_p = len(self._pnames)
        params = list(flat[:n_p])
        buffers = flat[n_p:n_p + self._nb]
        inputs = flat[n_p + self._nb:]
        scales = iter(buffers[self._n_model_buffers:])
        for i, quantized in enumerate(self._qmask):
            if quantized:
                params[i] = params[i].to(torch.bfloat16) * \
                    next(scales).to(torch.bfloat16)
        return functional_call(self._model, self._pnames, params,
                               self._bnames,
                               buffers[:self._n_model_buffers], *inputs,
                               **self._kwargs)


def export_program(program: _Program, args) -> "torch.export.ExportedProgram":
    """`torch.export` of a `_Program` at example `args` (plain tensors):
    the one export under `jit.save` and `jit.to_static`. Batch norm in
    training mode leaves its running statistics as they are, as the
    reference's traced forward does."""
    from ..core import compile_cache
    from ..nn.functional.norm import frozen_running_stats
    compile_cache.note_export()
    with frozen_running_stats():
        return torch.export.export(program, tuple(args))


def program_bytes(exported) -> bytes:
    """The exported program as bytes (`torch.export.save`), without its
    example inputs: the weights are the program's arguments and stay out.
    The one serializer under `jit.save`'s `.pdmodel` and the compile
    cache's entries."""
    buf = io.BytesIO()
    examples, exported._example_inputs = exported._example_inputs, None
    try:
        torch.export.save(exported, buf)
    finally:
        exported._example_inputs = examples
    return buf.getvalue()


def program_from_bytes(blob: bytes) -> "torch.export.ExportedProgram":
    """`program_bytes`' inverse (`torch.export.load`)."""
    # registers paddle_tpu_torch::flash_fwd / flash_bwd, which an exported
    # attention program calls
    from ..kernels import flash_attention  # noqa: F401
    return torch.export.load(io.BytesIO(blob))


def _plain(t: torch.Tensor) -> torch.Tensor:
    return t.detach().as_subclass(torch.Tensor)


def _npz_array(t: torch.Tensor) -> np.ndarray:
    """A host array of t; bf16 (which numpy lacks) as raw 2-byte void,
    the bytes the reference's npz holds."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def save(layer, path, input_spec=None, **configs):
    """Export `layer`'s forward at `input_spec` with its weights. `layer`
    is a Layer, a `to_static`'d Layer or a `StaticFunction` of a Layer's
    forward: a to_static capture is exported through its dy2static-
    rewritten forward, so its tensor control flow becomes `cond` /
    `while_loop` nodes (reference :25-37). configs:
    `precision` None / "float32", "bfloat16" (also "float16", "half",
    "bf16", "fp16", which export bf16 as in the reference) or "int8"
    ("int8_weight_only"): every floating parameter of 2 or more dims
    becomes an int8 argument with a per-channel f32 `__scale__{name}`
    buffer, quantized from the fp32 values."""
    from .to_static import StaticFunction
    if isinstance(layer, StaticFunction):
        if layer.layer is None:
            raise TypeError(
                "jit.save of a to_static function needs its Layer: the "
                "artifact's weights are a Layer's parameters\n  [Hint] "
                "to_static(layer) or to_static(layer.forward)")
        layer, forward = layer.layer, layer._function
    elif isinstance(layer, torch.nn.Module):
        sf = layer.__dict__.get("forward")
        forward = sf._function if isinstance(sf, StaticFunction) else None
    else:
        raise TypeError("jit.save expects a Layer or @to_static function")
    if input_spec is None:
        raise ValueError("jit.save requires input_spec (shapes must be "
                         "static for the exported program)")
    precision = configs.pop("precision", None)
    if precision not in _PRECISIONS:
        raise ValueError(f"unsupported save precision {precision!r}; "
                         "use 'float32', 'bfloat16' or 'int8' (weight-only)")
    specs = [s if isinstance(s, InputSpec) else InputSpec.from_tensor(s)
             for s in input_spec]
    from .to_static import forward_as
    was_training = layer.training
    layer.eval()
    try:
        with forward_as(layer, forward):
            return _save(layer, path, specs, precision)
    finally:
        if was_training:
            layer.train()


def _save(model, path, specs, precision):
    trainable, frozen = split_state(model)
    pnames, bnames = list(trainable), list(frozen)
    parrs = [_plain(trainable[n]) for n in pnames]
    barrs = [_plain(frozen[n]) for n in bnames]
    device = parrs[0].device if parrs else resolve_device()
    orig_parrs = list(parrs)        # int8 quantizes the fp32 values
    if precision in _BF16_PRECISIONS + _INT8_PRECISIONS:
        parrs = [a.to(torch.bfloat16) if a.is_floating_point() else a
                 for a in parrs]
        barrs = [a.to(torch.bfloat16) if a.is_floating_point() else a
                 for a in barrs]
        specs = [InputSpec(s.shape, "bfloat16" if s.dtype.is_floating_point
                           else s.dtype, s.name) for s in specs]
    qmask = [False] * len(parrs)
    quantized = []
    n_model_buffers = len(barrs)
    if precision in _INT8_PRECISIONS:
        from ..quantization import channel_quant
        scales = []
        for i, (n, a, orig) in enumerate(zip(pnames, parrs, orig_parrs)):
            if a.dim() >= 2 and a.is_floating_point():
                q, scale = channel_quant(orig)
                parrs[i] = q
                scales.append(scale)
                qmask[i] = True
                quantized.append(n)
        barrs = barrs + scales
        bnames = bnames + [f"__scale__{n}" for n in quantized]

    program = _Program(model, pnames, bnames, qmask, n_model_buffers)
    example = [torch.zeros([1 if d == -1 else d for d in s.shape],
                           dtype=s.dtype, device=device) for s in specs]
    exported = export_program(program, parrs + barrs + example)

    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path + ".pdmodel", "wb") as f:
        f.write(program_bytes(exported))
    np.savez(path + ".pdiparams",
             **{f"p::{n}": _npz_array(a) for n, a in zip(pnames, parrs)},
             **{f"b::{n}": _npz_array(a) for n, a in zip(bnames, barrs)})
    meta = {"input_specs": [{"shape": list(s.shape),
                             "dtype": dtype_name(s.dtype)} for s in specs],
            "param_names": pnames, "buffer_names": bnames,
            # npz stores bf16 as raw void ('|V2'); the dtypes re-view it
            "param_dtypes": [dtype_name(a.dtype) for a in parrs],
            "buffer_dtypes": [dtype_name(a.dtype) for a in barrs],
            "quantized": quantized,
            "precision": ("int8" if precision in _INT8_PRECISIONS
                          else (precision or "float32")),
            "framework_version": FRAMEWORK_VERSION,
            "op_versions": GLOBAL_OP_VERSION_REGISTRY.snapshot()}
    with open(path + ".pdmodel.json", "w") as f:
        json.dump(meta, f)
    return path


def _program_device(exported) -> torch.device:
    """The device the program was exported on: that of its first input."""
    for node in exported.graph.nodes:
        if node.op == "placeholder" and "val" in node.meta:
            return node.meta["val"].device
    return torch.device("cpu")


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class _Replay:
    """The program captured in a CUDA graph for one input signature: its
    static inputs, the outputs a replay writes, the growth of
    `torch.cuda.memory_reserved()` across the capture (the graph's private
    pool) and the bytes of the parameters it reads."""

    def __init__(self, graph, inputs, outputs, reserved, param_bytes):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.reserved, self.param_bytes = reserved, param_bytes

    def memory_analysis(self):
        """The reference's `memory_analysis()` keys for this capture
        (`obs.executable_memory` normalizes them): arguments = parameters
        + static inputs, outputs = static outputs, temps = the rest of the
        pool the capture reserved."""
        out = _nbytes(self.outputs)
        return {"argument_size_in_bytes":
                self.param_bytes + _nbytes(self.inputs),
                "output_size_in_bytes": out,
                "temp_size_in_bytes": max(0, self.reserved - out),
                "alias_size_in_bytes": 0,
                "generated_code_size_in_bytes": 0}


def capture(run, arrs, device, param_bytes, what):
    """(outputs, `_Replay`) of `run(inputs) -> [tensors]`: run eagerly on
    a side stream (cuDNN, cuBLAS and the kernels initialise lazily there),
    then captured in a CUDA graph over static copies of the inputs. The
    graph reads every other tensor `run` closes over (the weights) in
    place. The one capture under `TranslatedLayer` and `jit.to_static`.
    The capture checks only its own thread's CUDA calls
    (`capture_error_mode="thread_local"`): replicas of one process keep
    serving on their engines' threads while a new one captures."""
    static = [a.clone() for a in arrs]
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        outs = run(static)
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    reserved = torch.cuda.memory_reserved(device)
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            captured = run(static)
    except Exception as e:
        raise RuntimeError(f"{what} in a CUDA graph failed") from e
    reserved = torch.cuda.memory_reserved(device) - reserved
    return outs, _Replay(graph, static, captured, reserved, param_bytes)


class TranslatedLayer:
    """A loaded inference program: callable like a Layer (forward only),
    on the device it was loaded to. `Tensor` arguments give `Tensor`
    results.

    On a CUDA device each input signature (shapes and dtypes) is captured
    once in a CUDA graph: the first call of a signature runs the program
    eagerly (on a side stream) and captures it, and every later call
    copies its inputs into the graph's static buffers and replays it, the
    counterpart of the reference's one XLA dispatch per call
    (`jax.jit` of `Exported.call`, :176-178). Eager, the interpreted
    program costs ~1000 host op calls a run (ResNet-50), more than the
    card's work at batch 128. A replay returns copies of the graph's
    outputs, never the buffers the next replay overwrites. The kernels'
    `.launches` counters count host calls: a capture counts once and a
    replay not at all."""

    def __init__(self, exported, params, buffers, meta, device):
        self._exported = exported
        self._module = exported.module()
        self._params = params
        self._buffers = buffers
        self._meta = meta
        self._device = device
        self._graphs = {}
        self.training = False

    @property
    def device(self) -> torch.device:
        return self._device

    def _run(self, arrs):
        out = self._module(*self._params, *self._buffers, *arrs)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    @api
    def __call__(self, *args):
        arrs = [torch.as_tensor(a, device=self._device) for a in args]
        with torch.inference_mode():
            if self._device.type != "cuda":
                outs = self._run(arrs)
            else:
                outs = self._replay(arrs)
        return outs if len(outs) != 1 else outs[0]

    forward = __call__

    def _replay(self, arrs):
        key = tuple((tuple(a.shape), a.dtype) for a in arrs)
        rep = self._graphs.get(key)
        if rep is None:
            outs, self._graphs[key] = self._capture(arrs)
            return outs
        for s, a in zip(rep.inputs, arrs):
            s.copy_(a)
        rep.graph.replay()
        return [o.clone() for o in rep.outputs]

    def _capture(self, arrs):
        return capture(self._run, arrs, self._device,
                       _nbytes(list(self._params) + list(self._buffers)),
                       "TranslatedLayer: capturing the loaded program")

    def captures(self):
        """The CUDA-graph captures so far, one per input signature
        (`obs.executable_memory` of each gives its memory breakdown)."""
        return list(self._graphs.values())

    def eval(self):
        return self

    def state_dict(self):
        names = self._meta["param_names"] + self._meta["buffer_names"]
        return dict(zip(names, list(self._params) + list(self._buffers)))

    def program(self):
        """The `torch.export.ExportedProgram` this layer runs."""
        return self._exported


def _blob(data, key, name, device) -> torch.Tensor:
    a = data[key]
    if name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device=device,
                                  dtype=convert_dtype(name) if name
                                  else None)


def load(path, device=None, **configs):
    """Load `{path}.pdmodel` with its weights onto `device` (the current
    place unless given). An artifact the JAX package wrote (StableHLO) is
    refused: the port cannot run it."""
    with open(path + ".pdmodel.json") as f:
        meta = json.load(f)
    if not zipfile.is_zipfile(path + ".pdmodel"):
        raise UnimplementedError(
            f"{path}.pdmodel is not a paddle_tpu_torch artifact (a "
            "torch.export archive); the JAX package's StableHLO artifact "
            "cannot be loaded by the port\n  [Hint] rebuild the Layer in "
            "paddle_tpu_torch, load its weights and save it with "
            "paddle_tpu_torch.jit.save")
    if not is_compatible(meta.get("framework_version")):
        raise RuntimeError(f"artifact written by incompatible version "
                           f"{meta.get('framework_version')}")
    for msg in GLOBAL_OP_VERSION_REGISTRY.incompatibilities(
            meta.get("op_versions", {})):
        warnings.warn(f"op semantics changed since save: {msg}")
    dev = resolve_device(device)
    with open(path + ".pdmodel", "rb") as f:
        exported = program_from_bytes(f.read())
    src = _program_device(exported)
    if src != dev:
        from torch.export.passes import move_to_device_pass
        exported = move_to_device_pass(exported, {str(src): str(dev)})
    with np.load(path + ".pdiparams.npz") as data:
        pdt = meta.get("param_dtypes") or [None] * len(meta["param_names"])
        bdt = meta.get("buffer_dtypes") or [None] * len(meta["buffer_names"])
        params = [_blob(data, f"p::{n}", d, dev)
                  for n, d in zip(meta["param_names"], pdt)]
        buffers = [_blob(data, f"b::{n}", d, dev)
                   for n, d in zip(meta["buffer_names"], bdt)]
    return TranslatedLayer(exported, params, buffers, meta, dev)


__all__ = ["save", "load", "TranslatedLayer", "export_program", "capture",
           "program_bytes", "program_from_bytes"]
