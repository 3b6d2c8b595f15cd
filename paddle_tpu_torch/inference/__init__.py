"""paddle.inference counterpart: Config, create_predictor and Predictor.

Counterpart of `paddle_tpu/inference/__init__.py` (Config :19-89,
PredictorTensor :92-122, Predictor :125-284). A Predictor runs either a
saved artifact (`jit.save` -> `Config(path)` -> `create_predictor`: the
exported program of `jit/save_load.py`, no Python model code, under
`torch.inference_mode()`) or a live Layer (`Predictor(layer,
input_spec=[...])`) through `jit.to_static(layer.forward)` under
`torch.no_grad()`, as the reference's (:197-203, :270-275): each served
signature is exported once and, on the card, replayed as one CUDA graph. It runs on the card unless the Config or the
caller asks for the CPU (`Config.disable_gpu()`, `device="cpu"`, or
`set_device("cpu")` before a Config that names no device).

The artifact's exported signature decides the feed dtype: a bf16 artifact
takes bf16 feeds, cast once where they are fed (`copy_from_cpu`) and moved
to the device there; bf16 outputs read back as float32 on the host.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.dtype import dtype_name
from ..core.enforce import InvalidArgumentError, NotFoundError
from ..core.place import resolve_device
from ..core.tensor import api


class Config:
    """AnalysisConfig counterpart. Device and precision knobs are honoured;
    the others are recorded and shown by `summary()`, marked n/a where the
    card has no such thing."""

    def __init__(self, model_path=None, params_path=None):
        self.model_path = model_path
        self.params_path = params_path
        self._device = None          # the current place (set_device)
        self._device_id = 0
        self._precision = "float32"
        self._memory_optim = True
        self._quant = False
        self._options = {}

    # paddle API spellings
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device, self._device_id = "gpu", int(device_id)
        self._options["memory_pool_init_size_mb"] = (
            f"n/a ({int(memory_pool_init_size_mb)} requested; torch's "
            "caching allocator grows on demand)")

    def enable_tpu(self):
        # the reference's spelling for its accelerator: here the card
        self._device = "gpu"

    def disable_gpu(self):
        self._device = "cpu"

    def device(self) -> str:
        """The device the predictor runs on: the card when asked for, the
        CPU after `disable_gpu()`, else the current place."""
        if self._device is None:
            from ..core.place import get_device
            return get_device().replace("gpu", "cuda")
        return f"cuda:{self._device_id}" if self._device == "gpu" else "cpu"

    def set_cpu_math_library_num_threads(self, n):
        self._options["cpu_math_threads"] = (
            f"{int(n)} (recorded; torch's intra-op pool is process-wide)")

    def enable_memory_optim(self, flag=True):
        self._memory_optim = flag

    def enable_mkldnn(self):
        self._options["mkldnn"] = "n/a on the card (cuDNN runs the convs)"

    def enable_tensorrt_engine(self, workspace_size=1 << 30,
                               max_batch_size=1, min_subgraph_size=3,
                               precision_mode="float32", use_static=False,
                               use_calib_mode=False):
        # no TensorRT: the exported program runs as a whole; the precision
        # hint is honoured as in the reference
        self._precision = precision_mode if isinstance(precision_mode, str) \
            else "float16"
        self._options["trt"] = ("n/a: the exported program runs on torch's "
                                f"CUDA kernels (precision={self._precision})")
        if self._precision == "int8":
            self.enable_quant()

    def enable_quant(self, bits=8):
        """Serve a weight-only int8 artifact: it must have been exported
        with jit.save(..., precision='int8'); the predictor checks it."""
        if bits != 8:
            raise ValueError("only int8 weight-only quantization is "
                             "supported")
        self._options["quant"] = "int8-weight-only"
        self._quant = True

    def switch_use_feed_fetch_ops(self, flag):
        self._options["feed_fetch_ops"] = bool(flag)

    def switch_ir_optim(self, flag=True):
        self._options["ir_optim"] = (f"{bool(flag)} (n/a: the program runs "
                                     "as exported)")

    def precision(self):
        return self._precision

    def summary(self) -> str:
        """The effective config, with each recorded knob."""
        lines = [f"device: {self.device()}", f"precision: {self._precision}",
                 f"memory_optim: {self._memory_optim}"]
        lines += [f"{k}: {v}" for k, v in sorted(self._options.items())]
        return "\n".join(lines)


def _float32(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.dtype == torch.bfloat16 else t


class PredictorTensor:
    """ZeroCopyTensor counterpart — a named input/output slot."""

    def __init__(self, predictor, name, is_input):
        self._pred = predictor
        self.name = name
        self._is_input = is_input

    def copy_from_cpu(self, arr):
        # cast and move once at feed time, not in every run()
        self._pred._feeds[self.name] = self._pred._feed(np.asarray(arr))

    def reshape(self, shape):
        pass

    def copy_to_cpu(self):
        return _float32(self._pred._results[self.name]).cpu().numpy()

    def device_value(self):
        """The output tensor on the device: no host copy, no dtype change."""
        return self._pred._results[self.name]

    def share_external_data(self, tensor):
        self._pred._feeds[self.name] = self._pred._feed(tensor)


class Predictor:
    def __init__(self, config_or_layer, input_spec=None, device=None):
        self._feeds = {}
        self._results = {}
        self._output_names = ["output_0"]
        if isinstance(config_or_layer, Config):
            cfg = config_or_layer
            from ..jit.save_load import load
            path = cfg.model_path
            if path.endswith(".pdmodel"):
                path = path[:-len(".pdmodel")]
            if not os.path.exists(path + ".pdmodel"):
                raise NotFoundError(
                    f"Cannot open model file {path}.pdmodel\n"
                    "  [Hint] save the model with paddle_tpu_torch.jit.save "
                    "first.")
            self._translated = load(path, device=device or cfg.device())
            meta = self._translated._meta
            is_int8 = meta.get("precision") == "int8" or \
                bool(meta.get("quantized"))
            if cfg._quant and not is_int8:
                raise InvalidArgumentError(
                    "Config.enable_quant() requires an int8 artifact\n"
                    "  [Hint] re-export with jit.save(..., "
                    "precision='int8')")
            self._specs = [(list(s["shape"]), s["dtype"])
                           for s in meta["input_specs"]]
            self._device = self._translated.device
            self._layer = None
        elif isinstance(config_or_layer, torch.nn.Module):
            self._translated = None
            self._device = resolve_device(device)
            self._layer = config_or_layer.to(self._device)
            self._layer.eval()
            self._fn = None
            self._specs = [(list(s.shape), dtype_name(s.dtype))
                           for s in input_spec] if input_spec else None
        else:
            raise TypeError("Predictor expects a Config or a Layer")
        self._input_names = [f"input_{i}"
                             for i in range(len(self._specs or [1]))]
        # the artifact's exported signature decides the feed dtype
        self._bf16 = self._translated is not None and \
            any(d == "bfloat16" for _, d in self._specs)

    @property
    def device(self) -> torch.device:
        return self._device

    # --- paddle.inference API ---
    def get_input_names(self):
        return list(self._input_names)

    def get_output_names(self):
        return list(self._output_names)

    def get_input_handle(self, name):
        return PredictorTensor(self, name, True)

    def get_output_handle(self, name):
        return PredictorTensor(self, name, False)

    def _feed(self, a) -> torch.Tensor:
        """An input on the device, in the artifact's float dtype."""
        t = torch.as_tensor(a).to(self._device)
        if self._bf16 and t.is_floating_point():
            t = t.to(torch.bfloat16)
        return t

    def _forward(self, arrays):
        ins = [self._feed(a) for a in arrays]
        if self._translated is not None:
            out = self._translated(*ins)
        else:
            with torch.no_grad():
                out = self._static()(*ins)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def _static(self):
        """The live layer's `to_static` function (its own, when the Layer
        was to_static'd already)."""
        if self._fn is None:
            from ..jit.to_static import StaticFunction, to_static
            fwd = self._layer.__dict__.get("forward")
            self._fn = fwd if isinstance(fwd, StaticFunction) else \
                to_static(self._layer.forward)
        return self._fn

    @property
    def books_compiles(self) -> bool:
        """Whether the predictor books its own builds (a live layer's
        to_static does; the serving engine then books none)."""
        return self._layer is not None

    @api
    def run(self, inputs=None):
        """With `inputs`: returns the outputs as tensors on the predictor's
        device (bf16 read back as float32). Without: runs the fed input
        handles and fills the output handles."""
        arrs = inputs if inputs is not None else \
            [self._feeds[n] for n in self._input_names]
        outs = self._forward(arrs)
        self._output_names = [f"output_{i}" for i in range(len(outs))]
        self._results = dict(zip(self._output_names, outs))
        if inputs is not None:
            return [_float32(o) for o in outs]
        return None

    zero_copy_run = run

    def serving_buckets(self, ladder=None):
        """Shape-bucket declarations for the serving engine from the input
        specs: [(item_shapes, dtypes, batch_sizes)]. An artifact's
        signature is fixed, so its only batch is the exported one
        (requests pad up to it); a live layer takes any batch, so it gets
        the engine's batch ladder. Dynamic (-1) dims defer to bucket
        learning."""
        if not self._specs:
            return []
        shapes = [tuple(int(d) for d in s) for s, _ in self._specs]
        if any(len(s) < 1 or any(d < 0 for d in s) for s in shapes):
            return []
        # the wire carries f32/i32/i64; run_batch casts floats for bf16
        # artifacts, so float-family specs bucket as float32 on the host
        dtypes = ["float32" if "float" in d else d for _, d in self._specs]
        batches = {s[0] for s in shapes}
        if len(batches) != 1:
            return []
        batch = batches.pop()
        sizes = [batch] if self._translated is not None else \
            sorted(set(ladder or [batch]) | {batch})
        return [([s[1:] for s in shapes], dtypes, sizes)]

    def bucket_buffers(self):
        """The device buffers this predictor keeps per served signature:
        the captured graphs' static inputs and outputs, of a loaded
        artifact or of the live layer's to_static (on the CPU, none). The
        serving engine tags them `serving_bucket` for the memory census."""
        if self._translated is not None:
            reps = self._translated.captures()
        elif self._fn is not None:
            reps = self._fn.captures()
        else:
            return []
        return [t for rep in reps for t in (*rep.inputs, *rep.outputs)]

    def run_batch(self, arrays):
        """Batched entry for the serving engine: numpy arrays (leading dim
        = batch) in, host numpy arrays out, bf16 read back as float32.
        Touches no handle state, so engine workers need no lock for it."""
        if len(arrays) != len(self._input_names):
            raise ValueError(f"model expects {len(self._input_names)} "
                             f"inputs, got {len(arrays)}")
        return [_float32(o).cpu().numpy() for o in self._forward(arrays)]


def create_predictor(config):
    return Predictor(config)


__all__ = ["Config", "Predictor", "create_predictor", "PredictorTensor"]
