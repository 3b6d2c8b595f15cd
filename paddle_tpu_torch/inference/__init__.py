"""paddle.inference counterpart: Predictor over a live Layer.

Counterpart of `paddle_tpu/inference/__init__.py` (Predictor :125, the
live-layer branch :161-168, `run`/`run_batch`/`serving_buckets`
:184-284). The predictor runs its layer under `torch.inference_mode()` on
the layer's device, `cuda` unless the caller asks for the CPU; bf16
outputs come back as float32, as in the JAX package.

The JAX package's saved artifact (`.pdmodel`) is StableHLO, which the
port cannot load: `Config`/`create_predictor` raise until a later slice
adds an artifact of its own.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import dtype_name
from ..core.enforce import UnimplementedError
from ..core.place import resolve_device
from ..core.tensor import api

_NOT_PORTED = ("artifact loading is not ported yet: the .pdmodel artifact "
               "is StableHLO, which paddle_tpu_torch cannot load\n"
               "  [Hint] build the Layer and serve it with "
               "Predictor(layer, input_spec=[...])")


class Config:
    """AnalysisConfig counterpart; artifact loading is not ported yet."""

    def __init__(self, model_path=None, params_path=None):
        raise UnimplementedError(_NOT_PORTED)


def create_predictor(config):
    raise UnimplementedError(_NOT_PORTED)


def _float32(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.dtype == torch.bfloat16 else t


class PredictorTensor:
    """ZeroCopyTensor counterpart — a named input/output slot."""

    def __init__(self, predictor, name, is_input):
        self._pred = predictor
        self.name = name
        self._is_input = is_input

    def copy_from_cpu(self, arr):
        self._pred._feeds[self.name] = torch.as_tensor(np.asarray(arr))

    def reshape(self, shape):
        pass

    def copy_to_cpu(self):
        return _float32(self._pred._results[self.name]).cpu().numpy()

    def share_external_data(self, tensor):
        self._pred._feeds[self.name] = tensor


class Predictor:
    def __init__(self, layer, input_spec=None, device=None):
        if not isinstance(layer, torch.nn.Module):
            raise UnimplementedError(_NOT_PORTED)
        self._device = resolve_device(device)
        self._layer = layer.to(self._device)
        self._layer.eval()
        self._input_spec = input_spec
        self._input_names = [f"input_{i}"
                             for i in range(len(input_spec or [1]))]
        self._output_names = ["output_0"]
        self._feeds = {}
        self._results = {}

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

    def _forward(self, arrays):
        with torch.inference_mode():
            ins = [torch.as_tensor(a).to(self._device) for a in arrays]
            out = self._layer(*ins)
        return list(out) if isinstance(out, (list, tuple)) else [out]

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
        specs: [(item_shapes, dtypes, batch_sizes)]. A live layer takes any
        batch, so it gets the engine's batch ladder. Dynamic (-1) dims
        defer to bucket learning."""
        if not self._input_spec:
            return []
        shapes = [tuple(int(d) for d in s.shape) for s in self._input_spec]
        if any(len(s) < 1 or any(d < 0 for d in s) for s in shapes):
            return []
        names = [dtype_name(s.dtype) for s in self._input_spec]
        dtypes = ["float32" if "float" in n else n for n in names]
        batches = {s[0] for s in shapes}
        if len(batches) != 1:
            return []
        batch = batches.pop()
        sizes = sorted(set(ladder or [batch]) | {batch})
        return [([s[1:] for s in shapes], dtypes, sizes)]

    def run_batch(self, arrays):
        """Batched entry for the serving engine: numpy arrays (leading dim
        = batch) in, host numpy arrays out, bf16 read back as float32.
        Touches no handle state, so engine workers need no lock for it."""
        if len(arrays) != len(self._input_names):
            raise ValueError(f"model expects {len(self._input_names)} "
                             f"inputs, got {len(arrays)}")
        return [_float32(o).cpu().numpy() for o in self._forward(arrays)]


__all__ = ["Config", "Predictor", "create_predictor", "PredictorTensor"]
