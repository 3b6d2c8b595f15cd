"""int8 weight-only quantization for inference.

Counterpart of `channel_quant` (:183-197) and `quant_weight_only`
(:220-283) of `paddle_tpu/quantization/__init__.py`, for `nn.Linear`:
each 2-D weight becomes an int8 `wo_weight_q` buffer and a per-output-
channel f32 `wo_weight_scale` buffer under the reference's names, so a
state dict moves across, and the fp weight is dropped. The forward
dequantizes `q * scale` and runs the fp product, as the reference does
before XLA fuses the two.

Not ported yet: ColumnParallelLinear / RowParallelLinear (they come with
the mp slice), fake-quant, QAT and PTQ calibration.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..nn.functional import linear
from ..nn.layer.common import Linear

__all__ = ["channel_quant", "quant_weight_only", "WeightOnlyLinear"]


def _qrange(bits: int):
    return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1


def channel_quant(w, bits: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel symmetric int quantization of one weight: (q int8,
    scale f32 broadcastable), on w's device. Channel axis = out-features
    (axis 1 for [in, out] linears, axis 0 otherwise). The arithmetic is
    the reference's, step by step in f32, so q and scale are bit-equal to
    its numpy result."""
    if not isinstance(w, torch.Tensor):
        w = torch.from_numpy(np.asarray(w, dtype=np.float32))
    w = w.detach().to(torch.float32)
    qmin, qmax = _qrange(bits)
    ch_axis = 1 if w.dim() == 2 else 0
    axes = tuple(i for i in range(w.dim()) if i != ch_axis)
    scale = (w.abs().amax(dim=axes, keepdim=True) / qmax).clamp_min(1e-9)
    q = torch.round(w / scale).clamp(qmin, qmax).to(torch.int8)
    return q, scale


class WeightOnlyLinear(Linear):
    """A Linear whose weight lives as int8 `wo_weight_q` [in, out] and f32
    `wo_weight_scale` [1, out] buffers. The forward dequantizes into a
    transient fp weight (under a CUDA-graph capture it comes from the
    graph's pool) and runs the fp product."""

    def forward(self, x):
        scale = self.wo_weight_scale
        return linear(x, self.wo_weight_q.to(scale.dtype) * scale, self.bias)


def quant_weight_only(model, bits: int = 8):
    """TRUE int8 weight-only conversion IN PLACE: every `nn.Linear`'s 2-D
    weight is replaced by int8 `wo_weight_q` + per-channel f32
    `wo_weight_scale` buffers and the fp Parameter is dropped; the layer
    becomes a `WeightOnlyLinear`. Embeddings stay fp (the GPT head is
    weight-tied to one). Inference-only. Returns model; raises ValueError
    when there is no 2-D linear weight."""
    converted = 0
    for layer in model.modules():
        if not isinstance(layer, Linear) or isinstance(layer,
                                                       WeightOnlyLinear):
            continue
        w = layer._parameters.get("weight")
        if w is None or w.dim() != 2:
            continue
        q, scale = channel_quant(w, bits)
        del layer.weight
        layer.register_buffer("wo_weight_q", q)
        layer.register_buffer("wo_weight_scale", scale)
        layer.__class__ = WeightOnlyLinear
        converted += 1
    if converted == 0:
        raise ValueError("quant_weight_only found no 2-D linear weights")
    return model
