"""Functionalisation of Layers: run a Layer's forward with its parameters
and buffers bound to given tensors.

Counterpart of `paddle_tpu/jit/functional.py` (:18-85), on
`torch.func.functional_call`. Where JAX traces the forward with tracer
parameters, the port calls the forward eagerly with the given tensors in
place of the registered ones; autograd then differentiates with respect
to whatever tensors were bound.
"""
from __future__ import annotations

import collections
from typing import Dict, Tuple

import torch

from ..amp.state import auto_cast
from ..core.dtype import convert_dtype


def split_state(layer) -> Tuple[Dict[str, torch.Tensor],
                                Dict[str, torch.Tensor]]:
    """(trainable params, buffers + frozen params) by state_dict name."""
    trainable = collections.OrderedDict()
    frozen = collections.OrderedDict()
    for name, t in layer.state_dict(keep_vars=True).items():
        if isinstance(t, torch.nn.Parameter) and t.requires_grad:
            trainable[name] = t
        else:
            frozen[name] = t
    return trainable, frozen


def functional_call(layer, param_names, param_arrays, buffer_names,
                    buffer_arrays, *args, **kwargs):
    """Run layer(*args, **kwargs) with the named state bound to the given
    tensors."""
    state = dict(zip(param_names, param_arrays))
    state.update(zip(buffer_names, buffer_arrays))
    return torch.func.functional_call(layer, state, tuple(args), kwargs)


def amp_functional_call(model, pnames, ps, bnames, buffers, inputs,
                        amp_dtype):
    """functional_call under O1 autocast when amp_dtype is set.

    Casts the floating params to amp_dtype AND enables the autocast state,
    so white-list ops cast fp32 activations down too. The casts are
    `.to(amp_dtype)` inside the differentiated region: gradients reach
    the fp32 masters in `ps`, as `jax.value_and_grad` over them does."""
    if amp_dtype is None:
        return functional_call(model, pnames, ps, bnames, buffers, *inputs)
    dt = convert_dtype(amp_dtype)
    ps = [p.to(dt) if p.is_floating_point() else p for p in ps]
    with auto_cast(enable=True, dtype=dt):
        return functional_call(model, pnames, ps, bnames, buffers, *inputs)


__all__ = ["split_state", "functional_call", "amp_functional_call"]
