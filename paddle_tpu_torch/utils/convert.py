"""Weight transfer from the JAX package.

The port keeps the JAX package's parameter names and layouts
(`Linear.weight` is [in, out]), so a JAX layer's weights load with no
renaming:

    state = {k: np.asarray(v._value) for k, v in jax_layer.state_dict().items()}
    load_numpy_state(torch_layer, state)

The JAX package's `parallel.moe.MoELayer` is a plain object with five
arrays, not a Layer: `load_moe_state(torch_moe, jax_moe)` copies them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def load_numpy_state(layer, state: Dict[str, np.ndarray],
                     strict: bool = True) -> None:
    """Copy `{name: ndarray}` into a port Layer's parameters.

    Every name and shape is checked before anything is copied; each array
    is cast to the parameter's dtype and moved to its device. With strict,
    a missing or unexpected key raises KeyError; a shape mismatch always
    raises ValueError."""
    own = layer.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if strict and (missing or unexpected):
        raise KeyError(f"load_numpy_state: missing keys {missing}, "
                       f"unexpected keys {unexpected}")
    layer.set_state_dict({k: v for k, v in state.items() if k in own})


MOE_KEYS = ("wg", "w1", "b1", "w2", "b2")


def load_moe_state(layer, src) -> None:
    """Copy a MoE layer's gate and stacked expert weights into a port
    `parallel.MoELayer`: `src` is a {name: array} map or an object with
    the five attributes (the JAX `MoELayer`). Whole expert stacks load as
    the rank's own experts under expert parallelism."""
    get = src.__getitem__ if isinstance(src, dict) else \
        (lambda k: getattr(src, k))
    load_numpy_state(layer, {k: np.asarray(get(k)) for k in MOE_KEYS})


__all__ = ["load_numpy_state", "load_moe_state"]
