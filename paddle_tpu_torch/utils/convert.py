"""Weight transfer from the JAX package.

The port keeps the JAX package's parameter names and layouts
(`Linear.weight` is [in, out]), so a JAX layer's weights load with no
renaming:

    state = {k: np.asarray(v._value) for k, v in jax_layer.state_dict().items()}
    load_numpy_state(torch_layer, state)
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


__all__ = ["load_numpy_state"]
