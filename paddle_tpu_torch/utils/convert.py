"""Weight transfer from the JAX package.

The port keeps the JAX package's parameter names and layouts
(`Linear.weight` is [in, out]), so a JAX layer's weights load with no
renaming:

    state = {k: np.asarray(v._value) for k, v in jax_layer.state_dict().items()}
    load_numpy_state(torch_layer, state)

The JAX package's `parallel.moe.MoELayer` is a plain object with five
arrays, not a Layer: `load_moe_state(torch_moe, jax_moe)` copies them.
`load_scope_state(port_scope, jax_scope)` copies the legacy `static.nn`
builders' scope (`static.nn._LAYER_SCOPE`: Layers and bare parameters by
key) across.

The parameter server's state needs no conversion: the port's tables,
WAL and snapshots are the reference's formats byte for byte.
`load_ps_table(port_table, src)` installs a reference table's state — a
save file (`SparseTable.save`, `.npz`) or a live table — bit-equal, and a
reference `PsServer`'s `wal_dir` is recovered by the port's as it is
(`PsServer(wal_dir=...)`).
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


def load_scope_state(scope: dict, src: dict, keys=None) -> None:
    """Copy the entries of `src` (a `static.nn` layer scope of either
    package: key -> Layer or parameter) into the port's `scope` under the
    same keys, or under `keys`, a {src_key: scope_key} map. A Layer's
    state goes by name (`load_numpy_state`), a bare parameter in place."""
    import torch
    pairs = keys.items() if keys is not None else \
        ((k, k) for k in src if k in scope)
    for sk, dk in pairs:
        s, d = src[sk], scope[dk]
        if hasattr(s, "state_dict") and hasattr(d, "state_dict"):
            load_numpy_state(d, {k: np.asarray(getattr(v, "_value", v))
                                 for k, v in s.state_dict().items()})
        else:
            with torch.no_grad():
                d.copy_(torch.as_tensor(np.asarray(getattr(s, "_value", s)),
                                        dtype=d.dtype))


def load_ps_table(table, src) -> None:
    """Install a PS table's state into `table` (a port `SparseTable` /
    `DenseTable`): `src` is a save file's path (`.npz`) or any table with
    `snapshot_arrays()` (the reference's included); rows, optimizer
    slots and accessor stats arrive bit-equal."""
    if isinstance(src, str):
        src = np.load(src if src.endswith(".npz") else src + ".npz")
    else:
        src = src.snapshot_arrays()
    table.load_arrays(src)


__all__ = ["load_numpy_state", "load_moe_state", "load_scope_state",
           "load_ps_table"]
