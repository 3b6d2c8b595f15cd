"""Seeded random state.

Counterpart of `paddle_tpu/core/random.py`. One `torch.Generator` on the
CPU draws every initial weight, so a seed gives the same weights whichever
device the model then runs on; `seed` also seeds torch's own generators,
which draw dropout's bits on each device. JAX keys and torch's generators
give different numbers from one seed; parity tests copy weights across
instead (`paddle_tpu_torch.utils.convert`).

The random ops of the Tensor API (`ops/random.py`) draw from generators of
their own, one per device (`op_generator`), seeded by `seed` with the same
number: a seed repeats their draws bit for bit on each device, and they
never touch torch's global state or the initialisation generator.
"""
from __future__ import annotations

import torch

_DEFAULT = torch.Generator(device="cpu")
_DEFAULT.manual_seed(0)
_SEED = [0]
_OP_GENERATORS = {}


def seed(s: int) -> torch.Generator:
    """paddle.seed parity: reseed the default generator, the random ops'
    generators and torch's."""
    _SEED[0] = int(s)
    _DEFAULT.manual_seed(int(s))
    for gen in _OP_GENERATORS.values():
        gen.manual_seed(int(s))
    torch.manual_seed(int(s))
    return _DEFAULT


def op_generator(device: torch.device) -> torch.Generator:
    """The random ops' generator on `device`, made at its first use and
    seeded with the last `seed`."""
    key = (device.type, device.index or 0)
    gen = _OP_GENERATORS.get(key)
    if gen is None:
        gen = torch.Generator(device=torch.device(device.type, key[1]))
        gen.manual_seed(_SEED[0])
        _OP_GENERATORS[key] = gen
    return gen


def default_generator() -> torch.Generator:
    return _DEFAULT


def get_rng_state() -> dict:
    """The states of every generator the package draws from: the default
    (initialisation) generator, torch's CPU generator and, once CUDA is
    initialised, its per-device generators. `set_rng_state` of the result
    resumes all of them exactly (inside the port only: a JAX key does not
    carry across)."""
    state = {"default": _DEFAULT.get_state(), "cpu": torch.get_rng_state()}
    state.update({f"ops:{kind}:{idx}": g.get_state()
                  for (kind, idx), g in _OP_GENERATORS.items()})
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        state["cuda"] = torch.cuda.get_rng_state_all()
    return state


def set_rng_state(state: dict) -> None:
    _DEFAULT.set_state(_bytes(state["default"]))
    torch.set_rng_state(_bytes(state["cpu"]))
    if "cuda" in state:
        torch.cuda.set_rng_state_all([_bytes(s) for s in state["cuda"]])
    for key, s in state.items():
        if key.startswith("ops:"):
            _, kind, idx = key.split(":")
            op_generator(torch.device(kind, int(idx))).set_state(_bytes(s))


def _bytes(s) -> torch.Tensor:
    """A generator state as the uint8 CPU tensor torch takes (a saved state
    may come back as a numpy array)."""
    return torch.as_tensor(s, dtype=torch.uint8).cpu()


__all__ = ["seed", "default_generator", "op_generator", "get_rng_state",
           "set_rng_state"]
