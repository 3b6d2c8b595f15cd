"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A second package beside `paddle_tpu/` (JAX/XLA/Pallas), which stays the
reference. It keeps the JAX package's module paths, class names,
parameter names and layouts, so each module's counterpart is found by
path and a state dict moves across by name. It imports torch and numpy,
never jax or `paddle_tpu`.

Entry points run on `cuda` unless the caller asks for the CPU
(`set_device('cpu')` or `device='cpu'`); with no CUDA device and no such
request they raise. Every Pallas kernel on a ported path is a hand-written
Hopper kernel under `kernels/`.
"""
from . import (amp, inference, io, jit, models, monitor, nn,  # noqa: F401
               optimizer, parallel, quantization, serving, utils)
from .core.flags import set_flags  # noqa: F401
from .core.place import (CPUPlace, CUDAPlace, get_device,  # noqa: F401
                         set_device)
from .core.random import get_rng_state, seed, set_rng_state  # noqa: F401
from .framework.io import load, save  # noqa: F401
from .jit import InputSpec  # noqa: F401

__all__ = ["set_device", "get_device", "seed", "get_rng_state",
           "set_rng_state", "set_flags", "save", "load",
           "CPUPlace", "CUDAPlace", "InputSpec", "amp", "inference", "io", "jit",
           "models", "monitor", "nn", "optimizer", "parallel", "quantization",
           "serving", "utils"]
