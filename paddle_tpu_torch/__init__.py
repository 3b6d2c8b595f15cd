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

The paddle Tensor API: `to_tensor`, `Tensor` (a `torch.Tensor` subclass,
`core/tensor.py`), every op of `paddle_tpu.ops` but the sequence and lazy
ones at top level and as Tensor methods, `grad`, `no_grad` and the
`autograd` package (PyLayer, jacobian, hessian, vjp, jvp).
"""
from .core.tensor import Tensor  # noqa: F401
from .core.dtype import (  # noqa: F401
    bool_ as bool,  # noqa: A001
    uint8, int8, int16, int32, int64, float16, bfloat16, float32, float64,
    complex64, complex128, set_default_dtype, get_default_dtype, finfo,
    iinfo)
from .core.autograd import (enable_grad, grad, is_grad_enabled,  # noqa: F401
                            no_grad, set_grad_enabled)
from . import ops  # noqa: F401  (binds the Tensor methods)
from .ops import *  # noqa: F401,F403
from . import (amp, autograd, distributed, faults,  # noqa: F401
               inference, io, jit, models, monitor, nn, obs, optimizer,
               parallel, quantization, serving, static, utils, vision)
from .core.flags import set_flags  # noqa: F401
from .core.place import (CPUPlace, CUDAPlace, get_device,  # noqa: F401
                         set_device)
from .core.random import get_rng_state, seed, set_rng_state  # noqa: F401
from .core.lod import LoDTensor, create_lod_tensor  # noqa: F401
from .framework.io import load, save  # noqa: F401
from .framework.param_attr import ParamAttr  # noqa: F401
from .core.tensor import Parameter  # noqa: F401
from .jit import InputSpec  # noqa: F401

__all__ = ["set_device", "get_device", "seed", "get_rng_state",
           "set_rng_state", "set_flags", "save", "load", "ParamAttr",
           "Parameter",
           "CPUPlace", "CUDAPlace", "InputSpec", "amp", "autograd",
           "distributed", "faults",
           "inference", "io", "jit", "models", "monitor", "nn", "obs",
           "optimizer",
           "parallel", "quantization", "serving", "static", "utils", "vision",
           "Tensor", "grad",
           "no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "set_default_dtype", "get_default_dtype", "finfo", "iinfo", "bool",
           "uint8", "int8", "int16", "int32", "int64", "float16", "bfloat16",
           "float32", "float64", "complex64", "complex128"] + ops.__all__
