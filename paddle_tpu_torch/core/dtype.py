"""Paddle dtype names -> torch dtypes.

Counterpart of `paddle_tpu/core/dtype.py`. The dtype objects are torch's
(`float32` here is `torch.float32`); `dtype_name` gives the paddle name.

The dtype rule of the Tensor API. The reference runs JAX with 64-bit types
off, so its tensors are never int64, float64 or complex128: Python ints
and int64 arrays become int32, Python floats and float64 arrays the default
float dtype, and argmax, argsort, topk, arange, sum of ints and the rest
give int32. The port's Tensor API (`to_tensor` and the `ops` layer) gives
the same dtypes (`canonical`), so a script or a checkpoint moves across;
it casts indices to int64 only inside the torch calls that require them
(`gather`, `scatter`, `take_along_axis` and the like). The port's modules
behind the API (the layers, the kernels) keep torch's own dtypes.
"""
from __future__ import annotations

import numpy as np
import torch

_STR2DTYPE = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
    "float": torch.float32,
    "double": torch.float64,
    "half": torch.float16,
    "int": torch.int32,
    "long": torch.int64,
}

_DEFAULT_DTYPE = [torch.float32]


def convert_dtype(dtype):
    """Normalise a dtype spec (str, np.dtype, torch.dtype) to torch.dtype."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower().replace("paddle.", "").replace("fp", "float")
        if key in _STR2DTYPE:
            return _STR2DTYPE[key]
    key = np.dtype(dtype).name
    if key not in _STR2DTYPE:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _STR2DTYPE[key]


def dtype_name(dtype) -> str:
    """Paddle name of a dtype ('float32', 'bfloat16', ...)."""
    return str(convert_dtype(dtype)).replace("torch.", "")


def get_default_dtype() -> torch.dtype:
    return _DEFAULT_DTYPE[0]


def set_default_dtype(dtype) -> None:
    """paddle.set_default_dtype: the float dtype of Python floats and
    float64 data in `to_tensor` and of the creation ops."""
    d = convert_dtype(dtype)
    if d not in (torch.float16, torch.bfloat16, torch.float32,
                 torch.float64):
        raise TypeError(f"set_default_dtype only supports floating dtypes, "
                        f"got {dtype}")
    _DEFAULT_DTYPE[0] = d


# the reference's 32-bit canonical forms of the 64-bit types
CANONICAL = {torch.int64: torch.int32, torch.float64: torch.float32,
             torch.complex128: torch.complex64, torch.uint64: torch.uint32}


def canonical(dtype: torch.dtype) -> torch.dtype:
    return CANONICAL.get(dtype, dtype)


def is_floating(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return not d.is_floating_point and not d.is_complex


def finfo(dtype):
    return torch.finfo(convert_dtype(dtype))


def iinfo(dtype):
    return torch.iinfo(convert_dtype(dtype))


bool_ = torch.bool
uint8, int8, int16 = torch.uint8, torch.int8, torch.int16
int32, int64 = torch.int32, torch.int64
float16, bfloat16 = torch.float16, torch.bfloat16
float32, float64 = torch.float32, torch.float64
complex64, complex128 = torch.complex64, torch.complex128

