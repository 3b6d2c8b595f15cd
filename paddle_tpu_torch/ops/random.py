"""Random sampling ops.

Counterpart of `paddle_tpu/ops/random.py` (its 15 names). Every draw comes
from the port's own generator for the target device
(`core.random.op_generator`), seeded by `paddle_tpu_torch.seed`: two
seeded runs repeat bit for bit on one device, and torch's global state is
never read. JAX keys and torch's generators give other numbers from one
seed; what carries across is the distribution, the shapes and the dtypes.
"""
from __future__ import annotations

import torch

from ..core.dtype import canonical, convert_dtype, get_default_dtype
from ..core.place import resolve_device
from ..core.random import op_generator
from ._dispatch import _t, int_list, op

__all__ = [
    "uniform", "uniform_", "normal", "gaussian", "standard_normal", "randn",
    "rand", "randint", "randint_like", "randperm", "bernoulli",
    "multinomial", "poisson", "exponential_", "shuffle",
]


def _float(dtype):
    return canonical(convert_dtype(dtype)) if dtype is not None \
        else get_default_dtype()


def _gen(device, seed=0):
    if seed:
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        return g
    return op_generator(device)


@op
def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = resolve_device()
    out = torch.empty(int_list(shape), dtype=_float(dtype), device=dev)
    return out.uniform_(float(min), float(max), generator=_gen(dev, seed))


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    a = _t(x)
    with torch.no_grad():
        a.uniform_(float(min), float(max), generator=_gen(a.device, seed))
    return x


@op
def gaussian(shape, mean=0.0, std=1.0, dtype=None, name=None):
    dev = resolve_device()
    out = torch.empty(int_list(shape), dtype=_float(dtype), device=dev)
    return out.normal_(generator=op_generator(dev)) * std + mean


@op
def normal(mean=0.0, std=1.0, shape=None, name=None):
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        m = _t(mean) if isinstance(mean, torch.Tensor) else None
        s = _t(std, m) if isinstance(std, torch.Tensor) else None
        like = m if m is not None else s
        m = m if m is not None else torch.tensor(mean, device=like.device)
        s = s if s is not None else torch.tensor(std, device=like.device)
        dt = like.dtype if like.is_floating_point() else torch.float32
        shp = torch.broadcast_shapes(m.shape, s.shape)
        z = torch.empty(shp, dtype=dt, device=like.device)
        return z.normal_(generator=op_generator(like.device)) * s + m
    dev = resolve_device()
    z = torch.empty(int_list(shape if shape is not None else [1]),
                    dtype=get_default_dtype(), device=dev)
    return z.normal_(generator=op_generator(dev)) * std + mean


def standard_normal(shape, dtype=None, name=None):
    return gaussian(shape, 0.0, 1.0, dtype)


def randn(shape, dtype=None, name=None):
    return standard_normal(shape, dtype)


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, 0.0, 1.0)


def _int_dtype(dtype):
    dt = canonical(convert_dtype(dtype))
    return dt if not dt.is_floating_point and dt != torch.bool \
        else torch.int32


@op
def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = resolve_device()
    return torch.randint(int(low), int(high), int_list(shape),
                         dtype=_int_dtype(dtype), device=dev,
                         generator=op_generator(dev))


@op
def randint_like(x, low=0, high=None, dtype=None, name=None):
    a = _t(x)
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), a.shape,
                         dtype=_int_dtype(dtype or "int32"), device=a.device,
                         generator=op_generator(a.device))


@op
def randperm(n, dtype="int64", name=None):
    dev = resolve_device()
    return torch.randperm(int(n), dtype=torch.int64, device=dev,
                          generator=op_generator(dev)).to(_int_dtype(dtype))


@op
def bernoulli(x, name=None):
    a = _t(x)
    return torch.bernoulli(a, generator=op_generator(a.device))


@op
def multinomial(x, num_samples=1, replacement=False, name=None):
    a = _t(x)
    return torch.multinomial(a, int(num_samples), replacement,
                             generator=op_generator(a.device))


@op
def poisson(x, name=None):
    a = _t(x)
    return torch.poisson(a, generator=op_generator(a.device))


def exponential_(x, lam=1.0, name=None):
    a = _t(x)
    with torch.no_grad():
        a.exponential_(lam, generator=op_generator(a.device))
    return x


@op
def shuffle(x, axis=0):
    a = _t(x)
    perm = torch.randperm(a.shape[axis], device=a.device,
                          generator=op_generator(a.device))
    return torch.index_select(a, axis, perm)
