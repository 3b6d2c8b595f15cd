"""Shape, layout, gather/scatter and indexing ops.

Counterpart of `paddle_tpu/ops/manipulation.py` (reshape, transpose :53,
split :112, gather :171, gather_nd, scatter, scatter_nd_add, tile, expand,
pad, unique, masked_fill, put_along_axis, ...). Indices are cast to int64
only inside the torch calls that take them. `unique`, `unique_consecutive`
and boolean-mask indexing have data-dependent shapes and read the data on
the host, as the reference does.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as TF

from ..core.dtype import canonical, convert_dtype
from ..core.tensor import Tensor, to_torch
from ._dispatch import _inplace, _t, axis_arg, index64, int_list, op


def _norm_shape(shape, cur):
    """Paddle's reshape: -1 infers, 0 copies the input's dim."""
    return [cur[i] if s == 0 else s for i, s in enumerate(int_list(shape))]


@op
def cast(x, dtype):
    return _t(x).to(canonical(convert_dtype(dtype)))


@op
def reshape(x, shape, name=None):
    a = _t(x)
    return a.reshape(_norm_shape(shape, list(a.shape)))


def _meta_inplace(x, result):
    """Give x the shape of `result` in place (the reference rebinds x):
    for tensors off the autograd graph, and leaves under no_grad."""
    with torch.no_grad():
        x.set_(to_torch(result).detach().clone())
    return x


def reshape_(x, shape, name=None):
    return _meta_inplace(x, reshape(x, shape))


@op
def transpose(x, perm, name=None):
    return _t(x).permute([int(p) for p in perm])


@op
def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(_t(x), int(axis0), int(axis1))


@op
def moveaxis(x, source, destination, name=None):
    return torch.movedim(_t(x), source, destination)


@op
def flatten(x, start_axis=0, stop_axis=-1, name=None):
    a = _t(x)
    if a.ndim == 0:
        return a.reshape(1)
    return torch.flatten(a, start_axis, stop_axis)


@op
def squeeze(x, axis=None, name=None):
    a = _t(x)
    if axis is None:
        return torch.squeeze(a)
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    keep = tuple(int(d) % a.ndim for d in axes if a.shape[int(d)] == 1)
    return torch.squeeze(a, keep) if keep else a.view(a.shape)


@op
def unsqueeze(x, axis, name=None):
    a = _t(x)
    axes = axis_arg(axis)
    axes = axes if isinstance(axes, tuple) else (axes,)
    nd = a.ndim + len(axes)
    out_shape, it = [], iter(a.shape)
    pos = {d % nd for d in axes}
    for d in range(nd):
        out_shape.append(1 if d in pos else next(it))
    return a.reshape(out_shape)


def squeeze_(x, axis=None, name=None):
    return _meta_inplace(x, squeeze(x, axis))


def unsqueeze_(x, axis=None, name=None):
    return _meta_inplace(x, unsqueeze(x, axis))


@op
def concat(x, axis=0, name=None):
    return torch.cat([_t(t) for t in x], int(axis_arg(axis)))


@op
def stack(x, axis=0, name=None):
    return torch.stack([_t(t) for t in x], int(axis))


def _sections(dim, num_or_sections):
    if isinstance(num_or_sections, int):
        return [dim // num_or_sections] * num_or_sections
    sizes = int_list(num_or_sections)
    known = builtins.sum(s for s in sizes if s >= 0)
    return [s if s >= 0 else dim - known for s in sizes]


@op
def split(x, num_or_sections, axis=0, name=None):
    """Paddle's split: an int is the number of equal pieces."""
    a = _t(x)
    ax = int(axis_arg(axis))
    return list(torch.split(a, _sections(a.shape[ax], num_or_sections), ax))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


@op
def unbind(x, axis=0, name=None):
    return list(torch.unbind(_t(x), int(axis)))


def _static_ints(v):
    if isinstance(v, torch.Tensor):
        return [int(i) for i in to_torch(v).reshape(-1).tolist()]
    return [int(to_torch(i).item()) if isinstance(i, torch.Tensor) else int(i)
            for i in v]


@op
def slice(x, axes, starts, ends, name=None):
    a = _t(x)
    idx = [builtins.slice(None)] * a.ndim
    for ax, s, e in zip(_static_ints(axes), _static_ints(starts),
                        _static_ints(ends)):
        idx[ax] = builtins.slice(s, e)
    return a[tuple(idx)]


@op
def strided_slice(x, axes, starts, ends, strides, name=None):
    a = _t(x)
    idx = [builtins.slice(None)] * a.ndim
    for ax, s, e, st in zip(axes, starts, ends, strides):
        idx[int(ax)] = builtins.slice(int(s), int(e), int(st))
    a, tidx = _negative_steps(a, tuple(idx))
    return a[tidx]


@op
def gather(x, index, axis=0, name=None):
    a = _t(x)
    ax = int(axis_arg(axis)) % builtins.max(a.ndim, 1)
    ind = index64(index, a)
    out = torch.index_select(a, ax, ind.reshape(-1))
    return out.reshape(a.shape[:ax] + ind.shape + a.shape[ax + 1:])


@op
def gather_nd(x, index, name=None):
    a = _t(x)
    ind = index64(index, a)
    return a[tuple(ind[..., i] for i in range(ind.shape[-1]))]


def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis)


@op
def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    a = _t(arr)
    return torch.take_along_dim(a, index64(indices, a), int(axis))


@op
def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    a = _t(arr)
    ind = index64(indices, a)
    ax = int(axis) % a.ndim
    v = _t(values, a) if isinstance(values, torch.Tensor) else \
        torch.tensor(values, device=a.device)
    v = v.to(a.dtype).expand(ind.shape)
    if reduce == "assign":
        return torch.scatter(a, ax, ind, v)
    if reduce in ("add", "sum"):
        return torch.scatter_add(a, ax, ind, v)
    if reduce in ("mul", "multiply"):
        return torch.scatter_reduce(a, ax, ind, v, "prod")
    raise ValueError(f"unknown reduce {reduce}")


@op
def scatter(x, index, updates, overwrite=True, name=None):
    """Rows of x at `index` (axis 0) set to, or (overwrite=False) added
    with, the rows of `updates`, as the reference does."""
    a = _t(x)
    u = _t(updates, a).to(a.dtype)
    ind = index64(index, a).reshape(-1)
    if overwrite:
        return torch.index_put(a, (ind,), u)
    return torch.index_put(a, (ind,), u, accumulate=True)


def scatter_(x, index, updates, overwrite=True, name=None):
    return _inplace(x, scatter(x, index, updates, overwrite))


@op
def scatter_nd_add(x, index, updates, name=None):
    a = _t(x)
    ind = index64(index, a)
    idx = tuple(ind[..., i] for i in range(ind.shape[-1]))
    return torch.index_put(a, idx, _t(updates, a).to(a.dtype),
                           accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    from .creation import zeros
    return scatter_nd_add(zeros(shape, dtype=_t(updates).dtype), index,
                          updates)


@op
def tile(x, repeat_times, name=None):
    return torch.tile(_t(x), int_list(repeat_times))


@op
def expand(x, shape, name=None):
    a = _t(x)
    shape = int_list(shape)
    xs = [1] * (len(shape) - a.ndim) + list(a.shape)
    return a.expand([xd if s == -1 else s for s, xd in zip(shape, xs)])


def expand_as(x, y, name=None):
    return expand(x, list(_t(y).shape))


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    shape = torch.broadcast_shapes(*[tuple(_t(t).shape) for t in inputs])
    return [expand(t, list(shape)) for t in inputs]


@op
def flip(x, axis, name=None):
    ax = axis if isinstance(axis, (list, tuple)) else [axis]
    return torch.flip(_t(x), [int(d) for d in ax])


@op
def roll(x, shifts, axis=None, name=None):
    a = _t(x)
    if axis is None:
        return torch.roll(a.reshape(-1), shifts).reshape(a.shape)
    return torch.roll(a, shifts, axis)


@op
def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(_t(x), k, list(axes))


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        from .search import nonzero
        return nonzero(condition, as_tuple=True)
    return _where(condition, x, y)


@op
def _where(condition, x, y):
    c = _t(condition).to(torch.bool)
    if isinstance(x, torch.Tensor) or not isinstance(y, torch.Tensor):
        a = _t(x, c)
        b = _t(y, a) if isinstance(y, torch.Tensor) else \
            torch.tensor(y, dtype=a.dtype, device=a.device)
    else:
        b = _t(y, c)
        a = torch.tensor(x, dtype=b.dtype, device=b.device)
    return torch.where(c, a, b)


@op
def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Paddle's pad: 2 * ndim widths pad every axis in order; fewer pad
    the spatial axes innermost-first, (left, right, top, bottom, ...)."""
    a = _t(x)
    pad = int_list(pad)
    nd = a.ndim
    if len(pad) == 2 * nd:
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        n = len(pad) // 2
        spatial = [(pad[2 * i], pad[2 * i + 1]) for i in range(n)][::-1]
        if data_format.upper().endswith("C"):
            widths = [(0, 0)] * (nd - n - 1) + spatial + [(0, 0)]
        else:
            widths = [(0, 0)] * (nd - n) + spatial
    if mode == "constant":
        flat = [w for pair in widths[::-1] for w in pair]
        return TF.pad(a, flat, mode="constant", value=value)
    # torch pads the trailing dims of a batched input: move the padded
    # axes last, pad them there, move them back
    axes = [d for d, w in enumerate(widths) if w != (0, 0)]
    rest = [d for d in range(nd) if d not in axes]
    b = a.permute(rest + axes)
    lead = b.shape[:len(rest)]
    b = b.reshape((1, -1) + tuple(b.shape[len(rest):]))
    flat = [w for d in axes[::-1] for w in widths[d]]
    tmode = {"reflect": "reflect", "replicate": "replicate",
             "circular": "circular"}[mode]
    b = TF.pad(b, flat, mode=tmode)
    b = b.reshape(tuple(lead) + tuple(b.shape[2:]))
    return b.permute(np.argsort(rest + axes).tolist())


@op
def repeat_interleave(x, repeats, axis=None, name=None):
    a = _t(x)
    reps = _t(repeats, a).long() if isinstance(repeats, torch.Tensor) \
        else repeats
    return torch.repeat_interleave(a, reps, dim=axis)


def _host(x):
    return to_torch(x).detach().cpu().float().numpy() \
        if to_torch(x).dtype == torch.bfloat16 else \
        to_torch(x).detach().cpu().numpy()


@op
def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    a = _t(x)
    res = np.unique(_host(a), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        return torch.as_tensor(res, device=a.device)
    return tuple(torch.as_tensor(r, device=a.device) for r in res)


@op
def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, name=None):
    a = _t(x)
    h = _host(a)
    vals, prev = [], object()
    for v in (h.reshape(-1) if axis is None else h):
        if not np.array_equal(v, prev):
            vals.append(v)
        prev = v
    return torch.as_tensor(np.array(vals), device=a.device)


@op
def as_complex(x, name=None):
    a = _t(x)
    return torch.complex(a[..., 0], a[..., 1])


@op
def as_real(x, name=None):
    a = _t(x)
    if not a.is_complex():
        return torch.stack([a, torch.zeros_like(a)], -1)
    return torch.stack([torch.real(a), torch.imag(a)], -1)


@op
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    a = _t(input)
    size = index_num // nshards
    return torch.where(torch.div(a, size, rounding_mode="floor") == shard_id,
                       torch.remainder(a, size),
                       torch.full_like(a, ignore_value))


# ---- indexing (Tensor.__getitem__ / __setitem__) ----
def _conv_idx(idx, like):
    if isinstance(idx, torch.Tensor):
        return to_torch(idx).to(like.device)
    if isinstance(idx, tuple):
        return tuple(_conv_idx(i, like) for i in idx)
    if isinstance(idx, (list, np.ndarray)):
        return torch.as_tensor(np.asarray(idx), device=like.device)
    return idx


def _consumed(i):
    """How many axes of the indexed tensor one index entry takes."""
    if i is None:
        return 0
    if isinstance(i, torch.Tensor) and i.dtype == torch.bool:
        return builtins.max(i.ndim, 1)
    return 1


def _negative_steps(a, idx):
    """numpy's negative-step slices (which torch refuses) as flips of the
    axes they index and positive-step slices."""
    tup = idx if isinstance(idx, tuple) else (idx,)
    if not builtins.any(isinstance(i, builtins.slice) and i.step is not None
                        and i.step < 0 for i in tup):
        return a, idx
    n_ell = builtins.sum(1 for i in tup if i is Ellipsis)
    explicit = builtins.sum(_consumed(i) for i in tup if i is not Ellipsis)
    out, d = list(tup), 0
    for k, i in enumerate(tup):
        if i is Ellipsis:
            d += a.ndim - explicit if n_ell else 0
            continue
        if isinstance(i, builtins.slice) and i.step is not None and \
                i.step < 0:
            n = a.shape[d]
            start, stop, step = i.indices(n)
            a = torch.flip(a, [d])
            out[k] = builtins.slice(n - 1 - start, n - 1 - stop, -step)
        d += _consumed(i)
    return a, tuple(out)


@op
def getitem(x, idx):
    a = _t(x)
    a, tidx = _negative_steps(a, _conv_idx(idx, a))
    return a[tidx]


def setitem_(x, idx, value):
    a = _t(x)
    if isinstance(value, torch.Tensor):
        v = _t(value).to(a.dtype)
    elif isinstance(value, (list, np.ndarray)):
        v = torch.as_tensor(np.asarray(value), device=a.device).to(a.dtype)
    else:
        v = value
    a[_conv_idx(idx, a)] = v
    return x


@op
def index_put(x, indices, value, accumulate=False, name=None):
    a = _t(x)
    idx = tuple(_conv_idx(i, a) for i in indices)
    idx = tuple(i.long() if isinstance(i, torch.Tensor) and
                i.dtype != torch.bool else i for i in idx)
    return torch.index_put(a, idx, _t(value, a).to(a.dtype), accumulate)


@op
def masked_fill(x, mask, value, name=None):
    a = _t(x)
    m = _t(mask, a).to(torch.bool)
    v = _t(value, a).to(a.dtype) if isinstance(value, torch.Tensor) else \
        torch.tensor(value, dtype=a.dtype, device=a.device)
    return torch.where(m, v, a)


def fill_(x, value):
    with torch.no_grad():
        _t(x).fill_(value)
    return x


def fill_diagonal_(x, value, offset=0, wrap=False, name=None):
    a = _t(x)
    n = builtins.min(a.shape[-2], a.shape[-1])
    i = torch.arange(n, device=a.device)
    with torch.no_grad():
        a[..., i, i] = value
    return x


@op
def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(_t(x), offset, axis1, axis2)


@op
def take(x, index, mode="raise", name=None):
    """Flat-index gather; mode 'raise' checks the range on the host, 'clip'
    clamps, 'wrap' wraps."""
    a = _t(x)
    idx = index64(index, a)
    n = a.numel()
    if mode == "raise" and idx.numel():
        lo, hi = int(idx.min()), int(idx.max())
        if lo < -n or hi >= n:
            raise IndexError(f"take: index out of range for {n} elements "
                             f"(min {lo}, max {hi})")
    if mode == "wrap":
        idx = torch.remainder(idx, n)
    else:
        idx = torch.clamp(torch.where(idx < 0, idx + n, idx), 0, n - 1)
    return a.reshape(-1)[idx]


@op
def unstack(x, axis=0, num=None, name=None):
    return list(torch.unbind(_t(x), axis))


@op
def crop(x, shape=None, offsets=None, name=None):
    a = _t(x)
    shp = _static_ints(shape) if shape is not None else list(a.shape)
    offs = _static_ints(offsets) if offsets is not None else [0] * len(shp)
    sl = tuple(builtins.slice(o, a.shape[i] if s == -1 else o + s)
               for i, (o, s) in enumerate(zip(offs, shp)))
    return a[sl]


def reverse(x, axis, name=None):
    return flip(x, axis)


@op
def shape(input):
    a = _t(input)
    return torch.tensor(list(a.shape), dtype=torch.int32, device=a.device)


def tolist(x):
    if type(x) is Tensor:
        return Tensor.tolist(x)  # tpu-lint: disable=host-sync (paddle API: tolist reads the host)
    return np.asarray(_host(_t(x))).tolist()
