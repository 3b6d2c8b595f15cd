"""Ring-attention block kernels: hand-written CUDA kernels for Hopper.

Counterpart of the ring block kernels of
`paddle_tpu/kernels/flash_attention.py` (:495-717), the building blocks of
sequence-parallel ring attention (`parallel/sp.py`). `csrc/ring_attention.cu`
replaces all three:

- `ring_block_fwd` -> `_fa_ring_fwd_kernel` (:506, via `ring_block_fwd`
  :644): one hop, local q `[BH, Sq, D]` against the held k/v `[BH, Sk, D]`
  -> (out `[BH, Sq, D]` in q's dtype, lse `[BH, 1, Sq]` f32);
- `ring_block_dq` -> `_fa_ring_dq_kernel` (:551, via `ring_block_dq` :668):
  the hop's dq `[BH, Sq, D]` in f32 from the caller's lse and delta;
- `ring_block_dkv` -> `_fa_ring_dkv_kernel` (:592, via `ring_block_dkv`
  :693): the hop's dk, dv `[BH, Sk, D]` in f32.

`offs = (q_off, k_off)` are the global positions of the first q row and
the first held key. The reference passes them as an int32 tensor in SMEM;
here the single controller knows them on the host, so they are plain ints
passed as kernel arguments. With `causal`, key j is visible to row i when
`k_off + j <= q_off + i`. The exponentials are natural (`exp`, not
`exp2`), lse is `m + log l`, and a row that sees no key of the block gets
out = 0 and lse = -1e30 (the reference gets lse = -1e30 too; its out for
such a row depends on its block size, and the ring's merge gives it zero
weight either way). dq, dk and dv are f32 because the ring sums them over
the hops.

The kernels tile at their own sizes (64 x 64 in bf16, 32 x 32 in fp32), not
the TPU's 512, and accept offsets off their tile grid: every score is
masked by global position, and the loop bounds are only shortcuts. Ragged
Sq and Sk are masked in the kernels too, so a CUDA tensor never reaches a
plain version. On a CUDA tensor a wrapper launches its kernel or raises;
only a tensor on the CPU takes the plain PyTorch version, which the CPU
tests hold against the Pallas kernels in interpret mode. Each wrapper
counts its launches in `<wrapper>.launches`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .flash_attention import _HEAD_DIMS, _count, _on_cuda

_SRC = "ring_attention"
_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: pointers, then (bh, Sq, Sk, D, q_off, k_off, is_bf16,
# causal), then the stream
_SIGNATURES = {"ring_fwd": 5, "ring_dq": 7, "ring_dkv": 8}
_INT_MAX = 2 ** 31 - 1


def build() -> str:
    """Compile the ring kernels' library if it is not built yet."""
    return _build.build(_SRC)


def _entry(fn_name: str):
    fn = getattr(_build.load(_SRC), fn_name)
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = [_P] * _SIGNATURES[fn_name] + [_I] * 8 + [_P]
    return fn


def _offsets(offs):
    q_off, k_off = (int(x) for x in offs)
    return q_off, k_off


def _launch(fn_name, tensors, q, k, offs, causal):
    bh, sq, d = q.shape
    sk = k.shape[1]
    q_off, k_off = offs
    if not (0 <= q_off and 0 <= k_off and q_off + sq <= _INT_MAX
            and k_off + sk <= _INT_MAX):
        raise ValueError(f"{fn_name}: offsets {offs} outside [0, 2^31)")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _entry(fn_name)(*(x.data_ptr() for x in tensors), bh, sq, sk, d,
                             q_off, k_off, int(q.dtype == torch.bfloat16),
                             int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError_t {rc} "
                           f"(BH={bh}, Sq={sq}, Sk={sk}, D={d}, "
                           f"dtype={q.dtype})")


def _check(name, q, k, v, do=None, lse=None, delta=None):
    """Shapes, dtypes, device, contiguity and alignment the kernels take."""
    rows = (q, do) if do is not None else (q,)
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2] \
            or any(x.shape != q.shape for x in rows):
        raise ValueError(f"{name}: q{'/do' if do is not None else ''} "
                         "[BH, Sq, D] and k/v [BH, Sk, D], got "
                         f"{[tuple(x.shape) for x in (*rows, k, v)]}")
    mats = (*rows, k, v)
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            any(x.dtype != q.dtype for x in mats):
        raise TypeError(f"{name}: bf16 or fp32 inputs of one dtype, got "
                        f"{[x.dtype for x in mats]}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} not in "
                         f"{_HEAD_DIMS}")
    if not 1 <= q.shape[0] <= 65535:
        raise ValueError(f"{name}: BH={q.shape[0]} outside [1, 65535]")
    for row in (lse, delta):
        if row is not None and (row.shape != (q.shape[0], 1, q.shape[1])
                                or row.dtype != torch.float32):
            raise ValueError(f"{name}: lse and delta must be f32 "
                             f"[BH, 1, Sq], got {tuple(row.shape)} "
                             f"{row.dtype}")
    for x in (*mats, *(r for r in (lse, delta) if r is not None)):
        if x.device != q.device:
            raise ValueError(f"{name}: inputs on {x.device} and {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and 16-byte "
                             "aligned")


# ---- plain PyTorch versions (CPU tensors) ----------------------------------

def _scores(q, k, offs, causal):
    """f32 scaled scores [BH, Sq, Sk] and the visibility mask (None when
    every key is visible)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if not causal:
        return s, None
    q_off, k_off = _offsets(offs)
    qpos = q_off + torch.arange(q.shape[1], device=q.device)
    kpos = k_off + torch.arange(k.shape[1], device=q.device)
    return s, kpos[None, :] <= qpos[:, None]


def _probs_and_ds(q, k, v, do, lse, delta, offs, causal):
    """p = exp(s - lse) from the given lse [BH, 1, Sq], 0 where hidden, and
    ds = p * (dO v^T - delta), both f32 [BH, Sq, Sk]."""
    s, keep = _scores(q, k, offs, causal)
    p = torch.exp(s - lse.float().reshape(q.shape[0], q.shape[1], 1))
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta.float().reshape(p.shape[0], p.shape[1], 1))


def ring_block_fwd_plain(q, k, v, offs, causal=False):
    """Plain PyTorch version of the forward kernel, in f32: (out [BH, Sq, D]
    in q's dtype, lse [BH, 1, Sq] f32); a row with no visible key gets
    out = 0 and lse = -1e30."""
    s, keep = _scores(q, k, offs, causal)
    if keep is not None:
        s = s.masked_fill(~keep, -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    seen = torch.isfinite(lse)
    p = torch.exp(s - torch.where(seen, lse, 0.0)[..., None])
    out = torch.matmul(p, v.float()).to(q.dtype)
    return out, torch.where(seen, lse, -1e30)[:, None, :]


def ring_block_dq_plain(q, k, v, do, lse, delta, offs, causal=False):
    """Plain version of the dq kernel, in f32: dq = scale * ds k with
    p = exp(s - lse), ds = p * (dO v^T - delta). Returns f32 [BH, Sq, D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, offs, causal)
    return torch.matmul(ds, k.float()) * scale


def ring_block_dkv_plain(q, k, v, do, lse, delta, offs, causal=False):
    """Plain version of the dk/dv kernel, in f32: dk = scale * ds^T q,
    dv = p^T dO. Returns f32 (dk, dv) [BH, Sk, D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, offs, causal)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dk, dv


# ---- the wrappers ----------------------------------------------------------

def ring_block_fwd(q, k, v, offs, causal=False):
    """One ring hop: (out [BH, Sq, D] in q's dtype, lse [BH, 1, Sq] f32).

    CUDA tensors launch the kernel on the current stream (counted in
    `ring_block_fwd.launches`); CPU tensors take the plain version."""
    offs = _offsets(offs)
    if not _on_cuda("ring_fwd", q):
        return ring_block_fwd_plain(q, k, v, offs, causal)
    _check("ring_fwd", q, k, v)
    bh, sq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, 1, sq), dtype=torch.float32, device=q.device)
    _launch("ring_fwd", (q, k, v, out, lse), q, k, offs, causal)
    _count(ring_block_fwd)
    return out, lse


def ring_block_dq(q, k, v, do, lse, delta, offs, causal=False):
    """The hop's dq, f32 [BH, Sq, D]: one CTA per q tile, no atomics."""
    offs = _offsets(offs)
    if not _on_cuda("ring_dq", q):
        return ring_block_dq_plain(q, k, v, do, lse, delta, offs, causal)
    _check("ring_dq", q, k, v, do, lse, delta)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _launch("ring_dq", (q, k, v, do, lse, delta, dq), q, k, offs, causal)
    _count(ring_block_dq)
    return dq


def ring_block_dkv(q, k, v, do, lse, delta, offs, causal=False):
    """The hop's (dk, dv), f32 [BH, Sk, D]: one CTA per key tile."""
    offs = _offsets(offs)
    if not _on_cuda("ring_dkv", q):
        return ring_block_dkv_plain(q, k, v, do, lse, delta, offs, causal)
    _check("ring_dkv", q, k, v, do, lse, delta)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    _launch("ring_dkv", (q, k, v, do, lse, delta, dk, dv), q, k, offs,
            causal)
    _count(ring_block_dkv)
    return dk, dv


for _wrapper in (ring_block_fwd, ring_block_dq, ring_block_dkv):
    _wrapper.launches = 0

__all__ = ["build", "ring_block_fwd", "ring_block_dq", "ring_block_dkv",
           "ring_block_fwd_plain", "ring_block_dq_plain",
           "ring_block_dkv_plain"]
