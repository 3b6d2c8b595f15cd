"""Ring-attention block kernels: hand-written CUDA kernels for Hopper.

Counterpart of the ring block kernels of
`paddle_tpu/kernels/flash_attention.py` (:495-717), the building blocks of
sequence-parallel ring attention (`parallel/sp.py`). `csrc/ring_attention.cu`
replaces all three, each as one launch per ring step:

- `ring_fwd_step` -> `_fa_ring_fwd_kernel` (:506, via `ring_block_fwd`
  :644) and the merge around it (`parallel/sp.py:214-218`): every slot of a
  ring step on one device in one launch; each slot attends its local q
  `[BH, Sq, D]` against its held k/v `[BH, Sk, D]` and merges the hop into
  its running f32 accumulators (o `[BH, Sq, D]`, lse `[BH, 1, Sq]`) in the
  kernel's epilogue. `first` reads no accumulator (the merge into
  (0, -1e30)); `last` returns out in q's dtype and leaves o unwritten. A
  row that sees no key of its hop keeps its accumulators as they are.
  `ring_block_fwd` is a group of one with `first` and `last`: (out in q's
  dtype, lse), 0 and -1e30 for a row that sees nothing;
- `ring_dq_step` -> `_fa_ring_dq_kernel` (:551, via `ring_block_dq` :668)
  and the sum around it (`parallel/sp.py:258-260`): every slot of a ring
  step in one launch, each adding its hop's dq, from the caller's lse and
  delta, into its f32 dq accumulator `[BH, Sq, D]`; a q tile that sees no
  key of its hop leaves it untouched. `ring_block_dq` is a group of one
  that returns a fresh f32 dq;
- `ring_dkv_step` -> `_fa_ring_dkv_kernel` (:592, via `ring_block_dkv`
  :693) and the accumulation around it (`parallel/sp.py:264-265`): every
  slot of a ring step in one launch, each adding its hop's dk, dv into the
  rotating f32 accumulators `[BH, Sk, D]` (storing them under `first`).
  `ring_block_dkv` is a group of one that returns fresh f32 (dk, dv).

`offs = (q_off, k_off)` are the global positions of the first q row and
the first held key. The reference passes them as an int32 tensor in SMEM;
here the single controller knows them on the host, so they are plain ints
passed as kernel arguments. With `causal`, key j is visible to row i when
`k_off + j <= q_off + i`. The exponentials are natural (`exp`, not
`exp2`), lse is `m + log l`, and a row that sees no key of the block gets
out = 0 and lse = -1e30 (the reference gets lse = -1e30 too; its out for
such a row depends on its block size, and the ring's merge gives it zero
weight either way). dq, dk and dv are f32 because the ring sums them over
the hops. The merged forward keeps the hop's out in f32 before the merge
(the reference rounds it to q's dtype first).

The kernels tile at their own sizes, not the TPU's 512, and accept offsets
off their tile grid: every score is masked by global position, and the
loop bounds are only shortcuts. Ragged Sq and Sk are masked in the kernels
too, so a CUDA tensor never reaches a plain version. On a CUDA tensor a
wrapper launches its kernel or raises; only a tensor on the CPU takes the
plain PyTorch version, which the CPU tests hold against the Pallas kernels
in interpret mode. The step wrappers count their launches in
`<wrapper>.launches` and the slot-hops they served in `<wrapper>.hops`. A
launch takes at most `MAX_SLOTS` slots (the kernel's parameter space holds
their tensor maps).
"""
from __future__ import annotations

import contextlib
import ctypes
import math

import torch

from . import _build
from .flash_attention import (DTYPE_CODES, KERNEL_DTYPES, _HEAD_DIMS,
                              _count_lock, _on_cuda)

_SRC = "ring_attention"
_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: ptrs, offs, then n, bh, Sq, Sk, D, dtype code, causal [, first
# [, last]] (first for dk/dv, first and last for the forward); the stream
# last
_SIGNATURES = {"ring_fwd_step": [_P, _P] + [_I] * 9,
               "ring_dq_step": [_P, _P] + [_I] * 7,
               "ring_dkv_step": [_P, _P] + [_I] * 8}
_INT_MAX = 2 ** 31 - 1
MAX_SLOTS = 4  # slots per launch: kMaxSlots of csrc/ring_attention.cu


def build() -> str:
    """Compile the ring kernels' library if it is not built yet."""
    return _build.build(_SRC)


def _entry(fn_name: str):
    fn = getattr(_build.load(_SRC), fn_name)
    if fn.argtypes is None:
        fn.restype = _I
        fn.argtypes = _SIGNATURES[fn_name] + [_P]
    return fn


def _offsets(offs):
    q_off, k_off = (int(x) for x in offs)
    return q_off, k_off


def _check_offsets(name, offs, sq, sk):
    q_off, k_off = offs
    if not (0 <= q_off and 0 <= k_off and q_off + sq <= _INT_MAX
            and k_off + sk <= _INT_MAX):
        raise ValueError(f"{name}: offsets {offs} outside [0, 2^31)")


def _call(fn_name, ints, q, ptrs, offs):
    """Launch a step entry on q's device and current stream: a pointer
    table and an offset table, then `ints`."""
    bh, sq, d = q.shape
    # switching devices costs more than the launch: only when needed
    on = contextlib.nullcontext() if q.device.index == \
        torch.cuda.current_device() else torch.cuda.device(q.device)
    with on:
        stream = torch.cuda.current_stream().cuda_stream
        table = (ctypes.c_void_p * len(ptrs))(*ptrs)
        otable = (ctypes.c_int * len(offs))(*offs)
        rc = _entry(fn_name)(ctypes.addressof(table),
                             ctypes.addressof(otable), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError_t {rc} "
                           f"(BH={bh}, Sq={sq}, D={d}, dtype={q.dtype})")


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
    if q.dtype not in KERNEL_DTYPES or \
            any(x.dtype != q.dtype for x in mats):
        raise TypeError(f"{name}: fp32, bf16 or fp16 inputs of one dtype, "
                        f"got {[x.dtype for x in mats]}")
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
        _check_placed(name, x, q)


def _check_placed(name, x, q):
    if x.device != q.device:
        raise ValueError(f"{name}: inputs on {x.device} and {q.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: inputs must be contiguous and 16-byte "
                         "aligned")


def _check_acc(name, x, shape, q):
    """A running f32 accumulator of the given shape, placed as q."""
    if x.shape != shape or x.dtype != torch.float32:
        raise ValueError(f"{name}: accumulators must be f32 {tuple(shape)}, "
                         f"got {tuple(x.shape)} {x.dtype}")
    _check_placed(name, x, q)


def _check_group(name, qs, ks, offs):
    """The slots of one launch: 1 to MAX_SLOTS, one shape, dtype and
    device; offsets in range."""
    if not 1 <= len(qs) <= MAX_SLOTS:
        raise ValueError(f"{name}: {len(qs)} slots in one launch, not 1 to "
                         f"{MAX_SLOTS}")
    for q, k, off in zip(qs, ks, offs):
        if q.shape != qs[0].shape or k.shape != ks[0].shape or \
                q.dtype != qs[0].dtype or q.device != qs[0].device:
            raise ValueError(f"{name}: the slots of a launch share one "
                             "shape, dtype and device")
        _check_offsets(name, off, q.shape[1], k.shape[1])


def _count_step(wrapper, n_slots):
    with _count_lock:
        wrapper.launches += 1
        wrapper.hops += n_slots


def _flat_offsets(offs):
    return [x for off in offs for x in off]


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


def _hop_fwd(q, k, v, offs, causal):
    """One hop in f32: (out [BH, Sq, D] f32, lse [BH, 1, Sq] f32); a row
    with no visible key gets out = 0 and lse = -1e30."""
    s, keep = _scores(q, k, offs, causal)
    if keep is not None:
        s = s.masked_fill(~keep, -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    seen = torch.isfinite(lse)
    p = torch.exp(s - torch.where(seen, lse, 0.0)[..., None])
    return torch.matmul(p, v.float()), torch.where(seen, lse, -1e30)[:, None]


def ring_block_fwd_plain(q, k, v, offs, causal=False):
    """Plain PyTorch version of one forward hop, in f32: (out [BH, Sq, D]
    in q's dtype, lse [BH, 1, Sq] f32); a row with no visible key gets
    out = 0 and lse = -1e30."""
    out, lse = _hop_fwd(q, k, v, offs, causal)
    return out.to(q.dtype), lse


def ring_fwd_step_plain(qs, ks, vs, offs, o, lse, causal=False, first=False,
                        last=False):
    """Plain version of the forward ring step, slot by slot: each hop
    merged into (o[i], lse[i]) in place as `parallel/sp.py:214-218` merges
    it (o_hop in f32); `first` ignores the accumulators' contents; rows
    that see no key keep theirs. With `last` returns the outputs in q's
    dtype and leaves o unwritten, else returns None."""
    outs = []
    for i, (q, k, v, off) in enumerate(zip(qs, ks, vs, offs)):
        o_b, lse_b = _hop_fwd(q, k, v, _offsets(off), causal)
        if first:
            new_o, new_lse = o_b, lse_b
        else:
            new_lse = torch.logaddexp(lse[i], lse_b)
            new_o = o[i] * torch.exp(lse[i] - new_lse).transpose(1, 2) \
                + o_b * torch.exp(lse_b - new_lse).transpose(1, 2)
            seen = lse_b > -1e30
            new_o = torch.where(seen.transpose(1, 2), new_o, o[i])
            new_lse = torch.where(seen, new_lse, lse[i])
        lse[i].copy_(new_lse)
        if last:
            outs.append(new_o.to(q.dtype))
        else:
            o[i].copy_(new_o)
    return outs if last else None


def ring_block_dq_plain(q, k, v, do, lse, delta, offs, causal=False):
    """Plain version of one dq hop, in f32: dq = scale * ds k with
    p = exp(s - lse), ds = p * (dO v^T - delta). Returns f32 [BH, Sq, D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, _offsets(offs), causal)
    return torch.matmul(ds, k.float()) * scale


def ring_dq_step_plain(qs, ks, vs, dos, lses, deltas, offs, dqs,
                       causal=False):
    """Plain version of the dq ring step, slot by slot: each hop's dq
    added into dqs[i] in place."""
    for i, args in enumerate(zip(qs, ks, vs, dos, lses, deltas, offs)):
        dqs[i].add_(ring_block_dq_plain(*args, causal))


def ring_block_dkv_plain(q, k, v, do, lse, delta, offs, causal=False):
    """Plain version of one dk/dv hop, in f32: dk = scale * ds^T q,
    dv = p^T dO. Returns f32 (dk, dv) [BH, Sk, D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, _offsets(offs), causal)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dk, dv


def ring_dkv_step_plain(qs, ks, vs, dos, lses, deltas, offs, dks, dvs,
                        causal=False, first=False):
    """Plain version of the dk/dv ring step, slot by slot: each hop's
    (dk, dv) added into (dks[i], dvs[i]) in place, stored under `first`."""
    for i, args in enumerate(zip(qs, ks, vs, dos, lses, deltas, offs)):
        dk, dv = ring_block_dkv_plain(*args, causal)
        if first:
            dks[i].copy_(dk)
            dvs[i].copy_(dv)
        else:
            dks[i].add_(dk)
            dvs[i].add_(dv)


# ---- the wrappers ----------------------------------------------------------

def ring_fwd_step(qs, ks, vs, offs, o, lse, causal=False, first=False,
                  last=False):
    """One ring step's forward over the slots on one device, in one launch:
    lists of q [BH, Sq, D], k/v [BH, Sk, D], (q_off, k_off), and the running
    f32 accumulators o [BH, Sq, D] and lse [BH, 1, Sq], merged in place.
    Returns the outputs in q's dtype when `last`, else None. o may be None
    when `first` and `last` (it is neither read nor written).

    CUDA tensors launch the kernel on the current stream (counted in
    `ring_fwd_step.launches`, slots in `.hops`); CPU tensors take the
    plain version."""
    offs = [_offsets(x) for x in offs]
    if not _on_cuda("ring_fwd_step", qs[0]):
        return ring_fwd_step_plain(qs, ks, vs, offs, o, lse, causal, first,
                                   last)
    _check_group("ring_fwd_step", qs, ks, offs)
    q0 = qs[0]
    bh, sq, d = q0.shape
    outs = [torch.empty_like(q) for q in qs] if last else [None] * len(qs)
    ptrs = []
    for i, (q, k, v) in enumerate(zip(qs, ks, vs)):
        _check("ring_fwd_step", q, k, v, lse=lse[i])
        if not (first and last):
            _check_acc("ring_fwd_step", o[i], (bh, sq, d), q0)
        ptrs += [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if first and last else o[i].data_ptr(),
                 lse[i].data_ptr(),
                 None if outs[i] is None else outs[i].data_ptr()]
    _call("ring_fwd_step",
          [len(qs), bh, sq, ks[0].shape[1], d,
           DTYPE_CODES[q0.dtype], int(bool(causal)),
           int(bool(first)), int(bool(last))], q0, ptrs=ptrs,
          offs=_flat_offsets(offs))
    _count_step(ring_fwd_step, len(qs))
    return outs if last else None


def ring_dkv_step(qs, ks, vs, dos, lses, deltas, offs, dks, dvs,
                  causal=False, first=False):
    """One ring step's dk/dv over the slots on one device, in one launch:
    each slot's hop added into its rotating f32 accumulators dks[i], dvs[i]
    [BH, Sk, D] in place (stored under `first`); one CTA per key tile, no
    atomics."""
    offs = [_offsets(x) for x in offs]
    if not _on_cuda("ring_dkv_step", qs[0]):
        return ring_dkv_step_plain(qs, ks, vs, dos, lses, deltas, offs, dks,
                                   dvs, causal, first)
    _check_group("ring_dkv_step", qs, ks, offs)
    q0, k0 = qs[0], ks[0]
    ptrs = []
    for i in range(len(qs)):
        _check("ring_dkv_step", qs[i], ks[i], vs[i], dos[i], lses[i],
               deltas[i])
        for acc in (dks[i], dvs[i]):
            _check_acc("ring_dkv_step", acc, k0.shape, q0)
        ptrs += [x.data_ptr() for x in (qs[i], ks[i], vs[i], dos[i],
                                        lses[i], deltas[i], dks[i], dvs[i])]
    bh, sq, d = q0.shape
    _call("ring_dkv_step",
          [len(qs), bh, sq, k0.shape[1], d, DTYPE_CODES[q0.dtype],
           int(bool(causal)), int(bool(first))], q0, ptrs=ptrs,
          offs=_flat_offsets(offs))
    _count_step(ring_dkv_step, len(qs))


def ring_dq_step(qs, ks, vs, dos, lses, deltas, offs, dqs, causal=False):
    """One ring step's dq over the slots on one device, in one launch: each
    slot's hop added into its f32 dq accumulator dqs[i] [BH, Sq, D] in
    place; one CTA per q tile, no atomics."""
    offs = [_offsets(x) for x in offs]
    if not _on_cuda("ring_dq_step", qs[0]):
        return ring_dq_step_plain(qs, ks, vs, dos, lses, deltas, offs, dqs,
                                  causal)
    _check_group("ring_dq_step", qs, ks, offs)
    q0 = qs[0]
    ptrs = []
    for i in range(len(qs)):
        _check("ring_dq_step", qs[i], ks[i], vs[i], dos[i], lses[i],
               deltas[i])
        _check_acc("ring_dq_step", dqs[i], q0.shape, q0)
        ptrs += [x.data_ptr() for x in (qs[i], ks[i], vs[i], dos[i],
                                        lses[i], deltas[i], dqs[i])]
    bh, sq, d = q0.shape
    _call("ring_dq_step",
          [len(qs), bh, sq, ks[0].shape[1], d, DTYPE_CODES[q0.dtype],
           int(bool(causal))], q0, ptrs,
          _flat_offsets(offs))
    _count_step(ring_dq_step, len(qs))


def ring_block_fwd(q, k, v, offs, causal=False):
    """One ring hop: (out [BH, Sq, D] in q's dtype, lse [BH, 1, Sq] f32), a
    forward ring step of one slot with `first` and `last`."""
    if not _on_cuda("ring_fwd", q):
        return ring_block_fwd_plain(q, k, v, _offsets(offs), causal)
    lse = torch.empty((q.shape[0], 1, q.shape[1]), dtype=torch.float32,
                      device=q.device)
    out, = ring_fwd_step([q], [k], [v], [offs], None, [lse], causal,
                         first=True, last=True)
    return out, lse


def ring_block_dq(q, k, v, do, lse, delta, offs, causal=False):
    """The hop's dq, f32 [BH, Sq, D]: a dq ring step of one slot into a
    zeroed accumulator."""
    if not _on_cuda("ring_dq", q):
        return ring_block_dq_plain(q, k, v, do, lse, delta, offs, causal)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    ring_dq_step([q], [k], [v], [do], [lse], [delta], [offs], [dq], causal)
    return dq


def ring_block_dkv(q, k, v, do, lse, delta, offs, causal=False):
    """The hop's (dk, dv), f32 [BH, Sk, D]: a dk/dv ring step of one slot
    with `first`."""
    if not _on_cuda("ring_dkv", q):
        return ring_block_dkv_plain(q, k, v, do, lse, delta, _offsets(offs),
                                    causal)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    ring_dkv_step([q], [k], [v], [do], [lse], [delta], [offs], [dk], [dv],
                  causal, first=True)
    return dk, dv


for _wrapper in (ring_fwd_step, ring_dq_step, ring_dkv_step):
    _wrapper.launches = _wrapper.hops = 0

__all__ = ["MAX_SLOTS", "build", "ring_fwd_step", "ring_dq_step",
           "ring_dkv_step", "ring_block_fwd", "ring_block_dq",
           "ring_block_dkv", "ring_fwd_step_plain", "ring_dq_step_plain",
           "ring_dkv_step_plain", "ring_block_fwd_plain",
           "ring_block_dq_plain", "ring_block_dkv_plain"]
