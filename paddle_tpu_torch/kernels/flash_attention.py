"""Flash attention, forward and backward: hand-written CUDA kernels for Hopper.

Counterpart of `paddle_tpu/kernels/flash_attention.py`. Two sources:

- `csrc/flash_fwd.cu` replaces `_fa_kernel` (:58, reached through
  `_flash_fwd_bhsd` :180): out in the input dtype and lse in f32
  natural-log units, both from an online softmax in base 2, causal keys
  past the diagonal masked to -1e30.
- `csrc/flash_bwd.cu` replaces the three backward kernels, which share one
  tile function (`_bwd_tile_pds` :216): `_fa_bwd_fused_kernel` (:732, via
  `_flash_bwd_fused_bhsd` :799) as `flash_attention_bwd_fused`, and
  `_fa_bwd_dq_kernel` (:239) with `_fa_bwd_dkv_kernel` (:280), the
  two-pass form of `_flash_bwd_bhsd` (:336), as `flash_attention_bwd_dq`
  and `flash_attention_bwd_dkv`. The dq pass shares its Hopper template
  (`csrc/dq_wgmma.cuh`) with the ring's dq step.

`flash_fwd_op` / `flash_bwd_op` (registered operators) are the
counterpart of the `custom_vjp` `_flash_core` (:406-439): the forward
saves (q, k, v, out, lse) as `_flash_core_fwd` does, and the backward
picks a form as `_flash_core_bwd` does, with this
card's reason in place of the TPU's VMEM cap: on Hopper the fused form
sums dq across parallel CTAs with f32 atomics, so its dq is not bitwise
reproducible from run to run. The fused form is the default; under
`torch.use_deterministic_algorithms(True)` the deterministic two-pass
form runs instead. On the card `delta = rowsum(dO * O)` (which the
reference computes in XLA, `_delta` :209) comes from a small pass of the
same source that also zeroes the fused form's dq workspace, and another
scales and casts that workspace after the kernel; `_delta` is their plain
version.

The kernels take fp32, bf16 and fp16 (`KERNEL_DTYPES`, every dtype the
reference's dispatch sends to its Pallas kernels, whose dots run in the
input dtype): the bf16 and fp16 forms are one template over the element
type. Kernels are built with nvcc at first use and called through
ctypes; their bounds on the H100 and their designs are noted in the
sources. On a CUDA tensor a wrapper launches its kernel or raises; only a
tensor on the CPU takes the plain PyTorch version, which the CPU tests
hold against the Pallas kernels in interpret mode. Ragged lengths are
masked inside the kernels, so a CUDA tensor never reaches a plain
version. Each wrapper counts its launches in `<wrapper>.launches`.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import threading

import torch
from torch.utils.flop_counter import register_flop_formula

from . import _build

_FWD, _BWD = "flash_fwd", "flash_bwd"
_HEAD_DIMS = (64, 128, 256)
# the dtypes the kernels take, by the code their C entries take for them
# (every dtype the reference's dispatch sends to its Pallas kernels)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
KERNEL_DTYPES = tuple(DTYPE_CODES)
_count_lock = threading.Lock()
_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: pointers, then ints ((bh, S, D, dtype code, causal) for the
# attention kernels, (bh, S, D, dtype code) for the passes around the
# backward), then the stream
_SIGNATURES = {"flash_fwd": (5, 5), "flash_bwd_fused": (9, 5),
               "flash_bwd_dkv": (8, 5), "flash_bwd_dq": (7, 5),
               "flash_bwd_prep": (4, 4), "flash_bwd_dq_cast": (2, 4)}


def build() -> str:
    """Compile the forward kernel's library if it is not built yet."""
    return _build.build(_FWD)


def build_bwd() -> str:
    """Compile the backward kernels' library if it is not built yet."""
    return _build.build(_BWD)


def _entry(lib: str, fn_name: str):
    """A library's C entry point, typed (built and loaded on first use).
    Two threads may both type it: they set the same signature."""
    fn = getattr(_build.load(lib), fn_name)
    if fn.argtypes is None:
        n_ptr, n_int = _SIGNATURES[fn_name]
        fn.restype = _I
        fn.argtypes = [_P] * n_ptr + [_I] * n_int + [_P]
    return fn


def _count(wrapper) -> None:
    with _count_lock:
        wrapper.launches += 1


def _launch(lib, fn_name, tensors, q, causal=None):
    """Launch a C entry on q's device and current stream: the tensors'
    pointers (None passes a null pointer), then BH, S, D, the dtype code
    and, for the attention kernels, causal."""
    bh, s, d = q.shape
    ints = [bh, s, d, DTYPE_CODES[q.dtype]]
    if causal is not None:
        ints.append(int(bool(causal)))
    ptrs = [None if x is None else x.data_ptr() for x in tensors]
    # switching devices costs more than the launch: only when needed
    on = contextlib.nullcontext() if q.device.index == \
        torch.cuda.current_device() else torch.cuda.device(q.device)
    with on:
        rc = _entry(lib, fn_name)(*ptrs, *ints,
                                  torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError_t {rc} "
                           f"(BH={bh}, S={s}, D={d}, dtype={q.dtype})")


def flash_attention_fwd_plain(q, k, v, causal=False):
    """Plain PyTorch version of the forward kernel. q/k/v: [BH, S, D] ->
    (out [BH, S, D] in q's dtype, lse [BH, 1, S] f32): f32
    softmax(q k^T / sqrt(D)) with the -1e30 causal mask, lse =
    logsumexp of the scaled scores."""
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.matmul(p, v.float()).to(q.dtype)
    return out, lse[:, None, :]


def _scores(q, k, causal):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~keep, -1e30)
    return s


def _delta(do, o):
    """rowsum(dO * O) as [BH, S] f32: the softmax-grad correction term."""
    return (do.float() * o.float()).sum(-1)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False):
    """Plain PyTorch version of the backward kernels, not autograd of the
    plain forward: it recomputes p = exp(s - lse) from the saved lse and
    takes delta = rowsum(dO * O), as the kernels do, all in f32.
    Returns (dq, dk, dv) in the input dtypes."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal) - lse.float().reshape(
        q.shape[0], q.shape[1], 1))
    dof = do.float()
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    ds = p * (dp - _delta(do, o)[..., None])
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(name, *tensors):
    q = tensors[0]
    if q.dim() != 3 or any(x.shape != q.shape for x in tensors[1:]):
        raise ValueError(f"{name}: q/k/v must share one [BH, S, D] shape, "
                         f"got {[tuple(x.shape) for x in tensors]}")
    if q.dtype not in KERNEL_DTYPES or \
            any(x.dtype != q.dtype for x in tensors[1:]):
        raise TypeError(f"{name}: fp32, bf16 or fp16 q/k/v of one dtype, "
                        f"got {[x.dtype for x in tensors]}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {q.shape[-1]} not in "
                         f"{_HEAD_DIMS}")
    if not 1 <= q.shape[0] <= 65535:
        raise ValueError(f"{name}: BH={q.shape[0]} outside [1, 65535]")
    for x in tensors:
        if x.device != q.device:
            raise ValueError(f"{name}: inputs on {x.device} and {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and 16-byte "
                             "aligned")


def _on_cuda(name, q) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {q.device}")


def flash_attention_fwd(q, k, v, causal=False):
    """q/k/v: [BH, S, D] -> (out [BH, S, D], lse [BH, 1, S] f32).

    CUDA tensors launch the kernel on the current stream (counted in
    `flash_attention_fwd.launches`); CPU tensors take the plain version."""
    if not _on_cuda("flash_fwd", q):
        return flash_attention_fwd_plain(q, k, v, causal)
    _check("flash_fwd", q, k, v)
    bh, s, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, 1, s), dtype=torch.float32, device=q.device)
    _launch(_FWD, "flash_fwd", (q, k, v, out, lse), q, causal)
    _count(flash_attention_fwd)
    return out, lse


def flash_bwd_prep(do, o, workspace=False):
    """The pass before a backward (the prep kernel of `csrc/flash_bwd.cu`):
    delta = rowsum(dO * O) as [BH, S] f32 from dO, O [BH, S, D] and, with
    `workspace`, a zeroed f32 [BH, S, D] buffer (the fused form's dq
    workspace, the ring's dq accumulator), in one pass. CPU tensors take
    `_delta` and `torch.zeros`."""
    if not _on_cuda("flash_bwd_prep", do):
        return _delta(do, o), torch.zeros(do.shape, dtype=torch.float32) \
            if workspace else None
    _check("flash_bwd_prep", do, o)
    delta = torch.empty(do.shape[:2], dtype=torch.float32, device=do.device)
    dq_ws = torch.empty(do.shape, dtype=torch.float32, device=do.device) \
        if workspace else None
    _launch(_BWD, "flash_bwd_prep", (do, o, delta, dq_ws), do)
    return delta, dq_ws


def _bwd_inputs(name, q, k, v, o, lse, do, workspace=False):
    """Checks the backward's inputs and runs `flash_bwd_prep`."""
    _check(name, q, k, v, o, do)
    if lse.shape != (q.shape[0], 1, q.shape[1]) or \
            lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"{name}: lse must be a contiguous f32 "
                         f"[BH, 1, S], got {tuple(lse.shape)} {lse.dtype}")
    return flash_bwd_prep(do, o, workspace)


def flash_attention_bwd_fused(q, k, v, o, lse, do, causal=False):
    """One pass over the (q, k) tiles for dq, dk, dv. dq is summed across
    the key-block CTAs with f32 atomics into a zeroed workspace, so it is
    not bitwise reproducible; a pass after the kernel scales and casts it."""
    if not _on_cuda("flash_bwd_fused", q):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    delta, dq_ws = _bwd_inputs("flash_bwd_fused", q, k, v, o, lse, do,
                               workspace=True)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(_BWD, "flash_bwd_fused", (q, k, v, do, lse, delta, dq_ws, dk, dv),
            q, causal)
    _count(flash_attention_bwd_fused)
    dq = torch.empty_like(q)
    _launch(_BWD, "flash_bwd_dq_cast", (dq_ws, dq), q)
    return dq, dk, dv


def flash_attention_bwd_dq(q, k, v, o, lse, do, causal=False):
    """dq of the two-pass form: one CTA per q block, no atomics."""
    if not _on_cuda("flash_bwd_dq", q):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal)[0]
    delta, _ = _bwd_inputs("flash_bwd_dq", q, k, v, o, lse, do)
    dq = torch.empty_like(q)
    _launch(_BWD, "flash_bwd_dq", (q, k, v, do, lse, delta, dq), q, causal)
    _count(flash_attention_bwd_dq)
    return dq


def flash_attention_bwd_dkv(q, k, v, o, lse, do, causal=False):
    """(dk, dv) of the two-pass form: one CTA per key block."""
    if not _on_cuda("flash_bwd_dkv", q):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal)[1:]
    delta, _ = _bwd_inputs("flash_bwd_dkv", q, k, v, o, lse, do)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(_BWD, "flash_bwd_dkv", (q, k, v, do, lse, delta, dk, dv), q,
            causal)
    _count(flash_attention_bwd_dkv)
    return dk, dv


def flash_attention_bwd_two_pass(q, k, v, o, lse, do, causal=False):
    """The deterministic form: the dq kernel, then the dk/dv kernel."""
    if not _on_cuda("flash_bwd_two_pass", q):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    dq = flash_attention_bwd_dq(q, k, v, o, lse, do, causal)
    return (dq, *flash_attention_bwd_dkv(q, k, v, o, lse, do, causal))


for _wrapper in (flash_attention_fwd, flash_attention_bwd_fused,
                 flash_attention_bwd_dq, flash_attention_bwd_dkv):
    _wrapper.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, causal=False):
    """`_flash_core_bwd`: the fused form, or the two-pass form when
    `torch.are_deterministic_algorithms_enabled()`."""
    if torch.are_deterministic_algorithms_enabled():
        return flash_attention_bwd_two_pass(q, k, v, o, lse, do, causal)
    return flash_attention_bwd_fused(q, k, v, o, lse, do, causal)


# The kernels as two registered operators, `paddle_tpu_torch::flash_fwd`
# and `paddle_tpu_torch::flash_bwd`: the counterpart of the `custom_vjp`
# `_flash_core` (:406-439). The forward saves (q, k, v, out, lse) as
# `_flash_core_fwd` does. As operators they are visible to the dispatcher:
# a selective-checkpoint policy can name the forward and keep its output
# (the reference's `checkpoint_name(o, "flash_attn_out")`,
# `models/ernie.py:419-420`), and `FlopCounterMode` counts both through
# the formulas registered below.
@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """[BH, S, D] q/k/v -> (out, lse [BH, 1, S] f32): `flash_attention_fwd`."""
    return flash_attention_fwd(q, k, v, causal)


@flash_fwd_op.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q), q.new_empty((q.shape[0], 1, q.shape[1]),
                                            dtype=torch.float32)


@torch.library.custom_op("paddle_tpu_torch::flash_bwd", mutates_args=())
def flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                 causal: bool) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv): `flash_attention_bwd`."""
    return flash_attention_bwd(q, k, v, o, lse, do, causal)


@flash_bwd_op.register_fake
def _(q, k, v, o, lse, do, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _fwd_setup(ctx, inputs, output):
    q, k, v, causal = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.causal = causal


def _fwd_backward(ctx, do, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_bwd_op(q, k, v, out, lse, do.contiguous(), ctx.causal)
    return dq, dk, dv, None


flash_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)


def _attention_flops(q_shape, causal, products):
    """2 FLOPs per multiply-add, D per product and visible (q, k) pair:
    4·BH·S²·D forward (2 products), 10·BH·S²·D fused backward (5),
    halved when causal."""
    bh, s, d = q_shape
    flops = 2 * products * bh * s * s * d
    return flops // 2 if causal else flops


@register_flop_formula(torch.ops.paddle_tpu_torch.flash_fwd)
def _(q_shape, k_shape, v_shape, causal, *args, out_shape=None, **kwargs):
    return _attention_flops(q_shape, causal, 2)


@register_flop_formula(torch.ops.paddle_tpu_torch.flash_bwd)
def _(q_shape, *args, out_shape=None, **kwargs):
    return _attention_flops(q_shape, args[-1], 5)


def flash_attention_arrays(q, k, v, causal=False):
    """q/k/v: [B, S, H, D] (paddle layout). Returns [B, S, H, D];
    differentiable through `flash_fwd_op` on every device."""
    b, s, h, d = q.shape
    if k.shape[1] != s or v.shape[1] != s:
        raise ValueError(
            f"flash_attention requires q/k/v to share seq_len; got q={s}, "
            f"k={k.shape[1]}, v={v.shape[1]} (cross-length attention takes "
            "the fused path)")
    # the products need one operand dtype (e.g. an fp32 KV cache against
    # bf16 activations): promote once at the boundary
    ct = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    q, k, v = q.to(ct), k.to(ct), v.to(ct)

    def to_bhsd(x):
        return x.transpose(1, 2).reshape(b * h, s, d).contiguous()

    out, _ = flash_fwd_op(to_bhsd(q), to_bhsd(k), to_bhsd(v), bool(causal))
    return out.reshape(b, h, s, d).transpose(1, 2)


# torch tensors carry their own tape: the tensor-level entry that nn
# attention calls is the array function itself
flash_attention = flash_attention_arrays

__all__ = ["build", "build_bwd", "flash_attention", "flash_attention_arrays",
           "flash_attention_fwd", "flash_attention_fwd_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_bwd_fused", "flash_attention_bwd_two_pass",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_bwd_prep", "flash_fwd_op", "flash_bwd_op", "DTYPE_CODES",
           "KERNEL_DTYPES"]
