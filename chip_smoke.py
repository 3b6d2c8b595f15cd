"""Chip smoke test of the PyTorch/CUDA port (`paddle_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
last line is printed):

  1. device  - the card's name and power limit from nvidia-smi;
  2. build   - every kernel of the training, serving and sequence-parallel
               paths built from the sources in the checkout (one nvcc per
               source, all started together);
  3. kernels - each kernel held against its plain PyTorch version on the
               card, at the shapes the main paths give it and at the other
               shapes it accepts, with its time through the wrapper and on
               the device alone (a CUDA graph), its plain version's, the
               PyTorch library call's (also both ways) and the least time
               the card could take; the fused and the two-pass backward
               held against each other, the backward's prep pass (delta,
               the zeroed dq workspace) against its plain version. The three ring-attention block kernels: at the sp
               train's hop (BH 96, 128 x 128, non-causal), causal hops on
               the diagonal, in the past and in the future (exact zeros
               and -1e30), an offset off the tile grid, Sq != Sk, D 128
               and 256, and fp32;
  4. ring    - sequence_parallel_attention(impl="ring", causal=True) over
               a mesh of four slots at B=1, S=4096, H=12, D=64 in bf16,
               forward and backward, against the single-device flash
               attention on the same q/k/v, with 16 launches of each ring
               kernel;
  5. train   - GPTForCausalLM(gpt2_small(dropout=0.0)) at full width and
               depth, fp32 master weights drawn from a seed, trained in
               bf16 AMP on 8 x 1024 tokens through jit.TrainStep + AdamW:
               the step-1 gradients against the same weights in fp32 and
               against the deterministic two-pass backward, then one
               warm-up step, 5 __call__ steps, a run() span of 5 steps and
               one step under torch.use_deterministic_algorithms. Every
               attention forward and backward must go through the kernels
               (launch counts) and the loss must fall;
  6. serve   - the same model at full width in bf16, served through
               Predictor -> ServingEngine: 8 requests of 1024 tokens from
               4 threads. Every attention call must go through the kernel
               (launch counts), and one request's logits must match the
               same model run in float32;
  7. sp train - ErnieForPretraining(ernie_base(use_sp=True)) at full width
               and depth, trained in bf16 AMP on 8 x 512 tokens through
               jit.TrainStep + AdamW with the MLM + NSP loss, under
               HybridCommunicateGroup(sp_degree=4) over four slots of one
               card (or four cards when there are four): the step-1 loss
               and gradients against the same weights in fp32 without sp,
               then one warm-up step, 5 __call__ steps and a run() span of
               15. Every attention call must go through the ring kernels
               (12 x 16 launches of each per step, none of the flash
               kernels) and the loss must fall.

The last two lines are a JSON summary of the kernels and
`{"ok": true, "device": {...}}`. Imports nothing of JAX.
"""
from __future__ import annotations

import concurrent.futures
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
PEAK_BF16 = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_FP32 = 67e12       # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s
TRAIN_B, TRAIN_S = 8, 1024
SP_B, SP_S, SP_DEGREE = 8, 512, 4
# the sp train's run() span: from this seed AdamW(1e-4) lifts the loss at
# step 2 and it falls steadily only from about step 12, so the span runs
# the path past that point before "the loss fell" is read
SP_RUN = 15
RING_SRC = "paddle_tpu_torch/kernels/csrc/ring_attention.cu"
SOURCES = {"flash_fwd": "paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
           "flash_bwd_fused": "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
           "flash_bwd_dq": "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
           "flash_bwd_dkv": "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
           "ring_fwd": RING_SRC, "ring_dq": RING_SRC, "ring_dkv": RING_SRC}
REPLACES = {"flash_fwd": "paddle_tpu/kernels/flash_attention.py:58",
            "flash_bwd_fused": "paddle_tpu/kernels/flash_attention.py:732",
            "flash_bwd_dq": "paddle_tpu/kernels/flash_attention.py:239",
            "flash_bwd_dkv": "paddle_tpu/kernels/flash_attention.py:280",
            "ring_fwd": "paddle_tpu/kernels/flash_attention.py:506",
            "ring_dq": "paddle_tpu/kernels/flash_attention.py:551",
            "ring_dkv": "paddle_tpu/kernels/flash_attention.py:592"}
# products per visible (q, k) pair, in units of D multiply-adds x 2:
# forward q k^T and p v; fused backward the five of _bwd_tile_pds and its
# users; the dq pass recomputes s and dp and forms ds k; the dk/dv pass
# recomputes s and dp and forms p^T dO and ds^T q (the ring kernels alike)
PRODUCTS = {"flash_fwd": 2, "flash_bwd_fused": 5, "flash_bwd_dq": 3,
            "flash_bwd_dkv": 4, "ring_fwd": 2, "ring_dq": 3, "ring_dkv": 4}
# [BH, S, D] tensors read and written, [BH, S] f32 rows read and written
TRAFFIC = {"flash_fwd": (4, 1), "flash_bwd_fused": (7, 2),
           "flash_bwd_dq": (5, 2), "flash_bwd_dkv": (6, 2)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_name_and_limit() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def attention_bound(name, bh, s, d, itemsize, causal, peak_ops):
    """Least time (ms) for the card: each input read once, each output
    written once, over HBM bandwidth; the products' FLOPs over the peak
    for the input type. Causal counts the visible (q, k) pairs."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 2 * PRODUCTS[name] * d * pairs * bh
    mats, rows = TRAFFIC[name]
    nbytes = mats * bh * s * d * itemsize + rows * bh * s * 4
    t_ops, t_bytes = flops / peak_ops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def close_enough(got, want, tol):
    """max |got - want| and whether it is <= tol + tol * |want| everywhere."""
    err = (got.float() - want.float()).abs()
    return err.max().item(), bool((err <= tol + tol * want.float().abs())
                                  .all())


def fwd_case(fa, torch, b, s, h, d, dtype, causal):
    """Forward kernel vs plain version on one shape; the case's numbers."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.utils.cuda_timing import median_ms
    gen = torch.Generator(device="cuda").manual_seed(SEED + s + d)
    q, k, v = (torch.randn(b * h, s, d, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype) for _ in range(3))
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, causal)
    bf16 = dtype == torch.bfloat16
    # bf16: the kernel rounds p to bf16 before the PV product (as the
    # Pallas kernel does) and stores out in bf16 (2^-8 relative); the
    # plain version keeps p in f32. lse depends on f32 sums only, in
    # another order and with exp2 for exp. fp32: f32 everywhere, sums in
    # another order.
    tol_out = 2e-2 if bf16 else 1e-4
    tol_lse = 1e-3 if bf16 else 1e-4
    check(bool(torch.isfinite(out.float()).all()), f"non-finite out {s=} {d=}")
    err_out, ok_out = close_enough(out, ref_out, tol_out)
    err_lse, ok_lse = close_enough(lse, ref_lse, tol_lse)
    check(ok_out, f"flash_fwd out disagrees at {b=} {s=} {h=} {d=} {dtype} "
          f"{causal=}: max abs err {err_out}")
    check(ok_lse, f"flash_fwd lse disagrees at {b=} {s=} {h=} {d=} {dtype} "
          f"{causal=}: max abs err {err_lse}")
    q4, k4, v4 = (x.view(b, h, s, d) for x in (q, k, v))

    def kernel():
        return fa.flash_attention_fwd(q, k, v, causal)

    def library():
        return TF.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

    kernel_ms = median_ms(kernel)
    plain_ms = median_ms(
        lambda: fa.flash_attention_fwd_plain(q, k, v, causal))
    library_ms = median_ms(library)
    # the wrapper launches the kernel and allocates: its graph is the
    # kernel's device time
    device_ms, library_device_ms = graph_ms(torch, kernel), \
        graph_ms(torch, library)
    bound_ms, bound_by = attention_bound(
        "flash_fwd", b * h, s, d, q.element_size(), causal,
        PEAK_BF16 if bf16 else PEAK_FP32)
    return {"shape": [b, s, h, d], "dtype": str(dtype).replace("torch.", ""),
            "causal": causal, "max_abs_err": err_out,
            "max_abs_err_lse": err_lse, "tol_out": tol_out,
            "tol_lse": tol_lse, "ms": kernel_ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": library_device_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def bwd_case(fa, torch, b, s, h, d, dtype, causal):
    """The three backward kernels vs the plain backward, and the fused
    form vs the two-pass form, on one shape; each kernel's numbers."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.utils.cuda_timing import median_ms
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1 + s + d)
    q, k, v, do = (torch.randn(b * h, s, d, generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
                   for _ in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    args = (q, k, v, out, lse, do, causal)
    fused = fa.flash_attention_bwd_fused(*args)
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_plain(*args)
    bf16 = dtype == torch.bfloat16
    # bf16: the kernels round p and ds to bf16 before the products (as the
    # Pallas kernels do) and store bf16 gradients; the plain version keeps
    # f32 throughout. fp32: f32 everywhere, sums in another order.
    tol = 2e-2 if bf16 else 1e-4
    where = f"{b=} {s=} {h=} {d=} {dtype} {causal=}"
    errs = {}
    for kname, got in (("flash_bwd_fused", fused), ("flash_bwd_dq", (dq,)),
                       ("flash_bwd_dkv", (dk, dv))):
        want = ref if kname == "flash_bwd_fused" else \
            (ref[0],) if kname == "flash_bwd_dq" else ref[1:]
        errs[kname] = 0.0
        for g, r in zip(got, want):
            check(bool(torch.isfinite(g.float()).all()),
                  f"{kname}: non-finite gradient at {where}")
            err, ok = close_enough(g, r, tol)
            check(ok, f"{kname} disagrees with the plain backward at {where}:"
                  f" max abs err {err}")
            errs[kname] = max(errs[kname], err)
    # the fused and two-pass forms: dk, dv from the same arithmetic in the
    # same order (bit-equal); dq from f32 sums in another order (atomics
    # vs a register loop), then one rounding to the input dtype
    check(torch.equal(fused[1], dk) and torch.equal(fused[2], dv),
          f"fused and two-pass dk/dv differ at {where}")
    err_fq, ok_fq = close_enough(fused[0], dq, tol / 2)
    check(ok_fq, f"fused and two-pass dq differ at {where}: {err_fq}")
    q4, k4, v4, do4 = (x.view(b, h, s, d) for x in (q, k, v, do))
    lq, lk, lv = (x.detach().requires_grad_() for x in (q4, k4, v4))
    lout = TF.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)
    library_ms = median_ms(lambda: torch.autograd.grad(
        lout, (lq, lk, lv), do4, retain_graph=True))
    library_device_ms = sdpa_backward_device_ms(torch, TF, lq, lk, lv, do4,
                                                causal)
    plain_ms = median_ms(lambda: fa.flash_attention_bwd_plain(*args),
                         samples=10, per_sample=3, warmup=2)
    timed = {"flash_bwd_fused": lambda: fa.flash_attention_bwd_fused(*args),
             "flash_bwd_dq": lambda: fa.flash_attention_bwd_dq(*args),
             "flash_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(*args)}
    # the passes around the kernels: delta and the fused form's zeroed dq
    # workspace from the prep kernel against their plain versions (f32
    # sums of D products in another order)
    delta, dq_ws = fa._bwd_inputs("flash_bwd_prep", q, k, v, out, lse, do,
                                  workspace=True)
    err_d, ok_d = close_enough(delta, fa._delta(do, out), 1e-4)
    check(ok_d and bool((dq_ws == 0).all()),
          f"flash_bwd_prep: delta max abs err {err_d} or a non-zero "
          f"workspace at {where}")
    # the C entry points alone, on buffers made once: the wrapper adds the
    # prep pass and, for the fused form, the scale-and-cast of dq
    dq_b, dk_b, dv_b = (torch.empty_like(x) for x in (q, k, v))
    bufs = {"flash_bwd_fused": (q, k, v, do, lse, delta, dq_ws, dk_b, dv_b),
            "flash_bwd_dq": (q, k, v, do, lse, delta, dq_b),
            "flash_bwd_dkv": (q, k, v, do, lse, delta, dk_b, dv_b)}
    rows = {}
    for kname, fn in timed.items():
        entry = bufs[kname]
        device_ms = graph_ms(torch, lambda: fa._launch(
            fa._BWD, kname, entry, q, causal))
        bound_ms, bound_by = attention_bound(
            kname, b * h, s, d, q.element_size(), causal,
            PEAK_BF16 if bf16 else PEAK_FP32)
        rows[kname] = {"shape": [b, s, h, d],
                       "dtype": str(dtype).replace("torch.", ""),
                       "causal": causal, "max_abs_err": errs[kname],
                       "tol": tol, "ms": median_ms(fn),
                       "device_ms": device_ms,
                       "wrapper_device_ms": graph_ms(torch, fn),
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "library_device_ms": library_device_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by}
    rows["fused_vs_two_pass_dq_err"] = err_fq
    return rows


def ring_pairs(sq, sk, offs, causal):
    """Visible (q, k) pairs of one hop: key j is visible to row i when
    k_off + j <= q_off + i."""
    if not causal:
        return sq * sk
    q_off, k_off = offs
    return sum(min(max(q_off + i - k_off + 1, 0), sk) for i in range(sq))


def ring_bound(name, bh, sq, sk, d, itemsize, causal, offs, peak_ops):
    """Least time (ms) of one hop: the products over the visible pairs at
    the peak for the input type, against each input read once and each
    output written once (f32 dq, dk, dv at 4 bytes; a hop that sees no key
    needs no input)."""
    pairs = ring_pairs(sq, sk, offs, causal)
    flops = 2 * PRODUCTS[name] * d * pairs * bh
    qrows, krows = bh * sq * d, bh * sk * d
    if name == "ring_fwd":     # q, k, v -> out, lse
        reads = (qrows + 2 * krows) * itemsize
        writes = qrows * itemsize + bh * sq * 4
    elif name == "ring_dq":    # q, dO, k, v, lse, delta -> dq f32
        reads = (2 * qrows + 2 * krows) * itemsize + 2 * bh * sq * 4
        writes = qrows * 4
    else:                      # the same inputs -> dk, dv f32
        reads = (2 * qrows + 2 * krows) * itemsize + 2 * bh * sq * 4
        writes = 2 * krows * 4
    nbytes = writes + (reads if pairs else 0)
    t_ops, t_bytes = flops / peak_ops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def ring_case(tra, torch, bh, sq, sk, d, dtype, causal, offs):
    """The three ring kernels vs their plain versions on one hop; each
    kernel's numbers. dq and dk/dv take the plain forward's lse and delta,
    as the ring gives them the merged rows."""
    import torch.nn.functional as TF
    from paddle_tpu_torch.utils.cuda_timing import median_ms
    gen = torch.Generator(device="cuda").manual_seed(
        SEED + 2 + sq + sk + d + offs[0])
    q, do = (torch.randn(bh, sq, d, generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(bh, sk, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    out, lse = tra.ring_block_fwd(q, k, v, offs, causal)
    ref_out, ref_lse = tra.ring_block_fwd_plain(q, k, v, offs, causal)
    delta = (do.float() * ref_out.float()).sum(-1)[:, None, :]
    bargs = (q, k, v, do, ref_lse, delta, offs, causal)
    dq = tra.ring_block_dq(*bargs)
    dk, dv = tra.ring_block_dkv(*bargs)
    torch.cuda.synchronize()
    ref_dq = tra.ring_block_dq_plain(*bargs)
    ref_dk, ref_dv = tra.ring_block_dkv_plain(*bargs)
    bf16 = dtype == torch.bfloat16
    # bf16: the kernels round p (and ds) to bf16 before the products, as
    # the Pallas kernels do, and store out in bf16; the plain versions keep
    # f32. fp32: sums in another order.
    tol = 2e-2 if bf16 else 1e-4
    where = f"BH={bh} Sq={sq} Sk={sk} D={d} {dtype} {causal=} {offs=}"
    errs = {}
    for kname, pairs in (("ring_fwd", ((out, ref_out), (lse, ref_lse))),
                         ("ring_dq", ((dq, ref_dq),)),
                         ("ring_dkv", ((dk, ref_dk), (dv, ref_dv)))):
        errs[kname] = 0.0
        for got, want in pairs:
            check(bool(torch.isfinite(got.float()).all()),
                  f"{kname}: non-finite output at {where}")
            err, ok = close_enough(got, want, tol)
            check(ok, f"{kname} disagrees with its plain version at {where}:"
                  f" max abs err {err}")
            errs[kname] = max(errs[kname], err)
    future = causal and offs[1] >= offs[0] + sq
    if future:
        check(all(bool((x == 0).all()) for x in (out, dq, dk, dv)) and
              bool((lse == -1e30).all()),
              f"the future hop did not write exact zeros and -1e30 at {where}")
    # the library yardstick where one SDPA call computes the same out: a
    # hop that sees every key (non-causal, or wholly in the past) or the
    # diagonal hop
    lib_causal = None
    if not causal or offs[0] >= offs[1] + sk - 1:
        lib_causal = False
    elif offs[0] == offs[1] and sq == sk:
        lib_causal = True
    lib_fwd = lib_bwd = lib_fwd_dev = lib_bwd_dev = None
    if lib_causal is not None:
        q4, k4, v4, do4 = (x.view(1, bh, x.shape[1], d) for x in (q, k, v, do))

        def library():
            return TF.scaled_dot_product_attention(q4, k4, v4,
                                                   is_causal=lib_causal)

        lib_fwd, lib_fwd_dev = median_ms(library), graph_ms(torch, library)
        lq, lk, lv = (x.detach().requires_grad_() for x in (q4, k4, v4))
        lout = TF.scaled_dot_product_attention(lq, lk, lv,
                                               is_causal=lib_causal)
        lib_bwd = median_ms(lambda: torch.autograd.grad(
            lout, (lq, lk, lv), do4, retain_graph=True))
        lib_bwd_dev = sdpa_backward_device_ms(torch, TF, lq, lk, lv, do4,
                                              lib_causal)
    timed = {
        "ring_fwd": (lambda: tra.ring_block_fwd(q, k, v, offs, causal),
                     lambda: tra.ring_block_fwd_plain(q, k, v, offs, causal),
                     lib_fwd, lib_fwd_dev),
        "ring_dq": (lambda: tra.ring_block_dq(*bargs),
                    lambda: tra.ring_block_dq_plain(*bargs), lib_bwd,
                    lib_bwd_dev),
        "ring_dkv": (lambda: tra.ring_block_dkv(*bargs),
                     lambda: tra.ring_block_dkv_plain(*bargs), lib_bwd,
                     lib_bwd_dev)}
    rows = {}
    for kname, (fn, plain, lib, lib_dev) in timed.items():
        bound_ms, bound_by = ring_bound(kname, bh, sq, sk, d,
                                        q.element_size(), causal, offs,
                                        PEAK_BF16 if bf16 else PEAK_FP32)
        rows[kname] = {"shape": [bh, sq, sk, d], "offs": list(offs),
                       "dtype": str(dtype).replace("torch.", ""),
                       "causal": causal, "max_abs_err": errs[kname],
                       "tol": tol, "ms": median_ms(fn),
                       "device_ms": graph_ms(torch, fn),
                       "plain_ms": median_ms(plain, samples=10),
                       "library_ms": lib, "library_device_ms": lib_dev,
                       "bound_ms": bound_ms,
                       "bound_by": bound_by, "future": future}
    return rows


def graph_ms(torch, fn, calls=20, samples=10, stream=None):
    """Device time of one call of `fn` without the host's cost per call:
    `calls` calls captured in one CUDA graph, the graph replayed and timed
    with CUDA events (median of `samples` replays). `median_ms` times the
    wrapper as a caller sees it, host work included; for a kernel of a few
    microseconds the two differ by the host's launch cost."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    del graph
    return statistics.median(times)


def sdpa_backward_device_ms(torch, TF, q, k, v, do, causal):
    """Device time of PyTorch's SDPA backward on these inputs: a CUDA
    graph of forward + backward less a graph of the forward alone. The
    leaves are made on the capturing stream, so that the backward's
    gradient nodes run on it too."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))

    def fwd():
        return TF.scaled_dot_product_attention(q, k, v, is_causal=causal)

    def fwd_bwd():
        return torch.autograd.grad(fwd(), (q, k, v), do)

    try:
        return graph_ms(torch, fwd_bwd, stream=stream) - \
            graph_ms(torch, fwd, stream=stream)
    except Exception as e:  # noqa: BLE001 — a yardstick only: not measured
        print(f"chip_smoke: SDPA backward not captured in a CUDA graph: {e}",
              file=sys.stderr, flush=True)
        torch.cuda.synchronize()
        return None


def fmt_ms(x):
    return "not measured" if x is None else f"{x:.4f}"


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    na, nb = a.norm().item(), b.norm().item()
    return 1.0 if na == nb == 0 else (a @ b).item() / (na * nb)


def train_phase(pt, fa, torch, np, card, shape_rows):
    """gpt2_small trained in bf16 AMP through jit.TrainStep + AdamW."""
    from paddle_tpu_torch.jit import amp_functional_call, split_state
    pt.set_device("gpu")
    pt.seed(SEED)
    model = pt.models.GPTForCausalLM(pt.models.gpt2_small(dropout=0.0))
    n_layers = len(model.gpt.layers)
    vocab = model.gpt.embeddings.word_embeddings.weight.shape[0]
    crit = pt.models.GPTPretrainingCriterion()
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters())
    step = pt.jit.TrainStep(model, crit, opt, amp_dtype="bfloat16")
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(0, vocab, (TRAIN_B, TRAIN_S))).cuda()
    trainable, frozen = split_state(model)
    pnames, ps = list(trainable), list(trainable.values())
    bnames, bufs = list(frozen), list(frozen.values())
    n_params = sum(p.numel() for p in ps)

    def grads_of(amp_dtype, deterministic=False):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.use_deterministic_algorithms(deterministic, warn_only=True)
            try:
                with torch.enable_grad():
                    logits = amp_functional_call(model, pnames, ps, bnames,
                                                 bufs, [ids], amp_dtype)
                    loss = crit(logits, ids)
                    grads = torch.autograd.grad(loss, ps)
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
        return float(loss.detach()), [g.float() for g in grads]

    # ---- step-1 gradients: bf16 kernels (fused and two-pass) vs fp32 ----
    # fp32 at S=1024 takes the einsum path (the kernel from S=4096): no
    # kernel, the reference of the check
    loss32, g32 = grads_of(None)
    loss_f, g_f = grads_of("bfloat16")
    loss_d, g_d = grads_of("bfloat16", deterministic=True)
    rel = abs(loss_f - loss32) / abs(loss32)
    cos_32 = min((cosine(a, b), n) for a, b, n in zip(g_f, g32, pnames))
    cos_fd = min((cosine(a, b), n) for a, b, n in zip(g_f, g_d, pnames))
    print(f"train: step-1 loss fp32 {loss32:.6f} bf16 fused {loss_f:.6f} "
          f"bf16 two-pass {loss_d:.6f}; rel err bf16 vs fp32 {rel:.3g} "
          f"(tol 2e-2); min per-parameter grad cosine bf16 vs fp32 "
          f"{cos_32[0]:.6f} ({cos_32[1]}, tol 0.99), fused vs two-pass "
          f"{cos_fd[0]:.6f} ({cos_fd[1]}, tol 0.999) [{card}]", flush=True)
    # bf16 weights, activations, logits and loss (2^-8 relative per
    # rounding) through 12 post-LN layers against fp32
    check(rel <= 2e-2, f"bf16 vs fp32 step-1 loss rel err {rel}")
    check(cos_32[0] >= 0.99, f"bf16 vs fp32 gradient cosine {cos_32}")
    # the two forms differ only in the order of dq's f32 sums, which then
    # flows back through bf16 layers
    check(loss_d == loss_f, f"two-pass step changed the loss: {loss_d} vs "
          f"{loss_f}")
    check(cos_fd[0] >= 0.999, f"fused vs two-pass gradient cosine {cos_fd}")
    del g32, g_f, g_d
    torch.cuda.empty_cache()

    # ---- the main path: TrainStep through its entry points ----
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_fused,
                fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    t_start = time.perf_counter()
    losses = [step(ids, ids)]                       # warm-up step
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_start
    events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    t_calls = time.perf_counter()
    events[0].record()
    for i in range(5):
        losses.append(step(ids, ids))
        events[i + 1].record()
    torch.cuda.synchronize()
    calls_s = time.perf_counter() - t_calls
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(5)]
    stacked = ids.expand(5, TRAIN_B, TRAIN_S)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    span = step.run(stacked, stacked)
    e1.record()
    torch.cuda.synchronize()
    run_ms = e0.elapsed_time(e1) / 5
    losses.extend(span.unbind(0))
    before = [c.launches for c in counters]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            det_loss = float(step(ids, ids))
        finally:
            torch.use_deterministic_algorithms(False)
    det = [c.launches - n for c, n in zip(counters, before)]
    launches = {name: c.launches for name, c in zip(
        ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"),
        counters)}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_steps = 1 + 5 + 5 + 1
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses + [det_loss]),
          f"non-finite loss: {losses} {det_loss}")
    check(losses[-1] < losses[0], f"the loss did not fall over 10 steps on "
          f"the repeated batch: {losses}")
    check(launches["flash_fwd"] == n_layers * n_steps,
          f"flash_fwd launched {launches['flash_fwd']} times in "
          f"{n_steps} steps of {n_layers} layers")
    check(launches["flash_bwd_fused"] == n_layers * (n_steps - 1),
          f"flash_bwd_fused launched {launches['flash_bwd_fused']} times")
    check(det == [n_layers, 0, n_layers, n_layers],
          f"the deterministic step launched {det} (fwd, fused, dq, dkv)")

    # ---- where one step's device time goes (outside the counted run) ----
    values = [p.detach().clone() for p in ps]
    slots = opt.init_state(ps)
    split = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        with torch.enable_grad():
            logits = amp_functional_call(model, pnames, ps, bnames, bufs,
                                         [ids], "bfloat16")
            loss = crit(logits, ids)
        ev[1].record()
        grads = torch.autograd.grad(loss, ps)
        ev[2].record()
        opt.functional_update(values, grads, slots, opt.get_lr(), 2.0,
                              params_meta=ps)
        ev[3].record()
        torch.cuda.synchronize()
        for j, key in enumerate(split):
            split[key].append(ev[j].elapsed_time(ev[j + 1]))
        del logits, loss, grads
    split = {k: statistics.median(v[1:]) for k, v in split.items()}
    med_ms = statistics.median(step_ms)
    tokens = TRAIN_B * TRAIN_S
    # 6 FLOPs per parameter per token (the embedding table counted once, as
    # the tied head) plus causal attention's forward and backward products
    bh, d = TRAIN_B * model.gpt.layers[0].attention.num_heads, \
        model.gpt.layers[0].attention.head_dim
    pairs = TRAIN_S * (TRAIN_S + 1) // 2
    pos = model.gpt.embeddings.position_embeddings.weight.numel()
    step_flops = 6 * (n_params - pos) * tokens + n_layers * 2 * (
        PRODUCTS["flash_fwd"] + PRODUCTS["flash_bwd_fused"]) * d * pairs * bh
    fwd_row = shape_rows["fwd"]
    bwd_row = shape_rows["flash_bwd_fused"]
    attn_ms = n_layers * (fwd_row["device_ms"] +
                          bwd_row["wrapper_device_ms"])
    print(f"train: gpt2_small bf16 AMP {TRAIN_B}x{TRAIN_S} tokens, "
          f"{n_params} parameters, AdamW(1e-4): losses "
          f"{[round(x, 4) for x in losses]} then {det_loss:.4f} "
          f"(deterministic step) [{card}]", flush=True)
    print(f"train: step time median {med_ms:.3f} ms over 5 __call__ steps "
          f"(CUDA events; {[round(x, 3) for x in step_ms]}), run() "
          f"{run_ms:.3f} ms per step over 5; tokens/s "
          f"{tokens / med_ms * 1e3:.1f}; warm-up step {warm_s * 1e3:.1f} ms "
          f"host; 5 calls {calls_s * 1e3:.1f} ms host; step bound "
          f"{step_flops / PEAK_BF16 * 1e3:.3f} ms ({step_flops / 1e12:.3f} "
          f"TFLOP at 989 TFLOP/s), model FLOP utilisation "
          f"{step_flops / (med_ms * 1e-3) / PEAK_BF16:.3f} [{card}]",
          flush=True)
    print(f"train: one step's device time: forward {split['forward']:.3f} ms"
          f", backward {split['backward']:.3f} ms, optimizer "
          f"{split['optimizer']:.3f} ms (CUDA events, median of 3); "
          f"attention ~{attn_ms:.3f} ms of it ({n_layers} x (fwd "
          f"{fwd_row['device_ms']:.4f} + fused bwd wrapper "
          f"{bwd_row['wrapper_device_ms']:.4f}) ms, CUDA graphs at this "
          f"shape); peak max_memory_allocated "
          f"{peak_gib:.2f} GiB [{card}]", flush=True)
    print(f"train: attention launches in {n_steps} steps: {launches} "
          f"(deterministic step: fwd, fused, dq, dkv = {det}) [{card}]",
          flush=True)
    del step, opt, model, values, slots
    torch.cuda.empty_cache()
    return launches


def serve_phase(pt, fa, torch, np, card):
    """gpt2_small in bf16 through Predictor -> ServingEngine."""
    pt.set_device("gpu")
    pt.seed(SEED)
    model32 = pt.models.GPTForCausalLM(pt.models.gpt2_small())
    model32.eval()
    model = copy.deepcopy(model32).bfloat16()
    n_layers = len(model.gpt.layers)
    vocab = model.gpt.embeddings.word_embeddings.weight.shape[0]
    seq = 1024
    pred = pt.inference.Predictor(
        model, input_spec=[pt.InputSpec([4, seq], "int32")])
    engine = pt.serving.ServingEngine(pred, pt.serving.EngineConfig(
        max_batch_size=4, batch_sizes=(1, 2, 4), batch_timeout_ms=20.0))
    rng = np.random.default_rng(SEED)
    requests = [rng.integers(0, vocab, (1, seq)).astype(np.int32)
                for _ in range(8)]
    results_by_req = [None] * len(requests)
    latencies = [None] * len(requests)
    errors = []

    def client(idxs):
        try:
            for i in idxs:
                t = time.perf_counter()
                results_by_req[i] = engine.submit([requests[i]]).result(600)
                latencies[i] = time.perf_counter() - t
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd.launches = 0
    t_start = time.perf_counter()
    engine.start()
    t_warm = time.perf_counter()
    threads = [threading.Thread(target=client, args=([2 * j, 2 * j + 1],))
               for j in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t_warm
    engine.stop(drain=True)
    launches = fa.flash_attention_fwd.launches
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    check(not any(t.is_alive() for t in threads), "client threads hung")
    check(not errors, f"requests failed: {errors}")
    counts = engine.stats()["counters"]
    dispatched = counts["batches"] + counts["warmup_runs"]
    check(counts["completed"] == len(requests),
          f"completed {counts['completed']} of {len(requests)}")
    check(launches == n_layers * dispatched and launches > 0,
          f"attention kernel launched {launches} times for {dispatched} "
          f"batches of {n_layers} layers")
    for i, out in enumerate(results_by_req):
        logits = out[0][0]
        check(logits.shape == (seq, vocab) and logits.dtype == np.float32,
              f"request {i}: logits {logits.shape} {logits.dtype}")
        check(bool(np.isfinite(logits).all()), f"request {i}: non-finite")

    # one request against the same weights in float32 (at S=1024 fp32
    # attention takes the einsum path: no kernel)
    with torch.inference_mode():
        ref = model32(torch.from_numpy(requests[0]).cuda())[0].cpu().numpy()
    got = results_by_req[0][0][0]
    rel = float(np.abs(got - ref).mean() / np.abs(ref).mean())
    top1 = float((got.argmax(-1) == ref.argmax(-1)).mean())
    # bf16 weights and activations (2^-8 relative rounding per step) across
    # 12 post-LN layers, against fp32: relative mean-abs error <= 2e-2
    check(rel <= 2e-2, f"bf16 serve vs fp32 relative mean-abs error {rel}")
    # where a batch's time goes: the model on the device vs the whole
    # run_batch (adds the bf16->f32 logits copy to the host)
    from paddle_tpu_torch.utils.cuda_timing import median_ms
    batch4 = [np.concatenate(requests[:4])]
    fwd_ms = median_ms(lambda: pred._forward(batch4), samples=5,
                       per_sample=2, warmup=1)
    t = time.perf_counter()
    pred.run_batch(batch4)
    run_batch_ms = (time.perf_counter() - t) * 1e3
    print(f"serve breakdown: batch of 4 x {seq} tokens: model forward on "
          f"the device {fwd_ms:.2f} ms, run_batch (forward + logits to "
          f"host as f32) {run_batch_ms:.1f} ms [{card}]", flush=True)

    lat_ms = sorted(x * 1e3 for x in latencies)
    p50 = lat_ms[len(lat_ms) // 2]
    p99 = lat_ms[min(len(lat_ms) - 1, math.ceil(0.99 * len(lat_ms)) - 1)]
    print(f"serve: gpt2_small bf16 S={seq}: {len(requests)} requests in "
          f"{wall:.3f} s after {1e3 * (t_warm - t_start):.0f} ms warm-up "
          f"({counts['warmup_runs']} runs); batches={counts['batches']} "
          f"requests/s={len(requests) / wall:.3f} "
          f"tokens/s={len(requests) * seq / wall:.1f} p50_ms={p50:.1f} "
          f"p99_ms={p99:.1f} peak_mem_mib={peak_mib:.0f} "
          f"attention_launches={launches} ({n_layers} x {dispatched} "
          f"batches) vs_fp32_rel_mean_abs_err={rel:.3g} top1_agree={top1:.4f}"
          f" [{card}]", flush=True)
    return launches


def ring_phase(fa, tra, torch, card, devices):
    """The 4-slot causal flash ring at S=4096 against single-device flash
    attention on the same q/k/v, forward and backward."""
    from paddle_tpu_torch.parallel import create_mesh, set_mesh, sp
    from paddle_tpu_torch.utils.cuda_timing import median_ms
    b, s, h, d = 1, 4096, 12, 64
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    base = [torch.randn(b, s, h, d, generator=gen, device="cuda").bfloat16()
            for _ in range(3)]
    w = torch.randn(b, s, h, d, generator=gen, device="cuda")
    mesh = create_mesh({"sp": SP_DEGREE}, devices=devices)
    set_mesh(None)

    def ring(q, k, v):
        return sp.sequence_parallel_attention(q, k, v, impl="ring",
                                              causal=True, mesh=mesh)

    def flash(q, k, v):
        return fa.flash_attention(q, k, v, causal=True)

    def fwd_bwd(fn):
        q, k, v = (x.detach().requires_grad_() for x in base)
        out = fn(q, k, v)
        grads = torch.autograd.grad((out.float() * w).sum(), (q, k, v))
        return out, grads

    wrappers = (tra.ring_block_fwd, tra.ring_block_dq, tra.ring_block_dkv)
    before = [c.launches for c in wrappers]
    out, grads = fwd_bwd(ring)
    torch.cuda.synchronize()
    launched = [c.launches - n for c, n in zip(wrappers, before)]
    ref, ref_grads = fwd_bwd(flash)
    torch.cuda.synchronize()
    check(launched == [SP_DEGREE ** 2] * 3,
          f"the 4-slot ring launched {launched} (fwd, dq, dkv), not 16 each")
    # both in bf16 with f32 accumulation; they tile the sequence and round
    # p to bf16 at different places
    err_out, ok = close_enough(out, ref, 2e-2)
    check(ok, f"ring vs flash attention out: max abs err {err_out}")
    verdicts = []
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        err, ok = close_enough(g, r, 2e-2)
        cos = cosine(g.float(), r.float())
        check(ok or cos >= 0.999, f"ring vs flash {name}: max abs err {err}"
              f", cosine {cos}")
        verdicts.append(f"{name} max abs err {err:.3g} cosine {cos:.6f} "
                        f"({'elementwise 2e-2(1+|ref|)' if ok else 'cosine >= 0.999'})")
    ring_ms = median_ms(lambda: fwd_bwd(ring), samples=5, per_sample=2,
                        warmup=1)
    flash_ms = median_ms(lambda: fwd_bwd(flash), samples=5, per_sample=2,
                         warmup=1)
    print(f"ring: causal sp={SP_DEGREE} ring over {len(set(devices))} "
          f"device(s) at B={b} S={s} H={h} D={d} bf16 (s_loc "
          f"{s // SP_DEGREE}) vs single-device flash attention: out max abs"
          f" err {err_out:.3g} (tol 2e-2(1+|ref|)); {'; '.join(verdicts)}; "
          f"launches fwd, dq, dkv = {launched}; forward+backward "
          f"{ring_ms:.3f} ms ring vs {flash_ms:.3f} ms flash (CUDA events) "
          f"[{card}]", flush=True)


def sp_train_phase(pt, fa, tra, torch, np, card, devices):
    """ERNIE-base pretraining with the sp=4 ring through TrainStep."""
    from paddle_tpu_torch.jit import amp_functional_call, split_state
    pt.set_device("gpu")
    pt.seed(SEED)
    pt.parallel.HybridCommunicateGroup(
        hybrid_configs={"sp_degree": SP_DEGREE}, devices=devices)
    net = pt.models.ErnieForPretraining(
        pt.models.ernie_base(hidden_dropout_prob=0.0, use_sp=True))
    layers = net.ernie.layers
    n_layers = len(layers)
    vocab = net.ernie.embeddings.word_embeddings.weight.shape[0]
    ce = pt.nn.CrossEntropyLoss()

    def loss_fn(logits, nsp_logits, ids, nsp):       # bench.py:203-205
        v = logits.shape[-1]
        return ce(logits.reshape(-1, v), ids.reshape(-1)) + \
            ce(nsp_logits, nsp)

    opt = pt.optimizer.AdamW(learning_rate=1e-4, parameters=net.parameters())
    step = pt.jit.TrainStep(net, loss_fn, opt, amp_dtype="bfloat16",
                            n_model_inputs=1)
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(0, vocab, (SP_B, SP_S))).cuda()
    nsp = torch.from_numpy(rng.integers(0, 2, (SP_B,))).cuda()
    trainable, frozen = split_state(net)
    pnames, ps = list(trainable), list(trainable.values())
    bnames, bufs = list(frozen), list(frozen.values())
    n_params = sum(p.numel() for p in ps)

    def grads_of(amp_dtype, use_sp):
        for layer in layers:
            layer.attention.use_sp = use_sp
        try:
            with torch.enable_grad():
                logits, nsp_logits = amp_functional_call(
                    net, pnames, ps, bnames, bufs, [ids], amp_dtype)
                loss = loss_fn(logits, nsp_logits, ids, nsp)
                grads = torch.autograd.grad(loss, ps)
            torch.cuda.synchronize()
        finally:
            for layer in layers:
                layer.attention.use_sp = True
        return float(loss.detach()), [g.float() for g in grads]

    # ---- step-1: bf16 through the ring kernels vs fp32 without sp ----
    # fp32 at S=512 without sp takes the einsum path: no kernel
    loss32, g32 = grads_of(None, False)
    loss_sp, g_sp = grads_of("bfloat16", True)
    rel = abs(loss_sp - loss32) / abs(loss32)
    cos = min((cosine(a, b), n) for a, b, n in zip(g_sp, g32, pnames))
    print(f"sp_train: step-1 loss fp32 without sp {loss32:.6f}, bf16 sp=4 "
          f"ring {loss_sp:.6f}; rel err {rel:.3g} (tol 2e-2); min "
          f"per-parameter grad cosine {cos[0]:.6f} ({cos[1]}, tol 0.99) "
          f"[{card}]", flush=True)
    # bf16 weights, activations, logits and loss through 12 post-LN layers
    check(rel <= 2e-2, f"sp bf16 vs fp32 step-1 loss rel err {rel}")
    check(cos[0] >= 0.99, f"sp bf16 vs fp32 gradient cosine {cos}")
    del g32, g_sp
    torch.cuda.empty_cache()

    # ---- the main path: TrainStep through its entry points ----
    ring = (tra.ring_block_fwd, tra.ring_block_dq, tra.ring_block_dkv)
    flash = (fa.flash_attention_fwd, fa.flash_attention_bwd_fused,
             fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in ring + flash:
        c.launches = 0
    t_start = time.perf_counter()
    losses = [step(ids, ids, nsp)]                   # warm-up step
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_start
    events = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    t_calls = time.perf_counter()
    events[0].record()
    for i in range(5):
        losses.append(step(ids, ids, nsp))
        events[i + 1].record()
    torch.cuda.synchronize()
    calls_s = time.perf_counter() - t_calls
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(5)]
    sids, snsp = ids.expand(SP_RUN, SP_B, SP_S), \
        nsp.expand(SP_RUN, SP_B)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    span = step.run(sids, sids, snsp)
    e1.record()
    torch.cuda.synchronize()
    run_ms = e0.elapsed_time(e1) / SP_RUN
    losses.extend(span.unbind(0))
    launches = dict(zip(("ring_fwd", "ring_dq", "ring_dkv"),
                        (c.launches for c in ring)))
    flash_launches = [c.launches for c in flash]
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    n_steps = 1 + 5 + SP_RUN
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall over {n_steps} "
          f"steps on the repeated batch: {losses}")
    want = n_layers * SP_DEGREE ** 2 * n_steps
    check(all(n == want for n in launches.values()),
          f"ring kernels launched {launches} in {n_steps} steps of "
          f"{n_layers} layers (want {want} each)")
    check(flash_launches == [0] * 4,
          f"the flash kernels launched {flash_launches} on the sp path")

    # ---- where one step's device time goes (outside the counted run) ----
    values = [p.detach().clone() for p in ps]
    slots = opt.init_state(ps)
    split = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        with torch.enable_grad():
            logits, nsp_logits = amp_functional_call(
                net, pnames, ps, bnames, bufs, [ids], "bfloat16")
            loss = loss_fn(logits, nsp_logits, ids, nsp)
        ev[1].record()
        grads = torch.autograd.grad(loss, ps)
        ev[2].record()
        opt.functional_update(values, grads, slots, opt.get_lr(), 2.0,
                              params_meta=ps)
        ev[3].record()
        torch.cuda.synchronize()
        for j, key in enumerate(split):
            split[key].append(ev[j].elapsed_time(ev[j + 1]))
        del logits, nsp_logits, loss, grads
    split = {k: statistics.median(v[1:]) for k, v in split.items()}
    med_ms = statistics.median(step_ms)
    tokens = SP_B * SP_S
    # 6 FLOPs per product parameter per token (the word embeddings counted
    # once, as the tied head; the position and token-type lookups not) plus
    # the ring's non-causal products: 2 forward, 3 dq, 4 dk/dv per pair
    emb = net.ernie.embeddings
    lookups = emb.position_embeddings.weight.numel() + \
        emb.token_type_embeddings.weight.numel()
    att = layers[0].attention
    step_flops = 6 * (n_params - lookups) * tokens + n_layers * 2 * (
        PRODUCTS["ring_fwd"] + PRODUCTS["ring_dq"] + PRODUCTS["ring_dkv"]) \
        * att.head_dim * SP_S * SP_S * SP_B * att.num_heads
    where = "four cards" if len(set(devices)) > 1 else \
        f"{SP_DEGREE} slots of one card"
    print(f"sp_train: ernie_base use_sp=True, sp={SP_DEGREE} over {where} "
          f"({devices}), bf16 AMP, {SP_B}x{SP_S} tokens, {n_params} "
          f"parameters, AdamW(1e-4), MLM + NSP loss: losses "
          f"{[round(x, 4) for x in losses]} [{card}]", flush=True)
    print(f"sp_train: step time median {med_ms:.3f} ms over 5 __call__ "
          f"steps (CUDA events; {[round(x, 3) for x in step_ms]}), run() "
          f"{run_ms:.3f} ms per step over {SP_RUN}; tokens/s "
          f"{tokens / med_ms * 1e3:.1f}; warm-up step {warm_s * 1e3:.1f} ms "
          f"host; 5 calls {calls_s * 1e3:.1f} ms host; step bound "
          f"{step_flops / PEAK_BF16 * 1e3:.3f} ms ({step_flops / 1e12:.3f} "
          f"TFLOP at 989 TFLOP/s), model FLOP utilisation "
          f"{step_flops / (med_ms * 1e-3) / PEAK_BF16:.3f} [{card}]",
          flush=True)
    print(f"sp_train: one step's device time: forward "
          f"{split['forward']:.3f} ms, backward {split['backward']:.3f} ms, "
          f"optimizer {split['optimizer']:.3f} ms (CUDA events, median of "
          f"3); peak max_memory_allocated {peak_gib:.2f} GiB [{card}]",
          flush=True)
    print(f"sp_train: launches in {n_steps} steps: {launches} (= "
          f"{n_layers} layers x {SP_DEGREE ** 2} hops x {n_steps}); flash "
          f"kernels {flash_launches} [{card}]", flush=True)
    pt.parallel.set_mesh(None)
    del step, opt, net, values, slots
    torch.cuda.empty_cache()
    return launches


def spills(path):
    """`-Xptxas -v` lines of a built library's log that report spills."""
    with open(path + ".log") as f:
        return [ln.strip() for ln in f if "bytes spill" in ln
                and " 0 bytes spill stores, 0 bytes spill loads" not in ln]


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "paddle_tpu_torch")):
        fail(f"no paddle_tpu_torch package beside {__file__}: run from the "
             "root of a checkout")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs "
             "an NVIDIA GPU")
    sys.path.insert(0, HERE)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import ring_attention as tra
    check("jax" not in sys.modules, "jax was imported")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_limit()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {card}", flush=True)

    # ---- build: one nvcc per kernel source, all started together ----
    builds = {"flash_fwd": fa.build, "flash_bwd": fa.build_bwd,
              "ring_attention": tra.build}
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        paths = dict(zip(builds, pool.map(lambda f: f(), builds.values())))
    build_s = time.time() - t0
    print(f"build: {build_s:.1f} s for {sorted(paths)}; ptxas spills: "
          f"{ {k: spills(p) for k, p in paths.items()} }", flush=True)

    # ---- kernels vs their plain versions ----
    fwd_cases = [(4, 1024, 12, 64, torch.bfloat16, True),   # serving shape
                 (TRAIN_B, TRAIN_S, 12, 64, torch.bfloat16, True),  # train
                 (4, 1024, 6, 128, torch.bfloat16, True),
                 (4, 1024, 3, 256, torch.bfloat16, True),
                 (1, 4096, 12, 64, torch.float32, False),   # fp32 from 4096
                 (4, 1000, 12, 64, torch.bfloat16, True)]   # ragged S
    fwd_rows = []
    for case in fwd_cases:
        r = fwd_case(fa, torch, *case)
        fwd_rows.append(r)
        print(f"kernels: flash_fwd {r['shape']} {r['dtype']} "
              f"causal={r['causal']} max_abs_err out={r['max_abs_err']:.3g} "
              f"(tol {r['tol_out']}) lse={r['max_abs_err_lse']:.3g} "
              f"(tol {r['tol_lse']}) kernel_ms={r['ms']:.4f} "
              f"device_ms={r['device_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} "
              f"library_device_ms={fmt_ms(r['library_device_ms'])} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) [{card}]",
              flush=True)
    bwd_cases = [(TRAIN_B, TRAIN_S, 12, 64, torch.bfloat16, True),  # train
                 (TRAIN_B, TRAIN_S, 6, 128, torch.bfloat16, True),
                 (TRAIN_B, TRAIN_S, 3, 256, torch.bfloat16, True),
                 (1, 4096, 12, 64, torch.float32, False),
                 (TRAIN_B, 1000, 12, 64, torch.bfloat16, True)]    # ragged
    bwd_rows = []
    for case in bwd_cases:
        rows = bwd_case(fa, torch, *case)
        bwd_rows.append(rows)
        for kname in ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"):
            r = rows[kname]
            print(f"kernels: {kname} {r['shape']} {r['dtype']} "
                  f"causal={r['causal']} max_abs_err={r['max_abs_err']:.3g} "
                  f"(tol {r['tol']}) kernel_ms={r['ms']:.4f} "
                  f"device_ms={r['device_ms']:.4f} (entry alone; wrapper "
                  f"{r['wrapper_device_ms']:.4f}) "
                  f"plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']:.4f} "
                  f"library_device_ms={fmt_ms(r['library_device_ms'])} "
                  f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) [{card}]",
                  flush=True)
        print(f"kernels: fused vs two-pass dq max abs diff "
              f"{rows['fused_vs_two_pass_dq_err']:.3g} at "
              f"{rows['flash_bwd_fused']['shape']} (dk, dv bit-equal) "
              f"[{card}]", flush=True)
    serving_row, train_fwd_row = fwd_rows[0], fwd_rows[1]
    train_rows = dict(bwd_rows[0], fwd=train_fwd_row)
    # (BH, Sq, Sk, D, dtype, causal, (q_off, k_off))
    bf = torch.bfloat16
    ring_cases = [(96, 128, 128, 64, bf, False, (128, 256)),  # sp train hop
                  (12, 1024, 1024, 64, bf, True, (1024, 1024)),  # diagonal
                  (12, 1024, 1024, 64, bf, True, (2048, 0)),     # past
                  (12, 1024, 1024, 64, bf, True, (0, 1024)),     # future
                  (12, 128, 128, 64, bf, True, (96, 0)),    # off the tiles
                  (12, 128, 256, 64, bf, True, (128, 0)),   # Sq != Sk
                  (6, 1024, 1024, 128, bf, True, (1024, 1024)),
                  (3, 1024, 1024, 256, bf, True, (1024, 1024)),
                  (12, 256, 256, 64, torch.float32, True, (256, 128))]
    ring_rows = []
    for case in ring_cases:
        rows = ring_case(tra, torch, *case)
        ring_rows.append(rows)
        for kname, r in rows.items():
            lib = "n/a" if r["library_ms"] is None else \
                f"{r['library_ms']:.4f} library_device_ms=" \
                f"{fmt_ms(r['library_device_ms'])}"
            print(f"kernels: {kname} BH,Sq,Sk,D={r['shape']} {r['dtype']} "
                  f"causal={r['causal']} offs={r['offs']}"
                  f"{' (future hop: exact 0 / -1e30)' if r['future'] else ''}"
                  f" max_abs_err={r['max_abs_err']:.3g} (tol {r['tol']}) "
                  f"kernel_ms={r['ms']:.4f} device_ms={r['device_ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} library_ms={lib} "
                  f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) [{card}]",
                  flush=True)
    ring_devices = [torch.device("cuda", i) for i in range(SP_DEGREE)] \
        if torch.cuda.device_count() >= SP_DEGREE else \
        [torch.device("cuda", 0)] * SP_DEGREE
    ring_phase(fa, tra, torch, card, ring_devices)

    # ---- the main paths, each with its counts set to 0 just before ----
    train_launches = train_phase(pt, fa, torch, np, card, train_rows)
    serve_launches = serve_phase(pt, fa, torch, np, card)
    sp_launches = sp_train_phase(pt, fa, tra, torch, np, card, ring_devices)

    summary = {"flash_fwd": dict(serving_row,
                                 launches=train_launches["flash_fwd"]
                                 + serve_launches)}
    for kname in ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"):
        summary[kname] = dict(train_rows[kname],
                              launches=train_launches[kname])
    # the ring kernels at the sp train's hop, launches from the sp train
    for kname in ("ring_fwd", "ring_dq", "ring_dkv"):
        summary[kname] = dict(ring_rows[0][kname],
                              launches=sp_launches[kname])
    for kname, r in summary.items():
        path = "train + serve" if kname == "flash_fwd" else \
            "sp train" if kname.startswith("ring") else "train"
        print(f"kernels: {kname} summary at {r['shape']} {r['dtype']}: "
              f"max_abs_err={r['max_abs_err']:.3g} kernel_ms={r['ms']:.4f} "
              f"device_ms={r['device_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} "
              f"library_device_ms={fmt_ms(r['library_device_ms'])} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"launches={r['launches']} ({path}) [{card}]", flush=True)
    kernels = [{"name": kname, "route": "cuda", "source": SOURCES[kname],
                "replaces": REPLACES[kname], "launches": r["launches"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "library_device_ms": r["library_device_ms"]}
               for kname, r in summary.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
