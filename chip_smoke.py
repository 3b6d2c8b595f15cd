"""Chip smoke test of the PyTorch/CUDA port (`paddle_tpu_torch`).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
last line is printed):

  1. device  - the card's name and power limit from nvidia-smi;
  2. build   - every kernel of the training and serving paths built from
               the sources in the checkout (one nvcc per source, all
               started together);
  3. kernels - each kernel held against its plain PyTorch version on the
               card, at the shapes the main paths give it and at the other
               shapes it accepts, with its time, its plain version's, the
               PyTorch library call's and the least time the card could
               take; the fused and the two-pass backward held against each
               other;
  4. train   - GPTForCausalLM(gpt2_small(dropout=0.0)) at full width and
               depth, fp32 master weights drawn from a seed, trained in
               bf16 AMP on 8 x 1024 tokens through jit.TrainStep + AdamW:
               the step-1 gradients against the same weights in fp32 and
               against the deterministic two-pass backward, then one
               warm-up step, 5 __call__ steps, a run() span of 5 steps and
               one step under torch.use_deterministic_algorithms. Every
               attention forward and backward must go through the kernels
               (launch counts) and the loss must fall;
  5. serve   - the same model at full width in bf16, served through
               Predictor -> ServingEngine: 8 requests of 1024 tokens from
               4 threads. Every attention call must go through the kernel
               (launch counts), and one request's logits must match the
               same model run in float32.

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
SOURCES = {"flash_fwd": "paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
           "flash_bwd_fused": "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
           "flash_bwd_dq": "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
           "flash_bwd_dkv": "paddle_tpu_torch/kernels/csrc/flash_bwd.cu"}
REPLACES = {"flash_fwd": "paddle_tpu/kernels/flash_attention.py:58",
            "flash_bwd_fused": "paddle_tpu/kernels/flash_attention.py:732",
            "flash_bwd_dq": "paddle_tpu/kernels/flash_attention.py:239",
            "flash_bwd_dkv": "paddle_tpu/kernels/flash_attention.py:280"}
# products per visible (q, k) pair, in units of D multiply-adds x 2:
# forward q k^T and p v; fused backward the five of _bwd_tile_pds and its
# users; the dq pass recomputes s and dp and forms ds k; the dk/dv pass
# recomputes s and dp and forms p^T dO and ds^T q
PRODUCTS = {"flash_fwd": 2, "flash_bwd_fused": 5, "flash_bwd_dq": 3,
            "flash_bwd_dkv": 4}
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
    kernel_ms = median_ms(lambda: fa.flash_attention_fwd(q, k, v, causal))
    plain_ms = median_ms(
        lambda: fa.flash_attention_fwd_plain(q, k, v, causal))
    library_ms = median_ms(lambda: TF.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal))
    bound_ms, bound_by = attention_bound(
        "flash_fwd", b * h, s, d, q.element_size(), causal,
        PEAK_BF16 if bf16 else PEAK_FP32)
    return {"shape": [b, s, h, d], "dtype": str(dtype).replace("torch.", ""),
            "causal": causal, "max_abs_err": err_out,
            "max_abs_err_lse": err_lse, "tol_out": tol_out,
            "tol_lse": tol_lse, "ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
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
    plain_ms = median_ms(lambda: fa.flash_attention_bwd_plain(*args),
                         samples=10, per_sample=3, warmup=2)
    timed = {"flash_bwd_fused": lambda: fa.flash_attention_bwd_fused(*args),
             "flash_bwd_dq": lambda: fa.flash_attention_bwd_dq(*args),
             "flash_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(*args)}
    rows = {}
    for kname, fn in timed.items():
        bound_ms, bound_by = attention_bound(
            kname, b * h, s, d, q.element_size(), causal,
            PEAK_BF16 if bf16 else PEAK_FP32)
        rows[kname] = {"shape": [b, s, h, d],
                       "dtype": str(dtype).replace("torch.", ""),
                       "causal": causal, "max_abs_err": errs[kname],
                       "tol": tol, "ms": median_ms(fn), "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by}
    rows["fused_vs_two_pass_dq_err"] = err_fq
    return rows


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
    attn_ms = n_layers * (fwd_row["ms"] + bwd_row["ms"])
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
          f"attention kernels ~{attn_ms:.3f} ms of it (12 x (fwd "
          f"{fwd_row['ms']:.4f} + fused bwd {bwd_row['ms']:.4f}) ms timed "
          f"alone at this shape); peak max_memory_allocated "
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
    check("jax" not in sys.modules, "jax was imported")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_limit()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {card}", flush=True)

    # ---- build: one nvcc per kernel source, all started together ----
    builds = {"flash_fwd": fa.build, "flash_bwd": fa.build_bwd}
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
              f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f}"
              f" bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) [{card}]",
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
                  f"plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']:.4f} "
                  f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) [{card}]",
                  flush=True)
        print(f"kernels: fused vs two-pass dq max abs diff "
              f"{rows['fused_vs_two_pass_dq_err']:.3g} at "
              f"{rows['flash_bwd_fused']['shape']} (dk, dv bit-equal) "
              f"[{card}]", flush=True)
    serving_row, train_fwd_row = fwd_rows[0], fwd_rows[1]
    train_rows = dict(bwd_rows[0], fwd=train_fwd_row)

    # ---- the main paths, each with its counts set to 0 just before ----
    train_launches = train_phase(pt, fa, torch, np, card, train_rows)
    serve_launches = serve_phase(pt, fa, torch, np, card)

    summary = {"flash_fwd": dict(serving_row,
                                 launches=train_launches["flash_fwd"]
                                 + serve_launches)}
    for kname in ("flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv"):
        summary[kname] = dict(train_rows[kname],
                              launches=train_launches[kname])
    for kname, r in summary.items():
        print(f"kernels: {kname} summary at {r['shape']} {r['dtype']}: "
              f"max_abs_err={r['max_abs_err']:.3g} kernel_ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f}"
              f" bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"launches={r['launches']} (train"
              f"{' + serve' if kname == 'flash_fwd' else ''}) [{card}]",
              flush=True)
    kernels = [{"name": kname, "route": "cuda", "source": SOURCES[kname],
                "replaces": REPLACES[kname], "launches": r["launches"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
               for kname, r in summary.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
