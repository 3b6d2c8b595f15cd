"""Where a training step's device time goes, from a torch.profiler trace.

Trains `GPTForCausalLM(gpt2_small(dropout=0.0))` in bf16 AMP on 8 x 1024
tokens through `jit.TrainStep` + `AdamW(1e-4)` (the training path that
chip_smoke.py drives), warms up, then traces a few steps with CUPTI and
prints the device time per step by kernel, grouped into the attention
kernels, the matrix products, the elementwise and reduction kernels and
the optimizer's, with the device's idle share of the traced window. Run
on a machine with a CUDA device:

    python -m paddle_tpu_torch.utils.train_profile [--steps 3] [--top 20]

Prints one line per kernel group and per top kernel, and a JSON object as
its last line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

# kernel-name patterns of each group, tried in order
GROUPS = (("attention", ("flash_fwd", "flash_bwd")),
          ("optimizer", ("foreach", "multi_tensor")),
          ("products", ("gemm", "cutlass", "sm90_xmma", "nvjet", "cublas",
                        "gemv", "splitk")),
          ("elementwise_and_reductions", ("",)))


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return GROUPS[-1][0]


def _card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 \
        else torch.cuda.get_device_name(0)


def profile(steps=3, top=20, batch=8, seq=1024, seed=0):
    import paddle_tpu_torch as pt
    if not torch.cuda.is_available():
        raise RuntimeError("train_profile measures the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    pt.set_device("gpu")
    pt.seed(seed)
    model = pt.models.GPTForCausalLM(pt.models.gpt2_small(dropout=0.0))
    vocab = model.gpt.embeddings.word_embeddings.weight.shape[0]
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters())
    step = pt.jit.TrainStep(model, pt.models.GPTPretrainingCriterion(), opt,
                            amp_dtype="bfloat16")
    ids = torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (batch, seq))).cuda()
    for _ in range(3):
        step(ids, ids)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(ids, ids)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total", 0.0) / 1e3 / steps
        if ms > 0:
            kernels.append((ms, e.count // steps, e.key))
    kernels.sort(reverse=True)
    busy = sum(ms for ms, _, _ in kernels)
    groups = {}
    for ms, _, name in kernels:
        g = _group(name)
        groups[g] = groups.get(g, 0.0) + ms
    return {"card": _card(), "steps": steps, "tokens": batch * seq,
            "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy,
            "idle_share": 1.0 - busy * steps / wall_ms,
            "groups_ms_per_step": groups,
            "top": [{"ms_per_step": ms, "launches_per_step": n,
                     "kernel": name[:120]} for ms, n, name in kernels[:top]]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    r = profile(args.steps, args.top)
    card = r["card"]
    print(f"train_profile: {r['steps']} steps traced: wall "
          f"{r['wall_ms_per_step']:.3f} ms per step (host clock, profiler "
          f"on), device busy {r['device_busy_ms_per_step']:.3f} ms, idle "
          f"share {r['idle_share']:.3f} [{card}]", flush=True)
    for g, ms in sorted(r["groups_ms_per_step"].items(),
                        key=lambda kv: -kv[1]):
        print(f"train_profile: group {g}: {ms:.3f} ms per step "
              f"({ms / r['device_busy_ms_per_step']:.3f} of busy) [{card}]",
              flush=True)
    for row in r["top"]:
        print(f"train_profile: {row['ms_per_step']:.3f} ms "
              f"x{row['launches_per_step']} {row['kernel']}", flush=True)
    print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
