"""Where a training step's device time goes, from a torch.profiler trace.

Trains one of the training paths that chip_smoke.py drives, in bf16 AMP
through `jit.TrainStep` + `AdamW(1e-4)`:

- `--model gpt2` (default): `GPTForCausalLM(gpt2_small(dropout=0.0))` on
  8 x 1024 tokens;
- `--model ernie_sp`: `ErnieForPretraining(ernie_base(hidden_dropout_prob=
  0.0, use_sp=True))` on 8 x 512 tokens with the MLM + NSP loss, under
  `HybridCommunicateGroup(sp_degree=4)` over four slots of `cuda:0` (or
  four cards when there are four).

It warms up, times a few steps without the profiler (host clock, synced),
then traces as many with CUPTI and prints the device time per step by
kernel, grouped into the ring-attention kernels, the other attention
kernels (flash, the backward's prep pass), the matrix products, the
elementwise and reduction kernels and the optimizer's, with the device's
idle share of the traced window and of the untraced steps. Run on a
machine with a CUDA device:

    python -m paddle_tpu_torch.utils.train_profile [--model gpt2|ernie_sp]
        [--steps 3] [--top 20]

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
GROUPS = (("ring_attention", ("ring_fwd", "ring_dq", "ring_dkv")),
          ("attention", ("flash_fwd", "flash_bwd")),
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


def _gpt2(pt, rng):
    """gpt2_small's TrainStep and one batch of 8 x 1024 token ids."""
    model = pt.models.GPTForCausalLM(pt.models.gpt2_small(dropout=0.0))
    vocab = model.gpt.embeddings.word_embeddings.weight.shape[0]
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters())
    step = pt.jit.TrainStep(model, pt.models.GPTPretrainingCriterion(), opt,
                            amp_dtype="bfloat16")
    ids = torch.from_numpy(rng.integers(0, vocab, (8, 1024))).cuda()
    return step, (ids, ids)


def _ernie_sp(pt, rng, sp=4):
    """ERNIE-base pretraining over the sp ring: its TrainStep and one batch
    of 8 x 512 token ids with NSP labels."""
    n = torch.cuda.device_count()
    devices = [torch.device("cuda", i) for i in range(sp)] if n >= sp \
        else [torch.device("cuda", 0)] * sp
    pt.parallel.HybridCommunicateGroup(hybrid_configs={"sp_degree": sp},
                                       devices=devices)
    net = pt.models.ErnieForPretraining(
        pt.models.ernie_base(hidden_dropout_prob=0.0, use_sp=True))
    vocab = net.ernie.embeddings.word_embeddings.weight.shape[0]
    ce = pt.nn.CrossEntropyLoss()

    def loss_fn(logits, nsp_logits, ids, nsp):
        return ce(logits.reshape(-1, logits.shape[-1]), ids.reshape(-1)) + \
            ce(nsp_logits, nsp)

    opt = pt.optimizer.AdamW(learning_rate=1e-4, parameters=net.parameters())
    step = pt.jit.TrainStep(net, loss_fn, opt, amp_dtype="bfloat16",
                            n_model_inputs=1)
    ids = torch.from_numpy(rng.integers(0, vocab, (8, 512))).cuda()
    nsp = torch.from_numpy(rng.integers(0, 2, (8,))).cuda()
    return step, (ids, ids, nsp)


MODELS = {"gpt2": _gpt2, "ernie_sp": _ernie_sp}


def profile(steps=3, top=20, model="gpt2", seed=0):
    import paddle_tpu_torch as pt
    if not torch.cuda.is_available():
        raise RuntimeError("train_profile measures the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    pt.set_device("gpu")
    pt.seed(seed)
    step, batch = MODELS[model](pt, np.random.default_rng(seed))
    for _ in range(3):
        step(*batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(*batch)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, host = [], []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            # host ops: self time, the op's own Python-to-launch cost
            host.append((e.self_cpu_time_total / 1e3 / steps,
                         e.count // steps, e.key))
            continue
        ms = getattr(e, "self_device_time_total", 0.0) / 1e3 / steps
        if ms > 0:
            kernels.append((ms, e.count // steps, e.key))
    kernels.sort(reverse=True)
    host.sort(reverse=True)
    busy = sum(ms for ms, _, _ in kernels)
    groups = {}
    for ms, _, name in kernels:
        g = _group(name)
        groups[g] = groups.get(g, 0.0) + ms
    return {"card": _card(), "model": model, "steps": steps,
            "tokens": batch[0].numel(),
            "wall_ms_per_step": wall_ms / steps,
            "unprofiled_ms_per_step": plain_ms,
            "device_busy_ms_per_step": busy,
            "idle_share": 1.0 - busy * steps / wall_ms,
            "idle_share_unprofiled": 1.0 - busy / plain_ms,
            "kernel_launches_per_step": sum(n for _, n, _ in kernels),
            "groups_ms_per_step": groups,
            "top": [{"ms_per_step": ms, "launches_per_step": n,
                     "kernel": name[:120]} for ms, n, name in kernels[:top]],
            "host_top": [{"self_ms_per_step": ms, "calls_per_step": n,
                          "op": name[:80]} for ms, n, name in host[:top]]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="gpt2")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args()
    r = profile(args.steps, args.top, args.model)
    card = r["card"]
    print(f"train_profile: {r['model']}, {r['steps']} steps traced: wall "
          f"{r['wall_ms_per_step']:.3f} ms per step (host clock, profiler "
          f"on), device busy {r['device_busy_ms_per_step']:.3f} ms, idle "
          f"share {r['idle_share']:.3f}; without the profiler "
          f"{r['unprofiled_ms_per_step']:.3f} ms per step, idle share "
          f"{r['idle_share_unprofiled']:.3f} [{card}]", flush=True)
    for g, ms in sorted(r["groups_ms_per_step"].items(),
                        key=lambda kv: -kv[1]):
        print(f"train_profile: group {g}: {ms:.3f} ms per step "
              f"({ms / r['device_busy_ms_per_step']:.3f} of busy) [{card}]",
              flush=True)
    print(f"train_profile: {r['kernel_launches_per_step']} kernel launches "
          f"per step [{card}]", flush=True)
    for row in r["top"]:
        print(f"train_profile: {row['ms_per_step']:.3f} ms "
              f"x{row['launches_per_step']} {row['kernel']}", flush=True)
    for row in r["host_top"]:
        print(f"train_profile: host {row['self_ms_per_step']:.3f} ms self "
              f"x{row['calls_per_step']} {row['op']}", flush=True)
    print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
