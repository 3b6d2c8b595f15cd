"""Where the flash kernel overtakes the einsum path, measured on the card.

`scaled_dot_product_attention` sends attention to the kernel from S=1024
(bf16) or S=4096 (fp16, fp32), the JAX package's thresholds. This sweep
times both routes in the three dtypes, the forward alone and forward +
backward (the three gradients of a fixed upstream gradient), at GPT-2
small's attention shape (B=4, H=12, D=64, causal, q/k/v sliced from one
fused QKV tensor as the model gives them) over a range of sequence
lengths, so the threshold can be set from numbers taken on this card.
Run on a machine with a CUDA device:

    python -m paddle_tpu_torch.kernels.crossover

Prints one line per (dtype, S) and a JSON list as its last line.
"""
from __future__ import annotations

import json
import subprocess

import torch

from ..nn.functional.attention import _einsum_attention
from ..utils.cuda_timing import median_ms
from .flash_attention import flash_attention_arrays


def sweep(seqs=(128, 256, 512, 1024, 2048, 4096), b=4, h=12, d=64,
          dtypes=(torch.bfloat16, torch.float16, torch.float32)):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in dtypes:
        for s in seqs:
            qkv = torch.randn(b, s, 3, h, d, generator=gen, device="cuda",
                              dtype=torch.float32).to(dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            do = torch.randn(b, s, h, d, generator=gen, device="cuda",
                             dtype=torch.float32).to(dtype)

            def kernel():
                return flash_attention_arrays(q, k, v, causal=True)

            def einsum():
                return _einsum_attention(q, k, v, is_causal=True)

            def fwd_bwd(route):
                with torch.enable_grad():
                    leaf = qkv.detach().requires_grad_()
                    q_, k_, v_ = leaf[:, :, 0], leaf[:, :, 1], leaf[:, :, 2]
                    out = route(q_, k_, v_)
                    return torch.autograd.grad(out, leaf, do)

            row = {"dtype": str(dtype).replace("torch.", ""), "S": s,
                   "B": b, "H": h, "D": d, "kernel_ms": median_ms(kernel),
                   "einsum_ms": median_ms(einsum),
                   "kernel_fwd_bwd_ms": median_ms(lambda: fwd_bwd(
                       lambda *x: flash_attention_arrays(*x, causal=True))),
                   "einsum_fwd_bwd_ms": median_ms(lambda: fwd_bwd(
                       lambda *x: _einsum_attention(*x, is_causal=True)))}
            row["speedup"] = row["einsum_ms"] / row["kernel_ms"]
            row["speedup_fwd_bwd"] = row["einsum_fwd_bwd_ms"] / \
                row["kernel_fwd_bwd_ms"]
            rows.append(row)
            del qkv, q, k, v, do
            torch.cuda.empty_cache()
    return rows


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    rows = sweep()
    for r in rows:
        print(f"crossover: {r['dtype']} S={r['S']} kernel_ms="
              f"{r['kernel_ms']:.4f} einsum_ms={r['einsum_ms']:.4f} "
              f"speedup={r['speedup']:.2f}; forward + backward kernel_ms="
              f"{r['kernel_fwd_bwd_ms']:.4f} einsum_ms="
              f"{r['einsum_fwd_bwd_ms']:.4f} speedup="
              f"{r['speedup_fwd_bwd']:.2f} [{card}]", flush=True)
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
