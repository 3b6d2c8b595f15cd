"""The warm-start workload: one fresh process over a compile-cache directory.

Counterpart of `tests/warm_start_runner.py`. Run it twice over one
`FLAGS_compile_cache_dir`: the first (cold) process exports every
to_static signature and persists it; the second (warm) one loads each
from disk instead (`core/compile_cache.py`). Each prints ONE JSON line:
output digests (the warm process must reproduce the cold one's bit for
bit: both run under deterministic algorithms), `compile_cache.stats()`,
`warm_start_report()`, each signature's export or load seconds and entry
bytes, and the first-step / first-inference times.

The workload, in order:
  - LeNet through `jit.TrainStep`, two steps (the reference runner's
    train arm; TrainStep's build persists nothing, so its time is the
    same warm or cold);
  - a to_static function predictor's bucket warm-up (2 batch sizes)
    through `serving.ServingEngine`;
  - GPT-2 small (on CUDA, at full width: 12 layers, 768 wide) as a
    live-layer `inference.Predictor` of its bf16 copy behind a
    ServingEngine with the serve phase's 3 batch buckets (1, 2, 4 of 1 x
    1024 tokens), three requests served; then two bf16 auto_cast AdamW
    steps of the fp32 model through `jit.to_static` at 8 x 1024,
    `loss.backward()` across the static boundary. On the CPU the same
    code runs a GPT of 2 layers, 64 wide, on 16 tokens;
  - two `TransformerEncoderLayer`s (64 wide) that differ only in their
    `activation` (relu, gelu), each through to_static: one key each, so
    their outputs differ and match their eager layers'.

`t_first_infer_s` is the GPT engine's warm-up (its three signatures'
export or load, eager run and capture), `t_first_train_s` the GPT's first
to_static training step. `gpt_serve` / `gpt_train` hold the flash
kernels' host launches over the serve warm-up and over the training steps
(`launches`, CUDA only) and the flash_fwd nodes of each program
(`flash_nodes`).

Usage:
    python -m paddle_tpu_torch.utils.warm_start CACHE_DIR [--device cpu]

`spawn` / `result` drive it from another process (`utils/bench.py`'s
`--arm warm_start`, the smoke's warm_start phase, the tests).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

SEED = 0
GPT_CUDA = dict(seq=1024, serve_batch=4, train_batch=8)
GPT_CPU = dict(seq=16, serve_batch=4, train_batch=2,
               cfg=dict(vocab_size=256, hidden_size=64, num_layers=2,
                        num_heads=2, max_seq_len=64))


def spawn(cache_dir, device="gpu", env=None) -> subprocess.Popen:
    """A fresh process of this workload over `cache_dir`, run from the
    repo's root; `result` waits for it."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.utils.warm_start",
         str(cache_dir), "--device", device], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    proc.t0 = time.perf_counter()
    return proc


def result(proc: subprocess.Popen, timeout: float = 900) -> dict:
    """The JSON record a `spawn`ed process printed, with its wall seconds
    (`wall_s`); RuntimeError (the tail of its stderr) when it failed or
    outlived `timeout`, which kills it."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise RuntimeError(f"warm_start: no result in {timeout} s: "
                           f"{err[-3000:]}")
    if proc.returncode != 0 or not out.strip():
        raise RuntimeError(f"warm_start: exited {proc.returncode}: "
                           f"{err[-3000:]}")
    return dict(json.loads(out.strip().splitlines()[-1]),
                wall_s=time.perf_counter() - proc.t0)


def digests(record) -> tuple:
    """The digests a warm process must reproduce bit for bit."""
    return (record["train_digest"], record["serve_digest"],
            record["gpt_serve"]["digest"], record["gpt_train"]["digest"],
            record["activations"]["digest"])


def digest(*tensors) -> str:
    """sha256 of the tensors' bytes (bf16 as its raw 16-bit words)."""
    import torch
    h = hashlib.sha256()
    for t in tensors:
        t = torch.as_tensor(t).detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    return h.hexdigest()[:32]


def lenet_arm(pt, torch, np, device):
    """Two TrainStep steps of LeNet: (losses, digest, seconds)."""
    t0 = time.perf_counter()
    pt.seed(SEED)
    net = pt.models.LeNet()
    opt = pt.optimizer.Adam(parameters=net.parameters(), learning_rate=1e-3)
    step = pt.jit.TrainStep(net, pt.nn.CrossEntropyLoss(), opt)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(8, 1, 28, 28).astype("float32")).to(device)
    y = torch.from_numpy(rng.randint(0, 10, (8,)).astype("int64")).to(device)
    losses = [float(step(x, y)), float(step(x, y))]
    seconds = time.perf_counter() - t0
    return losses, digest(torch.tensor(losses, dtype=torch.float64),
                          *net.parameters()), seconds


def predictor_arm(pt, np):
    """A to_static function's bucket warm-up through ServingEngine:
    (digest, seconds, engine stats)."""
    @pt.jit.to_static
    def predictor(a):
        return a * 2.0 + 1.0

    t0 = time.perf_counter()
    eng = pt.serving.ServingEngine(predictor, pt.serving.EngineConfig(
        max_batch_size=2, num_workers=1, warmup_on_start=False,
        learn_buckets=False))
    eng.declare_bucket([(4,)], ["float32"], [1, 2])
    eng.warmup()
    seconds = time.perf_counter() - t0
    out = predictor(np.arange(8, dtype=np.float32).reshape(2, 4))
    return digest(out), seconds, eng.stats()


def _gpt(pt, on_cuda):
    pt.seed(SEED)
    if on_cuda:
        return pt.models.GPTForCausalLM(pt.models.gpt2_small(dropout=0.0))
    return pt.models.GPTForCausalLM(pt.models.GPTModel(
        dropout=0.0, **GPT_CPU["cfg"]))


def _flash_counts(fa):
    return {"flash_fwd": fa.flash_attention_fwd.launches,
            "flash_bwd_fused": fa.flash_attention_bwd_fused.launches,
            "flash_bwd_dq": fa.flash_attention_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_attention_bwd_dkv.launches}


def _flash_nodes(static_fn):
    """flash_fwd nodes in each program of a StaticFunction (exported here
    or loaded from the cache)."""
    from paddle_tpu_torch.static.program import op_names
    return [op_names(cap.exported.graph_module).count(
        "paddle_tpu_torch.flash_fwd")
        for cap in static_fn._programs.values()]


def _zero(fa):
    for c in (fa.flash_attention_fwd, fa.flash_attention_bwd_fused,
              fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv):
        c.launches = 0


def gpt_serve_arm(pt, torch, np, fa, on_cuda):
    """The GPT's bf16 live-layer Predictor behind a ServingEngine of 3
    batch buckets: its warm-up, then three requests."""
    shape = GPT_CUDA if on_cuda else GPT_CPU
    seq, batch = shape["seq"], shape["serve_batch"]
    model = _gpt(pt, on_cuda)
    model.eval()
    model = model.bfloat16()
    vocab = model.gpt.embeddings.word_embeddings.weight.shape[0]
    pred = pt.inference.Predictor(
        model, input_spec=[pt.InputSpec([batch, seq], "int32")])
    engine = pt.serving.ServingEngine(pred, pt.serving.EngineConfig(
        max_batch_size=batch, batch_sizes=(1, 2, 4), batch_timeout_ms=1.0))
    if on_cuda:
        torch.cuda.synchronize()
        _zero(fa)
    t0 = time.perf_counter()
    engine.start()
    if on_cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _flash_counts(fa) if on_cuda else None
    rng = np.random.default_rng(SEED)
    outs = []
    try:
        for _ in range(3):
            ids = rng.integers(0, vocab, (1, seq)).astype(np.int32)
            outs.append(engine.submit([ids]).result(600)[0])
    finally:
        engine.stop(drain=True)
    stats = engine.stats()
    return {"digest": digest(*[torch.from_numpy(o) for o in outs]),
            "seconds": seconds, "launches": launches,
            "signatures": len(pred._fn._programs),
            "flash_nodes": _flash_nodes(pred._fn),
            "warm_start_ms": stats["warm_start_ms"],
            "stats_compile_cache": stats["compile_cache"],
            "finite": bool(all(np.isfinite(o).all() for o in outs))}


def gpt_train_arm(pt, torch, np, fa, on_cuda):
    """Two bf16 auto_cast AdamW steps of the GPT through jit.to_static."""
    shape = GPT_CUDA if on_cuda else GPT_CPU
    model = _gpt(pt, on_cuda)
    vocab = model.gpt.embeddings.word_embeddings.weight.shape[0]
    device = next(model.parameters()).device
    ids = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, vocab, (shape["train_batch"], shape["seq"])).astype(
        np.int32)).to(device)
    pt.jit.to_static(model)
    opt = pt.optimizer.AdamW(1e-4, parameters=model.parameters())
    F = pt.nn.functional
    losses, ms = [], []
    if on_cuda:
        torch.cuda.synchronize()
        _zero(fa)
    for _ in range(2):
        t0 = time.perf_counter()
        with pt.amp.auto_cast(dtype="bfloat16"):
            logits = model(ids)
        loss = F.cross_entropy(
            logits[:, :-1].reshape(-1, vocab).float(),
            ids[:, 1:].reshape(-1)).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach())
        if on_cuda:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    losses = torch.stack(losses).float()
    return {"digest": digest(losses, *model.parameters()),
            "losses": losses.tolist(), "ms": ms,
            "flash_nodes": _flash_nodes(model.forward),
            "launches": _flash_counts(fa) if on_cuda else None}


def activation_arm(pt, torch, np, device):
    """Two TransformerEncoderLayers that differ only in `activation`, each
    through to_static (no grad): whether their outputs differ, and the
    largest gap to their eager layers' outputs."""
    x = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (2, 8, 64)).astype(np.float32)).to(device)
    outs, err = [], 0.0
    for act in ("relu", "gelu"):
        pt.seed(SEED)
        layer = pt.nn.TransformerEncoderLayer(64, 2, 128, dropout=0.0,
                                              activation=act)
        layer.eval()
        with torch.no_grad():
            want = layer(x)
            pt.jit.to_static(layer)
            got = layer(x)
        err = max(err, float((got - want).abs().max()))
        outs.append(got)
    return {"digest": digest(*outs), "differ": not torch.equal(*outs),
            "max_abs_err": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cache_dir")
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu")
    args = ap.parse_args(argv)
    # cuBLAS reduces in a fixed order only with a fixed workspace; set
    # before the first cuBLAS handle exists
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.core import compile_cache as cc
    from paddle_tpu_torch.kernels import flash_attention as fa

    t_proc = time.perf_counter()
    on_cuda = args.device == "gpu"
    if on_cuda and not torch.cuda.is_available():
        raise SystemExit("warm_start: no CUDA device (--device cpu runs on "
                         "the CPU)")
    if on_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    pt.set_device(args.device)
    device = torch.device("cuda" if on_cuda else "cpu")
    pt.set_flags({"FLAGS_monitor": True,
                  "FLAGS_compile_cache_dir": args.cache_dir})
    torch.use_deterministic_algorithms(True, warn_only=True)

    losses, train_digest, t_lenet = lenet_arm(pt, torch, np, device)
    serve_digest, t_predictor, pstats = predictor_arm(pt, np)
    serve = gpt_serve_arm(pt, torch, np, fa, on_cuda)
    train = gpt_train_arm(pt, torch, np, fa, on_cuda)
    activations = activation_arm(pt, torch, np, device)

    snap = monitor.snapshot()["counters"]
    programs = [{k: e.get(k) for k in ("event", "label", "kind", "key",
                                       "export_s", "load_s", "bytes")}
                for e in monitor.events()
                if e["event"] in ("compile_cache.hit",
                                  "compile_cache.store")]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0) if on_cuda else "cpu",
        "losses": losses,
        "train_digest": train_digest,
        "serve_digest": serve_digest,
        "gpt_serve": serve,
        "gpt_train": train,
        "activations": activations,
        "trace_compile": int(snap.get("trace_compile", 0)),
        "counters": {k: v for k, v in snap.items()
                     if k.startswith(("trace_compile", "compile_cache",
                                      "jit.train_step", "jit.to_static",
                                      "serving."))},
        "compile_cache": cc.stats(),
        "report": cc.warm_start_report(),
        "programs": programs,
        "warm_start_ms": pstats["warm_start_ms"],
        "stats_compile_cache": pstats["compile_cache"],
        "t_lenet_s": t_lenet,
        "t_predictor_s": t_predictor,
        "t_first_train_s": train["ms"][0] / 1e3,
        "t_first_infer_s": serve["seconds"],
        "process_s": time.perf_counter() - t_proc,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
