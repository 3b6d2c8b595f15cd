"""The port's counterpart of `bench.py`'s two ERNIE training arms and its
LLM serving arm.

- `--arm ernie_train` (`bench_ernie_train`, bench.py:188-276): the
  flagship, `ErnieForPretraining(ernie_base(hidden_dropout_prob=0.0))`
  without sp at 32 x 128, MLM + NSP `CrossEntropyLoss`, `AdamW(1e-4)`,
  `TrainStep(amp_dtype="bfloat16", n_model_inputs=1)`, 100 stacked steps
  from `np.random` seeded 0 through `run()`, 5 reps. Reports samples/s and
  spread, MFU by the reference's formula and from `cost_analysis`, the
  memory report and peak, the forward / backward / optimizer split by CUDA
  events, and the per-step path's samples/s with and without
  `io.DevicePrefetcher` (the two arms of `_overlap_ab`).
- `--arm ernie10b_layer` (`bench_ernie10b_layer`, bench.py:683-738): four
  titan layers, `ErnieScanStack(4096, 64, 16384, 4, remat="dots")` at
  2 x 2048 on `(out ** 2).mean()`, 10 stacked steps from
  `np.random.rand * 0.02`, 3 reps. Reports ms per layer-sample and MFU.

- `--arm llm` (`bench_llm`, bench.py:1559-1636): continuous-batching
  serving through `serving.LLMEngine`, the fp32 arm and the int8 arm
  (`quant="int8"`, `kv_int8=True`), on the same GPT built from one seed.
  On the card at bench.py's `backend == "tpu"` sizes (vocab 8192, hidden
  256, 4 layers, 8 heads, `max_seq_len` 512; 32 requests with prompt
  lengths from `default_rng(0)`, 48 new tokens; 8 slots, `max_len` 256),
  on the CPU at its other sizes (hidden 64, 2 layers, 4 heads; 8 requests,
  16 new tokens, `max_len` 64). Reports prefill and decode tokens/s, TTFT
  and inter-token p50/p95/p99, the KV pool, the warm start and
  `steady_state_captures` (CUDA-graph captures after warm-up, the
  counterpart of `steady_state_compiles`), and `int8_decode_speedup`.

Each arm prints one JSON line under `bench.py`'s keys where they exist.
MFU is over the H100's 989 TFLOP/s dense bf16 peak. Run on a machine with
a CUDA device:

    python -m paddle_tpu_torch.utils.bench --arm ernie_train|ernie10b_layer|llm

`--device cpu` runs the arms on the CPU instead. The arms are functions
too (`ernie_train`, `ernie10b_layer`, `llm`) whose sizes are arguments;
`chip_smoke.py` calls them with shorter spans (and `serve_llm` at GPT-2
small). This module defines no benchmark cell.
"""
from __future__ import annotations

import argparse
import json
import statistics
import threading
import time

import numpy as np
import torch

PEAK_BF16 = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device):
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device):
    """{max_memory_allocated, max_memory_reserved} on CUDA (a captured
    step's memory pool is reserved, not allocated, between replays); None
    on the CPU."""
    if device.type != "cuda":
        return {"max_memory_allocated": None, "max_memory_reserved": None}
    return {"max_memory_allocated": torch.cuda.max_memory_allocated(device),
            "max_memory_reserved": torch.cuda.max_memory_reserved(device)}


def _timed_rate(run, payload, reps, device):
    """(median rate, spread, last result) of `reps` calls of `run`, each
    timed on the host clock up to a synchronise, in payload units/s."""
    rates, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run()
        _sync(device)
        rates.append(payload / (time.perf_counter() - t0))
    med = statistics.median(rates)
    return med, (max(rates) - min(rates)) / med, out


def step_split_ms(step, *batch, reps=4):
    """Device time of one step's forward, backward and optimizer update,
    from CUDA events (median of the last reps - 1). The update runs on
    copies of the parameters and fresh slots: the step's state is
    untouched."""
    from ..jit.functional import amp_functional_call
    inputs, labels = step._prepare(batch)
    ps, opt = step._ptensors, step.optimizer
    values = [p.detach().clone() for p in ps]
    slots = opt.init_state(ps)
    split = {"forward": [], "backward": [], "optimizer": []}
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        with torch.enable_grad():
            out = amp_functional_call(step.model, step._pnames, ps,
                                      step._bnames, step._btensors, inputs,
                                      step.amp_dtype)
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            loss = step.loss_fn(*outs, *labels)
        ev[1].record()
        grads = torch.autograd.grad(loss, ps)
        ev[2].record()
        opt.functional_update(values, grads, slots, opt.get_lr(), 2.0,
                              params_meta=ps)
        ev[3].record()
        torch.cuda.synchronize()
        for j, key in enumerate(split):
            split[key].append(ev[j].elapsed_time(ev[j + 1]))
        del out, outs, loss, grads
    return {k: statistics.median(v[1:]) for k, v in split.items()}


def flagship_step(pt, model=None):
    """The flagship's TrainStep (bench.py:193-210): ERNIE-base without sp,
    or `ErnieModel(**model)`, with the MLM + NSP loss."""
    base = pt.models.ernie_base(hidden_dropout_prob=0.0) if model is None \
        else pt.models.ErnieModel(**model)
    net = pt.models.ErnieForPretraining(base)
    ce = pt.nn.CrossEntropyLoss()

    def loss_fn(logits, nsp_logits, ids, nsp):
        v = logits.shape[-1]
        return ce(logits.reshape(-1, v), ids.reshape(-1)) + \
            ce(nsp_logits, nsp)

    opt = pt.optimizer.AdamW(parameters=net.parameters(), learning_rate=1e-4)
    return pt.jit.TrainStep(net, loss_fn, opt, amp_dtype="bfloat16",
                            n_model_inputs=1)


def flagship_flops_per_sample(net, seq):
    """bench.py:258-262: 6·N_matmul·S + 3·L·4·S²·H + 6·S·H·V, N_matmul the
    2-D parameters other than the [V, H] embedding table."""
    emb = net.ernie.embeddings.word_embeddings.weight
    vocab, h = emb.shape
    n_layers = len(net.ernie.layers)
    n_matmul = sum(p.numel() for p in net.parameters()
                   if p.dim() == 2 and p.shape[0] != vocab)
    return 6 * n_matmul * seq + 3 * n_layers * 4 * seq ** 2 * h + \
        6 * seq * h * vocab


def ernie_train(batch=32, seq=128, n_steps=100, reps=5, prefetch_steps=20,
                model=None, seed=0):
    """The flagship arm; returns its JSON-able result."""
    import paddle_tpu_torch as pt
    from ..io import DevicePrefetcher
    pt.seed(seed)
    step = flagship_step(pt, model)
    net = step.model
    device = next(net.parameters()).device
    vocab = net.ernie.embeddings.word_embeddings.weight.shape[0]
    np.random.seed(seed)
    ids_np = np.random.randint(0, vocab, (n_steps, batch, seq)).astype(
        np.int32)
    nsp_np = np.random.randint(0, 2, (n_steps, batch)).astype(np.int32)
    ids_all = torch.from_numpy(ids_np).to(device)
    nsp_all = torch.from_numpy(nsp_np).to(device)

    def run():
        return step.run(ids_all, ids_all, nsp_all)

    t0 = time.perf_counter()
    first = run()                    # warm-up span: the capture is in it
    _sync(device)
    first_span_s = time.perf_counter() - t0
    _reset_peak(device)
    sps, spread, last = _timed_rate(run, batch * n_steps, reps, device)
    peak = _peak(device)
    one = (ids_all[0], ids_all[0], nsp_all[0])
    cost = step.cost_analysis(*one)
    memory = dict(step.memory_report(*one), **peak)
    split = step_split_ms(step, *one) if device.type == "cuda" else None

    # prefetch on/off on the per-step path (bench.py _overlap_ab): the same
    # host batches, fed as numpy to the step or staged by the prefetcher
    overlap = {}
    src = [(ids_np[0].copy(), ids_np[0].copy(), nsp_np[0].copy())
           for _ in range(prefetch_steps)]
    step(*src[0])
    for mode in ("prefetch_off", "prefetch_on"):
        feed = src if mode == "prefetch_off" else \
            DevicePrefetcher(src, step=step, depth=2)
        _sync(device)
        t0 = time.perf_counter()
        loss = None
        for b in feed:
            loss = step(*b)
        _sync(device)
        overlap[mode] = {"samples_per_sec":
                         batch * prefetch_steps / (time.perf_counter() - t0)}
        if feed is not src:
            feed.close()
    overlap["speedup"] = overlap["prefetch_on"]["samples_per_sec"] / \
        overlap["prefetch_off"]["samples_per_sec"]

    flops_sample = flagship_flops_per_sample(net, seq)
    losses = [float(x) for x in first] + [float(x) for x in last]
    return {"samples_per_sec": sps, "spread": spread,
            "mfu": sps * flops_sample / PEAK_BF16,
            "mfu_attributed": cost["flops"] * (sps / batch) / PEAK_BF16,
            "flops_per_step_formula": flops_sample * batch,
            "flops_per_step_attributed": cost["flops"],
            "bytes_per_step_attributed": cost["bytes_accessed"],
            "step_ms": batch / sps * 1e3,
            "split_ms": split, "overlap": overlap, "memory": memory,
            "first_span_s": first_span_s,
            "losses_first_span": losses[:n_steps],
            "loss_first": losses[0], "loss_last": losses[-1],
            "batch": batch, "seqlen": seq, "n_steps": n_steps,
            "reps": reps, "attention": "einsum path (S below the "
            "dispatch's 1024-token kernel threshold)"}


def titan_step(pt, h=4096, ffn=16384, heads=64, n_layers=4, remat="dots"):
    """Four titan layers' TrainStep (bench.py:706-715)."""
    net = pt.models.ErnieScanStack(h, heads, ffn, n_layers, remat=remat)

    def loss_fn(out):
        return (out ** 2).mean()

    opt = pt.optimizer.AdamW(parameters=net.parameters(), learning_rate=1e-4)
    return pt.jit.TrainStep(net, loss_fn, opt, amp_dtype="bfloat16",
                            n_model_inputs=1)


def ernie10b_layer(h=4096, ffn=16384, heads=64, seq=2048, batch=2,
                   n_layers=4, n_steps=10, reps=3, remat="dots", seed=0):
    """The titan arm; returns its JSON-able result."""
    import paddle_tpu_torch as pt
    pt.seed(seed)
    step = titan_step(pt, h, ffn, heads, n_layers, remat)
    device = next(step.model.parameters()).device
    np.random.seed(seed)
    x = torch.from_numpy(np.random.rand(n_steps, batch, seq, h).astype(
        np.float32) * 0.02).to(device)
    t0 = time.perf_counter()
    first = step.run(x)              # warm-up span: the capture is in it
    _sync(device)
    first_span_s = time.perf_counter() - t0
    _reset_peak(device)
    sps, spread, last = _timed_rate(lambda: step.run(x), n_steps, reps,
                                    device)
    peak = _peak(device)
    memory = dict(step.memory_report(x[0]), **peak)
    # per-layer products: qkv + out (4h^2) + mlp (2·h·ffn) (bench.py:727)
    n_matmul = 4 * h * h + 2 * h * ffn
    flops_step = batch * (6 * n_matmul * seq + 3 * 4 * seq * seq * h)
    losses = [float(v) for v in first] + [float(v) for v in last]
    return {"layer_step_ms_per_sample": 1000.0 / (sps * n_layers) / batch,
            "mfu": sps * n_layers * flops_step / PEAK_BF16,
            "steps_per_sec": sps, "spread": spread,
            "step_ms": 1000.0 / sps, "memory": memory,
            "first_span_s": first_span_s,
            "losses_first_span": losses[:n_steps],
            "loss_first": losses[0], "loss_last": losses[-1],
            "geometry": f"h{h}xffn{ffn}x{heads}head seq{seq}",
            "layers": n_layers, "batch": batch, "remat": remat,
            "n_steps": n_steps, "reps": reps}


def _quantiles(hist):
    return {k: hist.get(k, 0.0) for k in ("p50", "p95", "p99")}


def serve_llm(lm, cfg, prompts, clients=1):
    """Serve `prompts` through an `LLMEngine(lm, cfg)` on the current
    device, submitted from `clients` threads (each submits its share, then
    waits for it), with the monitor on. Returns (the engine, running and
    idle: the caller stops it; [(status, tokens)] per prompt; the metrics
    of bench.py's llm arm from the monitor and the engine's counters)."""
    from .. import monitor
    from ..core import flags
    from ..serving import LLMEngine
    was_on = flags.flag("monitor")
    flags.set_flags({"monitor": True})
    monitor.reset()
    try:
        eng = LLMEngine(lm, cfg).start()   # warm-up captures the step
        captures0 = eng.stats()["counters"]["graph_captures"]
        results = [None] * len(prompts)
        errors = []

        def client(idxs):
            try:
                streams = [(i, eng.submit(prompts[i])) for i in idxs]
                for i, st in streams:
                    results[i] = st.result(timeout=600.0)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        threads = [threading.Thread(target=client,
                                    args=(range(j, len(prompts), clients),))
                   for j in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            eng.stop(drain=False)
            raise RuntimeError(f"llm arm: requests failed {errors}")
        snap = monitor.snapshot()
    finally:
        flags.set_flags({"monitor": was_on})
    hist, counters = snap["histograms"], eng.stats()["counters"]
    decode_toks = sum(len(t) for _, t in results)
    return eng, results, {
        "requests": len(prompts), "clients": clients, "wall_s": wall,
        "prefill_tokens_per_s": sum(len(p) for p in prompts) / wall,
        "decode_tokens_per_s": decode_toks / wall,
        "ttft_ms": _quantiles(hist.get("llm.ttft_ms", {})),
        "inter_token_ms": _quantiles(hist.get("llm.inter_token_ms", {})),
        "decode_steps": snap["counters"].get("llm.decode.steps", 0),
        "graph_captures": counters["graph_captures"],
        "steady_state_captures": counters["graph_captures"] - captures0,
        "kv_pool_bytes": eng.kv_pool_bytes(),
        "kv_pool_mb": eng.kv_pool_bytes() / 2 ** 20,
        "warm_start_ms": eng.stats()["warm_start_ms"]}


def llm(big=True, seed=0):
    """bench.py's llm arm (bench.py:1559-1636), both arms; `big` takes its
    `backend == "tpu"` sizes, else its smaller ones. Returns the JSON-able
    result: {"fp32": ..., "int8": ..., "int8_decode_speedup": ...}."""
    import paddle_tpu_torch as pt
    from ..serving import LLMConfig
    vocab, n_req = 8192, (32 if big else 8)
    max_new = 48 if big else 16
    out = {}
    for arm, quant in (("fp32", "off"), ("int8", "int8")):
        pt.seed(seed)                  # the same weights in both arms
        lm = pt.models.GPTForCausalLM(pt.models.GPTModel(
            vocab_size=vocab, hidden_size=256 if big else 64,
            num_layers=4 if big else 2, num_heads=8 if big else 4,
            max_seq_len=512, dropout=0.0))
        cfg = LLMConfig(num_slots=8, max_len=256 if big else 64,
                        max_new_tokens=max_new, quant=quant,
                        kv_int8=(quant == "int8"))
        rng = np.random.default_rng(0)
        lens = rng.integers(4, cfg.max_len - max_new, size=n_req)
        prompts = [rng.integers(0, vocab, size=int(n)).tolist()
                   for n in lens]
        eng, _, out[arm] = serve_llm(lm, cfg, prompts)
        eng.stop()
    out["int8_decode_speedup"] = out["int8"]["decode_tokens_per_s"] / \
        out["fp32"]["decode_tokens_per_s"]
    return out


ARMS = {"ernie_train": ernie_train, "ernie10b_layer": ernie10b_layer,
        "llm": llm}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arm", choices=sorted(ARMS), action="append",
                    required=True)
    ap.add_argument("--device", choices=("gpu", "cpu"), default="gpu",
                    help="run on the card (default) or on the CPU")
    args = ap.parse_args(argv)
    import paddle_tpu_torch as pt
    if args.device == "cpu":
        pt.set_device("cpu")
        card = device = "cpu"
    else:
        if not torch.cuda.is_available():
            raise SystemExit("paddle_tpu_torch.utils.bench measures the "
                             "card: no CUDA device (--device cpu runs on "
                             "the CPU)")
        from .train_profile import _card
        torch.backends.cuda.matmul.allow_tf32 = False
        pt.set_device("gpu")
        card, device = _card(), torch.cuda.get_device_name(0)
    for arm in args.arm:
        r = ARMS[arm](big=args.device == "gpu") if arm == "llm" \
            else ARMS[arm]()
        r.update(arm=arm, card=card, device=device)
        print(json.dumps(r), flush=True)
        if args.device == "gpu":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
