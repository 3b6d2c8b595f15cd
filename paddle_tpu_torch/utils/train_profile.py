"""Where a training (decode, inference) step's device time goes, from a
torch.profiler trace.

Trains one of the training paths that chip_smoke.py drives, in bf16 AMP
through `jit.TrainStep` + `AdamW(1e-4)`:

- `--model gpt2` (default): `GPTForCausalLM(gpt2_small(dropout=0.0))` on
  8 x 1024 tokens;
- `--model ernie_sp`: `ErnieForPretraining(ernie_base(hidden_dropout_prob=
  0.0, use_sp=True))` on 8 x 512 tokens with the MLM + NSP loss, under
  `HybridCommunicateGroup(sp_degree=4)` over four slots of `cuda:0` (or
  four cards when there are four);
- `--model ernie`: the flagship of `utils/bench.py`, ERNIE-base without sp
  on 32 x 128 tokens;
- `--model ernie_dp`: config 3's step (`utils/bench.py dp_step`: the
  flagship through `fleet.distributed_model` and `SPMDTrainStep(
  grad_reduction="bucketed")`) in a world of one NCCL rank made in this
  process: where the data-parallel step's time goes beside `--model
  ernie`'s `__call__`; no `run()` span;
- `--model titan`: the titan arm of `utils/bench.py`, four layers of
  `ErnieScanStack(4096, 64, 16384, remat="dots")` on 2 x 2048;
- `--model titan_fp16` / `ernie_sp_fp16`: the titan stack / the sp
  ERNIE in fp16 AMP, eager (`TrainStep` takes no loss scaler):
  `auto_cast(dtype="float16")`, the scaled backward and
  `GradScaler().step(AdamW(1e-4))`. These have no `run()` span; they are
  also timed with FLAGS_amp_fused_update off (the legacy unscale_, a
  host read of found_inf, then the ungated update);
- `--model gpt2_dygraph`: the same GPT-2 small batch through the paddle
  user's dygraph loop of chip_smoke.py's dygraph phase (`Tensor` ids,
  eager `auto_cast(bf16)` (O1) forward, the loss in f32, `backward()`,
  AdamW's `step()`, `clear_grad()`): where its time goes beside
  `--model gpt2`'s TrainStep `__call__`; no `run()` span;
- `--model lenet`: bench.py's `lenet_dispatch` loop (`utils/bench.py
  lenet_loop`): a call is one eager dygraph step of LeNet on 32 x 1 x 28 x
  28 (`ce(net(x), y)`, `backward()`, SGD's `step()`, `clear_grad()`), and
  `run()` a `jit.TrainStep(...).run()` span of the same model, loss and
  SGD (fp32, one CUDA-graph replay per step);
- `--model stem` / `stem_nhwc` / `stem_bf16` / `stem_nhwc_bf16`:
  ResNet-50's stem (`Conv2D(3, 64, 7, stride=2, padding=3,
  bias_attr=False)`, `BatchNorm2D(64)`, `ReLU`, `MaxPool2D(3, 2, 1)`) at
  bench.py's `resnet50_infer` batch, 128 x 3 x 224 x 224, forward +
  backward (no input gradient), NCHW or NHWC, fp32 or bf16 `auto_cast`;
  no `run()` span;
- `--model resnet50_infer` / `resnet50_infer_int8` / `gpt2_deploy`: not
  a training step but one `run()` of a loaded Predictor (`jit.save` ->
  `Config` -> `create_predictor`): ResNet-50 NHWC at bench.py's 128 x 224
  x 224 x 3, exported bf16 or weight-only int8, and GPT-2 small's bf16
  artifact at 4 x 1024 ids (12 flash forwards per run); no `run()` span;
- `--model yoloe_infer` / `ocr_rec_infer`: one `run()` of bench.py's
  config-4 artifacts (`utils/bench.py config4_model`): PP-YOLOE-s NHWC at
  64 x 640 x 640 x 3 and PP-OCRv3 rec at 64 x 32 x 320 x 3, exported
  bf16; no `run()` span;
- `--model transformer`: the base Transformer (`transformer_step`: d_model
  512, 6 + 6 layers, src = tgt = 8 x 1024, causal target mask) trained in
  bf16 AMP through TrainStep + AdamW on mean((out - y) ** 2);
- `--model llm_decode` / `llm_decode_int8`: not a training step but one
  decode step of `serving.LLMEngine`'s whole pool, as chip_smoke.py's llm
  phase configures it (gpt2_small, 16 slots, max_len 1022, every slot
  prefilled with 16-896 prompt tokens; fp32, or int8 weights + int8 KV):
  a call is the eager step, `run()` one replay of the captured graph per
  step.

It warms up, times a few steps without the profiler (host clock, synced),
then traces as many with CUPTI and prints the device time per step by
kernel, grouped into the ring-attention kernels, the other attention
kernels (flash, the backward's prep pass), the matrix products, the
elementwise and reduction kernels and the optimizer's, with the device's
idle share of the traced window and of the untraced steps. It does the
same for a `run()` span of as many steps (one CUDA-graph replay per step,
after a first span that captures). Run on a machine with a CUDA device:

    python -m paddle_tpu_torch.utils.train_profile
        [--model gpt2|gpt2_dygraph|ernie_sp|ernie|titan|titan_fp16|
                 ernie_sp_fp16|lenet|stem|stem_nhwc|stem_bf16|stem_nhwc_bf16|
                 llm_decode|llm_decode_int8|resnet50_infer|
                 resnet50_infer_int8|gpt2_deploy|yoloe_infer|
                 ocr_rec_infer|transformer]
        [--steps 3] [--top 20]

Prints one line per kernel group and per top kernel, and a JSON object as
its last line.

`kernel_counts(graph_kernel_names(graph))` counts the port's kernels
among the kernel nodes of a captured `torch.cuda.CUDAGraph` (made with
keep_graph=True): a replay runs every node of its graph, so these are
exactly the launches of one replay, which a profiler trace of a replay
can undercount.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import re
import subprocess
import time

import numpy as np
import torch

# kernel-name patterns of each group, tried in order
GROUPS = (("ring_attention", ("ring_fwd", "ring_dq", "ring_dkv")),
          ("attention", ("flash_fwd", "flash_bwd")),
          ("optimizer", ("foreach", "multi_tensor")),
          # the scaler-gated update's copies of each parameter and its
          # slots and the selects that restore them on found_inf
          ("selects_and_device_copies", ("where_kernel", "memcpy dtod")),
          # cuDNN's RNN kernels and aten's fused LSTM / GRU cells
          ("recurrent", ("rnn", "lstm", "gru_cell")),
          ("convolutions", ("conv2d", "conv_depthwise", "convolve",
                            "implicit_gemm", "fprop", "dgrad", "wgrad")),
          ("products", ("gemm", "cutlass", "sm90_xmma", "nvjet", "cublas",
                        "gemv", "splitk")),
          ("elementwise_and_reductions", ("",)))


# the port's kernels by their symbols in a device trace or a graph's nodes
# (the C entries launch these; a template's arguments tell the fused
# backward from the dk/dv pass: `true` in a trace, `(bool)1` from
# cu++filt)
KERNEL_SYMBOLS = (
    ("flash_fwd", re.compile(r"\bflash_fwd_\w+_kernel\b")),
    ("flash_bwd_fused",
     re.compile(r"\bflash_bwd_kv_\w+_kernel<[^>]*(true|\(bool\)1)>")),
    ("flash_bwd_dkv",
     re.compile(r"\bflash_bwd_kv_\w+_kernel<[^>]*(false|\(bool\)0)>")),
    ("flash_bwd_dq", re.compile(r"\bflash_bwd_dq_(wgmma|mma|f32)_kernel\b")),
    ("ring_fwd", re.compile(r"\bring_fwd_\w+_kernel\b")),
    ("ring_dq_step", re.compile(r"\bring_dq_\w+_kernel\b")),
    ("ring_dkv", re.compile(r"\bring_dkv_\w+_kernel\b")),
    ("gemm", re.compile(r"gemm|cutlass|nvjet|xmma", re.IGNORECASE)))


def kernel_launches(prof) -> dict:
    """Launches of the port's kernels (and of the GEMMs) in a
    `torch.profiler` trace, counted from its CUDA kernel events by
    symbol: the count a CUDA graph's replays run, which the wrappers'
    `.launches` (host calls) do not see."""
    return kernel_counts(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)


def kernel_counts(names) -> dict:
    """Launches of the port's kernels (and of the GEMMs) among kernel
    names, by symbol."""
    counts = {name: 0 for name, _ in KERNEL_SYMBOLS}
    for n in names:
        for name, pattern in KERNEL_SYMBOLS:
            if pattern.search(n):
                counts[name] += 1
                break
    return counts


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h (CUDA 12)."""
    _fields_ = [("func", ctypes.c_void_p),
                ("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


_CU_GRAPH_NODE_TYPE_KERNEL = 0
_CU_GRAPH_NODE_TYPE_GRAPH = 4      # a child graph (cuDNN may capture one)


def _libcuda():
    cu = ctypes.CDLL("libcuda.so.1")
    vp, ref = ctypes.c_void_p, ctypes.POINTER
    sigs = {"cuGraphGetNodes": [vp, vp, ref(ctypes.c_size_t)],
            "cuGraphNodeGetType": [vp, ref(ctypes.c_int)],
            "cuGraphChildGraphNodeGetGraph": [vp, ref(vp)],
            "cuGraphKernelNodeGetParams_v2": [vp, ref(_KernelNodeParams)],
            "cuFuncGetName": [ref(ctypes.c_char_p), vp],
            "cuKernelGetName": [ref(ctypes.c_char_p), vp]}
    for fn, args in sigs.items():
        getattr(cu, fn).argtypes = args
        getattr(cu, fn).restype = ctypes.c_int
    return cu


def _demangle(names):
    cuda_tool = "/usr/local/cuda/bin/cu++filt"
    tool = shutil.which("cu++filt") or shutil.which("c++filt") or \
        (cuda_tool if os.path.exists(cuda_tool) else None)
    if tool is None or not names:
        return list(names)
    res = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60, check=True)
    out = res.stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def _ok(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUresult {rc}")


def _kernel_nodes(cu, g):
    """The kernel nodes of the CUDA graph `g` and of its child graphs."""
    n = ctypes.c_size_t(0)
    _ok(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    _ok(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        _ok(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
            "cuGraphNodeGetType")
        if kind.value == _CU_GRAPH_NODE_TYPE_KERNEL:
            out.append(node)
        elif kind.value == _CU_GRAPH_NODE_TYPE_GRAPH:
            child = ctypes.c_void_p()
            _ok(cu.cuGraphChildGraphNodeGetGraph(node, ctypes.byref(child)),
                "cuGraphChildGraphNodeGetGraph")
            out += _kernel_nodes(cu, child)
    return out


def graph_kernel_names(graph) -> list:
    """The (demangled) kernel names of every kernel node of a captured
    `torch.cuda.CUDAGraph` made with keep_graph=True, child graphs
    included, read through libcuda (`cuGraphGetNodes`,
    `cuGraphKernelNodeGetParams`, `cuFuncGetName` / `cuKernelGetName`)."""
    cu = _libcuda()
    names = []
    for node in _kernel_nodes(cu, ctypes.c_void_p(graph.raw_cuda_graph())):
        prm = _KernelNodeParams()
        _ok(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(prm)),
            "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if prm.func:
            _ok(cu.cuFuncGetName(ctypes.byref(name), prm.func),
                "cuFuncGetName")
        else:
            _ok(cu.cuKernelGetName(ctypes.byref(name), prm.kern),
                "cuKernelGetName")
        names.append(name.value.decode())
    return _demangle(names)


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


def _gpt2_dygraph(pt, rng):
    """gpt2_small's dygraph O1 step on Tensor ids of 8 x 1024."""
    model = pt.models.GPTForCausalLM(pt.models.gpt2_small(dropout=0.0))
    vocab = model.gpt.embeddings.word_embeddings.weight.shape[0]
    opt = pt.optimizer.AdamW(1e-4, parameters=model.parameters())
    F = pt.nn.functional

    def step(ids):
        with pt.amp.auto_cast(dtype="bfloat16"):
            logits = model(ids)
        loss = F.cross_entropy(
            logits[:, :-1].reshape([-1, vocab]).astype("float32"),
            ids[:, 1:].reshape([-1])).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()

    return step, (pt.to_tensor(rng.integers(0, vocab, (8, 1024))),)


def _sp_ernie(pt, sp):
    """ERNIE-base with use_sp=True over an sp mesh of four cards, or of
    four slots of `cuda:0` on one card; its vocabulary size."""
    n = torch.cuda.device_count()
    devices = [torch.device("cuda", i) for i in range(sp)] if n >= sp \
        else [torch.device("cuda", 0)] * sp
    pt.parallel.HybridCommunicateGroup(hybrid_configs={"sp_degree": sp},
                                       devices=devices)
    net = pt.models.ErnieForPretraining(
        pt.models.ernie_base(hidden_dropout_prob=0.0, use_sp=True))
    return net, net.ernie.embeddings.word_embeddings.weight.shape[0]


def _ernie_sp(pt, rng, sp=4):
    """ERNIE-base pretraining over the sp ring: its TrainStep and one batch
    of 8 x 512 token ids with NSP labels."""
    net, vocab = _sp_ernie(pt, sp)
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


def _ernie(pt, rng):
    """The flagship (ERNIE-base without sp) and one batch of 32 x 128."""
    from .bench import flagship_step
    step = flagship_step(pt)
    vocab = step.model.ernie.embeddings.word_embeddings.weight.shape[0]
    ids = torch.from_numpy(rng.integers(0, vocab, (32, 128))).cuda()
    nsp = torch.from_numpy(rng.integers(0, 2, (32,))).cuda()
    return step, (ids, ids, nsp)


def _ernie_dp(pt, rng):
    """Config 3's SPMDTrainStep over a world of one NCCL rank (this
    process) and the flagship's batch of 32 x 128."""
    import os
    from .bench import dp_step
    from ..parallel.launch import rank_envs
    os.environ.update(rank_envs(1, backend="nccl")[0])
    strategy = pt.parallel.DistributedStrategy()
    hcg = pt.distributed.fleet.init(is_collective=True, strategy=strategy)
    step = dp_step(pt, hcg)
    vocab = step.model.ernie.embeddings.word_embeddings.weight.shape[0]
    ids = torch.from_numpy(rng.integers(0, vocab, (32, 128))).cuda()
    nsp = torch.from_numpy(rng.integers(0, 2, (32,))).cuda()
    return step, (ids, ids, nsp)


def _titan(pt, rng):
    """Four titan layers and one batch of 2 x 2048 x 4096 inputs."""
    from .bench import titan_step
    x = torch.from_numpy(rng.random((2, 2048, 4096), np.float32) * 0.02)
    return titan_step(pt), (x.cuda(),)


def _titan_fp16(pt, rng):
    """The titan stack's eager fp16 AMP step with a GradScaler and one
    batch of 2 x 2048 x 4096 inputs."""
    net = pt.models.ErnieScanStack(4096, 64, 16384, 4, remat="dots")
    opt = pt.optimizer.AdamW(learning_rate=1e-4, parameters=net.parameters())
    scaler = pt.amp.GradScaler()

    def step(x):
        with pt.amp.auto_cast(dtype="float16"):
            loss = (net(x) ** 2).mean()
        scaler.scale(loss).backward()
        scaler.step(opt)             # also updates the scale
        opt.clear_grad()
        return loss.detach()

    x = torch.from_numpy(rng.random((2, 2048, 4096), np.float32) * 0.02)
    return step, (x.cuda(),)


def _ernie_sp_fp16(pt, rng, sp=4):
    """The sp ERNIE's eager fp16 AMP step: the MLM + NSP loss in f32 on
    the fp16 logits, AdamW(1e-4), and a GradScaler started at 2^11, the
    scale at which the default one (2^15) settles on this model, so that
    no timed step is skipped on overflow; one batch of 8 x 512."""
    net, vocab = _sp_ernie(pt, sp)
    ce = pt.nn.CrossEntropyLoss()
    opt = pt.optimizer.AdamW(learning_rate=1e-4, parameters=net.parameters())
    scaler = pt.amp.GradScaler(init_loss_scaling=2.0 ** 11)

    def step(ids, nsp):
        with pt.amp.auto_cast(dtype="float16"):
            logits, nsp_logits = net(ids)
            loss = ce(logits.float().reshape(-1, vocab), ids.reshape(-1)) \
                + ce(nsp_logits.float(), nsp)
        scaler.scale(loss).backward()
        scaler.step(opt)
        opt.clear_grad()
        return loss.detach()

    ids = torch.from_numpy(rng.integers(0, vocab, (8, 512))).cuda()
    nsp = torch.from_numpy(rng.integers(0, 2, (8,))).cuda()
    return step, (ids, nsp)


class _DecodeSteps:
    """An LLMEngine's decode step of the whole pool, driven as profile()
    drives a training step: a call is one eager step, `run(stacked)` one
    graph replay per row of `stacked`. Every step decodes the same tokens
    at the same positions (each rewrites the same pool rows)."""

    def __init__(self, eng, toks, pos):
        self.eng, self._toks, self._pos = eng, toks, pos

    def __call__(self, tokens):
        self.eng._decode_step(self._toks, self._pos, replay=False)

    def run(self, stacked):
        for _ in range(stacked.shape[0]):
            self.eng._decode_step(self._toks, self._pos)


def _llm_decode(pt, rng, int8=False):
    """gpt2_small behind an LLMEngine (16 slots, max_len 1022), warmed up
    (the decode step captured), every slot prefilled with a prompt of
    16-896 tokens; the step is one decode step of the pool."""
    from ..serving import LLMConfig, LLMEngine
    lm = pt.models.GPTForCausalLM(pt.models.gpt2_small(dropout=0.0))
    eng = LLMEngine(lm, LLMConfig(num_slots=16, max_len=1022,
                                  quant="int8" if int8 else "off",
                                  kv_int8=int8))
    eng._warmup()
    vocab = lm.gpt.embeddings.word_embeddings.weight.shape[0]
    toks, pos = np.zeros(16, np.int32), np.zeros(16, np.int32)
    for slot in range(16):
        prompt = rng.integers(0, vocab, size=int(rng.integers(16, 897)))
        toks[slot], _ = eng._prefill_slot(prompt.astype(np.int32), slot)
        pos[slot] = prompt.size
    return _DecodeSteps(eng, toks, pos), (torch.from_numpy(toks).cuda(),)


class _LenetSteps:
    """bench.py's LeNet loop driven as profile() drives a training step: a
    call is one eager dygraph step on the bench's batch, `run(xs, ys)` a
    TrainStep span (one graph replay per step)."""

    def __init__(self, pt):
        from .bench import lenet_loop
        net, _, ce, self.x, self.y, self._one = lenet_loop(pt)
        self.train_step = pt.jit.TrainStep(net, ce, pt.optimizer.SGD(
            parameters=net.parameters(), learning_rate=0.01))

    def __call__(self, x, y):
        self._one()

    def run(self, xs, ys):
        return self.train_step.run(xs, ys)


def _lenet(pt, rng):
    steps = _LenetSteps(pt)
    return steps, (steps.x, steps.y)


def _stem(pt, rng, fmt="NCHW", dtype="float32"):
    """ResNet-50's stem, forward + backward at 128 x 3 x 224 x 224."""
    nn = pt.nn
    m = nn.Sequential(
        nn.Conv2D(3, 64, 7, stride=2, padding=3, bias_attr=False,
                  data_format=fmt),
        nn.BatchNorm2D(64, data_format=fmt), nn.ReLU(),
        nn.MaxPool2D(3, 2, 1, data_format=fmt))
    x = torch.from_numpy(rng.standard_normal((128, 3, 224, 224),
                                             dtype=np.float32)).cuda()
    if fmt == "NHWC":
        x = x.permute(0, 2, 3, 1).contiguous()

    def step(x):
        with pt.amp.auto_cast(enable=dtype == "bfloat16", dtype=dtype):
            out = m(x)
        out.backward(torch.ones_like(out))
        for p in m.parameters():
            p.grad = None

    return step, (x,)


def _deploy(pt, rng, net, in_shape, precision, dtype="float32"):
    """A loaded Predictor (`jit.save` -> `Config` -> `create_predictor`,
    `utils/bench.py deploy_predictor`) with its input fed once; a call is
    one `run()`, as bench.py's deploy spans drive it."""
    from .bench import deploy_predictor
    pred = deploy_predictor(pt, net, in_shape, precision, dtype)
    if dtype == "int32":
        x = rng.integers(0, 50304, size=in_shape).astype(np.int32)
    else:
        x = rng.random(in_shape, dtype=np.float32)
    pred.get_input_handle(pred.get_input_names()[0]).copy_from_cpu(x)
    return (lambda x: pred.run()), (torch.from_numpy(x),)


def _resnet50_infer(pt, rng, precision="bfloat16"):
    """bench.py's resnet50_infer: ResNet-50 NHWC, 128 x 224 x 224 x 3."""
    return _deploy(pt, rng, pt.models.resnet50(data_format="NHWC"),
                   (128, 224, 224, 3), precision)


def _gpt2_deploy(pt, rng):
    """GPT-2 small's bf16 artifact at the serve phase's 4 x 1024 ids."""
    return _deploy(pt, rng, pt.models.GPTForCausalLM(
        pt.models.gpt2_small(dropout=0.0)), (4, 1024), "bfloat16", "int32")


def _config4_infer(pt, rng, name):
    """bench.py's yoloe_infer / ocr_rec_infer artifact (`utils/bench.py
    config4_model`): PP-YOLOE-s NHWC at 64 x 640 x 640 x 3 or PP-OCRv3 rec
    at 64 x 32 x 320 x 3, exported bf16."""
    from .bench import config4_model
    net, shape, precision = config4_model(pt, name)[:3]
    return _deploy(pt, rng, net, shape, precision)


class Seq2Seq(torch.nn.Module):
    """nn.Transformer on (src, tgt) with a fixed causal `tgt_mask` (a
    constant outside the state), the form `TrainStep(n_model_inputs=2)`
    takes."""

    def __init__(self, transformer, mask):
        super().__init__()
        self.t = transformer
        self.register_buffer("mask", mask, persistent=False)

    def forward(self, src, tgt):
        return self.t(src, tgt, tgt_mask=self.mask)


def transformer_step(pt, rng, batch=8, seq=1024, amp_dtype="bfloat16"):
    """The base Transformer of Vaswani et al. (d_model 512, 8 heads, 6 + 6
    layers, FFN 2048, dropout 0), its TrainStep with AdamW(1e-4) in bf16
    AMP on mean((out - y) ** 2), and one seeded batch: src = tgt = [batch,
    seq, 512] with the causal target mask, y the same shape. Encoder
    self-attention and the equal-length cross-attention take the flash
    kernels, the masked decoder self-attention the einsum path. (The
    output is a LayerNorm's, whose rows have a fixed sum of squares, so
    mean(out ** 2) alone would give every other parameter a zero gradient
    at initialisation.)"""
    t = pt.nn.Transformer(d_model=512, nhead=8, num_encoder_layers=6,
                          num_decoder_layers=6, dim_feedforward=2048,
                          dropout=0.0)
    model = Seq2Seq(t, t.generate_square_subsequent_mask(seq))
    opt = pt.optimizer.AdamW(learning_rate=1e-4,
                             parameters=model.parameters())
    step = pt.jit.TrainStep(model, mse_loss, opt, amp_dtype=amp_dtype,
                            n_model_inputs=2)
    device = next(model.parameters()).device
    src, tgt, y = (torch.from_numpy(rng.standard_normal(
        (batch, seq, 512)).astype(np.float32)).to(device) for _ in range(3))
    return step, (src, tgt, y)


def mse_loss(out, y):
    """mean((out - y) ** 2) in f32."""
    return ((out.float() - y) ** 2).mean()


MODELS = {"gpt2": _gpt2, "gpt2_dygraph": _gpt2_dygraph,
          "ernie_sp": _ernie_sp, "ernie": _ernie, "ernie_dp": _ernie_dp,
          "lenet": _lenet,
          "stem": _stem,
          "stem_nhwc": lambda pt, rng: _stem(pt, rng, "NHWC"),
          "stem_bf16": lambda pt, rng: _stem(pt, rng, "NCHW", "bfloat16"),
          "stem_nhwc_bf16": lambda pt, rng: _stem(pt, rng, "NHWC",
                                                  "bfloat16"),
          "titan": _titan, "titan_fp16": _titan_fp16,
          "ernie_sp_fp16": _ernie_sp_fp16, "llm_decode": _llm_decode,
          "llm_decode_int8": lambda pt, rng: _llm_decode(pt, rng, True),
          "resnet50_infer": _resnet50_infer,
          "resnet50_infer_int8": lambda pt, rng: _resnet50_infer(pt, rng,
                                                                 "int8"),
          "gpt2_deploy": _gpt2_deploy,
          "yoloe_infer": lambda pt, rng: _config4_infer(pt, rng,
                                                        "yoloe_infer"),
          "ocr_rec_infer": lambda pt, rng: _config4_infer(pt, rng,
                                                          "ocr_rec_infer"),
          "transformer": transformer_step}


def _trace(fn, steps):
    """(wall ms per step, busy ms per step, launches per step, kernels,
    host ops, port kernel counts) of fn() under the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
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
    return (wall_ms / steps, busy, sum(n for _, n, _ in kernels), kernels,
            host, {k: v / steps for k, v in kernel_launches(prof).items()})


def _timed_ms(fn, steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def profile(steps=3, top=20, model="gpt2", seed=0):
    import paddle_tpu_torch as pt
    if not torch.cuda.is_available():
        raise RuntimeError("train_profile measures the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pt.set_device("gpu")
    pt.seed(seed)
    step, batch = MODELS[model](pt, np.random.default_rng(seed))
    for _ in range(3):
        step(*batch)

    def calls():
        for _ in range(steps):
            step(*batch)

    plain_ms = _timed_ms(calls, steps)
    wall_ms, busy, launches, kernels, host, ours = _trace(calls, steps)
    groups = {}
    for ms, _, name in kernels:
        g = _group(name)
        groups[g] = groups.get(g, 0.0) + ms
    r = {"card": _card(), "model": model, "steps": steps,
         "tokens": batch[0].numel(),
         "wall_ms_per_step": wall_ms,
         "unprofiled_ms_per_step": plain_ms,
         "device_busy_ms_per_step": busy,
         "idle_share": 1.0 - busy / wall_ms,
         "idle_share_unprofiled": 1.0 - busy / plain_ms,
         "kernel_launches_per_step": launches,
         "port_kernels_per_step": ours,
         "groups_ms_per_step": groups,
         "top": [{"ms_per_step": ms, "launches_per_step": n,
                  "kernel": name[:120]} for ms, n, name in kernels[:top]],
         "host_top": [{"self_ms_per_step": ms, "calls_per_step": n,
                       "op": name[:80]} for ms, n, name in host[:top]],
         "run": None, "legacy_unprofiled_ms_per_step": None}
    if not hasattr(step, "run") and not model.endswith("_fp16"):
        return r
    if not hasattr(step, "run"):     # the eager fp16 step with a scaler
        pt.set_flags({"amp_fused_update": False})
        try:
            calls()
            r["legacy_unprofiled_ms_per_step"] = _timed_ms(calls, steps)
        finally:
            pt.set_flags({"amp_fused_update": True})
        return r
    stacked = [x.expand(steps, *x.shape) for x in batch]

    def span():
        step.run(*stacked)

    span()                           # the first span captures the graph
    run_plain_ms = _timed_ms(span, steps)
    run_wall_ms, run_busy, run_launches, _, run_host, run_ours = \
        _trace(span, steps)
    r["run"] = {"wall_ms_per_step": run_wall_ms,
                "unprofiled_ms_per_step": run_plain_ms,
                "device_busy_ms_per_step": run_busy,
                "idle_share": 1.0 - run_busy / run_wall_ms,
                "idle_share_unprofiled": 1.0 - run_busy / run_plain_ms,
                "kernel_launches_per_step": run_launches,
                "port_kernels_per_step": run_ours,
                "host_top": [{"self_ms_per_step": ms, "calls_per_step": n,
                              "op": name[:80]}
                             for ms, n, name in run_host[:5]]}
    return r


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
    run = r["run"]
    if run is None and r["legacy_unprofiled_ms_per_step"] is not None:
        print(f"train_profile: the same steps with FLAGS_amp_fused_update "
              f"off (unscale_, a host read of found_inf, the ungated "
              f"update): {r['legacy_unprofiled_ms_per_step']:.3f} ms per "
              f"step without the profiler [{card}]", flush=True)
    elif run is not None:
        print(f"train_profile: run() span of {r['steps']} (one graph "
              f"replay per step): wall {run['wall_ms_per_step']:.3f} ms per "
              f"step (profiler on), device busy "
              f"{run['device_busy_ms_per_step']:.3f} ms, idle share "
              f"{run['idle_share']:.3f}; without the profiler "
              f"{run['unprofiled_ms_per_step']:.3f} ms per step, idle share "
              f"{run['idle_share_unprofiled']:.3f}; "
              f"{run['kernel_launches_per_step']} kernel launches per step; "
              f"port kernels per step {run['port_kernels_per_step']} "
              f"[{card}]", flush=True)
    for row in r["top"]:
        print(f"train_profile: {row['ms_per_step']:.3f} ms "
              f"x{row['launches_per_step']} {row['kernel']}", flush=True)
    for row in r["host_top"]:
        print(f"train_profile: host {row['self_ms_per_step']:.3f} ms self "
              f"x{row['calls_per_step']} {row['op']}", flush=True)
    print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
