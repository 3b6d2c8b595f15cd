"""Slice 13 on a card: the sequence layers, CTC, beam search, the config-4
models through the deploy path and `vision.ops`.

Every test is marked `cuda` and skips without a CUDA device; the CPU
tests hold the port to the JAX package. fp32 with TF32 off: the card
within 1e-4 (1 + |ref|) of the same call on the CPU (1e-5 relative L2 for
a loaded artifact against the live layer). The file imports neither jax
nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_seq_cuda.py
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt

TOL = 1e-4


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: cuDNN's RNN kernels, the flash "
                    "kernels and CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pt.set_device("gpu")
    yield torch.device("cuda")
    pt.set_device("cpu")


def _dev(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float(((a - b).abs() / (1 + b.abs())).max())


def _card_and_cpu(make, run):
    """run(module, device) on the card and on a CPU copy of one module."""
    pt.seed(0)
    m = make()
    return run(m, "cuda"), run(copy.deepcopy(m).to("cpu"), "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["LSTM", "GRU", "SimpleRNN"])
@pytest.mark.parametrize("lengths", [False, True])
def test_rnn_card_matches_cpu(cuda_device, mode, lengths):
    rng = np.random.default_rng(0)
    x_np = rng.standard_normal((4, 20, 16)).astype(np.float32)
    seq = np.array([20, 3, 11, 20])

    def run(m, where):
        x = torch.tensor(x_np, device=where, requires_grad=True)
        out, _ = m(x, sequence_length=torch.from_numpy(seq).to(where)
                   if lengths else None)
        out.square().sum().backward()
        return [out, x.grad] + [p.grad for p in m.parameters()]

    got, want = _card_and_cpu(lambda: getattr(pt.nn, mode)(
        16, 32, num_layers=2, direction="bidirect"), run)
    assert _dev(got[0], want[0]) <= TOL
    # cuDNN's fp32 RNN gradients are about ten times less accurate than
    # the CPU's (chip_smoke.py RNN_GRAD_TOL)
    assert max(_dev(a, b) for a, b in zip(got[1:], want[1:])) <= 5e-4


@pytest.mark.cuda
def test_transformer_bf16_reaches_the_flash_kernels(cuda_device):
    from paddle_tpu_torch.kernels import flash_attention as fa
    pt.seed(0)
    t = pt.nn.Transformer(128, 2, 1, 1, 256, dropout=0.0)
    src = torch.randn(2, 1024, 128, device="cuda")
    mask = t.generate_square_subsequent_mask(1024)
    for c in (fa.flash_attention_fwd, fa.flash_attention_bwd_fused):
        c.launches = 0
    with pt.amp.auto_cast(dtype="bfloat16"):
        out16 = t(src, src, tgt_mask=mask)
    out16.float().square().mean().backward()
    # the encoder's self-attention and the cross-attention; the masked
    # decoder self-attention takes the einsum path
    assert fa.flash_attention_fwd.launches == 2
    assert fa.flash_attention_bwd_fused.launches == 2
    with torch.no_grad():
        out32 = t(src, src, tgt_mask=mask)
    rel = ((out16.float() - out32).norm() / out32.norm()).item()
    assert rel < 2e-2


@pytest.mark.cuda
def test_beam_search_card_matches_cpu(cuda_device):
    def make():
        return (pt.nn.Embedding(50, 16), pt.nn.GRUCell(16, 32),
                pt.nn.Linear(32, 50))

    h0 = np.random.default_rng(1).standard_normal((3, 32)).astype(np.float32)

    def run(mods, where):
        mods = [m.to(where) for m in mods]
        dec = pt.nn.BeamSearchDecoder(mods[1], 0, 1, 4, embedding_fn=mods[0],
                                      output_fn=mods[2])
        with torch.no_grad():
            ids, _, lengths = pt.nn.dynamic_decode(
                dec, inits=torch.from_numpy(h0).to(where), max_step_num=12,
                return_length=True)
        return ids, lengths

    pt.seed(0)
    mods = make()
    got = run(mods, "cuda")
    want = run([copy.deepcopy(m) for m in mods], "cpu")
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
def test_ctc_loss_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((40, 6, 30)).astype(np.float32)
    labels = rng.integers(1, 30, (6, 8)).astype(np.int32)
    in_len, lab_len = np.array([40, 40, 30, 17, 40, 2]), \
        np.array([8, 1, 5, 8, 3, 3])      # the last is infeasible

    res = []
    for where in ("cuda", "cpu"):
        x = torch.tensor(logits, device=where, requires_grad=True)
        loss = pt.nn.functional.ctc_loss(
            x, torch.from_numpy(labels).to(where), in_len, lab_len,
            reduction="none")
        loss.sum().backward()
        res.append([loss, x.grad])
    assert torch.isfinite(res[0][0]).all() and res[0][0][-1] > 1e29
    assert max(_dev(a, b) for a, b in zip(*res)) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ocr", "yoloe"])
def test_config4_artifact_on_the_card_matches_the_cpu(cuda_device, name,
                                                      tmp_path):
    pt.seed(0)
    if name == "ocr":
        net = pt.models.pp_ocrv3_rec(n_classes=97, scale=0.25,
                                     hidden_size=16)
        shape = [4, 32, 64, 3]
    else:
        net = pt.models.ppyoloe_s(num_classes=8, data_format="NHWC")
        shape = [2, 96, 96, 3]
    net.eval()
    path = str(tmp_path / name)
    pt.jit.save(net, path, input_spec=[pt.InputSpec(shape)])
    pred = pt.inference.create_predictor(pt.inference.Config(path))
    x = np.random.default_rng(3).random(shape, dtype=np.float32)
    first = pred.run([x])
    again = pred.run([x])                    # a replay of the graph
    with torch.inference_mode():
        want = copy.deepcopy(net).cpu()(torch.from_numpy(x))
    want = want if isinstance(want, list) else [want]
    for a, b, w in zip(first, again, want):
        a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
        assert torch.equal(a, b)
        assert ((a.double() - w.double()).norm() / w.double().norm()) \
            .item() <= 1e-5
    nodes = [str(n.target) for n in pred._translated.program().graph.nodes]
    assert nodes.count("aten.lstm.input") == (2 if name == "ocr" else 0)


@pytest.mark.cuda
def test_vision_ops_card_match_cpu(cuda_device):
    from paddle_tpu_torch.vision import ops
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 10, 10)).astype(np.float32)
    xy = rng.uniform(0, 6, (5, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 4, (5, 2))], 1) \
        .astype(np.float32)
    off = rng.standard_normal((2, 18, 10, 10)).astype(np.float32)
    w = rng.standard_normal((4, 8, 3, 3)).astype(np.float32)
    res = []
    for where in ("cuda", "cpu"):
        xt = torch.tensor(x, device=where, requires_grad=True)
        bt = torch.from_numpy(boxes).to(where)
        bn = torch.tensor([2, 3])
        outs = [ops.roi_align(xt, bt, bn, 2), ops.roi_pool(xt, bt, bn, 2),
                ops.psroi_pool(xt, bt, bn, 2),
                ops.deform_conv2d(xt, torch.from_numpy(off).to(where),
                                  torch.from_numpy(w).to(where), padding=1),
                ops.box_iou(bt, bt)]
        sum(o.sum() for o in outs).backward()
        res.append(outs + [xt.grad])
    assert max(_dev(a, b) for a, b in zip(*res)) <= TOL
