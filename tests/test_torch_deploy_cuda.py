"""Slice 12 on a card: the deploy path (`jit.save` -> `inference.Config`
-> `create_predictor`) and the two TrainStep repairs.

Every test is marked `cuda` and skips without a CUDA device; the CPU
tests hold the port to the JAX package. fp32 with TF32 off: the artifact
on the card within 1e-5 relative L2 of the live layer on the CPU. The
file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_deploy_cuda.py
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt

REL_TOL = 1e-5
GPT = dict(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
           max_seq_len=1024, dropout=0.0)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the exported program dispatches "
                    "to the CUDA kernels and CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pt.set_device("gpu")
    yield torch.device("cuda")
    pt.set_device("cpu")


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return ((a - b).norm() / b.norm()).item()


def _save(net, path, shape, dtype="float32", precision=None):
    pt.jit.save(net, path, input_spec=[pt.InputSpec(shape, dtype)],
                precision=precision)
    return pt.inference.create_predictor(pt.inference.Config(path))


def _flash_nodes(pred):
    return sum(str(n.target) == "paddle_tpu_torch.flash_fwd.default"
               for n in pred._translated.program().graph.nodes)


@pytest.mark.cuda
def test_artifact_on_the_card_matches_the_live_layer_on_the_cpu(
        cuda_device, tmp_path):
    pt.seed(0)
    net = pt.models.resnet18(num_classes=10, data_format="NHWC")
    pred = _save(net, str(tmp_path / "r18"), [4, 64, 64, 3])
    x = np.random.default_rng(0).random((4, 64, 64, 3), dtype=np.float32)
    first = pred.run([x])[0]
    again = pred.run([x])[0]            # a replay of the captured graph
    assert len(pred._translated._graphs) == 1
    with torch.inference_mode():
        ref = copy.deepcopy(net).cpu().eval()(torch.from_numpy(x))
    assert _rel(first, ref) <= REL_TOL
    assert torch.equal(first, again)
    other = pred.run([x[::-1].copy()])[0]
    assert not torch.equal(other, first)       # no aliasing of the graph's
    assert torch.equal(pred.run([x])[0], again)  # static outputs


@pytest.mark.cuda
def test_gpt_artifact_exported_on_the_card_takes_the_kernel(cuda_device,
                                                            tmp_path):
    from paddle_tpu_torch.kernels import flash_attention as fa
    pt.seed(0)
    lm = pt.models.GPTForCausalLM(pt.models.GPTModel(**GPT))
    pred = _save(lm, str(tmp_path / "gpt"), [2, 1024], "int32", "bfloat16")
    assert _flash_nodes(pred) == GPT["num_layers"]
    ids = np.random.default_rng(0).integers(0, 512, (2, 1024)).astype(
        np.int32)
    fa.flash_attention_fwd.launches = 0
    got = pred.run_batch([ids])[0]
    assert fa.flash_attention_fwd.launches == 2 * GPT["num_layers"]
    live = pt.inference.Predictor(copy.deepcopy(lm).to(torch.bfloat16),
                                  input_spec=[pt.InputSpec([2, 1024],
                                                           "int32")])
    np.testing.assert_array_equal(got, live.run_batch([ids])[0])


@pytest.mark.cuda
def test_cpu_exported_artifact_keeps_the_einsum_path(cuda_device,
                                                     tmp_path):
    from paddle_tpu_torch.kernels import flash_attention as fa
    pt.set_device("cpu")
    pt.seed(0)
    lm = pt.models.GPTForCausalLM(pt.models.GPTModel(**GPT))
    path = str(tmp_path / "gpt_cpu")
    pt.jit.save(lm, path, input_spec=[pt.InputSpec([2, 1024], "int32")],
                precision="bfloat16")
    pt.set_device("gpu")
    pred = pt.inference.create_predictor(pt.inference.Config(path))
    assert pred.device.type == "cuda" and _flash_nodes(pred) == 0
    ids = np.random.default_rng(0).integers(0, 512, (2, 1024)).astype(
        np.int32)
    fa.flash_attention_fwd.launches = 0
    got = pred.run_batch([ids])[0]
    assert fa.flash_attention_fwd.launches == 0
    live = pt.inference.Predictor(copy.deepcopy(lm).to(torch.bfloat16),
                                  input_spec=[pt.InputSpec([2, 1024],
                                                           "int32")],
                                  device="cpu")
    want = live.run_batch([ids])[0]
    assert np.abs(got - want).mean() / np.abs(want).mean() <= 2e-2


@pytest.mark.cuda
def test_bn_statistics_unchanged_under_a_captured_run(cuda_device):
    pt.seed(0)
    nn = pt.nn
    net = nn.Sequential(nn.Conv2D(3, 8, 3, data_format="NHWC"),
                        nn.BatchNorm2D(8, data_format="NHWC"), nn.ReLU(),
                        nn.Flatten(), nn.Linear(8 * 14 * 14, 5))
    step = pt.jit.TrainStep(net, nn.CrossEntropyLoss(), pt.optimizer.SGD(
        0.1, parameters=net.parameters()))
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.random((4, 8, 16, 16, 3),
                                     dtype=np.float32)).cuda()
    ys = torch.from_numpy(rng.integers(0, 5, (4, 8))).cuda()
    losses = step.run(xs, ys)
    step.run(xs, ys)                     # replays only
    assert len(step._graphs) == 1 and torch.isfinite(losses).all()
    assert not net[1]._mean.any()
    assert torch.equal(net[1]._variance, torch.ones_like(net[1]._variance))


@pytest.mark.cuda
def test_capture_after_an_eager_loop_that_kept_its_graph(cuda_device):
    from paddle_tpu_torch.utils import bench
    net, opt, ce, x, y, _ = bench.lenet_loop(pt)
    kept = ce(net(x), y)
    kept.backward()
    opt.step()
    opt.clear_grad()
    step = pt.jit.TrainStep(net, ce, pt.optimizer.SGD(
        parameters=net.parameters(), learning_rate=0.01))
    losses = step.run(x.expand([5] + x.shape), y.expand([5] + y.shape))
    assert kept.grad_fn is not None
    assert len(step._graphs) == 1 and torch.isfinite(losses).all()
