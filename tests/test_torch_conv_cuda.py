"""Slice 11 on a card: ResNet-50's stem (the ported Conv2D, BatchNorm2D,
ReLU and MaxPool2D) and one `_foreach` step of each optimizer, each
against the same call on the CPU.

Every test is marked `cuda` and skips without a CUDA device. The port's
CPU path is the reference here (the CPU tests hold it to the JAX
package). fp32 with TF32 off: relative L2 error within 1e-5 for the stem
(cuDNN sums in another order); the optimizers within 1e-6 (1 + |ref|)
(multi-tensor-apply against a loop over the same gradients). The file
imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_conv_cuda.py
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt

STEM_TOL = 1e-5
RULE_TOL = 1e-6


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: cuDNN and multi-tensor-apply have "
                    "no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    pt.set_device("cpu")


def _stem(fmt):
    nn = pt.nn
    return nn.Sequential(
        nn.Conv2D(3, 64, 7, stride=2, padding=3, bias_attr=False,
                  data_format=fmt),
        nn.BatchNorm2D(64, data_format=fmt), nn.ReLU(),
        nn.MaxPool2D(3, 2, 1, data_format=fmt))


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return ((a - b).norm() / b.norm()).item()


def _run_stem(device, fmt, x, g):
    pt.set_device("gpu" if device == "cuda" else device)
    pt.seed(0)
    m = _stem(fmt)
    xt = torch.tensor(x, device=device, requires_grad=True)
    inp = xt.permute(0, 2, 3, 1).contiguous() if fmt == "NHWC" else xt
    out = m(inp)
    if fmt == "NHWC":
        out = out.permute(0, 3, 1, 2)
    (out * torch.tensor(g, device=device)).sum().backward()
    return [out, xt.grad, m[0].weight.grad, m[1].weight.grad, m[1].bias.grad,
            m[1]._mean, m[1]._variance]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_stem_forward_backward_matches_the_cpu(cuda_device, fmt):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 3, 64, 64), dtype=np.float32)
    g = rng.standard_normal((4, 64, 16, 16), dtype=np.float32)
    want = _run_stem("cpu", "NCHW", x, g)
    got = _run_stem("cuda", fmt, x, g)
    for i, (a, b) in enumerate(zip(got, want)):
        assert _rel(a, b) <= STEM_TOL, (fmt, i, _rel(a, b))


def _zoo(name, params):
    o = pt.optimizer
    return {"SGD": lambda: o.SGD(0.01, params, weight_decay=0.01),
            "Momentum": lambda: o.Momentum(0.01, 0.9, params,
                                           use_nesterov=True),
            "Adam": lambda: o.Adam(1e-3, parameters=params),
            "AdamW": lambda: o.AdamW(1e-3, parameters=params),
            "Adamax": lambda: o.Adamax(1e-3, parameters=params),
            "Lamb": lambda: o.Lamb(1e-3, 0.01, parameters=params),
            "Adagrad": lambda: o.Adagrad(1e-2, parameters=params),
            "RMSProp": lambda: o.RMSProp(1e-3, 0.9, 1e-6, 0.5, True,
                                         params),
            "Adadelta": lambda: o.Adadelta(1.0, parameters=params),
            "LarsMomentum": lambda: o.LarsMomentum(0.01, 0.9,
                                                   parameters=params)}[name]()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["SGD", "Momentum", "Adam", "AdamW",
                                  "Adamax", "Lamb", "Adagrad", "RMSProp",
                                  "Adadelta", "LarsMomentum"])
def test_foreach_rule_matches_the_cpu(cuda_device, name):
    rng = np.random.default_rng(1)
    shapes = [(64, 3, 7, 7), (64,), (120, 84), (10,)]
    values = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 0.1
              for s in shapes] for _ in range(3)]
    out = {}
    for dev in ("cpu", "cuda"):
        params = [pt.Parameter(torch.tensor(v, device=dev)) for v in values]
        params[1].optimize_attr["learning_rate"] = 0.5
        opt = _zoo(name, params)
        for gs in grads:
            for p, g in zip(params, gs):
                p.grad = torch.tensor(g, device=dev)
            opt.step()
            opt.clear_grad()
        out[dev] = params
    for a, b in zip(out["cuda"], out["cpu"]):
        err = (a.detach().cpu() - b.detach()).abs().max().item()
        assert err <= RULE_TOL * (1 + b.detach().abs().max().item()), \
            (name, err)
