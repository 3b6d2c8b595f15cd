"""The port's vision models (`models/{resnet,vgg,mobilenet}.py`) and the
`vision.models` namespace against the JAX package on the CPU. This file
holds ResNet-18, ResNet-50 (a bottleneck net) and a VGG; the grouped and
depthwise nets run the same `check_model` in
`test_torch_vision_mobilenet.py`, so that test workers run the two files
side by side.

Each model is built in JAX from one seed and carried into the port by
name (`load_numpy_state`). The reference runs one seeded batch in NCHW in
training mode (forward, and the running statistics its batch norms write)
and then in eval mode (forward on those statistics and the gradients); the
port runs the same batch in NCHW and, for the ResNet family, in NHWC (the
input transposed, the same function).

In eval mode (batch norm an affine map on seeded running statistics, the
same in both packages) the outputs and every parameter's gradient of
`sum(out * g)` agree within 1e-4 (1 + |ref|). In training mode (batch
statistics) the output agrees within 5e-3 relative L2 and each running
statistic within 1e-3 (1 + |ref|): at initialisation a deep
batch-normalised net in training mode amplifies rounding (ResNet-50's stem
gradients reach ~800, and the port's own fp32 gradients differ from its
float64 ones by ~4 (1 + |ref|)), so training-mode gradients are not
compared here; batch norm's training backward is held to the reference
layer by layer in `test_torch_nn_functional.py` and
`test_torch_nn_conv_layers.py`. Sizes are cut to 4 x 32 x 32 images, 10
classes and a short VGG feature list (VGG's classifier, 25088 x 4096, is
left out with `num_classes=0`).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.core import autograd as jautograd
import paddle_tpu_torch as pt
from paddle_tpu_torch.utils import load_numpy_state

TOL = 1e-4
# training mode's batch statistics at initialisation amplify rounding
# (measured: ResNeXt-50 NHWC's output 1.1e-3 relative L2, ResNet-50's
# running variances 2.0e-4 (1 + |ref|); ResNet-18 1.6e-5 and 3.4e-5)
TRAIN_OUT_TOL = 5e-3
TRAIN_STAT_TOL = 1e-3

MODELS = {
    "resnet18": lambda m, fmt: m.resnet18(num_classes=10, data_format=fmt),
    "resnet50": lambda m, fmt: m.ResNet(m.BottleneckBlock, 50,
                                        num_classes=10, data_format=fmt),
    "resnext50_32x4d": lambda m, fmt: m.resnext50_32x4d(num_classes=10,
                                                        data_format=fmt),
    "mobilenet_v1": lambda m, fmt: m.mobilenet_v1(scale=0.25,
                                                  num_classes=10),
    "mobilenet_v2": lambda m, fmt: m.mobilenet_v2(scale=0.25,
                                                  num_classes=10),
    "vgg": lambda m, fmt: m.VGG(m.vgg._make_features(
        [8, "M", 16, 16, "M"], batch_norm=True), num_classes=0),
}


def _state(jlayer):
    return {k: np.asarray(v._value) for k, v in jlayer.state_dict().items()}


_REFERENCE = {}


def _statistics(net, seed=3):
    """Seeded running statistics for the eval pass, the same in both
    packages (the training pass's own differ by its rounding)."""
    rng = np.random.default_rng(seed)
    return {k: rng.uniform(0.5, 1.5, tuple(b.shape)).astype(np.float32)
            for k, b in sorted(net.named_buffers())}


def _reference(name):
    """The reference's NCHW run of one model (kept for the NHWC case):
    (state, x, g, train forward, running statistics, eval forward, eval
    gradients)."""
    if name not in _REFERENCE:
        paddle.seed(0)
        j = MODELS[name](jmodels, "NCHW")
        state = _state(j)
        rng = np.random.default_rng(1)
        x = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
        train = j(paddle.to_tensor(x)).numpy()
        bufs = dict(j.named_buffers())
        stats = {k: np.asarray(b._value) for k, b in bufs.items()}
        for k, v in _statistics(j).items():
            bufs[k]._value = jnp.asarray(v)
        j.eval()
        out = j(paddle.to_tensor(x))
        g = rng.standard_normal(tuple(out.shape)).astype(np.float32)
        paddle.sum(out * paddle.to_tensor(g)).backward()
        grads = {k: p.gradient() for k, p in j.named_parameters()}
        _REFERENCE[name] = (state, x, g, train, stats, out.numpy(), grads)
    return _REFERENCE[name]


def _dev(got, want):
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def check_model(name, fmt):
    state, x, g, train, stats, evaled, grads = _reference(name)
    t = MODELS[name](pt.models, fmt)
    assert sorted(t.state_dict()) == sorted(state)
    load_numpy_state(t, state)
    xt = torch.from_numpy(x)
    if fmt == "NHWC":
        xt = xt.permute(0, 2, 3, 1).contiguous()

    # training mode: batch statistics, running statistics written
    with torch.no_grad():
        out = t(xt).numpy()
    assert _rel_l2(out, train) <= TRAIN_OUT_TOL, f"{name} {fmt} train output"
    got = dict(t.named_buffers())
    assert sorted(got) == sorted(stats)
    for k, v in stats.items():
        assert _dev(got[k].numpy(), v) <= TRAIN_STAT_TOL, f"{name} {fmt} {k}"
    assert any(v.any() for k, v in got.items() if k.endswith("_mean"))

    # eval mode on seeded running statistics, and every parameter's
    # gradient
    with torch.no_grad():
        for k, v in _statistics(t).items():
            got[k].copy_(torch.from_numpy(v))
    t.eval()
    out = t(xt)
    assert _dev(out.detach().numpy(), evaled) <= TOL, f"{name} {fmt} eval"
    (out * torch.from_numpy(g)).sum().backward()
    for k, p in t.named_parameters():
        assert _dev(p.grad.numpy(), grads[k]) <= TOL, f"{name} {fmt} {k}"


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture(autouse=True)
def _fresh_reference_op_cache():
    jautograd._JIT_CACHE.clear()


@pytest.mark.parametrize("name,fmt", [
    ("resnet18", "NCHW"), ("resnet18", "NHWC"), ("resnet50", "NCHW"),
    ("resnet50", "NHWC"), ("vgg", "NCHW")])
def test_model_matches_the_reference(name, fmt):
    check_model(name, fmt)


def test_vision_models_namespace_holds_the_ported_names():
    import paddle_tpu.vision.models as jvm
    names = [n for n in dir(pt.vision.models) if not n.startswith("_")]
    assert sorted(names) == sorted(n for n in dir(jvm)
                                   if not n.startswith("_"))
    assert len(names) == 48
    assert pt.vision.models.resnet50 is pt.models.resnet50
    net = pt.vision.models.wide_resnet50_2(num_classes=0, with_pool=False)
    assert list(net.layer1[0].conv1.weight.shape) == [128, 64, 1, 1]
