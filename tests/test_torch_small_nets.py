"""The port's AlexNet, SqueezeNet, ShuffleNetV2, DenseNet, GoogLeNet and
InceptionV3 (`models/small_nets.py`) against the JAX package on the CPU,
in training and in eval mode (`torch_convnet_parity.check_convnet`:
training outputs within 5e-3 relative L2 and running statistics within
1e-3 (1 + |ref|); eval outputs and gradients within 1e-4 (1 + |ref|)).
Sizes are cut to small inputs (AlexNet's classifier needs 224 x 224;
InceptionV3 runs at 107 x 107, where its last blocks normalise over 2 x 2
positions: at its smallest input, 75 x 75, training-mode batch norm there
sees two values per channel and amplifies rounding past the bound), 10
classes, batch 2, and a narrow
DenseNet (the layer counts, growth and stem width are its arguments); the
constructors' published geometry is checked by parameter count.
"""
import numpy as np
import pytest

from paddle_tpu import models as jmodels
from paddle_tpu.core import autograd as jautograd
import paddle_tpu_torch as pt
from torch_convnet_parity import check_convnet

CASES = {
    "alexnet": (lambda m: m.alexnet(num_classes=10), 224),
    "squeezenet1_0": (lambda m: m.squeezenet1_0(num_classes=10), 64),
    "squeezenet1_1": (lambda m: m.squeezenet1_1(num_classes=10), 64),
    "shufflenet_v2_x0_25": (lambda m: m.shufflenet_v2_x0_25(num_classes=10),
                            64),
    "shufflenet_v2_swish": (lambda m: m.shufflenet_v2_swish(num_classes=10),
                            32),
    "densenet": (lambda m: m.DenseNet(layers=(2, 3), growth=8,
                                      init_features=16, num_classes=10), 32),
    "googlenet": (lambda m: m.googlenet(num_classes=10), 64),
    "inception_v3": (lambda m: m.inception_v3(num_classes=10), 107),
}


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture(autouse=True)
def _fresh_reference_op_cache():
    jautograd._JIT_CACHE.clear()


@pytest.mark.parametrize("name", sorted(CASES))
def test_small_net_matches_the_reference(name):
    make, size = CASES[name]
    x = np.random.default_rng(2).standard_normal(
        (2, 3, size, size)).astype(np.float32)
    check_convnet(lambda: make(jmodels), lambda: make(pt.models), x)


@pytest.mark.parametrize("ctor,lo,hi", [
    ("alexnet", 55_000_000, 58_000_000),
    ("squeezenet1_1", 1_100_000, 1_400_000),
    ("shufflenet_v2_x1_0", 1_200_000, 1_600_000),
    ("densenet121", 6_900_000, 8_100_000),
    ("googlenet", 9_000_000, 14_000_000),
    ("inception_v3", 21_000_000, 24_000_000)])
def test_published_geometry(ctor, lo, hi):
    kw = {} if ctor == "squeezenet1_1" else {"num_classes": 10}
    net = getattr(pt.vision.models, ctor)(**kw)
    ref = getattr(jmodels, ctor)(**kw)
    n = sum(p.numel() for p in net.parameters())
    assert n == sum(int(np.prod(p.shape)) for p in ref.parameters())
    assert lo < n < hi
