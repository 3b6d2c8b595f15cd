"""The port's grouped and depthwise nets against the JAX package on the
CPU (`test_torch_vision_models.py` says how): ResNeXt-50 32x4d in NCHW
and NHWC, MobileNetV1 and MobileNetV2 at scale 0.25."""
import pytest

from paddle_tpu.core import autograd as jautograd
import paddle_tpu_torch as pt
from test_torch_vision_models import check_model


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture(autouse=True)
def _fresh_reference_op_cache():
    jautograd._JIT_CACHE.clear()


@pytest.mark.parametrize("name,fmt", [
    ("resnext50_32x4d", "NCHW"), ("resnext50_32x4d", "NHWC"),
    ("mobilenet_v1", "NCHW"), ("mobilenet_v2", "NCHW")])
def test_model_matches_the_reference(name, fmt):
    check_model(name, fmt)
