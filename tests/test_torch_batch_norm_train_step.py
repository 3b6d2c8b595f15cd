"""Batch norm's running statistics under `jit.TrainStep` in the port
against the JAX package on the CPU.

The reference writes the running statistics only when batch norm's input
is not a jax Tracer (`paddle_tpu/nn/functional/norm.py:33-42`): inside a
traced step (`TrainStep.__call__` and `run()`) it never writes them, and
the eager dygraph path does. The port keeps both (ROADMAP Queue 3: a
reference defect kept; a BN model trained through TrainStep keeps its
initial eval statistics). Conv2D -> BatchNorm2D -> Flatten -> Linear,
one seeded batch, SGD(0.1): the losses agree within 1e-5 and the
statistics exactly (TrainStep) or within 1e-6 (1 + |ref|) (eager).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import autograd as jautograd
import paddle_tpu_torch as pt
from paddle_tpu_torch.utils import load_numpy_state

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture(autouse=True)
def _fresh_reference_op_cache():
    jautograd._JIT_CACHE.clear()


def _build(pkg, fmt):
    pkg.seed(0)
    nn = pkg.nn
    return nn.Sequential(nn.Conv2D(3, 4, 3, data_format=fmt),
                         nn.BatchNorm2D(4, data_format=fmt), nn.Flatten(),
                         nn.Linear(4 * 6 * 6, 5))


def _pair(fmt):
    j, t = _build(paddle, fmt), _build(pt, fmt)
    load_numpy_state(t, {k: np.asarray(v._value)
                         for k, v in j.state_dict().items()})
    rng = np.random.RandomState(0)
    shape = (4, 8, 8, 3) if fmt == "NHWC" else (4, 3, 8, 8)
    x = rng.rand(*shape).astype("float32")
    y = rng.randint(0, 5, (4,)).astype("int64")
    return j, t, x, y


def _steps(j, t):
    js = paddle.jit.TrainStep(j, paddle.nn.CrossEntropyLoss(),
                              paddle.optimizer.SGD(0.1,
                                                   parameters=j.parameters()))
    ts = pt.jit.TrainStep(t, pt.nn.CrossEntropyLoss(),
                          pt.optimizer.SGD(0.1, parameters=t.parameters()))
    return js, ts


def _stats(j, t):
    jb = {k: np.asarray(v._value) for k, v in j.named_buffers()}
    tb = {k: v.numpy() for k, v in t.named_buffers()}
    assert sorted(jb) == sorted(tb) == ["1._mean", "1._variance"]
    return jb, tb


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_train_step_call_and_run_leave_the_statistics(fmt):
    j, t, x, y = _pair(fmt)
    js, ts = _steps(j, t)
    want = float(js(paddle.to_tensor(x), paddle.to_tensor(y)))
    got = float(ts(torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(got - want) <= TOL * (1 + abs(want))
    xs, ys = np.stack([x] * 3), np.stack([y] * 3)
    want = np.asarray(js.run(paddle.to_tensor(xs),
                             paddle.to_tensor(ys))._value)
    got = ts.run(torch.from_numpy(xs), torch.from_numpy(ys)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    jb, tb = _stats(j, t)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])
    np.testing.assert_array_equal(tb["1._mean"], np.zeros(4, np.float32))
    np.testing.assert_array_equal(tb["1._variance"], np.ones(4, np.float32))
    # the TrainStep's other readers take the same forward
    ts.cost_analysis(torch.from_numpy(x), torch.from_numpy(y))
    ts.memory_report(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(t[1]._mean.numpy(), jb["1._mean"])


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_eager_steps_update_the_statistics(fmt):
    j, t, x, y = _pair(fmt)
    jopt = paddle.optimizer.SGD(0.1, parameters=j.parameters())
    topt = pt.optimizer.SGD(0.1, parameters=t.parameters())
    jce, tce = paddle.nn.CrossEntropyLoss(), pt.nn.CrossEntropyLoss()
    for _ in range(2):
        jl = jce(j(paddle.to_tensor(x)), paddle.to_tensor(y))
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = tce(t(pt.to_tensor(x)), pt.to_tensor(y))
        tl.backward()
        topt.step()
        topt.clear_grad()
        assert abs(float(tl) - float(jl)) <= TOL * (1 + abs(float(jl)))
    jb, tb = _stats(j, t)
    assert np.abs(tb["1._mean"]).min() > 0
    for k in jb:
        np.testing.assert_allclose(tb[k], jb[k], rtol=1e-6, atol=1e-6)


def test_frozen_running_stats_is_scoped():
    from paddle_tpu_torch.nn.functional.norm import frozen_running_stats
    bn = pt.nn.BatchNorm2D(2)
    x = torch.arange(16, dtype=torch.float32).reshape(2, 2, 2, 2)
    with frozen_running_stats():
        bn(x)
        assert not bn._mean.any()
    bn(x)
    assert bn._mean.any()
