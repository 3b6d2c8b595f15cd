"""Slice 11 as a whole: LeNet through bench.py's `lenet_dispatch` loop in
the port against the JAX package, on the CPU.

LeNet is built in JAX and carried across by name (`load_numpy_state`);
both packages then take bench.py's loop (`ce(net(x), y)`, `backward()`,
`SGD(0.01).step()`, `clear_grad()`) for 3 steps on one seeded batch, and
every loss and parameter must agree within 1e-5. The reference's
FLAGS_eager_auto_jit stays on (its own behaviour): from the third call
LeNet runs as its captured program, whose XLA fusion sums in another
order, which that tolerance covers. Then a port twin of
`tests/test_lenet_convergence.py`, `TrainStep.run()` against the eager
loop, and `utils/bench.py --arm lenet_dispatch --device cpu`.
"""
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.core import autograd as jautograd
import paddle_tpu_torch as pt
from paddle_tpu_torch.utils import bench, load_numpy_state

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture(autouse=True)
def _fresh_reference_op_cache():
    jautograd._JIT_CACHE.clear()


def _state(jlayer):
    return {k: np.asarray(v._value) for k, v in jlayer.state_dict().items()}


def _batch(seed=0, n=32):
    rng = np.random.RandomState(seed)
    return rng.rand(n, 1, 28, 28).astype("float32"), \
        rng.randint(0, 10, (n,)).astype("int64")


def test_lenet_names_shapes_and_forward():
    paddle.seed(0)
    j = jmodels.LeNet(num_classes=10)
    t = pt.models.LeNet(num_classes=10)
    js, ts = _state(j), t.state_dict()
    assert list(ts) == sorted(ts, key=list(js).index)
    assert {k: tuple(v.shape) for k, v in ts.items()} == \
        {k: v.shape for k, v in js.items()}
    load_numpy_state(t, js)
    x, _ = _batch()
    np.testing.assert_allclose(t(pt.to_tensor(x)).numpy(),
                               j(paddle.to_tensor(x)).numpy(), rtol=TOL,
                               atol=TOL)
    feats = pt.models.LeNet(num_classes=0)
    assert feats(pt.to_tensor(x)).shape == [32, 16, 5, 5]


def test_bench_loop_three_sgd_steps_match_the_reference():
    paddle.seed(0)
    jnet = jmodels.LeNet(num_classes=10)
    tnet = pt.models.LeNet(num_classes=10)
    load_numpy_state(tnet, _state(jnet))
    jopt = paddle.optimizer.SGD(parameters=jnet.parameters(),
                                learning_rate=0.01)
    topt = pt.optimizer.SGD(parameters=tnet.parameters(), learning_rate=0.01)
    jce, tce = paddle.nn.CrossEntropyLoss(), pt.nn.CrossEntropyLoss()
    xs, ys = _batch()
    jx, jy = paddle.to_tensor(xs), paddle.to_tensor(ys)
    tx, ty = pt.to_tensor(xs), pt.to_tensor(ys)
    for step in range(3):
        jl = jce(jnet(jx), jy)
        jl.backward()
        jopt.step()
        jopt.clear_grad()
        tl = tce(tnet(tx), ty)
        assert isinstance(tl, pt.Tensor)
        tl.backward()
        topt.step()
        topt.clear_grad()
        np.testing.assert_allclose(float(tl), float(jl), rtol=TOL,
                                   err_msg=f"loss at step {step}")
        for k, v in _state(jnet).items():
            np.testing.assert_allclose(tnet.state_dict()[k].numpy(), v,
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"{k} after step {step}")
    assert all(p.grad is None for p in tnet.parameters())


def test_train_step_run_matches_the_eager_loop():
    """TrainStep.run() (a loop on the CPU) and the eager dygraph loop give
    the same losses and parameters from one state."""
    pt.seed(0)
    a = pt.models.LeNet()
    b = pt.models.LeNet()
    b.set_state_dict(a.state_dict())
    xs, ys = _batch(1, 8)
    ce = pt.nn.CrossEntropyLoss()
    step = pt.jit.TrainStep(a, ce, pt.optimizer.SGD(
        parameters=a.parameters(), learning_rate=0.01))
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    losses = step.run(x.expand(4, *x.shape), y.expand(4, *y.shape))
    opt = pt.optimizer.SGD(parameters=b.parameters(), learning_rate=0.01)
    eager = []
    for _ in range(4):
        loss = ce(b(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        eager.append(float(loss))
    np.testing.assert_allclose(losses.numpy(), eager, rtol=1e-6)
    for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        np.testing.assert_allclose(p.numpy(), q.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def _synthetic_digits(n=64):
    """tests/test_lenet_convergence.py's data: each class c gets a bright
    square at a class-specific location."""
    rng = np.random.RandomState(0)
    xs = rng.rand(n, 1, 28, 28).astype("float32") * 0.1
    ys = rng.randint(0, 4, (n,))
    for i, c in enumerate(ys):
        r, col = divmod(int(c), 2)
        xs[i, 0, r * 14:r * 14 + 10, col * 14:col * 14 + 10] += 1.0
    return xs, ys.astype("int64")


class _LeNet4(pt.nn.Layer):
    """tests/test_lenet_convergence.py's LeNet (ReLUs between the Linear
    layers, 4 classes)."""

    def __init__(self, num_classes=4):
        super().__init__()
        nn = pt.nn
        self.features = nn.Sequential(
            nn.Conv2D(1, 6, 3, stride=1, padding=1), nn.ReLU(),
            nn.MaxPool2D(2, 2),
            nn.Conv2D(6, 16, 5, stride=1, padding=0), nn.ReLU(),
            nn.MaxPool2D(2, 2))
        self.fc = nn.Sequential(
            nn.Linear(400, 120), nn.ReLU(),
            nn.Linear(120, 84), nn.ReLU(),
            nn.Linear(84, num_classes))

    def forward(self, x):
        return self.fc(pt.flatten(self.features(x), 1))


def test_lenet_converges_and_gets_accurate():
    pt.seed(0)
    xs, ys = _synthetic_digits(64)
    net = _LeNet4()
    opt = pt.optimizer.Adam(parameters=net.parameters(), learning_rate=2e-3)
    lossfn = pt.nn.CrossEntropyLoss()
    x, y = pt.to_tensor(xs), pt.to_tensor(ys)
    first = None
    for _ in range(40):
        loss = lossfn(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        if first is None:
            first = float(loss)
    assert float(loss) < 0.1 * first, f"{first} -> {float(loss)}"
    net.eval()
    acc = (net(x).numpy().argmax(-1) == ys).mean()
    assert acc > 0.95, f"accuracy {acc}"


def test_bench_lenet_dispatch_arm_runs_on_the_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        bench.main(["--arm", "lenet_dispatch", "--device", "cpu"])
    lines = out.getvalue().strip().splitlines()
    r = json.loads(lines[-1])
    assert r["arm"] == "lenet_dispatch" and r["device"] == "cpu"
    # bench.py's _timeline_breakdown / _memory_breakdown lines before it
    assert lines[-3].startswith("timeline: ")
    assert lines[-2].startswith("memory: ")
    tl = json.loads(lines[-3][len("timeline: "):])
    assert {"h2d", "device_compute"} <= set(tl["phases_ms"])
    assert 0.8 <= tl["coverage"] <= 1.02 and tl["cost"]["flops"] > 0
    mem = json.loads(lines[-2][len("memory: "):])
    assert mem["tag_shares"]["params"] > 0 and mem["live_bytes"] > 0
    for key in ("step_latency_ms", "graph_step_latency_ms", "spread",
                "graph_spread"):
        assert np.isfinite(r[key]) and r[key] >= 0, key
    assert r["step_latency_ms"] > 0 and r["graph_step_latency_ms"] > 0
    assert r["loss_graph_last"] < r["loss_after_warmup"]
