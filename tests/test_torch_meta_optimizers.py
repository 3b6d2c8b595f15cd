"""`paddle_tpu_torch.parallel.meta_optimizers` and fleet's toggles against
the JAX package's (`tests/test_meta_optimizers.py`'s cases, each run in
both packages from the same weights and batches).

Tolerances: gradients and parameters within 1e-5 (1 + |ref|) in f32
(the two packages' matmuls sum in other orders); the dropout replay and
the merge-only steps exactly; LocalSGD and DGC in a two-rank gloo world
bit-equal across ranks."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.parallel import fleet as jfleet, strategy as jstrategy
from paddle_tpu.parallel import meta_optimizers as jmeta
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.parallel import fleet as tfleet, spawn
from paddle_tpu_torch.parallel import meta_optimizers as tmeta
from paddle_tpu_torch.parallel.strategy import DistributedStrategy

import torch_dist_runner as runner
from torch_parity import dev, pair


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def block(nn, dim=8):
    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(dim, dim)
            self.act = nn.ReLU()
            self.fc2 = nn.Linear(dim, dim)

        def forward(self, x):
            return self.fc2(self.act(self.fc1(x)))

    return Block()


def _r(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _g(t):
    g = t.grad
    return np.asarray(getattr(g, "_value", g)) if not isinstance(
        g, torch.Tensor) else g.numpy()


def _w(p):
    return p.detach().numpy() if isinstance(p, torch.Tensor) \
        else np.asarray(p._value)


# ---- recompute ----
def test_recompute_gradients_match_the_plain_forward_and_the_reference():
    x = _r(4, 8)
    jb, tb = pair(block)

    def port(use_rc):
        for p in tb.parameters():
            p.grad = None
        xt = pt.to_tensor(x, stop_gradient=False)
        out = tmeta.recompute(tb, xt) if use_rc else tb(xt)
        (out ** 2).sum().backward()
        return [_g(p) for p in tb.parameters()] + [_g(xt)]

    xj = paddle.to_tensor(x)
    xj.stop_gradient = False
    (jmeta.recompute(jb, xj) ** 2).sum().backward()
    ref = [_g(p) for p in jb.parameters()] + [_g(xj)]
    got, plain = port(True), port(False)
    for a, b, c in zip(got, plain, ref):
        assert dev(a, b) <= 1e-6
        assert dev(a, c) <= 1e-5


def test_recompute_keeps_no_activation_of_the_block():
    """The point of remat: under recompute the block's forward keeps no
    activation for the backward (what is saved is at most the block's
    input), where the plain forward saves its activations."""
    tb = block(tnn)
    xt = pt.to_tensor(_r(2, 8), stop_gradient=False)

    def saved(fn):
        n = [0]

        def pack(t):
            n[0] += 1
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = fn()
        return n[0], out

    n_plain, _ = saved(lambda: tb(xt))
    n_rc, out = saved(lambda: tmeta.recompute(tb, xt))
    assert n_plain >= 3 and n_rc <= 1
    out.sum().backward()
    assert all(p.grad is not None for p in tb.parameters())


def test_training_with_recompute_matches_the_reference():
    x = _r(32, 8)
    y = (x.sum(1) > 0).astype(np.int64)
    jb, tb = pair(block)
    jh, th = pair(lambda nn: nn.Linear(8, 2))

    def train(pkg, blk, head, rc, nn):
        opt = pkg.optimizer.Adam(parameters=list(blk.parameters())
                                 + list(head.parameters()),
                                 learning_rate=1e-2)
        ce = nn.CrossEntropyLoss()
        losses = []
        for _ in range(5):
            h = rc(blk, pkg.to_tensor(x))
            loss = ce(head(h), pkg.to_tensor(y))
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        return losses

    lj = train(paddle, jb, jh, jmeta.recompute, jnn)
    lt = train(pt, tb, th, tmeta.recompute, tnn)
    assert lt[-1] < lt[0]
    np.testing.assert_allclose(lt, lj, rtol=1e-4)


@pytest.mark.parametrize("prior", [False, True])
def test_dropout_mask_replayed_in_the_backward(prior):
    """For x = 1, out = mask / (1 - p) and d out / dx is the same, so
    x.grad equals out exactly only when the recomputation drew the
    forward's mask; with `prior`, other dropouts drew first (the
    reference's granularity case). Both packages."""
    for pkg, nn in ((paddle, jnn), (pt, tnn)):
        pkg.seed(7 if prior else 123)
        if prior:
            pre = nn.Dropout(p=0.5)
            pre.train()
            pre(pkg.to_tensor(np.ones((8,), np.float32)))
        drop = nn.Dropout(p=0.5)
        drop.train()
        xt = pkg.to_tensor(np.ones((64,), np.float32))
        xt.stop_gradient = False
        mod = jmeta if pkg is paddle else tmeta
        out = mod.recompute(drop, xt)
        out_v = np.array(_w(out))
        assert 0 < (out_v != 0).sum() < 64
        out.sum().backward()
        np.testing.assert_array_equal(_g(xt), out_v)
    # the surrounding stream is untouched: after the backward's replay,
    # the next draw is the one a run without recompute makes
    def next_draw(rc):
        pt.seed(5)
        xt = pt.to_tensor(np.ones((64,), np.float32), stop_gradient=False)
        drop = tnn.Dropout(p=0.5)
        out = tmeta.recompute(drop, xt) if rc else drop(xt)
        out.sum().backward()
        return tnn.Dropout(p=0.5)(pt.to_tensor(np.ones(64, np.float32)))

    np.testing.assert_array_equal(next_draw(True).numpy(),
                                  next_draw(False).numpy())


def test_recompute_of_a_plain_callable():
    x = _r(3, 3)
    for pkg, mod in ((paddle, jmeta), (pt, tmeta)):
        xt = pkg.to_tensor(x)
        xt.stop_gradient = False
        mod.recompute(lambda a: (a * a).sum(), xt).backward()
        np.testing.assert_allclose(_g(xt), 2 * x, rtol=1e-6)


def test_fleet_utils_recompute():
    out = tfleet.utils.recompute(block(tnn), pt.to_tensor(_r(2, 8)))
    assert out.shape == [2, 8]


# ---- gradient merge ----
def test_k_merged_steps_equal_the_large_batch_and_the_reference():
    x = _r(8, 8)
    y = (x.sum(1) > 0).astype(np.int64)
    jn, tn = pair(lambda nn: nn.Linear(8, 2))

    def run(pkg, net, mod, nn, merged):
        inner = pkg.optimizer.SGD(parameters=net.parameters(),
                                  learning_rate=0.1)
        ce = nn.CrossEntropyLoss()
        if merged:
            opt = mod.GradientMergeOptimizer(inner, k_steps=4, avg=True)
            for i in range(4):
                ce(net(pkg.to_tensor(x[i * 2:(i + 1) * 2])),
                   pkg.to_tensor(y[i * 2:(i + 1) * 2])).backward()
                opt.step()
                opt.clear_grad()
        else:
            ce(net(pkg.to_tensor(x)), pkg.to_tensor(y)).backward()
            inner.step()
        return _w(net.weight).copy()

    w0 = [_w(p).copy() for p in tn.parameters()]
    merged = run(pt, tn, tmeta, tnn, True)
    ref = run(paddle, jn, jmeta, jnn, True)
    assert dev(merged, ref) <= 1e-6
    with torch.no_grad():
        for p, w in zip(tn.parameters(), w0):
            p.copy_(torch.from_numpy(w))
    large = run(pt, tn, tmeta, tnn, False)
    assert dev(merged, large) <= 1e-6


def test_a_parameter_missing_on_the_last_micro_step_is_still_applied():
    ja, ta = pair(lambda nn: nn.Linear(4, 4))
    jb, tb = pair(lambda nn: nn.Linear(4, 4))
    x = _r(2, 4)
    out = []
    for pkg, a, b, mod in ((paddle, ja, jb, jmeta), (pt, ta, tb, tmeta)):
        inner = pkg.optimizer.SGD(
            parameters=list(a.parameters()) + list(b.parameters()),
            learning_rate=0.1)
        opt = mod.GradientMergeOptimizer(inner, k_steps=2, avg=False)
        wb0 = _w(b.weight).copy()
        xt = pkg.to_tensor(x)
        (b(a(xt)) ** 2).sum().backward()   # micro 1: a and b
        opt.step()
        opt.clear_grad()
        (a(xt) ** 2).sum().backward()      # micro 2: only a
        opt.step()
        opt.clear_grad()
        assert np.abs(_w(b.weight) - wb0).max() > 1e-7
        out.append([_w(p).copy() for p in list(a.parameters())
                    + list(b.parameters())])
    for r, g in zip(*out):
        assert dev(g, r) <= 1e-5


def test_the_wrapper_delegates_and_the_inner_waits_for_k():
    net = tnn.Linear(4, 2)
    opt = tmeta.GradientMergeOptimizer(pt.optimizer.Adam(
        parameters=net.parameters(), learning_rate=0.1), k_steps=3)
    assert isinstance(opt.state_dict(), dict)
    opt.set_lr(0.05)
    assert abs(opt.get_lr() - 0.05) < 1e-9
    w0 = _w(net.weight).copy()
    for i in range(2):
        (net(pt.to_tensor(_r(2, 4, seed=i))) ** 2).sum().backward()
        opt.step()
        opt.clear_grad()
        assert all(p.grad is None for p in net.parameters())
    np.testing.assert_array_equal(_w(net.weight), w0)


# ---- LocalSGD ----
def test_local_sgd_with_an_injected_mean_matches_the_reference():
    jn, tn = pair(lambda nn: nn.Linear(4, 2))
    res = []
    for pkg, net, mod in ((paddle, jn, jmeta), (pt, tn, tmeta)):
        calls = []

        def half(arr, calls=calls):
            calls.append(tuple(arr.shape))
            return arr * 0.5

        inner = pkg.optimizer.SGD(parameters=net.parameters(),
                                  learning_rate=0.1)
        opt = mod.LocalSGDOptimizer(inner, k_steps=2, allreduce_mean=half)
        for i in range(4):
            (net(pkg.to_tensor(_r(2, 4, seed=i))) ** 2).sum().backward()
            opt.step()
            opt.clear_grad()
        assert calls == [(4, 2), (2,)] * 2    # at steps 2 and 4
        res.append([_w(p).copy() for p in net.parameters()])
    for r, g in zip(*res):
        assert dev(g, r) <= 1e-6


# ---- DGC ----
def _dgc_run(pkg, mod, net, batches, resume_at=None):
    def make():
        inner = pkg.optimizer.SGD(parameters=net.parameters(),
                                  learning_rate=0.1)
        return mod.DGCMomentumOptimizer(
            inner, momentum=0.9, sparsity=[0.5, 0.75, 0.9],
            rampup_begin_step=2, allreduce=lambda a: a * 0.5)

    opt = make()
    ws = []
    for i, x in enumerate(batches):
        if i == resume_at:
            sd = opt.state_dict()
            opt = make()
            opt.set_state_dict(sd)
        (net(pkg.to_tensor(x)) ** 2).sum().backward()
        opt.step()
        opt.clear_grad()
        ws.append([_w(p).copy() for p in net.parameters()])
    return ws, opt


def test_dgc_six_steps_with_a_state_dict_round_trip_match_the_reference():
    """Two warm-up steps (dense, full momentum), then the sparsity ramp
    0.5 / 0.75 / 0.9 and its last value; the injected allreduce halves
    what is sent. The port's parameters after each step equal the
    reference's; a state_dict round trip at step 3 changes nothing."""
    batches = [_r(4, 16, seed=i) for i in range(6)]
    jn, tn = pair(lambda nn: nn.Linear(16, 16))
    w0 = [_w(p).copy() for p in tn.parameters()]
    ref, jopt = _dgc_run(paddle, jmeta, jn, batches)
    got, topt = _dgc_run(pt, tmeta, tn, batches)
    for r, g in zip(ref, got):
        assert max(dev(a, b) for a, b in zip(g, r)) <= 1e-5
    with torch.no_grad():
        for p, w in zip(tn.parameters(), w0):
            p.copy_(torch.from_numpy(w))
    again, opt2 = _dgc_run(pt, tmeta, tn, batches, resume_at=3)
    for a, b in zip(got[-1], again[-1]):
        np.testing.assert_array_equal(a, b)
    sd, jsd = topt.state_dict(), jopt.state_dict()
    assert sd["dgc_steps"] == jsd["dgc_steps"] == 6
    for key in ("dgc_u", "dgc_v"):
        assert sorted(sd[key]) == sorted(jsd[key]) == [0, 1]
        for i in sd[key]:
            assert dev(sd[key][i], np.asarray(jsd[key][i])) <= 1e-5
    with pytest.raises(ValueError, match="momentum"):
        tmeta.DGCMomentumOptimizer(pt.optimizer.Momentum(
            parameters=tn.parameters(), momentum=0.9))


def test_dgc_sends_the_top_k_and_keeps_the_rest():
    """k = int(numel (1 - sparsity)) entries leave per parameter (more
    only on a tie at the threshold); what is kept plus what is sent is the
    accumulation, exactly."""
    pt.seed(0)
    net = tnn.Linear(32, 32)
    sent = []

    def record(t):
        sent.append(t.clone())
        return t

    opt = tmeta.DGCMomentumOptimizer(
        pt.optimizer.SGD(parameters=net.parameters(), learning_rate=0.1),
        momentum=0.9, sparsity=0.99, allreduce=record)
    params = list(net.parameters())
    for i in range(3):
        prev_u = [opt._u.get(id(p)) for p in params]
        prev_v = [opt._v.get(id(p)) for p in params]
        (net(pt.to_tensor(_r(4, 32, seed=i))) ** 2).sum().backward()
        grads = [p.grad.clone() for p in params]
        sent.clear()
        opt.step()
        opt.clear_grad()
        for p, g, u0, v0, s in zip(params, grads, prev_u, prev_v, sent):
            u = g if u0 is None else 0.9 * u0 + g
            acc = u if v0 is None else v0 + u
            k = max(1, int(p.numel() * (1.0 - 0.99)))
            n_sent = int((s != 0).sum())
            thresh = torch.topk(acc.abs().reshape(-1), k).values[-1]
            ties = int((acc.abs() == thresh).sum())
            assert n_sent == k or (ties > 1 and k <= n_sent < k + ties)
            torch.testing.assert_close(opt._v[id(p)] + s, acc, rtol=0,
                                       atol=0)


# ---- fleet ----
def test_the_strategy_toggles_wrap_the_optimizer_as_the_reference():
    st, jst = DistributedStrategy(), jstrategy.DistributedStrategy()
    for s in (st, jst):
        s.gradient_merge = True
        s.gradient_merge_configs = {"k_steps": 2, "avg": True}
        s.localsgd = True
    tfleet.init(is_collective=True, strategy=st)
    jfleet.init(is_collective=True, strategy=jst)
    opt = tfleet.distributed_optimizer(pt.optimizer.SGD(
        parameters=tnn.Linear(4, 2).parameters(), learning_rate=0.1), st)
    jopt = jfleet.distributed_optimizer(paddle.optimizer.SGD(
        parameters=jnn.Linear(4, 2).parameters(), learning_rate=0.1), jst)
    for o, mod in ((opt, tmeta), (jopt, jmeta)):
        assert isinstance(o, mod.LocalSGDOptimizer)
        assert isinstance(o.inner_optimizer, mod.GradientMergeOptimizer)
    # dgc lifts the momentum of a shallow copy; the caller's optimizer
    # keeps its momentum and its state
    st2 = DistributedStrategy()
    st2.dgc = True
    net = tnn.Linear(4, 2)
    mom = pt.optimizer.Momentum(parameters=net.parameters(),
                                learning_rate=0.1, momentum=0.8)
    d = tfleet.distributed_optimizer(mom, st2)
    assert isinstance(d, tmeta.DGCMomentumOptimizer) and d.momentum == 0.8
    assert mom._momentum == 0.8
    (net(pt.to_tensor(_r(2, 4))) ** 2).sum().backward()
    d.step()
    assert mom.state_dict()["accumulators"] == {}
    # fleet holds every public name of the reference's fleet module
    names = [n for n in dir(jfleet) if not n.startswith("_") and n != "os"]
    assert len(names) == 26
    assert [n for n in names if not hasattr(tfleet, n)] == []


# ---- LocalSGD and DGC over a process world ----
def test_local_sgd_and_dgc_in_a_two_rank_world(tmp_path):
    """Two gloo ranks train a Linear on batches of their own: LocalSGD
    (k 2, the default mean over the world) and DGC (allreduce the mean of
    what each rank sends). Parameters bit-equal across ranks after each
    averaging step (and after each DGC step); LocalSGD's average equals
    the mean of the ranks' parameters before it."""
    spawn(runner.run, args=("meta", str(tmp_path)), nprocs=2,
          backend="gloo", device="cpu", timeout=300)
    res = [dict(np.load(tmp_path / f"meta_{r}.npz")) for r in range(2)]
    for key in res[0]:
        if key.startswith("avg") or key.startswith("dgc"):
            np.testing.assert_array_equal(res[0][key], res[1][key])
    for step in (2, 4):
        pre = (res[0][f"pre{step}"] + res[1][f"pre{step}"]) / 2
        np.testing.assert_allclose(res[0][f"avg{step}"], pre, rtol=1e-6)
    assert not np.array_equal(res[0]["pre2"], res[1]["pre2"])
