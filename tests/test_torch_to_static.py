"""`jit.to_static` of the port against the JAX package on the CPU.

The same weights (built in the JAX package, carried by name) and the same
numpy-seeded inputs go through both packages' `to_static`:
  - `test_jit_amp_io.py::TestToStatic`'s cases: the output within 1e-5
    (1 + |ref|) of the reference's and of the eager layer, the gradients
    through the static boundary, 60 Adam steps with the same losses, a
    function, `static.nn.cond` inside and `static.nn.while_loop` outside;
  - a tiny GPT (2 layers, hidden 64) forward and backward through
    to_static: logits, loss and every parameter's gradient within 1e-5
    (1 + |ref|);
  - the signature: a new shape or a sublayer's training flag exports
    anew, a known one replays; the AMP state is part of it (a deviation
    from the reference, which replays its auto_cast capture outside
    auto_cast: pinned here); `ProgramTranslator`'s toggle is stored and
    read by nothing in both (a reference defect kept);
  - the bookkeeping: the ledger's retrace counters, `jit.to_static.*`,
    FLAGS_check_nan_inf, `release()`, `program()`;
  - a live-layer Predictor runs through to_static, as the reference's,
    within 1e-5 of it, and the serving engine books each bucket's build
    once.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import inference as jinference
from paddle_tpu import models as jmodels
from paddle_tpu.core import autograd as jautograd
import paddle_tpu_torch as pt
from paddle_tpu_torch import monitor
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.utils import load_numpy_state

TOL = 1e-5
CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=64, dropout=0.0)


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")
    jautograd._JIT_CACHE.clear()


@pytest.fixture
def with_monitor():
    flags.set_flags({"monitor": True})
    monitor.reset()
    yield
    monitor.reset()
    flags.set_flags({"monitor": False})


def dev(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((np.abs(got - want) / (1 + np.abs(want))).max(initial=0))


def r(*shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype("float32")


def small_net(pkg):
    nn = pkg.nn

    class SmallNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(8, 16)
            self.fc2 = nn.Linear(16, 4)

        def forward(self, x):
            return self.fc2(pkg.nn.functional.relu(self.fc1(x)))

    return SmallNet()


def pair(make):
    paddle.seed(0)
    j = make(paddle)
    t = make(pt)
    load_numpy_state(t, {k: np.asarray(v._value)
                         for k, v in j.state_dict().items()})
    return j, t


# ---- test_jit_amp_io.py::TestToStatic ----

def test_matches_eager_and_the_reference():
    jnet, tnet = pair(small_net)
    jnet.eval()
    tnet.eval()
    x = r(3, 8)
    eager = tnet(pt.to_tensor(x)).numpy()
    want = paddle.jit.to_static(jnet)(paddle.to_tensor(x)).numpy()
    got = pt.jit.to_static(tnet)(pt.to_tensor(x))
    assert isinstance(got, pt.Tensor)
    assert dev(got.numpy(), eager) <= TOL and dev(got.numpy(), want) <= TOL


def test_backward_through_static():
    jnet, tnet = pair(small_net)
    x = r(3, 8)
    for pkg, net in ((paddle, jnet), (pt, tnet)):
        pkg.jit.to_static(net)
        net(pkg.to_tensor(x)).sum().backward()
    assert tnet.fc1.weight.grad is not None
    for name in ("fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"):
        jp = dict(jnet.named_parameters())[name]
        tp = dict(tnet.named_parameters())[name]
        assert dev(tp.grad.numpy(), np.asarray(jp.grad)) <= TOL, name


def test_training_with_static_descends_as_the_reference():
    jnet, tnet = pair(small_net)
    x = r(16, 8)
    y = np.random.default_rng(1).integers(0, 4, (16,)).astype("int64")
    losses = {}
    for pkg, net in ((paddle, jnet), (pt, tnet)):
        pkg.jit.to_static(net)
        opt = pkg.optimizer.Adam(parameters=net.parameters(),
                                 learning_rate=1e-2)
        lossfn = pkg.nn.CrossEntropyLoss()
        xs, ys = pkg.to_tensor(x), pkg.to_tensor(y)
        seq = []
        for _ in range(60):
            loss = lossfn(net(xs), ys)
            loss.backward()
            opt.step()
            opt.clear_grad()
            seq.append(float(loss))
        losses[pkg] = np.asarray(seq)
    assert losses[pt][-1] < losses[pt][0] * 0.5
    assert dev(losses[pt], losses[paddle]) <= 1e-4


def test_function_decorator():
    a, b = r(2, 2), r(2, 2, seed=1)
    outs = []
    for pkg in (paddle, pt):
        @pkg.jit.to_static
        def f(a, b):
            return a * 2 + b
        outs.append(f(pkg.to_tensor(a), pkg.to_tensor(b)).numpy())
    assert list(outs[1].shape) == [2, 2] and dev(outs[1], outs[0]) <= TOL


def test_control_flow_cond_and_while_loop():
    for x in (np.ones(2, "float32"), -np.ones(2, "float32")):
        outs = []
        for pkg in (paddle, pt):
            cond = pkg.static.nn.cond

            @pkg.jit.to_static
            def f(x):
                return cond(x.sum() > 0, lambda: x * 2, lambda: x * -1)
            outs.append(f(pkg.to_tensor(x)).numpy())
        assert dev(outs[1], outs[0]) <= TOL
    for pkg in (paddle, pt):
        i = pkg.to_tensor(np.asarray(0, "int32"))
        ten = pkg.to_tensor(np.asarray(10, "int32"))
        out = pkg.static.nn.while_loop(lambda i: i < ten, lambda i: i + 2,
                                       [i])
        assert int(out[0]) == 10


# ---- a tiny GPT forward and backward ----

def test_tiny_gpt_forward_and_backward_through_to_static():
    paddle.seed(0)
    jm = jmodels.GPTForCausalLM(jmodels.gpt.GPTModel(**CFG))
    tm = pt.models.GPTForCausalLM(pt.models.GPTModel(**CFG))
    load_numpy_state(tm, {k: np.asarray(v._value)
                          for k, v in jm.state_dict().items()})
    ids = np.random.default_rng(0).integers(0, 256, (2, 32)).astype("int32")
    res = {}
    for pkg, m in ((paddle, jm), (pt, tm)):
        sm = pkg.jit.to_static(m)
        logits = sm(pkg.to_tensor(ids))
        loss = pkg.nn.functional.cross_entropy(
            logits[:, :-1].reshape([-1, 256]),
            pkg.to_tensor(ids)[:, 1:].reshape([-1])).mean()
        loss.backward()
        res[pkg] = (np.asarray(logits.numpy()), float(loss),
                    {n: np.asarray(p.grad.numpy() if pkg is pt else p.grad)
                     for n, p in m.named_parameters()})
    (jl, jloss, jg), (tl, tloss, tg) = res[paddle], res[pt]
    assert dev(tl, jl) <= TOL and dev(tloss, jloss) <= TOL
    assert set(tg) == set(jg)
    for n in jg:
        assert dev(tg[n], jg[n]) <= TOL, n
    prog = tm.forward.program()
    hist = prog.op_histogram()
    # per block the fused qkv, the output projection and the two MLP
    # Linears; the head tied to the embedding is one matmul; per block one
    # softmax (the CPU's einsum attention)
    assert hist["aten.linear"] == 2 * 4, hist
    assert hist["aten.matmul"] == 1 and hist["aten.softmax"] == 2, hist


# ---- the signature ----

def test_signature_shape_training_and_kwargs():
    _, tnet = pair(small_net)
    sf = pt.jit.to_static(tnet).forward
    sf(pt.to_tensor(r(3, 8)))
    sf(pt.to_tensor(r(3, 8, seed=1)))
    assert len(sf._programs) == 1
    sf(pt.to_tensor(r(5, 8)))
    assert len(sf._programs) == 2
    tnet.fc1.eval()
    sf(pt.to_tensor(r(5, 8)))
    assert len(sf._programs) == 3
    sf.release()
    assert not sf._programs
    with pytest.raises(RuntimeError, match="call the @to_static"):
        sf.program()
    with pytest.raises(ValueError, match="positionally"):
        sf(x=pt.to_tensor(r(3, 8)))


def test_amp_state_is_part_of_the_signature():
    """The port exports anew outside auto_cast; the reference replays the
    program it traced under auto_cast there (a deviation, pinned)."""
    jnet, tnet = pair(small_net)
    jnet.eval()
    tnet.eval()
    x = r(3, 8)
    outs = {}
    for pkg, net in ((paddle, jnet), (pt, tnet)):
        f = pkg.jit.to_static(net)
        with pkg.amp.auto_cast(dtype="bfloat16"):
            amp_out = f(pkg.to_tensor(x))
        plain = f(pkg.to_tensor(x))
        outs[pkg] = (np.asarray(amp_out.astype("float32").numpy()),
                     np.asarray(plain.astype("float32").numpy()))
    eager = np.asarray(tnet(pt.to_tensor(x)).numpy())
    t_amp, t_plain = outs[pt]
    j_amp, j_plain = outs[paddle]
    assert dev(t_amp, j_amp) <= 2e-2            # bf16 in both
    assert dev(t_plain, eager) <= TOL            # the port: fp32 again
    assert len(tnet.forward._programs) == 2
    np.testing.assert_array_equal(j_plain, j_amp)  # the reference: stale
    assert dev(j_plain, eager) > 1e-4


def test_program_translator_toggle_is_stored_and_read_by_nothing():
    for pkg in (paddle, pt):
        pkg.jit.enable_to_static(False)
        try:
            assert not pkg.jit.ProgramTranslator.get_instance() \
                .enable_to_static

            @pkg.jit.to_static
            def f(x):
                return x * 2

            f(pkg.to_tensor(r(2)))
            assert f.program() is not None      # converted all the same
        finally:
            pkg.jit.enable_to_static(True)


# ---- the bookkeeping ----

def test_counters_and_flags(with_monitor):
    _, tnet = pair(small_net)
    f = pt.jit.to_static(tnet)
    for shape in ((3, 8), (3, 8), (4, 8), (3, 8)):
        f(pt.to_tensor(r(*shape)))
    c = monitor.snapshot()["counters"]
    assert c["jit.to_static.calls"] == 4
    assert c["jit.to_static.cache_miss"] == 2
    assert c["jit.to_static.traces"] == 1
    assert c["jit.to_static.retraces"] == 1
    assert c["trace_compile.to_static"] == 2

    @pt.jit.to_static
    def g(x):
        return x / 0.0

    flags.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="static_program"):
            g(pt.to_tensor(np.zeros(2, "float32")))
    finally:
        flags.set_flags({"check_nan_inf": False})


def test_traced_layer_and_not_to_static(tmp_path):
    jnet, tnet = pair(small_net)
    tnet.eval()
    x = pt.to_tensor(r(3, 8))
    outs, traced = pt.jit.TracedLayer.trace(tnet, [x])
    assert dev(traced(x).numpy(), outs.numpy()) <= TOL
    path = str(tmp_path / "traced")
    traced.save_inference_model(path)
    assert dev(pt.jit.load(path)(x).numpy(), outs.numpy()) <= TOL
    fn = pt.jit.not_to_static(lambda v: v)
    assert fn._not_to_static
    pt.jit.set_verbosity(3)
    pt.jit.set_code_level(50)


# ---- the live-layer Predictor ----

def test_live_layer_predictor_runs_through_to_static(with_monitor):
    jnet, tnet = pair(small_net)
    jnet.eval()
    x = r(4, 8)
    jpred = jinference.Predictor(jnet, input_spec=[
        paddle.static.InputSpec([4, 8], "float32")])
    tpred = pt.inference.Predictor(tnet, input_spec=[
        pt.InputSpec([4, 8], "float32")])
    want = np.asarray(jpred.run([x])[0].numpy())
    got = tpred.run([x])[0]
    assert dev(got.numpy(), want) <= TOL
    assert isinstance(tpred._fn, pt.jit.StaticFunction)
    assert len(tpred._fn._programs) == 1
    assert tpred.bucket_buffers() == []          # no CUDA graph on the CPU
    from paddle_tpu_torch.serving import EngineConfig, ServingEngine
    eng = ServingEngine(tpred, EngineConfig(max_batch_size=4,
                                            batch_timeout_ms=1)).start()
    try:
        rows = [eng.submit([x[i:i + 1]]).result(timeout=60)
                for i in range(2)]
    finally:
        eng.stop()
    assert dev(rows[0][0], want[:1]) <= TOL
    c = monitor.snapshot()["counters"]
    # one build per bucket, booked by the predictor's to_static alone
    assert c.get("trace_compile.serving_bucket", 0) == 0
    assert c["trace_compile"] == c["trace_compile.to_static"]
