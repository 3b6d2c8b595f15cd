"""`paddle.static` of the port (Program, the passes, `static.nn`, the
static API, `core/lod.py`, `ops/sequence.py`) against the JAX package on
the CPU.

  - `tests/test_program.py`'s Program and pass cases, with golden
    histograms in the port's operator names (one `aten.linear` per
    Linear, one `aten.tanh` per tanh) where the reference counts
    StableHLO's; run results within 1e-5 (1 + |ref|) of the reference's;
  - every `static.nn` builder and `sequence_*` function on numpy-seeded
    inputs, the port's scope carrying the reference's weights
    (`utils.load_scope_state`), within 1e-5 (1 + |ref|); the control-flow
    functions eagerly and inside to_static;
  - the static API: `Executor.run`, `save_inference_model` /
    `load_inference_model`, the scope's `save` / `load` and its
    serialisation, `append_backward`, `gradients`, EMA, `accuracy`,
    `auc`, `create_parameter`, the places, `train_from_dataset`;
  - the namespaces against `tests/reference_api_all.json`:
    `paddle.static` 47 / 47, `paddle.static.nn` 40 / 40, `paddle.jit`
    9 / 9.
"""
import json
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import static as jstatic
from paddle_tpu.core import autograd as jautograd
from paddle_tpu.core import lod as jlod
from paddle_tpu.ops import sequence as jseq
import paddle_tpu_torch as pt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core import lod as tlod
from paddle_tpu_torch.core.enforce import UnimplementedError
from paddle_tpu_torch.ops import sequence as tseq
from paddle_tpu_torch.utils import load_numpy_state, load_scope_state

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")
    jautograd._JIT_CACHE.clear()


def dev(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((np.abs(got - want) / (1 + np.abs(want))).max(initial=0))


def n_(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def npy(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def _mlp(pkg):
    nn = pkg.nn

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.a = nn.Linear(8, 16)
            self.b = nn.Linear(16, 16)
            self.c = nn.Linear(16, 2)

        def forward(self, x):
            return self.c(pkg.tanh(self.b(pkg.tanh(self.a(x)))))
    return MLP()


def _two_head(pkg):
    nn = pkg.nn

    class TwoHead(nn.Layer):
        def __init__(self):
            super().__init__()
            self.trunk = nn.Linear(8, 16)
            self.head_a = nn.Linear(16, 2)
            self.head_b = nn.Linear(16, 4)

        def forward(self, x):
            h = pkg.tanh(self.trunk(x))
            return self.head_a(h), self.head_b(h)
    return TwoHead()


def _pair(make):
    paddle.seed(0)
    j, t = make(paddle), make(pt)
    load_numpy_state(t, {k: np.asarray(v._value)
                         for k, v in j.state_dict().items()})
    j.eval()
    t.eval()
    return j, t


# ---- tests/test_program.py ----

def test_op_histogram_golden():
    _, net = _pair(_mlp)
    pt.jit.to_static(net)(pt.to_tensor(n_(4, 8)))
    prog = tstatic.default_main_program()
    hist = prog.op_histogram()
    # 3 Linear layers -> 3 aten.linear, 2 tanh
    assert hist["aten.linear"] == 3 and hist["aten.tanh"] == 2, hist
    assert prog.has_op("linear") and prog.num_blocks() == 1
    assert len(prog.inputs()) == 7            # 6 params + x
    assert prog.outputs()[0].shape == [4, 2]
    assert "Program(name='forward', inputs=7, ops=" in repr(prog)


def test_prune_backward_slice():
    _, net = _pair(_two_head)
    pt.jit.to_static(net)(pt.to_tensor(n_(4, 8)))
    prog = tstatic.default_main_program()
    assert prog.op_histogram()["aten.linear"] == 3
    pruned = prog.prune([0])                   # keep head_a only
    assert pruned.op_histogram()["aten.linear"] == 2
    assert len(pruned.outputs()) == 1 and pruned.outputs()[0].shape == [4, 2]


def test_program_run_matches_the_reference():
    jnet, tnet = _pair(_mlp)
    x = n_(4, 8)
    paddle.jit.to_static(jnet)(paddle.to_tensor(x))
    pt.jit.to_static(tnet)(pt.to_tensor(x))
    (want,) = jstatic.Executor().run(
        jstatic.default_main_program(),
        feed=[t._value for t in jnet.parameters()] + [x])
    exe = tstatic.Executor()
    (got,) = exe.run(tstatic.default_main_program(),
                     feed=list(tnet.parameters()) + [x])
    assert dev(got, want) <= TOL
    assert dev(got, tnet(pt.to_tensor(x)).numpy()) <= TOL


def test_from_callable_and_repr():
    def f(a, b):
        return a @ b + 1.0

    prog = tstatic.Program.from_callable(
        f, [torch.zeros(2, 3), torch.zeros(3, 4)])
    assert "Program(" in repr(prog)
    assert prog.has_op("matmul")
    assert prog.outputs()[0].shape == [2, 4]
    out = prog.run(np.ones((2, 3), "float32"), np.ones((3, 4), "float32"))
    np.testing.assert_allclose(out.numpy(), np.full((2, 4), 4.0))
    assert tstatic.default_startup_program().name == "startup"


def _tanh_prog():
    def f(x, y):
        return torch.tanh(x @ y).sum()
    return tstatic.Program.from_callable(
        f, [pt.InputSpec([4, 8], "float32"), pt.InputSpec([8, 4], "float32")])


def test_op_rewrite_pass_substitutes_the_operator():
    rewrite = tstatic.passes.make_op_rewrite_pass(
        {"tanh": lambda x: x / (1.0 + torch.abs(x))})
    tstatic.passes.register_pass("softsign_for_tanh", rewrite)
    prog = _tanh_prog()
    new = prog.apply_pass("softsign_for_tanh")
    assert prog.has_op("tanh") and not new.has_op("tanh")
    x, y = n_(4, 8, seed=0), n_(8, 4, seed=1)
    want = ((x @ y) / (1.0 + np.abs(x @ y))).sum()
    assert dev(new.run(x, y).numpy(), want) <= TOL


def test_rewrite_reaches_cond_branches_and_warns_in_loop_bodies():
    cond, while_loop = tstatic.nn.cond, tstatic.nn.while_loop

    def f(x):
        return cond(x.sum() > 0, lambda: torch.tanh(x), lambda: x * 3.0)

    prog = tstatic.Program.from_callable(f, [pt.InputSpec([8], "float32")])
    assert prog.num_blocks() == 3 and prog.has_op("cond")
    tstatic.passes.register_pass("tanh2x", tstatic.passes.make_op_rewrite_pass(
        {"aten.tanh": lambda x: x * 2.0}))
    new = prog.apply_pass("tanh2x")
    np.testing.assert_allclose(new.run(np.ones(8, "float32")).numpy(), 2.0)
    np.testing.assert_allclose(new.run(-np.ones(8, "float32")).numpy(), -3.0)

    def g(x):
        return while_loop(lambda c, i: i < 3,
                          lambda c, i: [torch.tanh(c), i + 1],
                          [x, torch.zeros((), dtype=torch.int32)])[0]

    prog = tstatic.Program.from_callable(g, [pt.InputSpec([4], "float32")])
    tstatic.passes.register_pass("tanh_id", tstatic.passes.make_op_rewrite_pass(
        {"tanh": lambda x: x}))
    tstatic.passes._warned_regions.clear()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        prog.apply_pass("tanh_id")
    assert any("NOT rewritten" in str(m.message) for m in w)


def test_builtin_passes_keep_the_result():
    prog = _tanh_prog()
    x, y = n_(4, 8, seed=2), n_(8, 4, seed=3)
    base = float(prog.run(x, y))
    assert abs(float(prog.apply_pass("remat").run(x, y)) - base) <= 1e-6
    bf = prog.apply_pass("bf16_io")
    assert abs(float(bf.run(x, y)) - base) < 0.3
    assert bf.has_op("aten.to")                # the casts are in the graph
    assert "remat" in tstatic.list_passes() and \
        "bf16_io" in tstatic.list_passes()
    with pytest.raises(KeyError, match="registered"):
        prog.apply_pass("nope")
    for name in ("lint", "concurrency"):
        with pytest.raises(UnimplementedError, match="analysis"):
            prog.apply_pass(name)


def test_dead_op_elim_drops_what_no_output_reads():
    def f(x):
        _ = torch.exp(x) * 2.0            # dead
        return torch.tanh(x)

    prog = tstatic.Program.from_callable(f, [pt.InputSpec([4], "float32")])
    assert prog.has_op("exp")
    new = prog.apply_pass("dead_op_elim")
    assert not new.has_op("exp") and new.has_op("tanh")
    x = n_(4)
    assert dev(new.run(x).numpy(), np.tanh(x)) <= TOL


def test_decorator_registration_and_compose():
    @tstatic.passes.register_pass("scale_out")
    def scale_out(fn, factor=2.0):
        def wrapped(*args):
            return fn(*args) * factor
        return wrapped

    prog = _tanh_prog()
    x, y = n_(4, 8, seed=4), n_(8, 4, seed=5)
    base = float(prog.run(x, y))
    doubled = prog.apply_pass("scale_out")
    assert abs(float(doubled.run(x, y)) - 2 * base) <= 1e-5
    quad = doubled.apply_pass("scale_out")
    assert abs(float(quad.run(x, y)) - 4 * base) <= 1e-5
    opt = prog.apply_pass("scale_out", factor=3.0)
    assert abs(float(opt.run(x, y)) - 3 * base) <= 1e-5
    with pytest.raises(TypeError, match="needs a name"):
        @tstatic.passes.register_pass
        def oops(fn):
            return fn


def test_rewrite_preserves_pytree_and_composes_with_remat():
    def f(x):
        return {"y": torch.tanh(x), "z": x + 1.0}

    prog = tstatic.Program.from_callable(f, [pt.InputSpec([4], "float32")])
    tstatic.passes.register_pass(
        "tanh_softsign", tstatic.passes.make_op_rewrite_pass(
            {"tanh": lambda x: x / (1.0 + torch.abs(x))}))
    new = prog.apply_pass("tanh_softsign")
    out = new._fn(torch.ones(4))
    assert isinstance(out, dict) and set(out) == {"y", "z"}
    np.testing.assert_allclose(out["y"].numpy(), 0.5)
    rem = prog.apply_pass("remat").apply_pass("tanh_softsign")
    assert not rem.has_op("tanh")


# ---- static.nn control flow ----

def _both(fn_of_pkg, *arrays, static=True):
    outs = []
    for pkg in (paddle, pt):
        f = fn_of_pkg(pkg)
        if static:
            f = pkg.jit.to_static(f)
        outs.append(npy(f(*[pkg.to_tensor(a) for a in arrays])))
    return outs


@pytest.mark.parametrize("static", [False, True])
def test_case_and_switch_case(static):
    def case_fn(pkg):
        snn = pkg.static.nn

        def f(x):
            s = x.sum()
            return snn.case([(s > 10, lambda: x * 10), (s > 0, lambda: x * 2)],
                            default=lambda: x * -1)
        return f

    def switch_fn(pkg):
        snn = pkg.static.nn

        def f(x, i):
            return snn.switch_case(i, {1: lambda: x + 1, 3: lambda: x * 3},
                                   default=lambda: x - 5)
        return f

    def switch_list(pkg):
        snn = pkg.static.nn

        def f(x, i):
            return snn.switch_case(i, [lambda: x + 1, lambda: x * 3],
                                   default=lambda: x - 5)
        return f

    for x in (np.full(2, 20.0, "float32"), np.ones(2, "float32"),
              -np.ones(2, "float32")):
        want, got = _both(case_fn, x, static=static)
        assert dev(got, want) <= TOL
    for make in (switch_fn, switch_list):
        for i in (0, 1, 3, 7):
            want, got = _both(make, np.ones(2, "float32"),
                              np.asarray(i, "int32"), static=static)
            assert dev(got, want) <= TOL, (make.__name__, i)


# ---- static.nn builders ----

def _new_keys(scope, before):
    return [k for k in scope if k not in before]


def _attr(pkg, name):
    return pkg.ParamAttr(name=name)


BUILDERS = {
    "fc": (lambda p, x: p.static.nn.fc(x, 5, weight_attr=_attr(p, "t_fc"),
                                       activation="relu"), [n_(3, 2, 4)]),
    "batch_norm": (lambda p, x: p.static.nn.batch_norm(
        x, param_attr=_attr(p, "t_bn")), [n_(2, 3, 4, 4)]),
    "embedding": (lambda p, i: p.static.nn.embedding(
        i, [10, 4], param_attr=_attr(p, "t_emb")),
        [np.array([[1, 2], [3, 9]], "int64")]),
    "sparse_embedding": (lambda p, i: p.static.nn.sparse_embedding(
        i, [10, 4], param_attr=_attr(p, "t_semb")),
        [np.array([[1, 2], [3, 9]], "int64")]),
    "conv2d": (lambda p, x: p.static.nn.conv2d(
        x, 4, 3, padding=1, param_attr=_attr(p, "t_c2"), act="relu"),
        [n_(2, 3, 6, 6)]),
    "conv2d_transpose": (lambda p, x: p.static.nn.conv2d_transpose(
        x, 4, 3, stride=2, param_attr=_attr(p, "t_c2t")), [n_(2, 3, 5, 5)]),
    "conv3d": (lambda p, x: p.static.nn.conv3d(
        x, 2, 3, param_attr=_attr(p, "t_c3")), [n_(1, 2, 5, 5, 5)]),
    "conv3d_transpose": (lambda p, x: p.static.nn.conv3d_transpose(
        x, 2, 2, stride=2, param_attr=_attr(p, "t_c3t")),
        [n_(1, 2, 3, 3, 3)]),
    "layer_norm": (lambda p, x: p.static.nn.layer_norm(
        x, begin_norm_axis=2, param_attr=_attr(p, "t_ln")), [n_(2, 3, 4, 5)]),
    "group_norm": (lambda p, x: p.static.nn.group_norm(
        x, 2, param_attr=_attr(p, "t_gn")), [n_(2, 4, 3, 3)]),
    "instance_norm": (lambda p, x: p.static.nn.instance_norm(
        x, param_attr=_attr(p, "t_in")), [n_(2, 3, 4, 4)]),
    "data_norm": (lambda p, x: p.static.nn.data_norm(x, act="tanh"),
                  [n_(6, 5)]),
    "prelu_all": (lambda p, x: p.static.nn.prelu(
        x, param_attr=_attr(p, "t_pra")), [n_(2, 3, 4)]),
    "prelu_channel": (lambda p, x: p.static.nn.prelu(
        x, mode="channel", param_attr=_attr(p, "t_prc")), [n_(2, 3, 4, 4)]),
    "spectral_norm": (lambda p, w: p.static.nn.spectral_norm(
        w, dim=1, power_iters=3), [n_(4, 6, 3)]),
    "bilinear_tensor_product": (lambda p, x, y: p.static.nn
                                .bilinear_tensor_product(
                                    x, y, 3, param_attr=_attr(p, "t_bl")),
                                [n_(4, 5), n_(4, 6, seed=1)]),
    "row_conv": (lambda p, x: p.static.nn.row_conv(
        x, 2, param_attr=_attr(p, "t_rc")), [n_(2, 6, 4)]),
    "crf_decoding": (lambda p, x: p.static.nn.crf_decoding(
        x, param_attr=_attr(p, "t_crf")), [n_(3, 7, 5)]),
    "crf_decoding_length": (lambda p, x, n: p.static.nn.crf_decoding(
        x, param_attr=_attr(p, "t_crf"), length=n),
        [n_(3, 7, 5), np.array([7, 3, 1], "int32")]),
    "crf_decoding_label": (lambda p, x, y: p.static.nn.crf_decoding(
        x, param_attr=_attr(p, "t_crf"), label=y),
        [n_(3, 7, 5), np.random.default_rng(0).integers(0, 5, (3, 7))
         .astype("int32")]),
    "deform_conv2d": (lambda p, x, off, m: p.static.nn.deform_conv2d(
        x, off, m, 4, 3, padding=1, weight_attr=_attr(p, "t_dc")),
        [n_(1, 2, 5, 5), 0.3 * n_(1, 18, 5, 5, seed=1),
         np.abs(n_(1, 9, 5, 5, seed=2))]),
    "multi_box_head": (lambda p, a, b, img: p.static.nn.multi_box_head(
        [a, b], img, 32, 3, [[2.0], [2.0, 3.0]], min_ratio=20, max_ratio=90),
        [n_(1, 4, 4, 4), n_(1, 4, 2, 2, seed=1), n_(1, 3, 32, 32, seed=2)]),
    "sequence_conv": (lambda p, x: p.static.nn.sequence_conv(
        x, 3, param_attr=_attr(p, "t_sc")), [n_(2, 6, 4)]),
    "sequence_first_step": (lambda p, x: p.static.nn.sequence_first_step(x),
                            [n_(2, 5, 3)]),
    "sequence_last_step": (lambda p, x, n: p.static.nn.sequence_last_step(
        x, n), [n_(2, 5, 3), np.array([2, 5], "int32")]),
    "sequence_concat": (lambda p, x, y: p.static.nn.sequence_concat([x, y]),
                        [n_(2, 3, 4), n_(2, 2, 4, seed=1)]),
    "sequence_slice": (lambda p, x, o, n: p.static.nn.sequence_slice(x, o, n),
                       [n_(2, 6, 3), np.array([1, 2], "int32"),
                        np.array([3, 2], "int32")]),
    "sequence_expand_as": (lambda p, x, n: p.static.nn.sequence_expand_as(
        x, n), [n_(3, 4), np.array([2, 0, 3], "int32")]),
    "sequence_reshape": (lambda p, x: p.static.nn.sequence_reshape(x, 2),
                         [n_(2, 3, 4)]),
    "sequence_scatter": (lambda p, x, i, u: p.static.nn.sequence_scatter(
        x, i, u), [n_(2, 5), np.array([[0, 3], [1, 1]], "int32"),
                   n_(2, 2, seed=1)]),
    "sequence_enumerate": (lambda p, x: p.static.nn.sequence_enumerate(
        x, 3, pad_value=-1), [np.arange(10, dtype="int32").reshape(2, 5)]),
    "sequence_reverse": (lambda p, x: p.static.nn.sequence_reverse(x),
                         [n_(2, 4, 3)]),
    "sequence_pool_sum": (lambda p, x, n: p.static.nn.sequence_pool(
        x, n, "sum"), [n_(3, 5, 2), np.array([1, 5, 3], "int32")]),
    "sequence_pool_average": (lambda p, x, n: p.static.nn.sequence_pool(
        x, n, "average"), [n_(3, 5, 2), np.array([1, 5, 3], "int32")]),
    "sequence_pool_sqrt": (lambda p, x, n: p.static.nn.sequence_pool(
        x, n, "sqrt"), [n_(3, 5, 2), np.array([1, 5, 3], "int32")]),
    "sequence_pool_max": (lambda p, x, n: p.static.nn.sequence_pool(
        x, n, "max"), [n_(3, 5, 2), np.array([1, 5, 3], "int32")]),
    "sequence_pool_first": (lambda p, x, n: p.static.nn.sequence_pool(
        x, n, "first"), [n_(3, 5, 2), np.array([1, 5, 3], "int32")]),
    "sequence_pool_last": (lambda p, x, n: p.static.nn.sequence_pool(
        x, n, "last"), [n_(3, 5, 2), np.array([1, 5, 3], "int32")]),
    "sequence_expand": (lambda p, x, n: p.static.nn.sequence_expand(x, n),
                        [n_(3, 4), np.array([2, 0, 3], "int32")]),
    "sequence_softmax": (lambda p, x, n: p.static.nn.sequence_softmax(x, n),
                         [n_(3, 6), np.array([1, 6, 4], "int32")]),
    "sequence_mask": (lambda p, n: p.ops.sequence.sequence_mask(n),
                      [np.array([1, 6, 4], "int32")]),
    "sequence_mask_maxlen": (lambda p, n: p.ops.sequence.sequence_mask(
        n, maxlen=8, dtype="int32"), [np.array([1, 6, 4], "int32")]),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_matches_the_reference(name):
    call, arrays = BUILDERS[name]
    jscope, tscope = jstatic.nn._LAYER_SCOPE, tstatic.nn._LAYER_SCOPE
    jb, tb = set(jscope), set(tscope)
    paddle.seed(0)
    want = call(paddle, *[paddle.to_tensor(a) for a in arrays])
    targs = [pt.to_tensor(a) for a in arrays]
    got = call(pt, *targs)
    jk, tk = _new_keys(jscope, jb), _new_keys(tscope, tb)
    assert len(jk) == len(tk), (jk, tk)
    if jk:
        load_scope_state(tscope, jscope, keys=dict(zip(jk, tk)))
        named = all(":" in k for k in tk)
        if named:                        # the named entries are reused
            got = call(pt, *targs)
        else:                            # fresh layers: run the copies
            assert name == "multi_box_head"
            got = _mbox_again(tscope, tk, targs)
    seq = (lambda o: list(o) if isinstance(o, (list, tuple)) else [o])
    for g, w in zip(seq(got), seq(want)):
        g, w = npy(g), npy(w)
        assert g.dtype.kind == w.dtype.kind or (
            g.dtype.kind in "iu" and w.dtype.kind in "iu"), (g.dtype, w.dtype)
        assert dev(g, w) <= TOL, name


def _mbox_again(tscope, keys, targs):
    """multi_box_head's convs with the copied weights (its builder makes
    fresh ones at every call)."""
    a, b, img = targs
    locs, confs = [], []
    for i, f in enumerate((a, b)):
        loc = tscope[keys[2 * i]](f)
        conf = tscope[keys[2 * i + 1]](f)
        locs.append(loc.transpose([0, 2, 3, 1]).reshape([1, -1, 4]))
        confs.append(conf.transpose([0, 2, 3, 1]).reshape([1, -1, 3]))
    _, _, box, var = tstatic.nn.multi_box_head(
        [a, b], img, 32, 3, [[2.0], [2.0, 3.0]], min_ratio=20, max_ratio=90)
    return [pt.concat(locs, axis=1), pt.concat(confs, axis=1), box, var]


def test_builders_inside_to_static_and_gradients():
    """fc and layer_norm inside a to_static function, their layers made by
    an eager call first: the export holds the scoped layers' weights as
    constants, as the reference's trace closes over them, so the input
    gets its gradient and the weights none in both."""
    outs = {}
    for pkg in (paddle, pt):
        snn = pkg.static.nn

        def f(x):
            h = snn.fc(x, 4, weight_attr=pkg.ParamAttr(name="t_grad_fc"))
            return snn.layer_norm(h, param_attr=pkg.ParamAttr(name="t_g_ln"))

        x = n_(3, 6)
        pkg.seed(0)
        f(pkg.to_tensor(x))              # the scoped layers are made eagerly
        if pkg is pt:                    # and carry the reference's weights
            load_scope_state(tstatic.nn._LAYER_SCOPE,
                             jstatic.nn._LAYER_SCOPE,
                             keys={k: k for k in ("fc:t_grad_fc",
                                                  "layer_norm:t_g_ln")})
        xt = pkg.to_tensor(x, stop_gradient=False)
        out = pkg.jit.to_static(f)(xt)
        (out * out).sum().backward()
        fc = pkg.static.nn._LAYER_SCOPE["fc:t_grad_fc"]
        assert fc.weight.grad is None
        outs[pkg] = (npy(out), npy(xt.gradient()))
    assert dev(outs[pt][0], outs[paddle][0]) <= TOL
    assert dev(outs[pt][1], outs[paddle][1]) <= TOL
    with pytest.raises(RuntimeError, match="eagerly"):
        pt.jit.to_static(lambda v: tstatic.nn.fc(v, 2))(pt.to_tensor(n_(2, 3)))


def test_nce_draws_fresh_negatives_on_the_reference_weights():
    x = pt.to_tensor(n_(4, 6))
    y = pt.to_tensor(np.array([1, 2, 3, 0], "int64"))
    a = tstatic.nn.nce(x, y, 20, num_neg_samples=5,
                       param_attr=pt.ParamAttr(name="t_nce"))
    b = tstatic.nn.nce(x, y, 20, num_neg_samples=5,
                       param_attr=pt.ParamAttr(name="t_nce"))
    assert list(a.shape) == [4, 1] and np.isfinite(a.numpy()).all()
    assert (a.numpy() > 0).all() and not np.array_equal(a.numpy(), b.numpy())
    # the weights: RandomState(seed) / sqrt(D), as the reference's
    jstatic.nn.nce(paddle.to_tensor(n_(4, 6)),
                   paddle.to_tensor(np.array([1, 2, 3, 0], "int64")), 20,
                   num_neg_samples=5, param_attr=paddle.ParamAttr(
                       name="t_nce"))
    np.testing.assert_array_equal(
        tstatic.nn._LAYER_SCOPE["nce:t_nce:20"].detach().numpy(),
        np.asarray(jstatic.nn._LAYER_SCOPE["nce:t_nce:20"]._value))


def test_py_func_eager_and_exported():
    def host(a):
        return np.sin(a) * 2.0

    x = n_(3, 4)
    want = jstatic.nn.py_func(host, paddle.to_tensor(x),
                              paddle.static.InputSpec([3, 4], "float32"))
    got = tstatic.py_func(host, pt.to_tensor(x), pt.InputSpec([3, 4],
                                                             "float32"))
    assert dev(got.numpy(), npy(want)) <= TOL

    @pt.jit.to_static
    def f(v):
        return tstatic.nn.py_func(host, v * 1.0,
                                  pt.InputSpec([3, 4], "float32")) + 1.0

    out = f(pt.to_tensor(x))
    assert dev(out.numpy(), np.sin(x) * 2.0 + 1.0) <= TOL
    assert f.program().has_op("py_func")


# ---- core/lod.py and ops/sequence.py ----

def test_lod_tensor_and_sequence_pad_match_the_reference():
    rng = np.random.default_rng(0)
    seqs = [rng.normal(size=(int(n), 3)).astype(np.float32)
            for n in rng.integers(1, 20, 5)]
    jl, tl = jlod.create_lod_tensor(seqs), tlod.create_lod_tensor(seqs)
    np.testing.assert_array_equal(tl.data.numpy(), np.asarray(jl.data))
    assert tl.lod() == jl.lod()
    assert tl.recursive_sequence_lengths() == jl.recursive_sequence_lengths()
    np.testing.assert_array_equal(tl.mask().numpy(), np.asarray(jl.mask()))
    for a, b in zip(tl.to_list(), seqs):
        np.testing.assert_array_equal(a, b)
    assert tlod.bucket_length(17) == jlod.bucket_length(17) == 32
    assert tlod.bucket_length(5000) == 5000
    with pytest.raises(ValueError):
        tlod.LoDTensor(np.zeros((3, 4)), np.array([1, 2]))
    jx, jn = jseq.sequence_pad(seqs)
    tx, tn = tseq.sequence_pad(seqs)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx._value))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn._value))
    for a, b in zip(tseq.sequence_unpad(tx, tn), seqs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="maxlen"):
        tseq.sequence_pad([np.zeros(10), np.zeros(3)], maxlen=8)
    assert tseq.sequence_pad(seqs, maxlen=20)[0].shape == [5, 20, 3]
    assert isinstance(pt.create_lod_tensor(seqs), pt.LoDTensor)


# ---- the static API ----

def test_inference_model_save_and_load(tmp_path):
    jnet, tnet = _pair(_mlp)
    x = n_(4, 8)
    path = str(tmp_path / "inf")
    tstatic.save_inference_model(path, [pt.InputSpec([4, 8], "float32")],
                                 None, layer=tnet)
    prog, feeds, fetches = tstatic.load_inference_model(path)
    assert feeds == ["input_0"] and fetches == ["output_0"]
    (got,) = tstatic.Executor().run(prog, feed={"input_0": x})
    assert dev(got, jnet(paddle.to_tensor(x)).numpy()) <= TOL
    with pytest.raises(NotImplementedError):
        tstatic.save_inference_model(path, [], [])


def test_scope_save_load_and_serialisation(tmp_path):
    x = pt.to_tensor(n_(2, 4))
    tstatic.nn.fc(x, 3, weight_attr=pt.ParamAttr(name="t_io_fc"))
    p = tstatic.create_parameter([2, 2], "float32", name="t_io_p")
    lin = tstatic.nn._LAYER_SCOPE["fc:t_io_fc"]
    w0 = lin.weight.detach().clone()
    path = str(tmp_path / "scope")
    tstatic.save(None, path)
    with torch.no_grad():
        lin.weight.add_(1.0)
        p.add_(1.0)
    tstatic.load(None, path)
    np.testing.assert_array_equal(lin.weight.detach().numpy(), w0.numpy())
    state = tstatic.load_program_state(path)
    assert "fc:t_io_fc" in state and "param:t_io_p" in state
    state["fc:t_io_fc"]["weight"] = np.zeros((4, 3), "float32")
    tstatic.set_program_state(None, state)
    assert float(lin.weight.abs().sum()) == 0.0
    blob = tstatic.serialize_persistables([], [])
    assert tstatic.deserialize_persistables(None, blob)["fc:t_io_fc"][
        "weight"].shape == (4, 3)
    pf = str(tmp_path / "blob")
    tstatic.save_to_file(pf, blob)
    assert tstatic.load_from_file(pf) == blob
    pt.jit.to_static(lambda v: v + 1)(x)
    prog = tstatic.deserialize_program(tstatic.serialize_program([x], [x]))
    assert prog["name"] == "<lambda>"
    assert tstatic.normalize_program(tstatic.default_main_program(),
                                     [x], [x]) is \
        tstatic.default_main_program()
    assert tstatic.global_scope().find_var("fc:t_io_fc") is lin


def test_create_parameter_matches_the_reference():
    j = jstatic.create_parameter([3, 4], "float32", name="t_cp")
    t = tstatic.create_parameter([3, 4], "float32", name="t_cp")
    np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j._value))
    assert isinstance(t, pt.Parameter) and t.name == "t_cp"
    g = tstatic.create_global_var([2, 3], 1.5, "float32", persistable=True,
                                  name="gv")
    assert g.name == "gv" and g.persistable and float(g.sum()) == 9.0


def test_append_backward_and_gradients():
    jnet, tnet = _pair(_mlp)
    x = n_(4, 8)
    jpairs = jstatic.append_backward(jnet(paddle.to_tensor(x)).sum())
    tpairs = tstatic.append_backward(tnet(pt.to_tensor(x)).sum())
    assert len(tpairs) == len(jpairs) == 6
    jname = {id(p): n for n, p in jnet.named_parameters()}
    tname = {id(p): n for n, p in tnet.named_parameters()}
    want = {jname[id(p)]: np.asarray(g) for p, g in jpairs}
    for p, g in tpairs:
        assert dev(g.numpy(), want[tname[id(p)]]) <= TOL
    xs = pt.to_tensor(n_(3), stop_gradient=False)
    (g,) = tstatic.gradients([(xs * xs).sum()], [xs])
    assert dev(g.numpy(), 2 * xs.numpy()) <= TOL


def test_ema_matches_the_reference():
    jnet, tnet = _pair(_mlp)
    jema = jstatic.ExponentialMovingAverage(0.9)
    tema = tstatic.ExponentialMovingAverage(0.9)
    jp, tp = list(jnet.parameters()), list(tnet.parameters())
    for step in range(3):
        jema.update(jp)
        tema.update(tp)
        for a, b in zip(jp, tp):
            v = n_(*b.shape, seed=step) * 0.1
            a._value = a._value + v
            with torch.no_grad():
                b.add_(torch.from_numpy(v))
    x = n_(2, 8)
    jema.apply()
    tema.apply()
    assert dev(tnet(pt.to_tensor(x)).numpy(),
               jnet(paddle.to_tensor(x)).numpy()) <= TOL
    tema.restore()
    jema.restore()
    assert dev(tnet(pt.to_tensor(x)).numpy(),
               jnet(paddle.to_tensor(x)).numpy()) <= TOL


def test_metrics_print_places_and_guards(capsys):
    logits = n_(8, 4)
    y = np.random.default_rng(1).integers(0, 4, (8, 1)).astype("int64")
    for k in (1, 2):
        assert float(tstatic.accuracy(pt.to_tensor(logits),
                                      pt.to_tensor(y), k=k)) == \
            float(jstatic.accuracy(paddle.to_tensor(logits),
                                   paddle.to_tensor(y), k=k))
    p2 = np.random.default_rng(2).random((16, 2)).astype("float32")
    y2 = np.random.default_rng(3).integers(0, 2, (16, 1)).astype("int64")
    assert abs(float(tstatic.auc(pt.to_tensor(p2), pt.to_tensor(y2))[0])
               - float(jstatic.auc(paddle.to_tensor(p2),
                                   paddle.to_tensor(y2))[0])) <= 1e-6
    x = pt.to_tensor(n_(2))
    assert tstatic.Print(x, message="dbg") is x
    assert "[dbg] shape=(2,)" in capsys.readouterr().out
    assert [pl.device_id for pl in tstatic.cpu_places(2)] == [0, 1]
    assert tstatic.cuda_places([1])[0] == pt.CUDAPlace(1)
    # the reference's xpu / npu / mlu places and name_scope raise (its
    # Place takes one argument; its unique_name has no guard): the port's
    # work (a deviation, pinned)
    for fn in ("xpu_places", "npu_places", "mlu_places"):
        with pytest.raises(TypeError):
            getattr(jstatic, fn)()
        assert getattr(tstatic, fn)([0, 1])[1].device_type == fn[:3]
    with pytest.raises(AttributeError):
        with jstatic.name_scope("n"):
            pass
    with tstatic.name_scope("n"), tstatic.program_guard(None), \
            tstatic.scope_guard(tstatic.global_scope()), \
            tstatic.ipu_shard_guard(), tstatic.device_guard("gpu"):
        pass
    spec = tstatic.data("x", [None, 3], "float32")
    assert spec.shape == (-1, 3) and spec.name == "x"
    cp = tstatic.CompiledProgram(lambda v: v * 2).with_data_parallel()
    assert float(cp(pt.to_tensor(np.float32(2.0)))) == 4.0
    s = tstatic.IpuStrategy()
    s.set_graph_config(num_ipus=2)
    assert tstatic.IpuCompiledProgram(cp).compile() is cp
    assert tstatic.BuildStrategy().memory_optimize and \
        tstatic.ExecutionStrategy().num_threads == 1
    assert tstatic.ParallelExecutor(main_program=cp)._program is cp
    assert tstatic.WeightNormParamAttr(dim=0).dim == 0
    assert tstatic.Variable is pt.Tensor


def test_train_from_dataset_and_executor_callable():
    jnet, tnet = _pair(_mlp)
    data = [n_(4, 8, seed=i) for i in range(3)]
    losses = {}
    for pkg, net in ((paddle, jnet), (pt, tnet)):
        opt = pkg.optimizer.SGD(learning_rate=0.1,
                                parameters=net.parameters())

        def step(batch, pkg=pkg, net=net, opt=opt):
            loss = (net(pkg.to_tensor(batch)) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        exe = (jstatic if pkg is paddle else tstatic).Executor()
        losses[pkg] = np.asarray(exe.train_from_dataset(step, data))
    assert dev(losses[pt], losses[paddle]) <= TOL
    (out,) = tstatic.Executor().run(lambda a: a * 2, feed=[np.ones(2)])
    np.testing.assert_array_equal(out, [2.0, 2.0])


def test_namespaces_against_the_reference_api():
    with open(os.path.join(os.path.dirname(__file__),
                           "reference_api_all.json")) as f:
        api = json.load(f)
    for ns, mod in (("paddle.static", tstatic),
                    ("paddle.static.nn", tstatic.nn),
                    ("paddle.jit", pt.jit)):
        missing = [n for n in api[ns] if not hasattr(mod, n)]
        assert not missing, (ns, missing)
    assert len(api["paddle.static"]) == 47 and \
        len(api["paddle.static.nn"]) == 40 and len(api["paddle.jit"]) == 9
