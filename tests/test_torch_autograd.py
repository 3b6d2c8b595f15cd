"""The port's autograd surface against the JAX package's, on the CPU:
`paddle.grad` (with create_graph for a second derivative, grad_outputs,
allow_unused), the `no_grad` / `enable_grad` / `set_grad_enabled` forms,
`PyLayer` with paddle's context, and `autograd.jacobian`, `hessian`,
`vjp` and `jvp`. Values within 1e-5.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.autograd as jag
import paddle_tpu_torch as pt
import paddle_tpu_torch.autograd as tag

A = np.random.default_rng(0).uniform(0.5, 1.5, (3, 4)).astype(np.float32)
B = np.random.default_rng(1).uniform(-1.0, 1.0, (3, 4)).astype(np.float32)
V = np.random.default_rng(2).uniform(0.5, 1.5, (4,)).astype(np.float32)


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _close(got, want, tol=1e-5):
    g = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    w = want.numpy() if hasattr(want, "numpy") else np.asarray(want)
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def _leaves(pkg, *arrays):
    return [pkg.to_tensor(a, stop_gradient=False) for a in arrays]


def test_grad_matches_the_reference_and_leaves_grad_alone():
    outs = []
    for pkg in (paddle, pt):
        x, y = _leaves(pkg, A, B)
        z = (x * x * y).sum() + (x.exp() * y).mean()
        gx, gy = pkg.grad(z, [x, y])
        assert x.grad is None and y.grad is None
        outs.append((gx, gy))
    assert isinstance(outs[1][0], pt.Tensor)
    for g, w in zip(outs[1], outs[0]):
        _close(g, w)


def test_grad_with_grad_outputs_and_several_outputs():
    res = []
    for pkg in (paddle, pt):
        x, = _leaves(pkg, A)
        y1, y2 = x * 2.0, x.sin()
        g = pkg.grad([y1, y2], x, grad_outputs=[pkg.to_tensor(B), None])
        res.append(g[0])
    _close(res[1], res[0])


def test_second_derivative_with_create_graph():
    res = []
    for pkg in (paddle, pt):
        x, = _leaves(pkg, A)
        y = (x ** 3).sum()
        (g,) = pkg.grad(y, x, create_graph=True)
        (g2,) = pkg.grad(g.sum(), x)
        res.append((g, g2))
    _close(res[1][0], res[0][0])
    _close(res[1][1], res[0][1])
    _close(res[1][1], 6 * A)


def test_allow_unused():
    for pkg in (paddle, pt):
        x, y = _leaves(pkg, A, B)
        z = (x * 2.0).sum()
        with pytest.raises(RuntimeError):
            pkg.grad(z, [x, y], retain_graph=True)
        gx, gy = pkg.grad(z, [x, y], allow_unused=True)
        assert gy is None
        _close(gx, np.full_like(A, 2.0))


@pytest.mark.parametrize("form", ["context", "decorator", "set", "enable"])
def test_no_grad_forms(form):
    for pkg in (paddle, pt):
        x, = _leaves(pkg, A)
        if form == "context":
            with pkg.no_grad():
                y = x * 2.0
            assert y.stop_gradient
        elif form == "decorator":
            @pkg.no_grad()
            def f(t):
                return t * 2.0
            assert f(x).stop_gradient
        elif form == "set":
            pkg.set_grad_enabled(False)
            try:
                assert not pkg.is_grad_enabled()
                assert (x * 2.0).stop_gradient
            finally:
                pkg.set_grad_enabled(True)
            assert pkg.is_grad_enabled()
        else:
            with pkg.no_grad():
                with pkg.enable_grad():
                    y = x * 2.0
            assert not y.stop_gradient


def _pylayer(pkg):
    class Cube(pkg.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k):
            ctx.save_for_backward(x)
            ctx.k = k
            return x * x * x * k

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * 3.0 * x * x * ctx.k

    class Two(pkg.autograd.PyLayer):
        @staticmethod
        def forward(ctx, a, b):
            ctx.save_for_backward(a, b)
            return a * b, a + b

        @staticmethod
        def backward(ctx, dp, ds):
            a, b = ctx.saved_tensor()
            return dp * b + ds, dp * a + ds

    return Cube, Two


def test_pylayer_matches_the_reference():
    res = []
    for pkg in (paddle, pt):
        Cube, Two = _pylayer(pkg)
        x, y = _leaves(pkg, A, B)
        c = Cube.apply(x, 2.0)
        p, s = Two.apply(c, y)
        (p.sum() + (s * s).sum()).backward()
        res.append((c, p, s, x.grad, y.grad))
    assert isinstance(res[1][0], pt.Tensor)
    for g, w in zip(res[1], res[0]):
        _close(g, w, tol=1e-4)


def test_pylayer_without_gradient_inputs_runs_forward_only():
    Cube, _ = _pylayer(pt)
    out = Cube.apply(pt.to_tensor(A), 1.0)
    assert out.stop_gradient
    _close(out, A ** 3)


def test_jacobian_and_hessian_match_the_reference():
    def f(pkg):
        return lambda x: (x * x).sum(axis=0) * 2.0 + x[0]

    def s(pkg):
        return lambda x: (x * x * x).sum()

    for fn, build in (("jacobian", f), ("hessian", s)):
        want = getattr(jag, fn)(build(paddle), paddle.to_tensor(V))
        got = getattr(tag, fn)(build(pt), pt.to_tensor(V))
        assert isinstance(got, pt.Tensor)
        _close(got, want)
    # several inputs: one block per input
    want = jag.jacobian(lambda a, b: a * b, [paddle.to_tensor(V),
                                             paddle.to_tensor(V * 2)])
    got = tag.jacobian(lambda a, b: a * b, [pt.to_tensor(V),
                                            pt.to_tensor(V * 2)])
    for g, w in zip(got, want):
        _close(g, w)


def test_vjp_and_jvp_match_the_reference():
    def fn(x):
        return x.exp() * 2.0

    jo, jg = jag.vjp(fn, paddle.to_tensor(V), paddle.to_tensor(V * 3))
    to, tg = tag.vjp(fn, pt.to_tensor(V), pt.to_tensor(V * 3))
    _close(to, jo)
    _close(tg, jg)
    jo, jg = jag.vjp(fn, paddle.to_tensor(V))
    to, tg = tag.vjp(fn, pt.to_tensor(V))
    _close(tg, jg)
    jo, jt = jag.jvp(fn, paddle.to_tensor(V), paddle.to_tensor(V * 0.5))
    to, tt = tag.jvp(fn, pt.to_tensor(V), pt.to_tensor(V * 0.5))
    _close(to, jo)
    _close(tt, jt)
    jo, jt = jag.jvp(fn, paddle.to_tensor(V))
    to, tt = tag.jvp(fn, pt.to_tensor(V))
    _close(tt, jt)


def test_autograd_backward_function():
    res = []
    for pkg in (paddle, pt):
        x, = _leaves(pkg, A)
        pkg.autograd.backward((x * x).sum())
        res.append(x.grad)
    _close(res[1], res[0])
