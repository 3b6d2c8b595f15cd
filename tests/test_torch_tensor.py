"""The port's paddle Tensor (`paddle_tpu_torch.Tensor`) against the JAX
package's, on the CPU: its surface (shape, size, place, stop_gradient,
numpy, item, tolist, astype, clone, detach), the dunders with the
reference's dtypes, indexing, grad accumulation across backward() calls,
clear_grad, hooks, in-place ops on leaves, and the boundary that keeps the
port's torch-facing code on plain tensors.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import autograd as jautograd
import paddle_tpu_torch as pt
from paddle_tpu_torch.core.dtype import dtype_name


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture(autouse=True)
def _fresh_reference_op_cache():
    """The reference's eager op cache keys a closure's Python constants by
    value (`paddle_tpu/core/autograd.py` `_freeze`), and 2 == 2.0: an op on
    an int tensor with an int constant, after the same op with the equal
    float constant anywhere earlier in the process, replays the float
    entry and returns float32. Each test starts from an empty cache."""
    jautograd._JIT_CACHE.clear()


A = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
B = np.random.default_rng(1).standard_normal((3, 4)).astype(np.float32)
I = np.arange(12, dtype=np.int32).reshape(3, 4)


def _both(a, **kw):
    return paddle.to_tensor(a, **kw), pt.to_tensor(a, **kw)


def _same(got, want, tol=1e-6):
    assert isinstance(got, pt.Tensor), type(got)
    assert dtype_name(got.dtype) == np.dtype(want.dtype).name
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol)


def test_metadata_matches_the_reference():
    j, t = _both(A)
    assert t.shape == j.shape == [3, 4] and isinstance(t.shape, list)
    assert t.size == j.size == 12 and isinstance(t.size, int)
    assert t.ndim == j.ndim == 2
    assert t.numel() == 12 and len(t) == 3
    assert t.place == pt.CPUPlace(0)
    assert t.stop_gradient is True and j.stop_gradient is True
    assert t.is_leaf


@pytest.mark.parametrize("data", [
    [1, 2, 3], [1.5, 2.0], 3, 2.5, True, [[True, False]],
    np.arange(4, dtype=np.int64), np.ones(3, np.float64),
    np.ones(2, np.float16), np.arange(3, dtype=np.uint8)])
def test_to_tensor_dtypes_match_the_reference(data):
    j, t = _both(data)
    assert dtype_name(t.dtype) == np.dtype(j.dtype).name, (t.dtype, j.dtype)
    np.testing.assert_array_equal(t.numpy(), j.numpy())


def test_to_tensor_copies_and_honours_place_and_dtype():
    src = torch.ones(3)
    t = pt.to_tensor(src)
    src.add_(1)
    assert t.tolist() == [1.0, 1.0, 1.0]
    t = pt.to_tensor(A, dtype="bfloat16", place="cpu")
    assert t.dtype == pt.bfloat16 and t.place == pt.CPUPlace(0)
    np.testing.assert_array_equal(
        t.numpy(), torch.from_numpy(A).bfloat16().float().numpy())
    assert t.numpy().dtype == np.float32   # numpy has no bf16: exact f32
    assert pt.to_tensor(pt.to_tensor(A)).stop_gradient is True


def test_numpy_item_tolist_astype_clone_detach_cpu():
    j, t = _both(A)
    np.testing.assert_array_equal(t.numpy(), A)
    assert t[1, 2].item() == pytest.approx(float(A[1, 2]))
    assert t.tolist() == j.tolist()
    _same(t.astype("int32"), j.astype("int32"))
    _same(t.cast("float16"), j.cast("float16"), tol=1e-3)
    c = t.clone()
    assert isinstance(c, pt.Tensor) and c.data_ptr() != t.data_ptr()
    d = pt.to_tensor(A, stop_gradient=False).detach()
    assert d.stop_gradient and isinstance(d, pt.Tensor)
    assert isinstance(t.cpu(), pt.Tensor)
    assert np.asarray(t).shape == (3, 4)
    assert float(pt.to_tensor(2.5)) == 2.5 and int(pt.to_tensor(3)) == 3


@pytest.mark.parametrize("expr", [
    "x + y", "x - y", "x * y", "x / y", "x ** 2", "-x", "abs(x)", "x @ y.t()",
    "x + 1", "1 - x", "2 * x", "1 / (abs(x) + 1)", "x > y", "x >= 0",
    "x < y", "x <= 0", "x == x", "x != y", "i + 1", "i * 2", "i / 2",
    "i // 3", "i % 5", "i ** 2", "i - 1.5", "~(x > 0)", "i + x[:, :1]"])
def test_dunders_match_the_reference(expr):
    j_env = {"x": paddle.to_tensor(A), "y": paddle.to_tensor(B),
             "i": paddle.to_tensor(I)}
    t_env = {"x": pt.to_tensor(A), "y": pt.to_tensor(B),
             "i": pt.to_tensor(I)}
    _same(eval(expr, {}, t_env), eval(expr, {}, j_env), tol=1e-5)


def test_bitwise_dunders_match_the_reference_functions():
    """The reference's Tensor has no &, |, ^: the port's give its
    bitwise_* ops' results."""
    j, t = _both(I)
    _same(t & 6, paddle.bitwise_and(j, 6))
    _same(t | 1, paddle.bitwise_or(j, 1))
    _same(t ^ 3, paddle.bitwise_xor(j, 3))
    _same(~t, paddle.bitwise_not(j))
    _same(~(t > 3), paddle.logical_not(j > 3))


@pytest.mark.parametrize("idx", [
    1, -1, (1, 2), (slice(0, 2), 1), (Ellipsis, 0), (None, 1),
    (slice(None, None, -1),), (slice(None), slice(3, 0, -2)), [0, 2],
    (np.array([0, 2]), np.array([1, 3]))])
def test_getitem_matches_the_reference(idx):
    j, t = _both(A)
    _same(t[idx], j[idx])


def test_getitem_with_tensor_and_mask_indices():
    j, t = _both(A)
    ji, ti = _both(np.array([2, 0], np.int32))
    _same(t[ti], j[ji])
    jm, tm = j > 0, t > 0
    _same(t[tm], j[jm])


@pytest.mark.parametrize("idx,value", [
    ((1, 2), 5.0), (0, np.ones(4, np.float32)), ((slice(None), 1), -1.0),
    ([0, 2], 3.0)])
def test_setitem_matches_the_reference(idx, value):
    j, t = _both(A)
    j[idx] = value
    t[idx] = value
    _same(t, j)


def test_setitem_with_a_tensor_value_is_differentiable():
    jx, tx = _both(A, stop_gradient=False)
    jv, tv = _both(np.full(4, 2.0, np.float32), stop_gradient=False)
    jy, ty = jx * 1.0, tx * 1.0
    jy[1] = jv * 3.0
    ty[1] = tv * 3.0
    (jy * jy).sum().backward()
    (ty * ty).sum().backward()
    np.testing.assert_allclose(tx.gradient(), jx.gradient(), rtol=1e-6)
    np.testing.assert_allclose(tv.gradient(), jv.gradient(), rtol=1e-6)


def test_grads_accumulate_over_two_backwards_and_clear_grad():
    jx, tx = _both(A, stop_gradient=False)
    for _ in range(2):
        (jx * jx).sum().backward()
        (tx * tx).sum().backward()
    assert isinstance(tx.grad, pt.Tensor)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad),
                               rtol=1e-6)
    np.testing.assert_allclose(tx.gradient(), 4 * A, rtol=1e-6)
    tx.clear_grad()
    jx.clear_grad()
    assert tx.grad is None and jx.grad is None
    tx.clear_gradient()


def test_backward_with_grad_tensor_and_retain_graph():
    jx, tx = _both(A, stop_gradient=False)
    g = np.full((3, 4), 0.5, np.float32)
    jy, ty = jx.exp(), tx.exp()
    jy.backward(paddle.to_tensor(g), retain_graph=True)
    ty.backward(pt.to_tensor(g), retain_graph=True)
    ty.backward(pt.to_tensor(g))
    jy.backward(paddle.to_tensor(g))
    np.testing.assert_allclose(tx.gradient(), jx.gradient(), rtol=1e-6)


def test_backward_of_a_stop_gradient_tensor_is_a_no_op():
    jx, tx = _both(A)
    jx.sum().backward()
    tx.sum().backward()
    assert tx.grad is None and jx.grad is None


def test_stop_gradient_blocks_and_opens_the_graph():
    tx = pt.to_tensor(A)
    assert tx.stop_gradient
    tx.stop_gradient = False
    assert tx.requires_grad and not tx.stop_gradient
    y = tx.sum() * 2
    assert not y.stop_gradient
    assert y.detach().stop_gradient


def test_register_hook_sees_and_replaces_the_gradient():
    jx, tx = _both(A, stop_gradient=False)
    seen = []
    h = tx.register_hook(lambda g: seen.append(type(g)) or g * 2)
    jx.register_hook(lambda g: g * 2)
    (tx * 3).sum().backward()
    (jx * 3).sum().backward()
    assert seen == [pt.Tensor]
    np.testing.assert_allclose(tx.gradient(), jx.gradient())
    h.remove()


def test_set_value_and_zero_():
    j, t = _both(A)
    t.set_value(B)
    j.set_value(B)
    _same(t, j)
    with pytest.raises(ValueError):
        t.set_value(np.ones(3, np.float32))
    t.zero_()
    assert not t.numpy().any()


@pytest.mark.parametrize("name,args", [
    ("add_", (B,)), ("scale_", (2.0, 1.0)), ("exp_", ()), ("clip_", (-0.2, 0.2)),
    ("fill_", (3.0,)), ("subtract_", (B,)), ("multiply_", (B,))])
def test_inplace_ops_on_leaves(name, args):
    """Without a gradient, and under no_grad on a leaf that needs one, an
    in-place op writes the leaf as the reference rebinds it. With autograd
    on, a leaf that needs a gradient cannot be written in place in torch:
    the port raises RuntimeError (the reference would route that leaf's
    gradient to a hidden copy)."""
    jargs = [paddle.to_tensor(a) if isinstance(a, np.ndarray) else a
             for a in args]
    targs = [pt.to_tensor(a) if isinstance(a, np.ndarray) else a
             for a in args]
    j, t = _both(A)
    assert getattr(t, name)(*targs) is t
    getattr(j, name)(*jargs)
    _same(t, j, tol=1e-6)
    j, t = _both(A, stop_gradient=False)
    with pt.no_grad():
        getattr(t, name)(*targs)
    with paddle.no_grad():
        getattr(j, name)(*jargs)
    _same(t, j, tol=1e-6)
    assert not t.stop_gradient
    if name != "fill_":
        with pytest.raises(RuntimeError):
            getattr(t, name)(*targs)


def test_inplace_op_on_a_non_leaf_keeps_the_graph():
    jx, tx = _both(A, stop_gradient=False)
    jy, ty = jx * 2.0, tx * 2.0
    jy.exp_()
    ty.exp_()
    jy.sum().backward()
    ty.sum().backward()
    np.testing.assert_allclose(tx.gradient(), jx.gradient(), rtol=1e-6)


def test_dual_call_forms_of_clashing_methods():
    t = pt.to_tensor(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
    assert t.reshape([6, 4]).shape == t.reshape(6, 4).shape == [6, 4]
    assert t.transpose([2, 0, 1]).shape == [4, 2, 3]
    assert t.transpose(0, 2).shape == [4, 3, 2]
    assert t.expand([2, 2, 3, 4]).shape == t.expand(2, 2, 3, 4).shape
    assert t.tile([1, 2, 1]).shape == t.tile(1, 2, 1).shape == [2, 6, 4]
    # paddle's meaning only
    assert [p.shape for p in t.split(2, axis=2)] == [[2, 3, 2]] * 2
    assert [p.shape for p in t.split(3, axis=1)] == [[2, 1, 4]] * 3
    assert t.max(axis=1).shape == [2, 4]
    assert t.sort(axis=0).shape == [2, 3, 4]
    assert t.flatten(1).shape == [2, 12]
    g = t.gather(pt.to_tensor([0, 2]), axis=1)
    assert g.shape == [2, 2, 4]


def test_torch_functions_take_tensors_and_give_tensors_back():
    t = pt.to_tensor(A)
    out = torch.nn.functional.softmax(t, dim=-1)
    assert isinstance(out, pt.Tensor)
    np.testing.assert_allclose(out.numpy(),
                               torch.softmax(torch.from_numpy(A), -1).numpy())
    parts = torch.split(t, 2, dim=1)        # torch's meaning through torch
    assert [p.shape for p in parts] == [[3, 2], [3, 2]]
    assert torch.cat([t, t]).shape == [6, 4]
    assert isinstance(t.float(), pt.Tensor)
    assert str(t.sum()).startswith("Tensor(")


def test_iteration_and_repr():
    t = pt.to_tensor(A)
    rows = list(t)
    assert len(rows) == 3 and all(isinstance(r, pt.Tensor) for r in rows)
    assert "shape=[3, 4]" in repr(t) and "float32" in repr(t)


def test_dtype_aliases_are_torchs():
    assert pt.float32 is torch.float32 and pt.int32 is torch.int32
    assert pt.bfloat16 is torch.bfloat16 and pt.bool is torch.bool
    assert dtype_name(pt.to_tensor(A).dtype) == "float32"


def test_check_nan_inf_raises_naming_the_op():
    x = pt.to_tensor(np.array([1.0, 0.0], np.float32))
    pt.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="log"):
            pt.log(x - 1.0)
        with pytest.raises(FloatingPointError, match="divide"):
            pt.divide(x, pt.zeros([2]))
        pt.exp(x)
    finally:
        pt.set_flags({"FLAGS_check_nan_inf": False})
    pt.log(x)                  # off: no check


def test_monitor_books_each_op():
    from paddle_tpu_torch import monitor
    monitor.reset()
    x = pt.to_tensor(A)
    pt.set_flags({"FLAGS_monitor": True})
    try:
        (x + 1).sum()
        pt.exp(x)
    finally:
        pt.set_flags({"FLAGS_monitor": False})
    snap = monitor.snapshot()
    counters = snap["counters"]
    assert counters["dispatch.op_count"] == 3
    assert counters["dispatch.op.add"] == 1 and counters["dispatch.op.exp"] == 1
    (x + 1).sum()
    assert monitor.snapshot()["counters"]["dispatch.op_count"] == 3


def test_layers_and_functionals_keep_plain_tensors_plain():
    """The boundary: a Tensor argument gives Tensor outputs of the same
    values; plain arguments give plain outputs (no Tensor inside)."""
    pt.seed(0)
    lin = pt.nn.Linear(4, 5)
    x = torch.from_numpy(A)
    plain = lin(x)
    wrapped = lin(pt.to_tensor(A))
    assert type(plain) is torch.Tensor and type(wrapped) is pt.Tensor
    np.testing.assert_array_equal(wrapped.numpy(), plain.detach().numpy())
    F = pt.nn.functional
    for fn, args in ((F.gelu, (x,)), (F.tanh, (x,)),
                     (F.layer_norm, (x, 4)), (F.dropout, (x, 0.0)),
                     (F.linear, (x, lin.weight, lin.bias))):
        p = fn(*args)
        w = fn(*[pt.to_tensor(a.detach().numpy()) if a is x else a
                 for a in args])
        assert type(p) is torch.Tensor and type(w) is pt.Tensor
        np.testing.assert_allclose(w.numpy(), p.detach().numpy(), rtol=1e-6)
    ids = np.array([[1, 0, 2]], np.int32)
    emb = F.embedding(pt.to_tensor(ids), lin.weight)
    assert type(emb) is pt.Tensor
    loss = F.cross_entropy(pt.to_tensor(A), pt.to_tensor(np.array([0, 3, 1])))
    assert type(loss) is pt.Tensor and loss.shape == []
    q = pt.to_tensor(np.ones((1, 8, 2, 64), np.float32))
    att = F.scaled_dot_product_attention(q, q, q, is_causal=True)
    assert type(att) is pt.Tensor and att.shape == [1, 8, 2, 64]
