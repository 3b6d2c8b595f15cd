"""The port's `ErnieScanStack` against the JAX package's, on a small stack
carried across by name.

One JAX state dict feeds both packages: 2 layers, hidden 256, 4 heads of
64, FFN 512, on B=2 x S=128 inputs drawn from a numpy seed. The JAX stack
runs its Pallas flash kernels in interpret mode (as
`tests/test_flash_attention.py` runs them), the port's takes the kernels'
plain versions on the CPU. For each remat mode the output, the loss
`(out ** 2).mean()` and every parameter's gradient are held against the
reference, in fp32 and (loss only) under bf16 AMP; the port's three remat
modes give the same gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.functional import amp_functional_call as jamp_call
from paddle_tpu.jit.functional import split_state as jsplit_state
from paddle_tpu.models.ernie import ErnieScanStack as JScanStack
import paddle_tpu_torch as pt
from paddle_tpu_torch.jit.functional import amp_functional_call, split_state
from paddle_tpu_torch.utils import load_numpy_state

H, HEADS, FFN, LAYERS = 256, 4, 512, 2
B, S = 2, 128
REMATS = [False, True, "dots"]


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _x(seed=0):
    return (np.random.default_rng(seed).standard_normal((B, S, H))
            .astype(np.float32) * 0.5)


def _pair(remat):
    paddle.seed(0)
    jm = JScanStack(H, HEADS, FFN, LAYERS, remat=remat)
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    tm = pt.models.ErnieScanStack(H, HEADS, FFN, LAYERS, remat=remat)
    load_numpy_state(tm, state)
    return jm, tm


def _jax_run(jm, x, amp=None):
    """(out, loss, {name: grad}) through the JAX stack, traced once."""
    names, params = zip(*((n, p._value) for n, p in
                          jsplit_state(jm)[0].items()))

    def loss_fn(ps, x):
        out = jamp_call(jm, list(names), ps, [], [], [x], amp)
        return (out.astype(jnp.float32) ** 2).mean(), out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        list(params), jnp.asarray(x))
    return (np.asarray(out.astype(jnp.float32)), float(loss),
            {n: np.asarray(g) for n, g in zip(names, grads)})


def _torch_run(tm, x, amp=None):
    trainable, _ = split_state(tm)
    names, ps = list(trainable), list(trainable.values())
    out = amp_functional_call(tm, names, ps, [], [], [torch.from_numpy(x)],
                              amp)
    loss = (out.float() ** 2).mean()
    grads = torch.autograd.grad(loss, ps)
    return (out.detach().float().numpy(), float(loss),
            {n: g.numpy() for n, g in zip(names, grads)})


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    return 1.0 if na == nb == 0 else float(a @ b / (na * nb))


def test_names_and_shapes_match_the_jax_stack():
    jm, tm = _pair(True)
    jshapes = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    tshapes = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert tshapes == jshapes
    assert tshapes["qkv_w"] == (LAYERS, H, 3 * H)
    assert tshapes["fc2_w"] == (LAYERS, FFN, H)
    # the reference's initialisation: U(-1/sqrt(h), 1/sqrt(h)) products,
    # zero biases, unit layer-norm gains
    w = tm.qkv_w.detach()
    assert float(w.abs().max()) <= 1 / np.sqrt(H)
    assert float(tm.fc1_b.abs().max()) == 0.0
    assert float(tm.ln2_g.min()) == float(tm.ln2_g.max()) == 1.0


@pytest.mark.parametrize("remat", REMATS)
def test_fp32_output_and_gradients_match_the_jax_stack(remat):
    jm, tm = _pair(remat)
    x = _x()
    jout, jloss, jgrads = _jax_run(jm, x)
    tout, tloss, tgrads = _torch_run(tm, x)
    # fp32 throughout; XLA and PyTorch sum in other orders, the Pallas
    # kernel and the plain version tile the softmax differently
    err = np.abs(tout - jout)
    assert (err <= 1e-4 * (1 + np.abs(jout))).all(), err.max()
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert sorted(tgrads) == sorted(jgrads)
    for n, g in tgrads.items():
        assert _cos(g, jgrads[n]) >= 0.9999, n


@pytest.mark.parametrize("remat", REMATS)
def test_bf16_amp_loss_matches_the_jax_stack(remat):
    jm, tm = _pair(remat)
    x = _x(1)
    _, jloss, _ = _jax_run(jm, x, "bfloat16")
    tout, tloss, tgrads = _torch_run(tm, x, "bfloat16")
    # bf16 carry, weights and products (2^-8 per rounding) through two
    # post-LN layers
    assert abs(tloss - jloss) <= 2e-2 * abs(jloss), (tloss, jloss)
    assert np.isfinite(tout).all()
    # the gradients reach the fp32 masters
    assert all(g.dtype == np.float32 for g in tgrads.values())


def test_remat_modes_give_the_same_gradients():
    x = _x(2)
    runs = [_torch_run(_pair(remat)[1], x) for remat in REMATS]
    base_out, base_loss, base_grads = runs[0]
    for out, loss, grads in runs[1:]:
        np.testing.assert_array_equal(out, base_out)
        assert loss == base_loss
        for n, g in grads.items():
            np.testing.assert_allclose(g, base_grads[n], rtol=0, atol=1e-6,
                                       err_msg=n)


def test_dots_saves_the_products_and_the_flash_output():
    """Under "dots" the backward recomputes no product and no attention:
    the operators that run inside backward() are elementwise only."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    counts = {}
    for remat in (True, "dots"):
        _, tm = _pair(remat)
        x = torch.from_numpy(_x())
        out = tm(x)
        with Ops() as ops:
            (out ** 2).mean().backward()
        counts[remat] = (sum("flash_fwd" in f for f in ops.seen),
                         sum(f.startswith("aten.mm") for f in ops.seen))
    # blanket remat: each layer's forward again (one attention, four
    # products) before its backward; dots: only the backward's own products
    assert counts[True][0] == LAYERS
    assert counts["dots"][0] == 0
    assert counts[True][1] - counts["dots"][1] == 4 * LAYERS


def test_invalid_remat_raises():
    with pytest.raises(Exception, match="remat"):
        pt.models.ErnieScanStack(H, HEADS, FFN, 1, remat="all")
