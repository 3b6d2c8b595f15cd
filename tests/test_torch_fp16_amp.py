"""fp16 AMP training through both packages: the slice's parity test.

A small `ErnieScanStack` (2 layers, hidden 128, 2 heads of 64, inputs 2 x
128) and a small sp ERNIE (`ErnieForPretraining` with `use_sp=True` over
four slots, 128 tokens per slot: the flash ring) take three steps of the
reference's loop in each package, from one JAX state dict carried across
by name:

    with amp.auto_cast(dtype="float16"):
        loss = ...
    scaler.scale(loss).backward()
    scaler.step(opt)
    scaler.update()

with `GradScaler` and AdamW. At the second step an inf is written into
one gradient in both, after the backward: both skip that step. The losses
agree within 1e-2 relative (fp16 activations and products through two
post-LN layers, 2^-11 per rounding, summed in other orders), the scalers'
states (scale, streak counters) step for step exactly, and the step
counts. The JAX side runs its Pallas kernels in interpret mode; the sp
ERNIE's gradients come from its forward under `jax.jit` (its Pallas ring
run op by op takes ~50 s a step on the CPU), fed to the reference's
scaler and optimizer as its tape would feed them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.jit.functional import functional_call as jfunctional_call
from paddle_tpu.jit.functional import split_state as jsplit_state
from paddle_tpu.models.ernie import ErnieScanStack as JScanStack
from paddle_tpu.parallel import topology as jtopo
import paddle_tpu_torch as pt
from paddle_tpu_torch.parallel import topology as ttopo
from paddle_tpu_torch.utils import load_numpy_state

STEPS, INF_STEP = 3, 1          # the second step gets an injected inf
LR, EPS = 1e-3, 1e-6


@pytest.fixture(autouse=True)
def _cpu_and_fresh_meshes():
    pt.set_device("cpu")
    saved = (jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0],
             ttopo._GLOBAL_MESH[0], ttopo._GLOBAL_HCG[0])
    yield
    (jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0],
     ttopo._GLOBAL_MESH[0], ttopo._GLOBAL_HCG[0]) = saved


def _load(jm, tm):
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    load_numpy_state(tm, state)


def _optimizers(jm, tm, scaler_kw):
    return (paddle.optimizer.AdamW(learning_rate=LR, epsilon=EPS,
                                   parameters=jm.parameters()),
            pt.optimizer.AdamW(learning_rate=LR, epsilon=EPS,
                               parameters=tm.parameters()),
            paddle.amp.GradScaler(**scaler_kw),
            pt.amp.GradScaler(**scaler_kw))


def _inject_inf(jm, tm):
    """An inf in the first element of one gradient, in both packages."""
    jp = next(p for p in jm.parameters() if p.grad is not None)
    g = np.array(jp.grad)
    g.flat[0] = np.inf
    jp.grad = jnp.asarray(g)
    tp = next(p for p in tm.parameters() if p.grad is not None)
    tp.grad.view(-1)[0] = float("inf")


def _torch_step(ts, loss_fn):
    with pt.amp.auto_cast(dtype="float16"):
        loss = loss_fn()
    ts.scale(loss).backward()
    return loss.detach()


def _finish(opt, scaler):
    scaler.step(opt)
    scaler.update()
    opt.clear_grad()


def _check_step(step, jloss, tloss, js, ts, jopt, topt):
    assert abs(tloss - jloss) <= 1e-2 * abs(jloss), (step, tloss, jloss)
    assert ts.state_dict() == js.state_dict(), step
    assert topt._step_count == jopt._step_count, step


def test_scan_stack_fp16_amp_steps_match_the_jax_stack():
    paddle.seed(0)
    jm = JScanStack(128, 2, 256, 2, remat="dots")
    tm = pt.models.ErnieScanStack(128, 2, 256, 2, remat="dots")
    _load(jm, tm)
    jopt, topt, js, ts = _optimizers(jm, tm, {})
    x = (np.random.default_rng(0).standard_normal((2, 128, 128))
         .astype(np.float32) * 0.5)
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    for step in range(STEPS):
        with paddle.amp.auto_cast(dtype="float16"):
            out = jm(jx)
            jloss = (out.astype("float32") ** 2).mean()
        js.scale(jloss).backward()
        tloss = _torch_step(ts, lambda: (tm(tx).float() ** 2).mean())
        if step == INF_STEP:
            _inject_inf(jm, tm)
            before = [p.detach().clone() for p in tm.parameters()]
        _finish(jopt, js)
        _finish(topt, ts)
        _check_step(step, float(jloss), float(tloss), js, ts, jopt, topt)
        if step == INF_STEP:        # skipped in both: no parameter moved
            assert all(torch.equal(p.detach(), b)
                       for p, b in zip(tm.parameters(), before))
    assert topt._step_count == STEPS - 1
    # the stack pins its carry and weights to fp16 (a layer below the AMP
    # white list), as the reference's does: the output is fp16 in both
    with pt.amp.auto_cast(dtype="float16"):
        assert tm(tx).dtype == torch.float16
    assert out.dtype == np.float16
    # the weights: two AdamW steps of lr 1e-3 from the same fp32 masters
    jstate = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), jstate[k], rtol=1e-3,
                                   atol=2e-3, err_msg=k)


CFG = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
           num_attention_heads=2, intermediate_size=256,
           hidden_dropout_prob=0.0)
B, S = 2, 512            # 128 tokens per slot over sp = 4: the flash ring


def test_sp_ernie_fp16_amp_steps_match_the_jax_model():
    jtopo.HybridCommunicateGroup(hybrid_configs={"sp_degree": 4})
    ttopo.HybridCommunicateGroup(hybrid_configs={"sp_degree": 4},
                                 devices=["cpu"] * 4)
    paddle.seed(0)
    jm = jmodels.ErnieForPretraining(jmodels.ErnieModel(**CFG, use_sp=True))
    tm = pt.models.ErnieForPretraining(pt.models.ErnieModel(**CFG,
                                                            use_sp=True))
    _load(jm, tm)
    # the fp16 MLM + NSP loss starts near 35: at the default 2^15 its
    # scaled value overflows fp16 at every step, in both packages alike;
    # 2^10 lets the steps through, and grows every 2 good updates
    jopt, topt, js, ts = _optimizers(
        jm, tm, dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2))
    jce, tce = jnn.CrossEntropyLoss(), pt.nn.CrossEntropyLoss()
    rng = np.random.default_rng(2)
    ids = rng.integers(0, CFG["vocab_size"], (B, S)).astype(np.int32)
    nsp = rng.integers(0, 2, (B,)).astype(np.int32)
    tids, tnsp = torch.from_numpy(ids).long(), torch.from_numpy(nsp).long()
    names, jparams = zip(*jsplit_state(jm)[0].items())

    def jscaled(ps, scale):
        with paddle.amp.auto_cast(dtype="float16"):
            logits, nl = jfunctional_call(jm, list(names), ps, [], [],
                                          jnp.asarray(ids))
            v = logits.shape[-1]
            loss = (jce(JTensor(logits).reshape([-1, v]),
                        JTensor(jnp.asarray(ids)).reshape([-1])) +
                    jce(JTensor(nl), JTensor(jnp.asarray(nsp))))._value
        return loss * scale.astype(loss.dtype), loss   # scaler.scale

    jgrad = jax.jit(jax.grad(jscaled, has_aux=True))

    def tloss_fn():
        logits, nl = tm(tids)
        v = logits.shape[-1]
        return tce(logits.reshape(-1, v), tids.reshape(-1)) + tce(nl, tnsp)

    for step in range(STEPS):
        grads, jloss = jgrad([p._value for p in jparams],
                             js._dev_scales()[0])
        for p, g in zip(jparams, grads):
            p.grad = g
        tloss = _torch_step(ts, tloss_fn)
        assert tloss.dtype == torch.float16
        if step == INF_STEP:
            _inject_inf(jm, tm)
            before = [p.detach().clone() for p in tm.parameters()]
        _finish(jopt, js)
        _finish(topt, ts)
        _check_step(step, float(jloss), float(tloss), js, ts, jopt, topt)
        if step == INF_STEP:
            assert all(torch.equal(p.detach(), b)
                       for p, b in zip(tm.parameters(), before))
    assert topt._step_count == STEPS - 1
    assert ts.get_loss_scaling() > 2.0 ** 10


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_layer_norm_of_an_amp_input_promotes_as_the_reference(dtype):
    # eager under auto_cast a LayerNorm sees an fp16 / bf16 activation and
    # its fp32 parameters: the reference normalises in the input's dtype
    # and promotes in the affine, so the output is fp32 in both
    import paddle_tpu.nn.functional as JF
    import paddle_tpu_torch.nn.functional as TF
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    w, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    jx = jnp.asarray(x, dtype)
    want = JF.layer_norm(paddle.to_tensor(jx), 64, paddle.to_tensor(w),
                         paddle.to_tensor(b))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = TF.layer_norm(tx, 64, torch.from_numpy(w), torch.from_numpy(b))
    assert str(want.dtype) == "float32" and got.dtype == torch.float32
    # the normalised input rounds to the input's dtype (2^-11, 2^-8
    # relative) before the fp32 affine, in both
    tol = 4e-3 if dtype == "float16" else 3e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=tol, atol=tol)
