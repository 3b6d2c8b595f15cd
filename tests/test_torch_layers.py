"""Port's layers (`paddle_tpu_torch.nn`) against the JAX package in fp32,
with weights carried across by name, plus the attention dispatch rule."""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional.attention as jattn
from paddle_tpu.core.tensor import Tensor as JTensor
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.nn.functional.attention import (
    _flash_eligible, scaled_dot_product_attention as t_sdpa)
from paddle_tpu_torch.utils import load_numpy_state

# fp32 on both sides; XLA and PyTorch sum in different orders
TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _state(jlayer):
    return {k: np.asarray(v._value) for k, v in jlayer.state_dict().items()}


def _pair(jlayer, tlayer):
    load_numpy_state(tlayer, _state(jlayer))
    jlayer.eval()
    tlayer.eval()
    return jlayer, tlayer


def _run(jlayer, tlayer, x):
    want = jlayer(paddle.to_tensor(x)).numpy()
    with torch.inference_mode():
        got = tlayer(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    j, t = _pair(jnn.Linear(24, 40, bias_attr=None if bias else False),
                 tnn.Linear(24, 40, bias_attr=None if bias else False))
    assert tuple(t.weight.shape) == (24, 40)       # paddle layout [in, out]
    x = np.random.RandomState(0).randn(3, 5, 24).astype(np.float32)
    np.testing.assert_allclose(*_run(j, t, x), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("padding_idx", [None, 3])
def test_embedding(padding_idx):
    j, t = _pair(jnn.Embedding(50, 16, padding_idx=padding_idx),
                 tnn.Embedding(50, 16, padding_idx=padding_idx))
    ids = np.random.RandomState(1).randint(0, 50, (4, 9)).astype(np.int32)
    ids[0, 0] = 3
    np.testing.assert_allclose(*_run(j, t, ids), rtol=TOL, atol=TOL)


def test_layer_norm():
    j, t = _pair(jnn.LayerNorm(32), tnn.LayerNorm(32))
    rng = np.random.RandomState(2)
    # a non-trivial affine on both sides
    w, b = rng.randn(32).astype(np.float32), rng.randn(32).astype(np.float32)
    j.set_state_dict({"weight": w, "bias": b})
    t.set_state_dict({"weight": w, "bias": b})
    x = (rng.randn(2, 7, 32) * 3 + 1).astype(np.float32)
    np.testing.assert_allclose(*_run(j, t, x), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu(approximate):
    x = np.linspace(-6, 6, 301, dtype=np.float32).reshape(7, 43)
    got, want = _run(jnn.GELU(approximate), tnn.GELU(approximate), x)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mask", [None, "bool", "additive"])
@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_einsum_path(mask, causal):
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 96, 3, 64).astype(np.float32) for _ in range(3))
    m = None
    if mask == "bool":
        m = rng.rand(2, 1, 96, 96) > 0.3
        m[..., 0] = True                       # every row sees one key
    elif mask == "additive":
        m = (rng.randn(2, 3, 96, 96) * 2).astype(np.float32)
    want = jattn.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        attn_mask=None if m is None else paddle.to_tensor(m),
        is_causal=causal, training=False).numpy()
    got = t_sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                 attn_mask=None if m is None else torch.from_numpy(m),
                 is_causal=causal, training=False).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mask", [None, "bool"])
@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_einsum_path_in_fp16(mask, causal):
    # fp16 takes the einsum path (the kernels are bf16 and fp32): the masked
    # logits are -1e9 in fp16, which is -inf, as in the reference
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(2, 96, 3, 64).astype(np.float16) for _ in range(3))
    m = None
    if mask == "bool":
        m = rng.rand(2, 1, 96, 96) > 0.3
        m[..., 0] = True                       # every row sees one key
    want = jattn.scaled_dot_product_attention(
        JTensor(jnp.asarray(q)), JTensor(jnp.asarray(k)),
        JTensor(jnp.asarray(v)),
        attn_mask=None if m is None else paddle.to_tensor(m),
        is_causal=causal, training=False).numpy()
    got = t_sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                 attn_mask=None if m is None else torch.from_numpy(m),
                 is_causal=causal, training=False)
    assert want.dtype == np.float16 and got.dtype == torch.float16
    # fp16 logits, probabilities and products in both, summed in another
    # order (2^-11 relative at |x| < 4)
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=5e-3, atol=5e-3)


def test_sdpa_einsum_path_promotes_mixed_dtypes():
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(1, 64, 2, 64).astype(np.float32) for _ in range(3))
    qb = jnp.asarray(q, jnp.bfloat16)
    want = jattn.scaled_dot_product_attention(
        JTensor(qb), paddle.to_tensor(k), paddle.to_tensor(v),
        is_causal=True, training=False).numpy()
    tq = torch.from_numpy(np.array(qb.astype(jnp.float32))).bfloat16()
    got = t_sdpa(tq, torch.from_numpy(k), torch.from_numpy(v),
                 is_causal=True, training=False)
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


class _FakeTpu:
    platform = "tpu"


class _TookFlash(Exception):
    pass


_DISPATCH_CASES = [
    # (q dtype, k/v dtype, S_q, S_kv, head_dim, mask, dropout)
    ("bfloat16", "bfloat16", 1024, 1024, 64, False, 0.0),
    ("bfloat16", "bfloat16", 1023, 1023, 64, False, 0.0),
    ("bfloat16", "bfloat16", 2048, 2048, 128, False, 0.0),
    ("bfloat16", "bfloat16", 1024, 1024, 256, False, 0.0),
    ("bfloat16", "bfloat16", 1024, 1024, 32, False, 0.0),
    ("bfloat16", "bfloat16", 1024, 1024, 96, False, 0.0),
    ("bfloat16", "bfloat16", 1024, 1024, 64, True, 0.0),
    ("bfloat16", "bfloat16", 1024, 1024, 64, False, 0.1),
    ("bfloat16", "bfloat16", 1024, 2048, 64, False, 0.0),
    ("float32", "float32", 1024, 1024, 64, False, 0.0),
    ("float32", "float32", 4095, 4095, 64, False, 0.0),
    ("float32", "float32", 4096, 4096, 64, False, 0.0),
    ("bfloat16", "float32", 1024, 1024, 64, False, 0.0),
    ("bfloat16", "float32", 4096, 4096, 64, False, 0.0),
]


def _jax_takes_flash(monkeypatch, qd, kd, sq, skv, d, mask, dropout):
    """Ask the JAX package itself, with a TPU faked in and both of its
    routes stubbed out, which route it picks."""
    # the module, not the function of the same name that
    # paddle_tpu.kernels re-exports
    jfa_mod = importlib.import_module("paddle_tpu.kernels.flash_attention")

    def flash(*a, **kw):
        raise _TookFlash()

    monkeypatch.setattr(jax, "devices", lambda *a, **kw: [_FakeTpu()])
    monkeypatch.setattr(jfa_mod, "flash_attention", flash)
    monkeypatch.setattr(jattn, "run_op", lambda *a, **kw: "einsum")
    q = JTensor(jnp.zeros((1, sq, 1, d), qd))
    k = JTensor(jnp.zeros((1, skv, 1, d), kd))
    m = JTensor(jnp.ones((1, 1, sq, skv), bool)) if mask else None
    try:
        route = jattn.scaled_dot_product_attention(q, k, k, attn_mask=m,
                                                   dropout_p=dropout)
    except _TookFlash:
        return True
    assert route == "einsum"
    return False


@pytest.mark.parametrize("case", _DISPATCH_CASES)
def test_dispatch_picks_the_kernel_on_exactly_the_jax_conditions(
        monkeypatch, case):
    qd, kd, sq, skv, d, mask, dropout = case
    want = _jax_takes_flash(monkeypatch, *case)
    q = torch.empty((1, sq, 1, d), dtype=getattr(torch, qd), device="meta")
    k = torch.empty((1, skv, 1, d), dtype=getattr(torch, kd), device="meta")
    m = torch.ones((1, 1, sq, skv), dtype=torch.bool, device="meta") \
        if mask else None
    assert _flash_eligible(q, k, k, m, dropout) == want


def test_dispatch_needs_a_cuda_tensor():
    # an eligible CPU call takes the einsum path (no kernel on the CPU)
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(1, 1024, 1, 64).astype(np.float32))
    q = q.bfloat16()
    assert _flash_eligible(q, q, q)
    import paddle_tpu_torch.kernels.flash_attention as tfa
    before = tfa.flash_attention_fwd.launches
    out = t_sdpa(q, q, q, is_causal=True)
    assert out.shape == q.shape and tfa.flash_attention_fwd.launches == before
