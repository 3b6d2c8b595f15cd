"""Port's flash-attention backward (`paddle_tpu_torch.kernels`) against the
JAX package's Pallas backward kernels, run in interpret mode on the CPU.

On the CPU the port's wrappers take the plain PyTorch backward; the CUDA
kernels themselves are held against it on a card by
tests/test_torch_kernels_cuda.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.flash_attention import (
    _flash_bwd_bhsd, _flash_bwd_fused_bhsd, _flash_fwd_bhsd,
    flash_attention_arrays as jax_flash_arrays)
from paddle_tpu_torch.kernels import flash_attention as tfa

# fp32 on both sides: the two differ in summation order and in
# exp2-with-folded-scale (Pallas) vs exp (plain), a few f32 ulps of
# gradients of magnitude ~1
TOL = 2e-5


def _arrays(seed, *shape, n=4):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# fp16 on both sides: the Pallas kernels round p and ds to fp16 before
# their products and store fp16 gradients (2^-11 relative), the plain
# version computes in f32 and rounds once. Held to max |err| <= 5e-3
# (1 + |ref|)
TOL_FP16 = 5e-3


def _backward_pair(form, d, causal, dtype):
    q, k, v, g = (x.astype(dtype) for x in _arrays(d + causal, 2, 256, d))
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    out, lse = _flash_fwd_bhsd(jq, jk, jv, causal=causal, block_q=128,
                               block_k=128, interpret=True)
    bwd = _flash_bwd_fused_bhsd if form == "fused" else _flash_bwd_bhsd
    want = bwd(jq, jk, jv, out, lse, jg, causal=causal, block_q=128,
               block_k=128, interpret=True)
    got = tfa.flash_attention_bwd_plain(
        *_t(q, k, v, np.asarray(out), np.asarray(lse), g), causal=causal)
    for a in got:
        assert a.shape == (2, 256, d)
    return got, [np.asarray(b) for b in want]


@pytest.mark.parametrize("form", ["fused", "two_pass"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_pallas_interpret(form, d, causal):
    got, want = _backward_pair(form, d, causal, np.float32)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("form", ["fused", "two_pass"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_pallas_interpret_in_fp16(form, d, causal):
    got, want = _backward_pair(form, d, causal, np.float16)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float16 and b.dtype == np.float16
        b = b.astype(np.float32)
        err = np.abs(a.float().numpy() - b)
        assert (err <= TOL_FP16 * (1 + np.abs(b))).all(), \
            f"{name}: max abs err {err.max()}"


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_matches_jax_grad(causal):
    # [B, S, H, D] through both packages' layout transforms; the JAX side
    # is the custom_vjp `_flash_core` (Pallas kernels, interpret mode)
    q, k, v, w = _arrays(11 + causal, 2, 256, 2, 64)

    def loss(a, b, c):
        out = jax_flash_arrays(a, b, c, causal=causal, block_q=128,
                               block_k=128)
        return jnp.sum(out * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                               for x in (q, k, v)))
    tq, tk, tv = (x.requires_grad_() for x in _t(q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal)
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    for name, a, b in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_fused_and_two_pass_selections_agree():
    q, k, v, g = _arrays(5, 2, 192, 64)
    tq, tk, tv, tg = _t(q, k, v, g)
    out, lse = tfa.flash_attention_fwd(tq, tk, tv, True)
    counts = [f.launches for f in (tfa.flash_attention_bwd_fused,
                                   tfa.flash_attention_bwd_dq,
                                   tfa.flash_attention_bwd_dkv)]
    fused = tfa.flash_attention_bwd(tq, tk, tv, out, lse, tg, True)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        two_pass = tfa.flash_attention_bwd(tq, tk, tv, out, lse, tg, True)
    finally:
        torch.use_deterministic_algorithms(prev)
    for a, b in zip(fused, two_pass):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    explicit = tfa.flash_attention_bwd_two_pass(tq, tk, tv, out, lse, tg,
                                                True)
    for a, b in zip(fused, explicit):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # CPU tensors take the plain version: no kernel launch is counted
    assert counts == [f.launches for f in (tfa.flash_attention_bwd_fused,
                                           tfa.flash_attention_bwd_dq,
                                           tfa.flash_attention_bwd_dkv)]


def test_plain_backward_is_the_gradient_of_attention():
    # independent of both packages' kernels: float64 autograd through
    # softmax(q k^T / sqrt(D)) v, ragged length and causal mask
    q, k, v, g = (torch.from_numpy(a).double()
                  for a in _arrays(3, 2, 100, 64))
    for x in (q, k, v):
        x.requires_grad_()
    s = q @ k.transpose(-1, -2) / 8.0
    s = s.masked_fill(~torch.ones(100, 100, dtype=torch.bool).tril(), -1e30)
    torch.autograd.backward(torch.softmax(s, -1) @ v, g)
    f = [x.detach().float() for x in (q, k, v)]
    out, lse = tfa.flash_attention_fwd_plain(*f, causal=True)
    got = tfa.flash_attention_bwd_plain(*f, out, lse, g.float(), causal=True)
    for a, b in zip(got, (q, k, v)):
        np.testing.assert_allclose(a.numpy(), b.grad.numpy(), rtol=TOL,
                                   atol=TOL)


def test_backward_wrappers_refuse_devices_they_have_no_kernel_for():
    q = torch.empty(1, 128, 64, device="meta")
    lse = torch.empty(1, 1, 128, device="meta")
    for fn in (tfa.flash_attention_bwd_fused, tfa.flash_attention_bwd_dq,
               tfa.flash_attention_bwd_dkv):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(q, q, q, q, lse, q)
