"""Port's flash-attention forward (`paddle_tpu_torch.kernels`) against the
JAX package's Pallas kernel, run in interpret mode on the CPU.

On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel itself is held against that plain version on a card by
tests/test_torch_kernels_cuda.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels.flash_attention import (
    _flash_fwd_bhsd, flash_attention_arrays as jax_flash_arrays)
from paddle_tpu_torch.kernels import flash_attention as tfa

# fp32 on both sides: the two differ only in summation order and in
# exp2-with-folded-scale (Pallas) vs exp (plain), a few f32 ulps
TOL = 2e-5


def _inputs(seed, *shape, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(dtype) for _ in range(3)]


# fp16 on both sides: the Pallas kernel runs its dots in fp16 and rounds
# p to fp16 before the PV product, the plain version computes in f32; both
# store out in fp16 (2^-11 relative). Held to max |err| <= 5e-3 (1 + |ref|)
TOL_FP16 = 5e-3


def _forward_pair(d, causal, dtype):
    q, k, v = _inputs(d + causal, 2, 256, d, dtype=dtype)
    j_out, j_lse = _flash_fwd_bhsd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=128, block_k=128, interpret=True)
    t_out, t_lse = tfa.flash_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal)
    assert t_lse.dtype == torch.float32 and t_lse.shape == (2, 1, 256)
    return (t_out, t_lse), (np.asarray(j_out), np.asarray(j_lse))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_matches_pallas_interpret(d, causal):
    (t_out, t_lse), (j_out, j_lse) = _forward_pair(d, causal, np.float32)
    assert t_out.dtype == torch.float32
    np.testing.assert_allclose(t_out.numpy(), j_out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t_lse.numpy(), j_lse, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_matches_pallas_interpret_in_fp16(d, causal):
    (t_out, t_lse), (j_out, j_lse) = _forward_pair(d, causal, np.float16)
    assert t_out.dtype == torch.float16 and j_out.dtype == np.float16
    for name, got, want in (("out", t_out, j_out), ("lse", t_lse, j_lse)):
        want = want.astype(np.float32)
        err = np.abs(got.float().numpy() - want)
        assert (err <= TOL_FP16 * (1 + np.abs(want))).all(), \
            f"{name}: max abs err {err.max()}"


@pytest.mark.parametrize("causal", [False, True])
def test_arrays_entry_matches_pallas_in_paddle_layout(causal):
    # [B, S, H, D] in, through the layout transforms of both packages
    q, k, v = _inputs(7, 2, 256, 2, 64)
    want = jax_flash_arrays(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, block_q=128, block_k=128)
    before = tfa.flash_attention_fwd.launches
    got = tfa.flash_attention_arrays(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal)
    assert tuple(got.shape) == (2, 256, 2, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert tfa.flash_attention_fwd.launches == before


def test_seq_len_mismatch_raises_like_the_reference():
    q, _, _ = _inputs(1, 1, 128, 1, 64)
    k, v, _ = _inputs(2, 1, 64, 1, 64)
    with pytest.raises(ValueError, match="share seq_len"):
        jax_flash_arrays(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    with pytest.raises(ValueError, match="share seq_len"):
        tfa.flash_attention_arrays(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v))


def test_mixed_dtypes_promote_at_the_boundary():
    q, k, v = _inputs(3, 1, 256, 2, 64)
    qb = jnp.asarray(q, dtype=jnp.bfloat16)
    want = jax_flash_arrays(qb, jnp.asarray(k), jnp.asarray(v), causal=True,
                            block_q=128, block_k=128)
    tq = torch.from_numpy(np.array(qb.astype(jnp.float32))).bfloat16()
    got = tfa.flash_attention_arrays(tq, torch.from_numpy(k),
                                     torch.from_numpy(v), causal=True)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_wrapper_refuses_devices_it_has_no_kernel_for():
    q = torch.empty(1, 128, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_attention_fwd(q, q, q)
