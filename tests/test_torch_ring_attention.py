"""The port's ring-attention block kernels (plain versions, on the CPU)
against the JAX package's Pallas ring kernels run in interpret mode.

Same numpy inputs through `paddle_tpu.kernels.flash_attention.ring_block_*`
and `paddle_tpu_torch.kernels.ring_attention.ring_block_*`: hops in the
past, on the diagonal, in the future and off the tile grid, Sq != Sk,
causal both ways, in fp32 and bf16. Every case keeps at least one visible
key per q row (or none at all, the future hop): the reference's out for a
row that sees nothing depends on its block size, and the ring gives such
a row zero weight.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.flash_attention import (ring_block_dkv as jring_dkv,
                                              ring_block_dq as jring_dq,
                                              ring_block_fwd as jring_fwd)
from paddle_tpu_torch.kernels import ring_attention as tra

BH, D = 2, 64
# (Sq, Sk, (q_off, k_off), causal)
CASES = [(128, 128, (256, 0), True),      # past
         (128, 128, (128, 128), True),    # diagonal
         (128, 128, (0, 128), True),      # future: no key visible
         (128, 128, (96, 0), True),       # off the 64-row tile grid
         (128, 256, (128, 0), True),      # Sq != Sk, partly visible
         (128, 256, (0, 0), False),       # Sq != Sk, full
         (128, 128, (0, 128), False)]     # offsets ignored without causal
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(sq, sk, seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((BH, sq, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((BH, sk, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _jax_fwd(q, k, v, offs, causal, jdt):
    out, lse = jring_fwd(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(offs, jnp.int32), causal=causal, block_q=64, block_k=64,
        interpret=True)
    return np.array(out.astype(jnp.float32)), np.array(lse)


def _close(got, want, dtype, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    if dtype == "float32":
        # f32 products and sums in another order
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
    else:
        # bf16 inputs: the Pallas kernel rounds p and ds to bf16 before the
        # products and stores out in bf16; the plain version keeps f32
        err = np.abs(got - want)
        assert (err <= 2e-2 * (1 + np.abs(want))).all(), \
            f"{what}: max abs err {err.max()}"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_ring_block_fwd_matches_the_pallas_kernel(case, dtype):
    sq, sk, offs, causal = case
    jdt, tdt = DTYPES[dtype]
    q, k, v, _ = _inputs(sq, sk, sum(offs) + sq + sk)
    want_out, want_lse = _jax_fwd(q, k, v, offs, causal, jdt)
    out, lse = tra.ring_block_fwd(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), offs, causal)
    assert out.dtype == tdt and lse.dtype == torch.float32
    assert lse.shape == (BH, 1, sq)
    _close(out, want_out, dtype, "out")
    _close(lse, want_lse, dtype, "lse")
    if causal and offs == (0, 128):
        # a hop wholly in the future: exact zeros and -1e30 in both
        assert (want_out == 0).all() and (want_lse == -1e30).all()
        assert bool((out == 0).all()) and bool((lse == -1e30).all())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=str)
def test_ring_block_dq_dkv_match_the_pallas_kernels(case, dtype):
    sq, sk, offs, causal = case
    jdt, tdt = DTYPES[dtype]
    q, k, v, do = _inputs(sq, sk, sum(offs) + sq + sk + 1)
    out, lse = _jax_fwd(q, k, v, offs, causal, jdt)
    delta = (do * out).sum(-1)[:, None, :].astype(np.float32)
    jargs = [jnp.asarray(x, jdt) for x in (q, k, v, do)] + \
        [jnp.asarray(lse), jnp.asarray(delta), jnp.asarray(offs, jnp.int32)]
    kw = dict(causal=causal, block_q=64, block_k=64, interpret=True)
    want_dq = np.asarray(jring_dq(*jargs, **kw))
    want_dk, want_dv = (np.asarray(x) for x in jring_dkv(*jargs, **kw))
    targs = [torch.from_numpy(x).to(tdt) for x in (q, k, v, do)] + \
        [torch.from_numpy(lse), torch.from_numpy(delta), offs, causal]
    dq = tra.ring_block_dq(*targs)
    dk, dv = tra.ring_block_dkv(*targs)
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    assert dq.shape == (BH, sq, D) and dk.shape == dv.shape == (BH, sk, D)
    for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                            ("dv", dv, want_dv)):
        _close(got, want, dtype, name)
    if causal and offs == (0, 128):
        for x in (dq, dk, dv):
            assert bool((x == 0).all())


def test_offsets_are_host_ints_or_a_pair_tensor():
    q, k, v, _ = _inputs(128, 128, 0)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    a = tra.ring_block_fwd(tq, tk, tv, (96, 0), True)
    b = tra.ring_block_fwd(tq, tk, tv, torch.tensor([96, 0]), True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
