"""The port's ring-attention block kernels (plain versions, on the CPU)
against the JAX package's Pallas ring kernels run in interpret mode.

Same numpy inputs through `paddle_tpu.kernels.flash_attention.ring_block_*`
and `paddle_tpu_torch.kernels.ring_attention.ring_block_*`: hops in the
past, on the diagonal, in the future and off the tile grid, Sq != Sk,
causal both ways, in fp32, bf16 and fp16. Every case keeps at least one visible
key per q row (or none at all, the future hop): the reference's out for a
row that sees nothing depends on its block size, and the ring gives such
a row zero weight.
"""
import functools

import jax
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
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


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
        # bf16 / fp16 inputs: the Pallas kernel rounds p and ds to the
        # input dtype before the products and stores out in it (2^-8,
        # 2^-11 relative); the plain version keeps f32
        tol = 2e-2 if dtype == "bfloat16" else 5e-3
        err = np.abs(got - want)
        assert (err <= tol * (1 + np.abs(want))).all(), \
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


# ---- the ring steps: hops merged (forward) and summed (dk/dv) ---------------
# one slot's q (Sq = 128 at q_off = 96, off the 64-row tile grid) against
# k/v blocks of Sk = 192 at the k_off of each ring step: the first hop is
# partly visible (rows before key 192 see none of it), the second wholly in
# the future, the third in the past, the last on the diagonal
SQ, SK, Q_OFF = 128, 192, 96
HOPS = [192, 384, 0, 96]


def _hop_inputs(seed):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((BH, SQ, D)).astype(np.float32)
             for _ in range(2))
    kv = [(rng.standard_normal((BH, SK, D)).astype(np.float32),
           rng.standard_normal((BH, SK, D)).astype(np.float32))
          for _ in HOPS]
    return q, kv, do


def _jax_ring_fwd(q, kv, causal, jdt):
    # the reference's composition (paddle_tpu/parallel/sp.py:205-219): the
    # Pallas hop kernel, then the lse merge in f32
    o = jnp.zeros((BH, SQ, D), jnp.float32)
    lse = jnp.full((BH, 1, SQ), -1e30, jnp.float32)
    for (k, v), k_off in zip(kv, HOPS):
        o_b, lse_b = jring_fwd(
            jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
            jnp.asarray((Q_OFF, k_off), jnp.int32), causal=causal,
            block_q=64, block_k=64, interpret=True)
        lse_new = jnp.logaddexp(lse, lse_b)
        o = o * jnp.swapaxes(jnp.exp(lse - lse_new), 1, 2) + \
            o_b.astype(jnp.float32) * jnp.swapaxes(jnp.exp(lse_b - lse_new),
                                                   1, 2)
        lse = lse_new
    return np.array(o.astype(jdt).astype(jnp.float32)), np.array(lse)


def _torch_ring_fwd(q, kv, causal, tdt):
    tq = torch.from_numpy(q).to(tdt)
    o = [torch.empty(BH, SQ, D)]
    lse = [torch.empty(BH, 1, SQ)]
    for step, ((k, v), k_off) in enumerate(zip(kv, HOPS)):
        out = tra.ring_fwd_step_plain(
            [tq], [torch.from_numpy(k).to(tdt)],
            [torch.from_numpy(v).to(tdt)], [(Q_OFF, k_off)], o, lse, causal,
            first=step == 0, last=step == len(HOPS) - 1)
    return out[0], lse[0]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_ring_fwd_step_matches_the_pallas_hops_and_merge(causal, dtype):
    jdt, tdt = DTYPES[dtype]
    q, kv, _ = _hop_inputs(7)
    want_out, want_lse = _jax_ring_fwd(q, kv, causal, jdt)
    out, lse = _torch_ring_fwd(q, kv, causal, tdt)
    assert out.dtype == tdt and out.shape == (BH, SQ, D)
    _close(out, want_out, dtype, "out")
    _close(lse, want_lse, dtype, "lse")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_ring_dkv_step_matches_the_sum_of_the_pallas_hops(causal, dtype):
    jdt, tdt = DTYPES[dtype]
    q, kv, do = _hop_inputs(8)
    out, lse = _jax_ring_fwd(q, kv, causal, jdt)
    delta = (do * out).sum(-1)[:, None, :].astype(np.float32)
    tq, tdo = (torch.from_numpy(x).to(tdt) for x in (q, do))
    tlse, tdelta = torch.from_numpy(lse), torch.from_numpy(delta)
    # one key block held through every hop, as a rotating accumulator sees
    # its own block against each slot's q: here the same q at each offset
    k, v = kv[0]
    want_dk = want_dv = 0.0
    dk, dv = [torch.empty(BH, SK, D)], [torch.empty(BH, SK, D)]
    for step, k_off in enumerate(HOPS):
        jdk, jdv = jring_dkv(
            *(jnp.asarray(x, jdt) for x in (q, k, v, do)), jnp.asarray(lse),
            jnp.asarray(delta), jnp.asarray((Q_OFF, k_off), jnp.int32),
            causal=causal, block_q=64, block_k=64, interpret=True)
        want_dk, want_dv = want_dk + np.asarray(jdk), want_dv + np.asarray(jdv)
        tra.ring_dkv_step_plain(
            [tq], [torch.from_numpy(k).to(tdt)], [torch.from_numpy(v).to(tdt)],
            [tdo], [tlse], [tdelta], [(Q_OFF, k_off)], dk, dv, causal,
            first=step == 0)
    _close(dk[0], want_dk, dtype, "dk")
    _close(dv[0], want_dv, dtype, "dv")


def _four_slots(seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dtype)
    qs, dos = ([t(BH, SQ, D) for _ in range(4)] for _ in range(2))
    ks, vs = ([t(BH, SK, D) for _ in range(4)] for _ in range(2))
    offs = [(Q_OFF + 128 * i, k_off) for i, k_off in enumerate(HOPS)]
    return qs, ks, vs, dos, offs


@pytest.mark.parametrize("first,last", [(True, False), (False, False),
                                        (False, True), (True, True)])
def test_a_group_of_four_slots_is_four_groups_of_one(first, last):
    qs, ks, vs, dos, offs = _four_slots(9)
    rng = np.random.default_rng(10)
    o0 = [torch.from_numpy(rng.standard_normal((BH, SQ, D))
                           .astype(np.float32)) for _ in range(4)]
    l0 = [torch.from_numpy(rng.standard_normal((BH, 1, SQ))
                           .astype(np.float32)) for _ in range(4)]
    o1, l1 = [x.clone() for x in o0], [x.clone() for x in l0]
    got = tra.ring_fwd_step(qs, ks, vs, offs, o0, l0, True, first, last)
    want = [tra.ring_fwd_step([qs[i]], [ks[i]], [vs[i]], [offs[i]],
                              [o1[i]], [l1[i]], True, first, last)
            for i in range(4)]
    for a, b in zip(o0 + l0, o1 + l1):
        assert torch.equal(a, b)
    if last:
        for a, (b,) in zip(got, want):
            assert torch.equal(a, b)
    lse = l0
    delta = [torch.from_numpy(rng.standard_normal((BH, 1, SQ))
                              .astype(np.float32)) for _ in range(4)]
    dk0 = [torch.from_numpy(rng.standard_normal((BH, SK, D))
                            .astype(np.float32)) for _ in range(4)]
    dv0 = [x * 2 for x in dk0]
    dk1, dv1 = [x.clone() for x in dk0], [x.clone() for x in dv0]
    tra.ring_dkv_step(qs, ks, vs, dos, lse, delta, offs, dk0, dv0, True,
                      first)
    for i in range(4):
        tra.ring_dkv_step([qs[i]], [ks[i]], [vs[i]], [dos[i]], [lse[i]],
                          [delta[i]], [offs[i]], [dk1[i]], [dv1[i]], True,
                          first)
    for a, b in zip(dk0 + dv0, dk1 + dv1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_first_is_the_merge_into_empty_accumulators(dtype):
    # forward: `first` on garbage equals the merge into (0, -1e30); dk/dv:
    # `first` on garbage equals the sum into zeros
    tdt = DTYPES[dtype][1]
    qs, ks, vs, dos, offs = _four_slots(11, tdt)
    garbage = [torch.full((BH, SQ, D), float("nan")) for _ in range(4)]
    glse = [torch.full((BH, 1, SQ), 3.0) for _ in range(4)]
    zeros = [torch.zeros(BH, SQ, D) for _ in range(4)]
    empty = [torch.full((BH, 1, SQ), -1e30) for _ in range(4)]
    tra.ring_fwd_step(qs, ks, vs, offs, garbage, glse, True, first=True)
    tra.ring_fwd_step(qs, ks, vs, offs, zeros, empty, True)
    for a, b in zip(garbage + glse, zeros + empty):
        assert torch.equal(a, b)
    # the wholly future slot (offs[1]) is the merge's identity
    assert bool((zeros[1] == 0).all()) and bool((empty[1] == -1e30).all())
    delta = [torch.ones(BH, 1, SQ) for _ in range(4)]
    dk = [torch.full((BH, SK, D), float("nan")) for _ in range(4)]
    dv = [torch.full((BH, SK, D), float("nan")) for _ in range(4)]
    dk0, dv0 = ([torch.zeros(BH, SK, D) for _ in range(4)] for _ in range(2))
    tra.ring_dkv_step(qs, ks, vs, dos, empty, delta, offs, dk, dv, True,
                      first=True)
    tra.ring_dkv_step(qs, ks, vs, dos, empty, delta, offs, dk0, dv0, True)
    for a, b in zip(dk + dv, dk0 + dv0):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bwd_prep_delta_matches_the_reference_ring(dtype):
    # delta as `_ring_flash_bwd_rule` computes it (paddle_tpu/parallel/
    # sp.py:248), and the zeroed dq accumulator
    from paddle_tpu_torch.kernels.flash_attention import flash_bwd_prep
    jdt, tdt = DTYPES[dtype]
    q, _, do = _hop_inputs(12)
    want = jnp.sum(jnp.asarray(do, jdt).astype(jnp.float32) *
                   jnp.asarray(q, jdt).astype(jnp.float32), axis=-1)
    delta, dq = flash_bwd_prep(torch.from_numpy(do).to(tdt),
                               torch.from_numpy(q).to(tdt), workspace=True)
    assert delta.dtype == dq.dtype == torch.float32
    # f32 sums of D products in another order
    np.testing.assert_allclose(delta.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert dq.shape == (BH, SQ, D) and bool((dq == 0).all())


# ---- the dq step: a 4-slot ring's hops added into the accumulators ---------
# four slots of S_LOC = 96 rows: slot i holds q rows from 96 i, off the
# kernels' 64-row tile grid, and at ring step `step` the key block of slot
# (i - step) mod 4. The accumulators start non-zero, as a dq step finds
# them after earlier hops.
S_LOC, N_SLOTS = 96, 4


def _ring_slots(seed):
    """Per-slot q, k, v, dO [BH, S_LOC, D] and the global lse and delta
    rows [BH, 1, S_LOC] of attention over the whole sequence, in float64
    (p = exp(s - lse) as the ring's backward gives it)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((BH, N_SLOTS * S_LOC, D))
                   for _ in range(4))
    return q, k, v, do


def _global_rows(q, k, v, do, causal):
    s = q @ np.swapaxes(k, 1, 2) / np.sqrt(D)
    if causal:
        n = s.shape[-1]
        s = np.where(np.tril(np.ones((n, n), bool)), s, -np.inf)
    lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    out = np.exp(s - lse[..., None]) @ v
    return lse[:, None, :], (do * out).sum(-1)[:, None, :]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_ring_dq_step_adds_the_pallas_hops_into_the_accumulators(causal,
                                                                 dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v, do = _ring_slots(13)
    lse, delta = (x.astype(np.float32) for x in _global_rows(q, k, v, do,
                                                               causal))

    def slot(x, i):
        return x[..., i * S_LOC:(i + 1) * S_LOC, :].astype(np.float32)

    def rows(x, i):
        return x[..., i * S_LOC:(i + 1) * S_LOC]
    acc0 = np.random.default_rng(14).standard_normal(
        (N_SLOTS, BH, S_LOC, D)).astype(np.float32)
    want = acc0.astype(np.float64)
    dqs = [torch.from_numpy(x.copy()) for x in acc0]
    tq, tdo = ([torch.from_numpy(slot(x, i)).to(tdt) for i in range(N_SLOTS)]
               for x in (q, do))
    tk, tv = ([torch.from_numpy(slot(x, i)).to(tdt) for i in range(N_SLOTS)]
              for x in (k, v))
    tlse, tdelta = ([torch.from_numpy(np.ascontiguousarray(rows(x, i)))
                     for i in range(N_SLOTS)] for x in (lse, delta))
    # one trace for the 16 hops: the offsets are traced values
    hop_dq = jax.jit(functools.partial(jring_dq, causal=causal, block_q=32,
                                       block_k=32, interpret=True))
    for step in range(N_SLOTS):
        blocks = [(i - step) % N_SLOTS for i in range(N_SLOTS)]
        offs = [(i * S_LOC, b * S_LOC) for i, b in enumerate(blocks)]
        for i, b in enumerate(blocks):
            want[i] += np.asarray(hop_dq(
                *(jnp.asarray(slot(x, j), jdt)
                  for x, j in ((q, i), (k, b), (v, b), (do, i))),
                jnp.asarray(rows(lse, i)), jnp.asarray(rows(delta, i)),
                jnp.asarray(offs[i], jnp.int32)))
        tra.ring_dq_step_plain(tq, [tk[b] for b in blocks],
                               [tv[b] for b in blocks], tdo, tlse, tdelta,
                               offs, dqs, causal)
    for i in range(N_SLOTS):
        assert dqs[i].dtype == torch.float32
        _close(dqs[i], want[i], dtype, f"dq[{i}]")


def test_ring_dq_step_is_the_sum_of_ring_block_dq():
    # the step over four slots adds exactly what four one-hop calls return
    qs, ks, vs, dos, offs = _four_slots(15)
    rng = np.random.default_rng(16)
    lse = [torch.from_numpy(rng.standard_normal((BH, 1, SQ))
                            .astype(np.float32)) + 5.0 for _ in range(4)]
    delta = [torch.from_numpy(rng.standard_normal((BH, 1, SQ))
                              .astype(np.float32)) for _ in range(4)]
    acc = [torch.from_numpy(rng.standard_normal((BH, SQ, D))
                            .astype(np.float32)) for _ in range(4)]
    got = [x.clone() for x in acc]
    tra.ring_dq_step(qs, ks, vs, dos, lse, delta, offs, got, True)
    for i in range(4):
        hop = tra.ring_block_dq(qs[i], ks[i], vs[i], dos[i], lse[i],
                                delta[i], offs[i], True)
        assert torch.equal(got[i], acc[i] + hop)
    # the wholly future slot (offs[1]) adds exact zeros
    assert torch.equal(got[1], acc[1])
