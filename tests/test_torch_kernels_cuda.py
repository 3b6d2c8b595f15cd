"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without a CUDA device (the
kernels have no CPU mode). The bf16 and fp16 kernels at D 64 and 128 are
the wgmma/TMA designs: besides the shapes of the main paths they are held
at the edges of their tiles (ragged S inside a TMA box at a head boundary,
S below one tile, BH = 1, D = 128, non-causal), in both element types.
This file imports neither jax nor the JAX package, so it also runs on a
machine that has only torch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import ring_attention as tra
from paddle_tpu_torch.parallel import sp as tsp

# the counted ring wrappers: the forward, dq and dk/dv step kernels (also
# behind the one-hop ring_block_fwd / ring_block_dq / ring_block_dkv)
RING_WRAPPERS = (tra.ring_fwd_step, tra.ring_dq_step, tra.ring_dkv_step)


# tolerances against the plain versions (f32 throughout), as max |got -
# want| <= tol (1 + |want|): bf16 rounds p and ds to bf16 before the
# products (as the Pallas kernels do) and stores bf16 (2^-8 relative);
# fp16 does the same at 2^-11, held to 5e-3 forward and 1e-2 for the
# gradients; fp32 sums in another order
FWD_TOL = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 1e-4}
GRAD_TOL = {torch.bfloat16: 2e-2, torch.float16: 1e-2, torch.float32: 1e-4}


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,s,causal", [
    (torch.bfloat16, 64, 1024, True), (torch.bfloat16, 128, 1000, True),
    (torch.bfloat16, 256, 512, False), (torch.bfloat16, 64, 17, True),
    (torch.float32, 64, 300, True), (torch.float32, 256, 129, False),
    (torch.float16, 64, 1024, True), (torch.float16, 128, 1000, True),
    (torch.float16, 256, 512, False), (torch.float16, 64, 17, True),
    (torch.float16, 64, 2048, False)])
def test_flash_fwd_matches_plain(cuda_device, dtype, d, s, causal):
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(6, s, d, generator=gen, device=cuda_device)
               .to(dtype) for _ in range(3))
    before = tfa.flash_attention_fwd.launches
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    ref_out, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, causal)
    # FWD_TOL for out; lse is f32
    tol = FWD_TOL[dtype]
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_paddle_layout_entry_on_fused_qkv_slices(cuda_device):
    # q/k/v as the model gives them: strided slices of one QKV tensor
    gen = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn(2, 1024, 3, 12, 64, generator=gen,
                      device=cuda_device).bfloat16()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = tfa.flash_attention_arrays(q, k, v, causal=True)
    want = tfa.flash_attention_arrays(q.cpu(), k.cpu(), v.cpu(), causal=True)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    q = torch.zeros(2, 64, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_fwd(q, q, q)
    q = torch.zeros(2, 64, 64, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="bf16 or fp16"):
        tfa.flash_attention_fwd(q, q, q)
    q = torch.zeros(2, 64, 128, device=cuda_device,
                    dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_fwd(q, q, q)


# the backward kernels at the shapes chip_smoke.py holds them at:
# (B, S, H, D, dtype, causal)
BWD_SHAPES = [(8, 1024, 12, 64, torch.bfloat16, True),
              (8, 1024, 6, 128, torch.bfloat16, True),
              (8, 1024, 3, 256, torch.bfloat16, True),
              (1, 4096, 12, 64, torch.float32, False),
              (8, 1000, 12, 64, torch.bfloat16, True),
              (8, 1024, 12, 64, torch.float16, True),
              (8, 1024, 6, 128, torch.float16, True),
              (8, 1024, 3, 256, torch.float16, True),
              (8, 1000, 12, 64, torch.float16, True),
              (2, 2048, 64, 64, torch.float16, False)]


def _bwd_inputs(b, s, h, d, dtype, causal):
    gen = torch.Generator(device="cuda").manual_seed(s + d)
    q, k, v, do = (torch.randn(b * h, s, d, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    return q, k, v, out, lse, do


def _bwd_tol(dtype):
    # bf16: the kernels round p and ds to bf16 before the products (as the
    # Pallas kernels do) and store bf16 gradients of magnitude <~8; the
    # plain version keeps f32. fp16: the same at 2^-11, GRAD_TOL. fp32:
    # sums in another order.
    if dtype == torch.bfloat16:
        return 6e-2, 2e-2
    return GRAD_TOL[dtype], GRAD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=str)
def test_flash_bwd_kernels_match_plain(cuda_device, shape):
    *dims, dtype, causal = shape
    args = _bwd_inputs(*dims, dtype, causal)
    counts = [f.launches for f in (tfa.flash_attention_bwd_fused,
                                   tfa.flash_attention_bwd_dq,
                                   tfa.flash_attention_bwd_dkv)]
    fused = tfa.flash_attention_bwd_fused(*args, causal)
    two_pass = tfa.flash_attention_bwd_two_pass(*args, causal)
    torch.cuda.synchronize()
    assert [f.launches for f in (tfa.flash_attention_bwd_fused,
                                 tfa.flash_attention_bwd_dq,
                                 tfa.flash_attention_bwd_dkv)] == \
        [c + 1 for c in counts]
    ref = tfa.flash_attention_bwd_plain(*args, causal)
    atol, rtol = _bwd_tol(dtype)
    for got in (fused, two_pass):
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            assert g.dtype == dtype and bool(torch.isfinite(g).all()), name
            torch.testing.assert_close(g.float(), r.float(), atol=atol,
                                       rtol=rtol, msg=name)


# the wgmma/TMA kernels (bf16, D 64 and 128) at the edges of their tiles:
# (BH, S, D, causal). S = 1000 and 100 end inside a TMA box at a head
# boundary (the next head's rows must read as zeros), 50 and 100 are
# shorter than one tile, BH = 1, non-causal
WGMMA_CASES = [(2, 1000, 64, True), (3, 100, 64, False), (2, 100, 128, True),
               (1, 1024, 64, True), (1, 50, 128, False),
               (4, 1000, 128, False), (5, 300, 64, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", WGMMA_CASES, ids=str)
def test_wgmma_kernels_match_plain_at_tile_edges(cuda_device, case, dtype):
    bh, s, d, causal = case
    gen = torch.Generator(device="cuda").manual_seed(bh * s + d)
    q, k, v, do = (torch.randn(bh, s, d, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    args = (q, k, v, out, lse, do, causal)
    fused = tfa.flash_attention_bwd_fused(*args)
    dq = tfa.flash_attention_bwd_dq(*args)
    dk, dv = tfa.flash_attention_bwd_dkv(*args)
    delta, workspace = tfa._bwd_inputs("prep", q, k, v, out, lse, do,
                                       workspace=True)
    torch.cuda.synchronize()
    ref_out, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, causal)
    tol = FWD_TOL[dtype]
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-3, atol=1e-3)
    ref = tfa.flash_attention_bwd_plain(*args)
    atol, rtol = _bwd_tol(dtype)
    for name, g, r in zip(("dq", "dk", "dv"), fused, ref):
        assert g.dtype == dtype and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), r.float(), atol=atol,
                                   rtol=rtol, msg=name)
    # the fused and the two-pass dk/dv run one template: bit-equal; dq
    # differs in the order of its f32 sums, then one rounding to the dtype
    assert torch.equal(fused[1], dk) and torch.equal(fused[2], dv)
    torch.testing.assert_close(fused[0].float(), dq.float(), atol=1.6e-2,
                               rtol=8e-3)
    # the prep pass: delta in f32 (sums of D products in another order)
    # and a zeroed workspace
    torch.testing.assert_close(delta, tfa._delta(do, out), atol=1e-4,
                               rtol=1e-4)
    assert bool((workspace == 0).all())


@pytest.mark.cuda
def test_fused_and_two_pass_kernels_agree(cuda_device):
    args = _bwd_inputs(2, 1024, 12, 64, torch.bfloat16, True)
    fused = tfa.flash_attention_bwd_fused(*args, True)
    two_pass = tfa.flash_attention_bwd_two_pass(*args, True)
    again = tfa.flash_attention_bwd_two_pass(*args, True)
    # dk and dv come from the same arithmetic in the same order; dq differs
    # only in the order of its f32 sums (atomics), then one bf16 rounding
    for a, b in zip(fused[1:], two_pass[1:]):
        assert torch.equal(a, b)
    torch.testing.assert_close(fused[0].float(), two_pass[0].float(),
                               atol=1.6e-2, rtol=8e-3)
    for a, b in zip(two_pass, again):  # the two-pass form is deterministic
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("deterministic", [False, True])
def test_attention_on_the_card_carries_its_gradient(cuda_device,
                                                    deterministic):
    # the tensor-level entry records a node, and q/k/v gradients through
    # the kernels match the plain backward's (on the CPU)
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(2, 1024, 12, 64, generator=gen, device="cuda")
               .bfloat16().requires_grad_() for _ in range(3))
    w = torch.randn(2, 1024, 12, 64, generator=gen, device="cuda")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        before = (tfa.flash_attention_bwd_fused.launches,
                  tfa.flash_attention_bwd_dq.launches)
        out = tfa.flash_attention(q, k, v, causal=True)
        assert out.grad_fn is not None
        (out.float() * w).sum().backward()
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(prev)
    launched = (tfa.flash_attention_bwd_fused.launches - before[0],
                tfa.flash_attention_bwd_dq.launches - before[1])
    assert launched == ((0, 1) if deterministic else (1, 0))
    cq, ck, cv = (x.detach().cpu().float().requires_grad_()
                  for x in (q, k, v))
    ref = tfa.flash_attention(cq, ck, cv, causal=True)
    (ref * w.cpu()).sum().backward()
    for x, c in ((q, cq), (k, ck), (v, cv)):
        assert x.grad is not None and x.grad.abs().sum() > 0
        torch.testing.assert_close(x.grad.float().cpu(), c.grad,
                                   atol=1.5e-1, rtol=2e-2)


# ---- the ring-attention block kernels ---------------------------------------
# (BH, Sq, Sk, D, dtype, causal, (q_off, k_off)): the ERNIE-base path hop,
# causal hops on the diagonal, in the past and in the future, an offset off
# the tile grid, Sq != Sk, D 128 and 256, fp32, and ragged lengths
RING_CASES = [(96, 128, 128, 64, torch.bfloat16, False, (128, 256)),
              (12, 1024, 1024, 64, torch.bfloat16, True, (1024, 1024)),
              (12, 1024, 1024, 64, torch.bfloat16, True, (2048, 0)),
              (12, 1024, 1024, 64, torch.bfloat16, True, (0, 1024)),
              (12, 128, 128, 64, torch.bfloat16, True, (96, 0)),
              (12, 128, 256, 64, torch.bfloat16, True, (128, 0)),
              (6, 512, 512, 128, torch.bfloat16, True, (512, 512)),
              (3, 512, 512, 256, torch.bfloat16, True, (512, 512)),
              (12, 256, 256, 64, torch.float32, True, (256, 128)),
              (12, 100, 200, 64, torch.bfloat16, True, (150, 0)),
              (96, 128, 128, 64, torch.float16, False, (128, 256)),
              (12, 1024, 1024, 64, torch.float16, True, (1024, 1024)),
              (12, 1024, 1024, 64, torch.float16, True, (0, 1024)),
              (12, 128, 128, 64, torch.float16, True, (96, 0)),
              (6, 512, 512, 128, torch.float16, True, (512, 512)),
              (3, 512, 512, 256, torch.float16, True, (512, 512)),
              (12, 100, 200, 64, torch.float16, True, (150, 0))]


def _ring_inputs(bh, sq, sk, d, dtype, causal, offs):
    gen = torch.Generator(device="cuda").manual_seed(sq + sk + d)
    q, do = (torch.randn(bh, sq, d, generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(bh, sk, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    out, lse = tra.ring_block_fwd_plain(q, k, v, offs, causal)
    delta = (do.float() * out.float()).sum(-1)[:, None, :]
    return q, k, v, do, lse, delta


def _ring_close(got, want, dtype, name):
    # FWD_TOL for out and lse, GRAD_TOL for dq, dk, dv (f32 sums of
    # products of p and ds rounded to the input dtype)
    grad = name.split("[")[0] in ("dq", "dk", "dv")
    tol = (GRAD_TOL if grad else FWD_TOL)[dtype]
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all()), name
    err = (got - want).abs()
    assert bool((err <= tol + tol * want.abs()).all()), \
        f"{name}: max abs err {err.max().item()}"


@pytest.mark.cuda
@pytest.mark.parametrize("case", RING_CASES, ids=str)
def test_ring_kernels_match_plain(cuda_device, case):
    *dims, dtype, causal, offs = case
    q, k, v, do, lse, delta = _ring_inputs(*dims, dtype, causal, offs)
    counts = [f.launches for f in RING_WRAPPERS]
    out, got_lse = tra.ring_block_fwd(q, k, v, offs, causal)
    dq = tra.ring_block_dq(q, k, v, do, lse, delta, offs, causal)
    dk, dv = tra.ring_block_dkv(q, k, v, do, lse, delta, offs, causal)
    torch.cuda.synchronize()
    assert [f.launches for f in RING_WRAPPERS] == [c + 1 for c in counts]
    assert out.dtype == dtype and got_lse.dtype == torch.float32
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    ref_out, ref_lse = tra.ring_block_fwd_plain(q, k, v, offs, causal)
    ref_dq = tra.ring_block_dq_plain(q, k, v, do, lse, delta, offs, causal)
    ref_dk, ref_dv = tra.ring_block_dkv_plain(q, k, v, do, lse, delta, offs,
                                              causal)
    for name, g, r in (("out", out, ref_out), ("lse", got_lse, ref_lse),
                       ("dq", dq, ref_dq), ("dk", dk, ref_dk),
                       ("dv", dv, ref_dv)):
        _ring_close(g, r, dtype, name)


def _step_inputs(n, bh, sq, sk, d, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dt)
    qs, dos = ([draw(bh, sq, d) for _ in range(n)] for _ in range(2))
    ks, vs = ([draw(bh, sk, d) for _ in range(n)] for _ in range(2))
    o = [draw(bh, sq, d, dt=torch.float32) for _ in range(n)]
    lse = [draw(bh, 1, sq, dt=torch.float32) + 5.0 for _ in range(n)]
    dk, dv = ([draw(bh, sk, d, dt=torch.float32) for _ in range(n)]
              for _ in range(2))
    return qs, ks, vs, dos, o, lse, dk, dv


def _clones(xs):
    return [x.clone() for x in xs]


# the step kernels: the sp train's ring step (4 slots on one card, hop
# (i, i - 1)), and each ring case above as a group of two slots
STEP_CASES = [(4, 96, 128, 128, 64, torch.bfloat16, c,
               [(128 * i, 128 * ((i - 1) % 4)) for i in range(4)])
              for c in (False, True)] + \
    [(2, *dims, dtype, causal, [offs, offs])
     for *dims, dtype, causal, offs in RING_CASES]


@pytest.mark.cuda
@pytest.mark.parametrize("case", STEP_CASES, ids=str)
@pytest.mark.parametrize("first,last", [(True, False), (False, False),
                                        (False, True)])
def test_ring_step_kernels_match_plain(cuda_device, case, first, last):
    n, bh, sq, sk, d, dtype, causal, offs = case
    qs, ks, vs, dos, o, lse, dk, dv = _step_inputs(n, bh, sq, sk, d, dtype,
                                                   n + sq + sk + d)
    counts = [x for f in RING_WRAPPERS for x in (f.launches, f.hops)]
    ok, lk, op, lp = _clones(o), _clones(lse), _clones(o), _clones(lse)
    got = tra.ring_fwd_step(qs, ks, vs, offs, ok, lk, causal, first, last)
    want = tra.ring_fwd_step_plain(qs, ks, vs, offs, op, lp, causal, first,
                                   last)
    fwd = [tra.ring_block_fwd_plain(q, k, v, off, causal)
           for q, k, v, off in zip(qs, ks, vs, offs)]
    glse = [x for _, x in fwd]
    delta = [(g.float() * x.float()).sum(-1)[:, None, :]
             for g, (x, _) in zip(dos, fwd)]
    dkk, dvk, dkp, dvp = _clones(dk), _clones(dv), _clones(dk), _clones(dv)
    tra.ring_dkv_step(qs, ks, vs, dos, glse, delta, offs, dkk, dvk, causal,
                      first)
    tra.ring_dkv_step_plain(qs, ks, vs, dos, glse, delta, offs, dkp, dvp,
                            causal, first)
    # dq adds into the accumulators at every step (no `first`): here the
    # running o stands in for a dq accumulator from earlier hops
    dqk, dqp = _clones(o), _clones(o)
    tra.ring_dq_step(qs, ks, vs, dos, glse, delta, offs, dqk, causal)
    tra.ring_dq_step_plain(qs, ks, vs, dos, glse, delta, offs, dqp, causal)
    torch.cuda.synchronize()
    assert [x for f in RING_WRAPPERS for x in (f.launches, f.hops)] == \
        [c + (1 if i % 2 == 0 else n) for i, c in enumerate(counts)]
    if last:
        assert all(x.dtype == dtype for x in got)
        pairs = zip(got, want)
    else:
        assert got is None
        pairs = zip(ok, op)
    for i, (g, r) in enumerate(pairs):
        _ring_close(g, r, dtype, f"o/out[{i}]")
    for name, gs, rs in (("lse", lk, lp), ("dq", dqk, dqp), ("dk", dkk, dkp),
                         ("dv", dvk, dvp)):
        for i, (g, r) in enumerate(zip(gs, rs)):
            _ring_close(g, r, dtype, f"{name}[{i}]")
    for i, off in enumerate(offs):
        if causal and off[1] >= off[0] + sq and not first:
            # a hop wholly in the future leaves the accumulators as they are
            assert torch.equal(lk[i], lse[i])
            assert torch.equal(got[i], o[i].to(dtype)) if last else \
                torch.equal(ok[i], o[i])
            assert torch.equal(dkk[i], dk[i]) and torch.equal(dvk[i], dv[i])
        if causal and off[1] >= off[0] + sq:
            assert torch.equal(dqk[i], o[i])


@pytest.mark.cuda
def test_ring_steps_are_deterministic_and_capped(cuda_device):
    qs, ks, vs, dos, o, lse, dk, dv = _step_inputs(4, 96, 128, 128, 64,
                                                   torch.bfloat16, 1)
    offs = [(128 * i, 128 * ((i - 2) % 4)) for i in range(4)]
    delta = [torch.ones_like(x) for x in lse]
    runs = []
    for _ in range(2):
        ok, lk, dkk, dvk = _clones(o), _clones(lse), _clones(dk), _clones(dv)
        dqk = _clones(o)
        tra.ring_fwd_step(qs, ks, vs, offs, ok, lk)
        tra.ring_dkv_step(qs, ks, vs, dos, lse, delta, offs, dkk, dvk)
        tra.ring_dq_step(qs, ks, vs, dos, lse, delta, offs, dqk)
        runs.append(ok + lk + dkk + dvk + dqk)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    five = (qs + qs[:1], ks + ks[:1], vs + vs[:1], offs + offs[:1])
    with pytest.raises(ValueError, match="slots in one launch"):
        tra.ring_fwd_step(*five, o + o[:1], lse + lse[:1])
    with pytest.raises(ValueError, match="accumulators must be f32"):
        tra.ring_fwd_step(qs, ks, vs, offs, [x.bfloat16() for x in o], lse)


@pytest.mark.cuda
def test_ring_future_hop_writes_exact_zeros(cuda_device):
    # a hop wholly in the future runs no iteration and must still write
    # every output: out = dq = dk = dv = 0 and lse = -1e30 exactly
    q, k, v, do, lse, delta = _ring_inputs(12, 1024, 1024, 64,
                                           torch.bfloat16, True, (0, 1024))
    out, got_lse = tra.ring_block_fwd(q, k, v, (0, 1024), True)
    dq = tra.ring_block_dq(q, k, v, do, lse, delta, (0, 1024), True)
    dk, dv = tra.ring_block_dkv(q, k, v, do, lse, delta, (0, 1024), True)
    torch.cuda.synchronize()
    for x in (out, dq, dk, dv):
        assert bool((x == 0).all())
    assert bool((got_lse == -1e30).all())


@pytest.mark.cuda
def test_ring_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.zeros(2, 64, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tra.ring_block_fwd(q, q, q, (0, 0))
    q = torch.zeros(2, 64, 64, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="bf16 or fp16"):
        tra.ring_block_fwd(q, q, q, (0, 0))
    q = torch.zeros(2, 64, 64, device=cuda_device, dtype=torch.bfloat16)
    lse = torch.zeros(2, 1, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="f32"):
        tra.ring_block_dq(q, q, q, q, lse, lse, (0, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_attention_on_the_card(cuda_device, causal, dtype):
    # four ring slots on one card: the flash ring records one autograd node
    # per slot, launches each of the forward, dq and dk/dv step kernels
    # once per ring step (4 launches of 16 slot-hops), and its output and
    # gradients match the same ring on the CPU (plain versions)
    from paddle_tpu_torch.parallel import create_mesh, topology
    prev = topology.get_mesh()
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(1, 512, 2, 64, generator=gen, device="cuda")
               .to(dtype).requires_grad_() for _ in range(3))
    w = torch.randn(1, 512, 2, 64, generator=gen, device="cuda")
    try:
        mesh = create_mesh({"sp": 4}, devices=["cuda:0"] * 4)
        counts = [f.launches for f in RING_WRAPPERS]
        hops = [f.hops for f in RING_WRAPPERS]
        out = tsp.sequence_parallel_attention(q, k, v, causal=causal)
        assert out.grad_fn is not None and out.dtype == dtype
        (out.float() * w).sum().backward()
        torch.cuda.synchronize()
        assert [f.launches - c for f, c in zip(RING_WRAPPERS, counts)] == \
            [4, 4, 4]
        assert [f.hops - c for f, c in zip(RING_WRAPPERS, hops)] == \
            [16, 16, 16]
        cq, ck, cv = (x.detach().cpu().float().requires_grad_()
                      for x in (q, k, v))
        cpu_mesh = create_mesh({"sp": 4}, devices=["cpu"] * 4)
        ref = tsp.sequence_parallel_attention(cq, ck, cv, causal=causal,
                                              mesh=cpu_mesh)
        (ref * w.cpu()).sum().backward()
    finally:
        topology.set_mesh(prev)
    torch.testing.assert_close(out.float().cpu(), ref.detach(), atol=2e-2,
                               rtol=2e-2)
    for x, c in ((q, cq), (k, ck), (v, cv)):
        assert x.grad is not None and x.grad.abs().sum() > 0
        torch.testing.assert_close(x.grad.float().cpu(), c.grad,
                                   atol=1.5e-1, rtol=2e-2)


@pytest.mark.cuda
def test_sequence_parallel_attention_takes_the_dense_ring_for_a_head_dim_off_the_kernels(
        cuda_device):
    # the ring kernels' wrappers raise for a head_dim they are not built
    # for; sequence_parallel_attention sends such shards to the dense ring,
    # which computes them without a kernel
    from paddle_tpu_torch.parallel import create_mesh, topology
    prev = topology.get_mesh()
    q = torch.zeros(1, 512, 2, 32, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        tra.ring_block_fwd(q[0].transpose(0, 1).contiguous(),
                           q[0].transpose(0, 1).contiguous(),
                           q[0].transpose(0, 1).contiguous(), (0, 0))
    try:
        mesh = create_mesh({"sp": 4}, devices=["cuda:0"] * 4)
        counts = [f.launches for f in RING_WRAPPERS]
        out = tsp.sequence_parallel_attention(q, q, q, mesh=mesh)
        torch.cuda.synchronize()
        assert [f.launches for f in RING_WRAPPERS] == counts
        assert out.shape == q.shape and bool(torch.isfinite(out).all())
    finally:
        topology.set_mesh(prev)


# ---- the dq step: csrc/dq_wgmma.cuh over the slots of a ring step ----------
# (BH, Sq, Sk, D, dtype, causal, offsets of 4 slots): the sp train's ring
# step (causal both ways), a causal diagonal at S_loc = 1024, hops wholly
# in the future, offsets off the tile grid, ragged Sq, D 128 and 256, fp32
SP_HOP = [(128 * i, 128 * ((i - 1) % 4)) for i in range(4)]
DQ_STEP_CASES = [
    (96, 128, 128, 64, torch.bfloat16, False, SP_HOP),
    (96, 128, 128, 64, torch.bfloat16, True, SP_HOP),
    (12, 1024, 1024, 64, torch.bfloat16, True,
     [(1024 * i, 1024 * i) for i in range(4)]),
    (12, 1024, 1024, 64, torch.bfloat16, True,
     [(1024 * i, 1024 * (i + 1)) for i in range(4)]),
    (12, 128, 128, 64, torch.bfloat16, True,
     [(96, 0), (160, 32), (32, 0), (0, 200)]),
    (12, 100, 200, 64, torch.bfloat16, True,
     [(150, 0), (50, 0), (250, 100), (0, 100)]),
    (6, 1024, 1024, 128, torch.bfloat16, True,
     [(1024 * i, 1024 * i) for i in range(4)]),
    (3, 512, 512, 256, torch.bfloat16, True,
     [(512 * i, 512 * i) for i in range(4)]),
    (12, 256, 256, 64, torch.float32, True,
     [(256, 128), (0, 0), (512, 0), (0, 256)]),
    (96, 128, 128, 64, torch.float16, False, SP_HOP),
    (96, 128, 128, 64, torch.float16, True, SP_HOP),
    (12, 1024, 1024, 64, torch.float16, True,
     [(1024 * i, 1024 * i) for i in range(4)]),
    (6, 1024, 1024, 128, torch.float16, True,
     [(1024 * i, 1024 * i) for i in range(4)]),
    (3, 512, 512, 256, torch.float16, True,
     [(512 * i, 512 * i) for i in range(4)])]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DQ_STEP_CASES, ids=str)
def test_ring_dq_step_matches_plain(cuda_device, case):
    bh, sq, sk, d, dtype, causal, offs = case
    qs, ks, vs, dos, acc, _, _, _ = _step_inputs(4, bh, sq, sk, d, dtype,
                                                 bh + sq + sk + d)
    fwd = [tra.ring_block_fwd_plain(q, k, v, off, causal)
           for q, k, v, off in zip(qs, ks, vs, offs)]
    lse = [x for _, x in fwd]
    delta = [(g.float() * x.float()).sum(-1)[:, None, :]
             for g, (x, _) in zip(dos, fwd)]
    got, want = _clones(acc), _clones(acc)
    counts = (tra.ring_dq_step.launches, tra.ring_dq_step.hops)
    tra.ring_dq_step(qs, ks, vs, dos, lse, delta, offs, got, causal)
    torch.cuda.synchronize()
    assert (tra.ring_dq_step.launches, tra.ring_dq_step.hops) == \
        (counts[0] + 1, counts[1] + 4)
    tra.ring_dq_step_plain(qs, ks, vs, dos, lse, delta, offs, want, causal)
    for i, (g, w) in enumerate(zip(got, want)):
        # the added part alone: the accumulator's own size must not widen
        # the tolerance
        _ring_close(g - acc[i], w - acc[i], dtype, f"dq[{i}]")
        if causal and offs[i][1] >= offs[i][0] + sq:
            # a hop wholly in the future leaves the accumulator untouched
            assert torch.equal(g, acc[i])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", WGMMA_CASES + [(8, 1024, 64, True)],
                         ids=str)
def test_flash_bwd_dq_is_bitwise_reproducible(cuda_device, case, dtype):
    # one CTA per q tile, no atomics: a second run repeats the bits, and
    # both match the plain backward
    bh, s, d, causal = case
    gen = torch.Generator(device="cuda").manual_seed(bh + s + d)
    q, k, v, do = (torch.randn(bh, s, d, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    args = (q, k, v, out, lse, do, causal)
    ref = tfa.flash_attention_bwd_plain(*args)[0]
    atol, rtol = _bwd_tol(dtype)
    first = tfa.flash_attention_bwd_dq(*args)
    again = tfa.flash_attention_bwd_dq(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    torch.testing.assert_close(first.float(), ref.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
def test_fp16_attention_takes_the_kernels_on_the_card(cuda_device):
    # an fp16 call that the reference's rule sends to its kernel (S = 4096,
    # D = 64, no mask) launches the flash kernel here, the fp16 sp ring the
    # ring kernels, and both agree with the fp32 einsum path; a head_dim
    # the kernels are not built for (96) still takes the dense ring
    from paddle_tpu_torch.nn.functional.attention import (
        _einsum_attention, scaled_dot_product_attention)
    from paddle_tpu_torch.parallel import create_mesh, topology
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(1, 4096, 4, 64, generator=gen, device="cuda")
               for _ in range(3))
    ref = _einsum_attention(q, k, v, is_causal=True)
    counted = (tfa.flash_attention_fwd, *RING_WRAPPERS)
    counts = [f.launches for f in counted]
    h16 = [x.half() for x in (q, k, v)]
    out = scaled_dot_product_attention(*h16, is_causal=True)
    prev = topology.get_mesh()
    try:
        mesh = create_mesh({"sp": 4}, devices=["cuda:0"] * 4)
        ring = tsp.sequence_parallel_attention(*h16, causal=True, mesh=mesh)
        torch.cuda.synchronize()
        assert [f.launches - c for f, c in zip(counted, counts)] == \
            [1, 4, 0, 0]
        odd = [torch.randn(1, 512, 2, 96, generator=gen, device="cuda")
               .half() for _ in range(3)]
        counts = [f.launches for f in counted]
        dense = tsp.sequence_parallel_attention(*odd, causal=True, mesh=mesh)
        want = _einsum_attention(*(x.float() for x in odd), is_causal=True)
        torch.cuda.synchronize()
        assert [f.launches for f in counted] == counts
    finally:
        topology.set_mesh(prev)
    # fp16 inputs and outputs (2^-11 relative), p rounded to fp16 before
    # the PV product, against fp32
    for got, r in ((out, ref), (ring, ref), (dense, want)):
        assert got.dtype == torch.float16
        torch.testing.assert_close(got.float(), r, atol=1e-2, rtol=1e-2)


# ---- TrainStep.run() as one CUDA-graph replay per step ----

def _small_ernie_step(seed=0, layers=2):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.utils.bench import flagship_step
    pt.set_device("gpu")
    pt.seed(seed)
    return flagship_step(pt, dict(vocab_size=1024, hidden_size=128,
                                  num_hidden_layers=layers,
                                  num_attention_heads=2,
                                  intermediate_size=512,
                                  hidden_dropout_prob=0.0))


def _ernie_batches(n, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ids = torch.randint(0, 1024, (n, 4, 64), generator=gen, device="cuda")
    nsp = torch.randint(0, 2, (n, 4), generator=gen, device="cuda")
    return ids, ids, nsp


@pytest.mark.cuda
def test_run_graph_equals_the_loop_of_calls(cuda_device):
    a, b = _small_ernie_step(), _small_ernie_step()
    batch = _ernie_batches(6)
    loop = torch.stack([a(*[x[i] for x in batch]) for i in range(6)])
    span = b.run(*batch)                 # warm-up step, capture, 5 replays
    assert len(b._graphs) == 1
    torch.testing.assert_close(span.float(), loop.float(), rtol=1e-4,
                               atol=0)
    opt = b.optimizer
    assert opt._step_count == 6 and float(opt._t_arr) == 7.0
    for p, q in zip(a._ptensors, b._ptensors):
        torch.testing.assert_close(p, q, rtol=1e-4, atol=1e-6)
    again = b.run(*batch)                # all six steps replayed
    assert len(b._graphs) == 1 and float(opt._t_arr) == 13.0
    assert again[-1] < span[0]


@pytest.mark.cuda
def test_run_graph_follows_set_state_dict_and_replaced_params(cuda_device):
    step = _small_ernie_step()
    batch = _ernie_batches(4, seed=1)
    step.run(*batch)
    saved = step.state_dict()
    cap = next(iter(step._graphs.values()))
    first = step.run(*batch)
    step.set_state_dict(saved)           # in place: the same graph replays
    assert next(iter(step._graphs.values())) is cap
    torch.testing.assert_close(step.run(*batch), first, rtol=0, atol=0)
    # a parameter given new storage: the step is captured again
    p = step._ptensors[0]
    with torch.no_grad():
        p.data = p.detach().clone()
    step.set_state_dict(saved)
    redo = step.run(*batch)
    assert next(iter(step._graphs.values())) is not cap
    torch.testing.assert_close(redo.float(), first.float(), rtol=1e-4,
                               atol=0)


@pytest.mark.cuda
def test_run_graph_capture_failure_raises(cuda_device):
    step = _small_ernie_step()
    inner = step.loss_fn

    def syncing_loss(*args):
        loss = inner(*args)
        float(loss)                      # a host sync: not capturable
        return loss

    step.loss_fn = syncing_loss
    with pytest.raises(RuntimeError, match="CUDA graph"):
        step.run(*_ernie_batches(3))
    # the eager first step was taken and counted; nothing else ran
    opt = step.optimizer
    assert opt._step_count == 1 and float(opt._t_arr) == 2.0


@pytest.mark.cuda
def test_titan_dots_saves_the_flash_output_in_the_graph(cuda_device):
    """Under remat="dots" a replayed step launches one flash forward and
    one fused backward per layer; under remat=True the forward twice."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.utils.bench import titan_step
    from paddle_tpu_torch.utils.train_profile import kernel_launches
    pt.set_device("gpu")
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.rand(3, 2, 1024, 256, generator=gen, device="cuda") * 0.02
    counts = {}
    for remat in ("dots", True):
        pt.seed(0)
        step = titan_step(pt, h=256, ffn=512, heads=4, n_layers=2,
                          remat=remat)
        step.run(x)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            step.run(x)
            torch.cuda.synchronize()
        counts[remat] = kernel_launches(prof)
    assert counts["dots"]["flash_fwd"] == 2 * 3
    assert counts["dots"]["flash_bwd_fused"] == 2 * 3
    assert counts[True]["flash_fwd"] == 2 * 2 * 3
    assert counts[True]["flash_bwd_fused"] == 2 * 3
    assert counts["dots"]["gemm"] < counts[True]["gemm"]


@pytest.mark.cuda
def test_prefetcher_on_a_side_stream_yields_the_source(cuda_device):
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.io import DevicePrefetcher
    pt.set_device("gpu")
    src = [(np.full((64, 64), i, np.float32), np.arange(8) + i)
           for i in range(9)]
    feed = DevicePrefetcher(src, depth=3)
    got = []
    for x, y in feed:
        assert x.device.type == "cuda" and y.device.type == "cuda"
        got.append((x * 2, y.clone()))   # consumed on the current stream
    torch.cuda.synchronize()
    assert len(got) == len(src)
    for (x, y), (sx, sy) in zip(got, src):
        assert torch.equal(x.cpu(), torch.from_numpy(sx) * 2)
        assert torch.equal(y.cpu(), torch.from_numpy(sy))
    assert feed.stats()["consumed"] == 9
    feed.close()


@pytest.mark.cuda
def test_llm_decode_replays_one_graph_equal_to_the_eager_step(cuda_device):
    """LLMEngine on the card: one CUDA-graph capture at warm-up and none
    while serving; a replay's next tokens and logits equal the eager
    step's from one pool state (within 1e-5 (1 + |ref|)). No attention
    kernel launches: cached attention is masked einsums."""
    import numpy as np
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.serving import LLMConfig, LLMEngine
    pt.set_device("gpu")
    pt.seed(7)
    lm = pt.models.GPTForCausalLM(pt.models.GPTModel(
        vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
        max_seq_len=128, dropout=0.0))
    before = tfa.flash_attention_fwd.launches
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 64, size=int(n)).tolist()
               for n in rng.integers(2, 14, size=4)]
    for quant in ("off", "int8"):
        eng = LLMEngine(lm if quant == "off" else copy_of(lm), LLMConfig(
            num_slots=4, max_len=32, max_new_tokens=8, quant=quant,
            kv_int8=quant == "int8")).start()
        try:
            assert eng.stats()["counters"]["graph_captures"] == 1
            res = [s.result(60.0) for s in [eng.submit(p) for p in prompts]]
            assert all(st == "done" and len(t) == 8 for st, t in res)
            assert eng.stats()["counters"]["graph_captures"] == 1
            toks, pos = np.zeros(4, np.int32), np.zeros(4, np.int32)
            toks[0], _ = eng._prefill_slot(np.asarray([5, 17, 3], np.int32),
                                           0)
            pos[0] = 3
            state = [t.clone() for t in (*eng._pool, *eng._scales)]
            g_tok, g_lg = (x.clone() for x in eng._decode_step(toks, pos))
            for t, v in zip((*eng._pool, *eng._scales), state):
                t.copy_(v)
            e_tok, e_lg = eng._decode_step(toks, pos, replay=False)
            assert torch.equal(g_tok, e_tok)
            torch.testing.assert_close(g_lg, e_lg, rtol=1e-5, atol=1e-5)
        finally:
            eng.stop()
    assert tfa.flash_attention_fwd.launches == before


def copy_of(module):
    import copy
    return copy.deepcopy(module)


@pytest.mark.cuda
def test_dygraph_step_on_tensors_reaches_the_flash_kernels(cuda_device):
    """A paddle user's dygraph step (`to_tensor`, Tensor methods,
    backward(), step(), clear_grad()) on a small GPT at S = 1024 under
    auto_cast(bf16) sends each layer's attention through the flash
    forward and the fused backward, and its loss is a finite Tensor."""
    import numpy as np
    import paddle_tpu_torch as pt
    pt.set_device("gpu")
    pt.seed(0)
    model = pt.models.GPTForCausalLM(pt.models.GPTModel(
        vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
        max_seq_len=1024, dropout=0.0))
    opt = pt.optimizer.AdamW(1e-4, parameters=model.parameters())
    ids = pt.to_tensor(np.random.default_rng(0).integers(0, 512, (2, 1024)))
    assert ids.place == pt.CUDAPlace(0) and ids.dtype == pt.int32
    fwd, bwd = tfa.flash_attention_fwd, tfa.flash_attention_bwd_fused
    before = (fwd.launches, bwd.launches)
    with pt.amp.auto_cast(dtype="bfloat16"):
        logits = model(ids)
    loss = pt.nn.functional.cross_entropy(
        logits[:, :-1].reshape([-1, 512]).astype("float32"),
        ids[:, 1:].reshape([-1])).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()
    torch.cuda.synchronize()
    assert isinstance(logits, pt.Tensor) and isinstance(loss, pt.Tensor)
    assert np.isfinite(loss.item())
    assert (fwd.launches - before[0], bwd.launches - before[1]) == (2, 2)
    assert all(p.grad is None for p in model.parameters())
