"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without a CUDA device (the
kernels have no CPU mode). The bf16 kernels at D 64 and 128 are the
wgmma/TMA designs: besides the shapes of the main paths they are held at
the edges of their tiles (ragged S inside a TMA box at a head boundary,
S below one tile, BH = 1, D = 128, non-causal). This file imports
neither jax nor the JAX package, so it also runs on a machine that has
only torch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import ring_attention as tra
from paddle_tpu_torch.parallel import sp as tsp

RING_WRAPPERS = (tra.ring_block_fwd, tra.ring_block_dq, tra.ring_block_dkv)


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
    (torch.float32, 64, 300, True), (torch.float32, 256, 129, False)])
def test_flash_fwd_matches_plain(cuda_device, dtype, d, s, causal):
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(6, s, d, generator=gen, device=cuda_device)
               .to(dtype) for _ in range(3))
    before = tfa.flash_attention_fwd.launches
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    assert tfa.flash_attention_fwd.launches == before + 1
    ref_out, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, causal)
    # bf16: p is rounded to bf16 before the PV product and out is stored
    # in bf16 (2^-8 relative); fp32 sums in another order. lse is f32.
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
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
    q = torch.zeros(2, 64, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16 or fp32"):
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
              (8, 1000, 12, 64, torch.bfloat16, True)]


def _bwd_inputs(b, s, h, d, dtype, causal):
    gen = torch.Generator(device="cuda").manual_seed(s + d)
    q, k, v, do = (torch.randn(b * h, s, d, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    return q, k, v, out, lse, do


def _bwd_tol(dtype):
    # bf16: the kernels round p and ds to bf16 before the products (as the
    # Pallas kernels do) and store bf16 gradients of magnitude <~8; the
    # plain version keeps f32. fp32: sums in another order.
    return (6e-2, 2e-2) if dtype == torch.bfloat16 else (1e-4, 1e-4)


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
@pytest.mark.parametrize("case", WGMMA_CASES, ids=str)
def test_wgmma_kernels_match_plain_at_tile_edges(cuda_device, case):
    bh, s, d, causal = case
    gen = torch.Generator(device="cuda").manual_seed(bh * s + d)
    q, k, v, do = (torch.randn(bh, s, d, generator=gen, device="cuda")
                   .bfloat16() for _ in range(4))
    out, lse = tfa.flash_attention_fwd(q, k, v, causal)
    args = (q, k, v, out, lse, do, causal)
    fused = tfa.flash_attention_bwd_fused(*args)
    dq = tfa.flash_attention_bwd_dq(*args)
    dk, dv = tfa.flash_attention_bwd_dkv(*args)
    delta, workspace = tfa._bwd_inputs("prep", q, k, v, out, lse, do,
                                       workspace=True)
    torch.cuda.synchronize()
    ref_out, ref_lse = tfa.flash_attention_fwd_plain(q, k, v, causal)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-3, atol=1e-3)
    ref = tfa.flash_attention_bwd_plain(*args)
    atol, rtol = _bwd_tol(torch.bfloat16)
    for name, g, r in zip(("dq", "dk", "dv"), fused, ref):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), r.float(), atol=atol,
                                   rtol=rtol, msg=name)
    # the fused and the two-pass dk/dv run one template: bit-equal; dq
    # differs in the order of its f32 sums, then one bf16 rounding
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
              (12, 100, 200, 64, torch.bfloat16, True, (150, 0))]


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
    # bf16: p and ds are rounded to bf16 before the products (as the Pallas
    # kernels do), out is stored in bf16; the plain version keeps f32.
    # fp32: sums in another order.
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
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
    q = torch.zeros(2, 64, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        tra.ring_block_fwd(q, q, q, (0, 0))
    q = torch.zeros(2, 64, 64, device=cuda_device, dtype=torch.bfloat16)
    lse = torch.zeros(2, 1, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="f32"):
        tra.ring_block_dq(q, q, q, q, lse, lse, (0, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_attention_on_the_card(cuda_device, causal):
    # four ring slots on one card: the flash ring records one autograd node
    # per slot, launches 16 hops each way, and its output and gradients
    # match the same ring on the CPU (plain versions)
    from paddle_tpu_torch.parallel import create_mesh, topology
    prev = topology.get_mesh()
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn(1, 512, 2, 64, generator=gen, device="cuda")
               .bfloat16().requires_grad_() for _ in range(3))
    w = torch.randn(1, 512, 2, 64, generator=gen, device="cuda")
    try:
        mesh = create_mesh({"sp": 4}, devices=["cuda:0"] * 4)
        counts = [f.launches for f in RING_WRAPPERS]
        out = tsp.sequence_parallel_attention(q, k, v, causal=causal)
        assert out.grad_fn is not None and out.dtype == torch.bfloat16
        (out.float() * w).sum().backward()
        torch.cuda.synchronize()
        assert [f.launches - c for f, c in zip(RING_WRAPPERS, counts)] == \
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
def test_sequence_parallel_attention_raises_for_a_head_dim_off_the_kernels(
        cuda_device):
    from paddle_tpu_torch.parallel import create_mesh, topology
    prev = topology.get_mesh()
    q = torch.zeros(1, 512, 2, 32, device=cuda_device, dtype=torch.bfloat16)
    try:
        mesh = create_mesh({"sp": 4}, devices=["cuda:0"] * 4)
        with pytest.raises(ValueError, match="head_dim"):
            tsp.sequence_parallel_attention(q, q, q, mesh=mesh)
    finally:
        topology.set_mesh(prev)
