"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without a CUDA device (the
kernels have no CPU mode). This file imports neither jax nor the JAX
package, so it also runs on a machine that has only torch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa


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
