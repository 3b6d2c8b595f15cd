"""Which path an attention call takes: the dispatch predicates of the
port's `nn.functional.scaled_dot_product_attention` and of its sp ring.

The port's kernels are built for fp32, bf16 and fp16 and for head_dim 64,
128 and 256; the reference's Pallas kernels take any dtype. So both
dispatches add one condition to the reference's: what the kernels cannot
take (float64, and on the ring an odd head_dim) goes to the plain path
(the einsum attention, the dense einsum ring), never to a kernel that
would raise. fp16 reaches the kernels, at the reference's threshold for
it (S >= 4096). The length thresholds stay the reference's
(`tests/test_torch_layers.py` holds them against the JAX package).
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import ring_attention as tra
from paddle_tpu_torch.nn.functional.attention import _flash_eligible
from paddle_tpu_torch.parallel import sp as tsp
from paddle_tpu_torch.parallel import topology as ttopo


def _meta(dtype, s, d):
    return torch.empty((1, s, 2, d), dtype=dtype, device="meta")


@pytest.mark.parametrize("q_dtype,kv_dtype,s,d,want", [
    (torch.float16, torch.float16, 4096, 64, True),    # fp16 from 4096
    (torch.float16, torch.float16, 8192, 128, True),
    (torch.bfloat16, torch.bfloat16, 1024, 64, True),  # bf16 from 1024
    (torch.float32, torch.float32, 4096, 64, True),    # fp32 from 4096
    (torch.float16, torch.float32, 4096, 64, True),    # promoted to fp32
    (torch.bfloat16, torch.float16, 4096, 64, True),   # promoted to fp32
    (torch.float64, torch.float64, 4096, 64, False),
    (torch.float16, torch.float16, 2048, 64, False)])  # fp16 below 4096
def test_flash_eligible_takes_only_the_kernels_dtypes(q_dtype, kv_dtype, s, d,
                                                      want):
    q, kv = _meta(q_dtype, s, d), _meta(kv_dtype, s, d)
    assert _flash_eligible(q, kv, kv) == want


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, True), (torch.float32, 128, True),
    (torch.bfloat16, 256, True), (torch.float16, 64, True),
    (torch.bfloat16, 96, False), (torch.float32, 32, False),
    (torch.float64, 64, False)])
def test_the_ring_kernels_take_bf16_and_fp32_at_their_head_dims(dtype, d,
                                                                want):
    shards = [_meta(dtype, 128, d)] * 4
    assert tsp._kernels_take(shards, shards, shards) == want


def test_the_ring_kernels_take_one_dtype():
    q = [_meta(torch.bfloat16, 128, 64)] * 4
    kv = [_meta(torch.float32, 128, 64)] * 4
    assert not tsp._kernels_take(q, kv, kv)


@pytest.fixture()
def cpu_mesh():
    pt.set_device("cpu")
    saved = ttopo._GLOBAL_MESH[0], ttopo._GLOBAL_HCG[0]
    yield ttopo.create_mesh({"sp": 4}, devices=["cpu"] * 4)
    ttopo._GLOBAL_MESH[0], ttopo._GLOBAL_HCG[0] = saved


@pytest.mark.parametrize("dtype,d", [(torch.float16, 96),
                                     (torch.bfloat16, 96),
                                     (torch.float32, 32)])
def test_the_ring_sends_what_the_kernels_do_not_take_to_the_dense_ring(
        monkeypatch, cpu_mesh, dtype, d):
    # s_loc = 128 passes the reference's length rule; the head_dim sends
    # the shards to the dense ring, in fp16 too: no step kernel is called
    calls = []
    for name in ("ring_fwd_step", "ring_dq_step", "ring_dkv_step"):
        real = getattr(tra, name)
        monkeypatch.setattr(tra, name, lambda *a, _r=real, **k:
                            calls.append(1) or _r(*a, **k))
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 512, 2, d))
                                .astype(np.float32)).to(dtype)
               .requires_grad_() for _ in range(3))
    out = tsp.sequence_parallel_attention(q, k, v, impl="ring", causal=True)
    out.float().sum().backward()
    assert out.dtype == dtype and q.grad.dtype == dtype and not calls
    want = tsp.sequence_parallel_attention(q, k, v, impl="ring_dense",
                                           causal=True)
    assert torch.equal(out, want)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float32])
def test_the_flash_kernels_check_takes_fp16(dtype):
    # `_check` refused fp16 q/k/v, so ErnieScanStack under
    # auto_cast(dtype="float16") raised TypeError on the card; float64
    # is still refused
    q = torch.empty(2, 128, 64, dtype=dtype, device="meta")
    tfa._check("flash_fwd", q, q, q)
    tra._check("ring_fwd_step", q, q, q)
    f64 = q.to(torch.float64)
    with pytest.raises(TypeError, match="fp32, bf16 or fp16"):
        tfa._check("flash_fwd", f64, f64, f64)
