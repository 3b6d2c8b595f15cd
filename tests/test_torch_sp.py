"""The port's sequence parallelism and hybrid topology against the JAX
package's.

`sequence_parallel_attention` (ring with the flash block kernels, the
dense einsum ring, Ulysses) runs the same numpy q/k/v in both packages:
the JAX function over `create_mesh({"sp": 4})` on its 8-device CPU mesh
(the Pallas ring kernels in interpret mode), the port's over a mesh of four
CPU slots (the kernels' plain versions). Outputs and q/k/v gradients are
held against each other in fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.parallel import topology as jtopo
from paddle_tpu.parallel import (HybridCommunicateGroup as JHCG,
                                 create_mesh as jcreate_mesh,
                                 sequence_parallel_attention as jspa)
import paddle_tpu_torch as pt
from paddle_tpu_torch.core.enforce import UnavailableError
from paddle_tpu_torch.kernels import ring_attention as tra
from paddle_tpu_torch.parallel import sp as tsp
from paddle_tpu_torch.parallel import topology as ttopo

CPU4 = ["cpu"] * 4


@pytest.fixture(autouse=True)
def _fresh_meshes():
    pt.set_device("cpu")
    saved = (jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0],
             ttopo._GLOBAL_MESH[0], ttopo._GLOBAL_HCG[0])
    yield
    (jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0],
     ttopo._GLOBAL_MESH[0], ttopo._GLOBAL_HCG[0]) = saved


def _qkvw(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) * 0.5
            for _ in range(4)]


def _jax_run(arrs, impl, causal):
    # the JAX entry traced once under jit (as its TrainStep traces it):
    # eager dispatch of every ring op would take ~10x longer on the CPU
    jcreate_mesh({"sp": 4})

    def loss(q, k, v, w):
        out = jspa(q, k, v, impl=impl, causal=causal)._value
        return (out * w).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
            *(jnp.asarray(x) for x in arrs))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_run(arrs, impl, causal):
    ttopo.create_mesh({"sp": 4}, devices=CPU4)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in arrs[:3])
    out = tsp.sequence_parallel_attention(q, k, v, impl=impl, causal=causal)
    (out * torch.from_numpy(arrs[3])).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in (q, k, v)]


def _compare(arrs, impl, causal):
    want_out, want_grads = _jax_run(arrs, impl, causal)
    got_out, got_grads = _torch_run(arrs, impl, causal)
    # fp32 in both; per-hop products and the lse merge in another order
    np.testing.assert_allclose(got_out, want_out, rtol=2e-5, atol=2e-5)
    for name, g, w in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_ring_matches_the_jax_flash_ring(causal):
    # s_loc = 128: the flash ring with the block kernels in both packages
    _compare(_qkvw(1, 512, 2, 64, 0), "ring", causal)


def _run_in(arrs, impl, causal, jdt, tdt):
    """Both functions on inputs rounded to one dtype; results in f32."""
    arrs = [np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))
            for x in arrs]

    def jloss(q, k, v, w):
        out = jspa(q, k, v, impl=impl, causal=causal)._value
        return (out.astype(jnp.float32) * w).sum(), out

    jcreate_mesh({"sp": 4})
    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
            *(jnp.asarray(x, jdt) for x in arrs[:3]), jnp.asarray(arrs[3]))
    ttopo.create_mesh({"sp": 4}, devices=CPU4)
    q, k, v = (torch.from_numpy(x).to(tdt).requires_grad_()
               for x in arrs[:3])
    out = tsp.sequence_parallel_attention(q, k, v, impl=impl, causal=causal)
    (out.float() * torch.from_numpy(arrs[3])).sum().backward()
    assert out.dtype == tdt and all(x.grad.dtype == tdt for x in (q, k, v))
    return ([np.asarray(jout.astype(jnp.float32))] +
            [np.asarray(g.astype(jnp.float32)) for g in jgrads],
            [out.detach().float().numpy()] +
            [x.grad.float().numpy() for x in (q, k, v)])


@pytest.mark.parametrize("causal", [False, True])
def test_fp16_ring_matches_the_jax_flash_ring(monkeypatch, causal):
    # s_loc = 128 at fp16: both packages run their flash ring (the kernels
    # take fp16; here the step kernels' plain versions, 4 ring steps of 4
    # slots each way). fp16 inputs; the reference rounds p and ds to fp16
    # before the products and each hop's out to fp16, the plain versions
    # keep f32, and both round out and the gradients to fp16 (2^-11
    # relative, 1e-3 at the largest values here, |x| < 2)
    calls = []
    for name in ("ring_fwd_step", "ring_dq_step", "ring_dkv_step"):
        real = getattr(tra, name)
        monkeypatch.setattr(tra, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    want, got = _run_in(_qkvw(1, 512, 2, 64, 7), "ring", causal,
                        jnp.float16, torch.float16)
    assert sorted(calls) == sorted(["ring_fwd_step", "ring_dq_step",
                                    "ring_dkv_step"] * 4)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-2, atol=1e-3, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_head_dim_96_ring_matches_the_jax_flash_ring(causal):
    # s_loc = 128 at D = 96: the reference's flash ring against the port's
    # dense ring, fp32 in both (products and the merge in another order)
    want, got = _run_in(_qkvw(1, 512, 2, 96, 8), "ring", causal,
                        jnp.float32, torch.float32)
    np.testing.assert_allclose(got[0], want[0], rtol=2e-5, atol=2e-5)
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("impl", ["ring", "ring_dense", "ulysses"])
def test_short_shards_match_the_jax_functions(impl, causal):
    # s_loc = 8: "ring" takes the dense einsum ring, as in the reference
    _compare(_qkvw(2, 32, 4, 8, 1), impl, causal)


@pytest.mark.parametrize("s,hops", [(512, 16), (256, 0), (96, 0)])
def test_the_flash_ring_dispatch_rule_is_the_references(monkeypatch, s,
                                                        hops):
    # flash blocks when s_loc >= 128 and s_loc % min(512, s_loc) == 0;
    # counted in slot-hops of the forward's ring steps
    calls = []
    real = tra.ring_fwd_step
    monkeypatch.setattr(tra, "ring_fwd_step",
                        lambda *a, **k: calls.append(len(a[0])) or
                        real(*a, **k))
    ttopo.create_mesh({"sp": 4}, devices=CPU4)
    q = torch.from_numpy(_qkvw(1, s, 2, 64, 2)[0])
    out = tsp.sequence_parallel_attention(q, q, q, impl="ring", causal=True)
    assert out.shape == q.shape and sum(calls) == hops


@pytest.mark.parametrize("devices,groups", [
    (CPU4, [[0, 1, 2, 3]]),
    (["cpu:0", "cpu:1", "cpu:0", "cpu:1"], [[0, 2], [1, 3]]),
    (["cpu"] * 6, [[0, 1, 2, 3], [4, 5]])])
def test_ring_steps_group_the_slots_of_a_device(devices, groups):
    # one launch per ring step and device, at most MAX_SLOTS slots each
    assert tra.MAX_SLOTS == 4
    assert tsp._step_groups([torch.device(d) for d in devices]) == groups


@pytest.mark.parametrize("causal", [False, True])
def test_the_ring_calls_each_step_kernel_once_per_ring_step(monkeypatch,
                                                            causal):
    # four slots on one device: the forward, dq and dk/dv kernels each take
    # all four slots of a ring step in one call (4 calls of 4 slot-hops)
    calls = {"fwd": [], "dkv": [], "dq": []}
    for name, key in (("ring_fwd_step", "fwd"), ("ring_dkv_step", "dkv"),
                      ("ring_dq_step", "dq")):
        real = getattr(tra, name)

        def spy(*a, _real=real, _key=key, **k):
            calls[_key].append(len(a[0]))
            return _real(*a, **k)
        monkeypatch.setattr(tra, name, spy)
    ttopo.create_mesh({"sp": 4}, devices=CPU4)
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkvw(1, 512, 2, 64, 6)[:3])
    tsp.sequence_parallel_attention(q, k, v, impl="ring",
                                    causal=causal).sum().backward()
    assert calls == {"fwd": [4] * 4, "dkv": [4] * 4, "dq": [4] * 4}


def test_no_mesh_or_one_slot_is_plain_attention():
    from paddle_tpu_torch.nn.functional.attention import \
        scaled_dot_product_attention
    q = torch.from_numpy(_qkvw(1, 64, 2, 16, 3)[0])
    want = scaled_dot_product_attention(q, q, q, is_causal=True)
    assert torch.equal(tsp.sequence_parallel_attention(q, q, q, causal=True),
                       want)
    mesh = ttopo.create_mesh({"sp": 1}, devices=["cpu"])
    assert torch.equal(tsp.sequence_parallel_attention(q, q, q, causal=True,
                                                       mesh=mesh), want)


def test_sequence_parallel_attention_layer_picks_as_the_reference():
    ttopo.create_mesh({"sp": 4}, devices=CPU4)
    layer = tsp.SequenceParallelAttention(impl="auto", causal=True)
    arrs = _qkvw(1, 32, 8, 8, 4)
    q = torch.from_numpy(arrs[0])
    want = tsp.sequence_parallel_attention(q, q, q, impl="ulysses",
                                           causal=True)
    assert torch.equal(layer(q, q, q), want)


HYBRID = [{"sp_degree": 4}, {"dp_degree": 2, "sp_degree": 4},
          {"dp_degree": 2, "mp_degree": 2, "pp_degree": 2},
          {"sharding_degree": 4, "mp_degree": 2}]


@pytest.mark.parametrize("cfg", HYBRID, ids=str)
def test_hybrid_group_matches_the_reference(cfg):
    want = JHCG(hybrid_configs=cfg, devices=jax.devices())
    got = ttopo.HybridCommunicateGroup(hybrid_configs=cfg,
                                       devices=["cpu"] * 8)
    assert got.mesh.axis_names == tuple(want.mesh.axis_names)
    assert got.mesh.shape == dict(want.mesh.shape)
    assert got.topology.get_hybrid_group_names() == \
        want.topology.get_hybrid_group_names()
    assert got.topology.world_size() == want.topology.world_size()
    for name in want.topology.get_hybrid_group_names():
        assert got.topology.get_dim(name) == want.topology.get_dim(name)
    for meth in ("get_parallel_mode", "get_data_parallel_world_size",
                 "get_model_parallel_world_size",
                 "get_pipe_parallel_world_size",
                 "get_sharding_parallel_world_size",
                 "get_sep_parallel_world_size", "get_model_parallel_group"):
        assert getattr(got, meth)() == getattr(want, meth)(), meth
    assert ttopo.get_mesh() is got.mesh
    assert ttopo.get_hybrid_communicate_group() is got


def test_hybrid_group_from_a_strategy():
    strategy = pt.parallel.DistributedStrategy()
    strategy.hybrid_configs["sp_degree"] = 2
    hcg = ttopo.HybridCommunicateGroup(strategy, devices=["cpu"] * 2)
    assert hcg.mesh.shape == {"dp": 1, "pp": 1, "sharding": 1, "mp": 1,
                              "sp": 2}
    assert hcg.get_sep_parallel_world_size() == 2


def test_too_few_devices_raise_as_the_reference():
    cfg = {"dp_degree": 4, "sp_degree": 4}
    with pytest.raises(ValueError) as want:
        JHCG(hybrid_configs=cfg, devices=jax.devices())
    with pytest.raises(ValueError) as got:
        ttopo.HybridCommunicateGroup(hybrid_configs=cfg, devices=["cpu"] * 8)
    assert str(got.value) == str(want.value)
    # the default devices on the CPU place are one CPU: no slot is made up
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        ttopo.HybridCommunicateGroup(hybrid_configs={"sp_degree": 4})


def test_create_mesh_and_use_mesh():
    mesh = ttopo.create_mesh({"dp": 2, "sp": 4}, devices=["cpu"] * 8)
    jmesh = jcreate_mesh({"dp": 2, "sp": 4})
    assert mesh.shape == dict(jmesh.shape)
    assert mesh.axis_devices("sp") == [torch.device("cpu")] * 4
    inner = ttopo.create_mesh({"sp": 2}, devices=["cpu"] * 2)
    ttopo.set_mesh(mesh)
    with ttopo.use_mesh(inner) as m:
        assert m is inner and ttopo.get_mesh() is inner
    assert ttopo.get_mesh() is mesh


def test_cuda_slots_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda slots are valid here")
    with pytest.raises(UnavailableError):
        ttopo.create_mesh({"sp": 4}, devices=["cuda:0"] * 4)
