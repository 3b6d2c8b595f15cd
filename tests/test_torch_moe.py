"""`paddle_tpu_torch.parallel.moe` against `paddle_tpu.parallel.moe` on the
same seeded inputs (`tests/test_moe.py`'s cases in both packages).

Tolerances: the gate's dispatch mask bit-equal (argmax ties to the first
expert in both), combine weights within 3e-7 (the two softmaxes round the
last bit apart), aux losses within 1e-7; layer outputs and gradients in
f32 within 1e-5 (1 + |ref|). Expert parallelism: four gloo ranks on the
CPU (`torch_dist_runner.py` `job_moe`), each with its E/4 experts and its
own quarter of the tokens, against the reference's `shard_map` over a
mesh of four (`tests/test_moe.py:103-121`) and the reference's layer on
each quarter with every expert local."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu.parallel import create_mesh, topology as jtopo
from paddle_tpu.parallel import moe as jm
import paddle_tpu_torch as pt
from paddle_tpu_torch.parallel import moe as tm, spawn
from paddle_tpu_torch.utils import load_moe_state

import torch_dist_runner as runner
from torch_parity import dev

EP = 4
D, H, E, K, SEED = 16, 32, 8, 2, 3
T_LOCAL = 16


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture(autouse=True)
def _fresh_mesh():
    saved = (jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0])
    yield
    jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0] = saved


NAMES = ("wg", "w1", "b1", "w2", "b2")


@jax.jit
def _jax_loss_and_grads(params, xs):
    """The reference layer's forward (its gate, dispatch, batched experts
    and combine) as one function of its five arrays: (y ** 2).sum() +
    aux, its gradients to the arrays and to xs, y and aux."""
    def f(params, xs):
        wg, w1, b1, w2, b2 = params
        dispatch, combine, aux = jm.top_k_gating(xs @ wg, K)
        out = jm.MoELayer._ffn(jm.moe_dispatch(xs, dispatch), w1, b1, w2, b2)
        y = jm.moe_combine(out, combine)
        return (y ** 2).sum() + aux, (y, aux)

    (_, (y, aux)), g = jax.value_and_grad(f, argnums=(0, 1),
                                          has_aux=True)(params, xs)
    return y, aux, g


_jax_gate = jax.jit(jm.top_k_gating, static_argnums=(1, 2))


def _params(j):
    return tuple(jnp.asarray(np.asarray(getattr(j, n))) for n in NAMES)


def _r(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _logits():
    lg = _r(48, E)
    lg[3] = lg[3, 0]                    # a row of eight equal logits
    lg[7, 2] = lg[7, 5] = lg[7].max() + 1.0   # a tie for the top
    lg[9:20] = lg[9]                    # one expert crowded past capacity
    return lg


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity", [None, 4, 48])
def test_gating_equals_the_reference_ties_included(k, capacity):
    lg = _logits()
    jd, jc, ja = _jax_gate(jnp.asarray(lg), k, capacity)
    td, tc, ta = tm.top_k_gating(torch.from_numpy(lg), k, capacity=capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                               atol=3e-7)
    assert abs(float(ta) - float(ja)) <= 1e-7
    if capacity == 48:   # no drops: the tie goes to the first expert
        assert td[7, 2].sum() == 1 and \
            td[7, 5].sum() == (1 if k == 2 else 0)
    if capacity == 4:    # a token past its expert's capacity has no slot
        assert float(td.sum()) < k * 48


def test_dispatch_and_combine_equal_the_reference():
    x, lg = _r(12, 8), _r(12, 3, seed=1)
    jd, jc, _ = _jax_gate(jnp.asarray(lg), 1, 12)
    td, tc, _ = tm.top_k_gating(torch.from_numpy(lg), 1, capacity=12)
    jb = jax.jit(jm.moe_dispatch)(jnp.asarray(x), jd)
    tb = tm.moe_dispatch(torch.from_numpy(x), td)
    assert dev(tb.numpy(), np.asarray(jb)) <= 1e-6
    y = tm.moe_combine(tb, tc).numpy()
    assert dev(y, np.asarray(jax.jit(jm.moe_combine)(jb, jc))) <= 1e-6
    gate = torch.softmax(torch.from_numpy(lg), -1).max(-1).values.numpy()
    np.testing.assert_allclose(y, x * gate[:, None], rtol=1e-5)


def test_the_seed_gives_the_reference_weights_and_the_carry_loads_them():
    j = jm.MoELayer(D, H, E, top_k=K, seed=SEED)
    t = tm.MoELayer(D, H, E, top_k=K, seed=SEED)
    for n in NAMES:
        np.testing.assert_array_equal(getattr(t, n).detach().numpy(),
                                      np.asarray(getattr(j, n)))
    other = tm.MoELayer(D, H, E, top_k=K, seed=SEED + 1)
    load_moe_state(other, j)
    np.testing.assert_array_equal(other.w2.detach().numpy(),
                                  np.asarray(j.w2))


def test_the_layer_forward_and_backward_equal_the_reference():
    j = jm.MoELayer(D, H, E, top_k=K, seed=SEED)
    t = tm.MoELayer(D, H, E, top_k=K, seed=0)
    load_moe_state(t, {n: np.asarray(getattr(j, n)) for n in NAMES})
    x = _r(T_LOCAL * 2, D, seed=2)
    jy, jaux, (jg, jgx) = _jax_loss_and_grads(_params(j), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = t(xt, return_aux=True)
    ((y ** 2).sum() + aux).backward()
    assert dev(y.detach().numpy(), np.asarray(jy)) <= 1e-5
    assert abs(float(aux) - float(jaux)) <= 1e-6
    for n, g in zip(NAMES, jg):
        assert dev(getattr(t, n).grad.numpy(), np.asarray(g)) <= 1e-5, n
    assert dev(xt.grad.numpy(), np.asarray(jgx)) <= 1e-5


def test_one_expert_is_the_dense_ffn_and_a_skewed_gate_costs_more_aux():
    t = tm.MoELayer(8, 32, num_experts=1, top_k=1)
    x = torch.from_numpy(_r(16, 8))
    ref = torch.nn.functional.gelu(x @ t.w1[0] + t.b1[0],
                                   approximate="tanh") @ t.w2[0] + t.b2[0]
    torch.testing.assert_close(t(x, capacity=16), ref, rtol=1e-5,
                               atol=1e-5)
    layer = tm.MoELayer(8, 16, num_experts=4, top_k=1)
    x = torch.from_numpy(_r(64, 8, seed=4))
    layer(x, capacity=64)
    balanced = float(layer.aux_loss)
    with torch.no_grad():
        layer.wg[:, 0] = 100.0
    layer(x, capacity=64)
    assert float(layer.aux_loss) > balanced


@pytest.fixture(scope="module")
def ep_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe")
    x = _r(EP, T_LOCAL, D, seed=5)
    buckets = _r(E, 4, D, seed=6)
    counts = np.array([4, 2, 0, 3, 1, 4, 0, 2], np.int32)
    np.savez(out / "moe_in.npz", x=x, cfg=np.array([D, H, E, K, SEED]),
             buckets=buckets, counts=counts)
    spawn(runner.run, args=("moe", str(out)), nprocs=EP, backend="gloo",
          device="cpu", timeout=300)
    res = [dict(np.load(out / f"moe_{r}.npz")) for r in range(EP)]
    return x, buckets, counts, res


def test_expert_parallel_equals_all_local_and_the_reference(ep_world):
    """Each rank's outputs at ep 4 equal the all-local layer's on its
    tokens and the reference's shard_map; the aux loss is equal; the
    expert gradients (each rank its slice, every rank's tokens) equal
    the sum over the quarters of the reference's all-local gradients."""
    x, _, _, res = ep_world
    mesh = create_mesh({"ep": EP})
    jdist = jm.MoELayer(D, H, E, top_k=K, seed=SEED, ep_axis="ep")
    f = jax.jit(shard_map(lambda xs: jdist(xs), mesh=mesh, in_specs=P("ep"),
                          out_specs=P("ep"), check_rep=False))
    jy = np.asarray(f(jnp.asarray(x.reshape(EP * T_LOCAL, D))))
    params = _params(jm.MoELayer(D, H, E, top_k=K, seed=SEED))
    grads = [np.zeros(np.shape(p), np.float32) for p in params]
    for r in range(EP):
        _, aux, (g, _) = _jax_loss_and_grads(params, jnp.asarray(x[r]))
        got = res[r]
        assert int(got["ep_n_local"]) == E // EP
        assert dev(got["ep_y"], jy[r * T_LOCAL:(r + 1) * T_LOCAL]) <= 1e-5
        assert dev(got["ep_y"], got["local_y"]) <= 1e-5
        assert got["ep_aux"] == got["local_aux"]
        assert abs(float(got["ep_aux"]) - float(aux)) <= 1e-6
        assert dev(got["ep_x_grad"], got["local_x_grad"]) <= 1e-5
        assert dev(got["ep_wg_grad"], got["local_wg_grad"]) <= 1e-5
        for i, gi in enumerate(g):
            grads[i] += np.asarray(gi)
    per = E // EP
    for i, n in enumerate(NAMES[1:], start=1):
        whole = np.concatenate([res[r][f"ep_{n}_grad"] for r in range(EP)])
        assert whole.shape[0] == E
        assert dev(whole, grads[i]) <= 1e-5, n
        local = sum(res[r][f"local_{n}_grad"] for r in range(EP))
        assert dev(whole, local) <= 1e-5, n
        assert res[0][f"ep_{n}_grad"].shape[0] == per


def test_scatter_and_gather_with_counts_equal_the_reference(ep_world):
    _, buckets, counts, res = ep_world
    mesh = create_mesh({"ep": EP})

    def body(b):
        s = jm.global_scatter(b, local_count=paddle.to_tensor(counts),
                              group="ep")
        return s._value, jm.global_gather(s, group="ep")._value

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=P("ep"),
                          out_specs=(P("ep"), P("ep")), check_rep=False))
    js, jg = f(jnp.tile(jnp.asarray(buckets), (EP, 1, 1)))
    js, jg = np.asarray(js), np.asarray(jg)
    per = E // EP
    for r in range(EP):
        np.testing.assert_array_equal(res[r]["scattered"],
                                      js[r * per:(r + 1) * per])
        np.testing.assert_array_equal(res[r]["gathered"],
                                      jg[r * E:(r + 1) * E])
    masked = buckets.copy()
    for e, c in enumerate(counts):
        masked[e, c:] = 0
    np.testing.assert_array_equal(res[0]["gathered"], masked)
