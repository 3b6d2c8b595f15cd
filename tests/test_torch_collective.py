"""`paddle_tpu_torch.parallel.collective` over four gloo ranks on the CPU
against `paddle_tpu.distributed` inside `shard_map` over a mesh of four.

Rank r of the port gets row r of a seeded integer-valued f32 input and
runs every collective (tests/torch_dist_runner.py `job_collectives`); the
reference runs the same calls per shard, shard r on the same row. The
results are equal exactly (sums of small integers), but PROD, whose
reference is exp(psum(log)): it is held to the exact numpy product, and
to the reference within 1e-6 relative. The monitor's `collective.*`
counters carry the reference's names.
"""
import json

import numpy as np
import pytest
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.parallel import create_mesh, topology as jtopo
from paddle_tpu_torch.parallel import spawn

import torch_dist_runner as runner

N = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("coll")
    rng = np.random.default_rng(0)
    x = rng.integers(1, 4, (N, 8)).astype(np.float32)
    common = rng.integers(0, 9, (N, 3)).astype(np.float32)
    np.savez(out / "coll_in.npz", x=x, common=common)
    spawn(runner.run, args=("collectives", str(out)), nprocs=N,
          backend="gloo", device="cpu", timeout=300)
    res = []
    for r in range(N):
        with np.load(out / f"collectives_{r}.npz") as z:
            res.append({k: z[k] for k in z.files})
    return x, common, res


@pytest.fixture(autouse=True)
def _fresh_mesh():
    saved = (jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0])
    yield
    jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0] = saved


def _per_shard(fn, x, *extra):
    """fn(paddle tensor of shard r's row) inside shard_map over {'dp': N};
    returns each shard's result, stacked."""
    mesh = create_mesh({"dp": N})

    def body(a):
        out = fn(paddle.to_tensor(a[0]), *extra)
        v = out._value if hasattr(out, "_value") else out
        return v[None]

    f = shard_map(body, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"),
                  check_rep=False)
    return np.asarray(f(jnp.asarray(x)))


def _got(res, key):
    return np.stack([r[key] for r in res])


OPS = {"sum": jdist.ReduceOp.SUM, "max": jdist.ReduceOp.MAX,
       "min": jdist.ReduceOp.MIN, "avg": jdist.ReduceOp.AVG}


@pytest.mark.parametrize("name", sorted(OPS))
def test_all_reduce_ops_equal_the_reference(ranks, name):
    x, _, res = ranks
    want = _per_shard(lambda t: jdist.all_reduce(t, op=OPS[name]), x)
    np.testing.assert_array_equal(_got(res, f"all_reduce_{name}"), want)


def test_all_reduce_prod_async_and_bf16(ranks):
    x, _, res = ranks
    want = _per_shard(lambda t: jdist.all_reduce(t, op=jdist.ReduceOp.PROD),
                      x)
    got = _got(res, "all_reduce_prod")
    np.testing.assert_array_equal(got, np.broadcast_to(x.prod(0), got.shape))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    sums = np.broadcast_to(x.sum(0), got.shape)
    np.testing.assert_array_equal(_got(res, "all_reduce_async"), sums)
    np.testing.assert_array_equal(_got(res, "all_reduce_bf16"), sums)


def test_gathers_and_reduce_scatter_equal_the_reference(ranks):
    x, _, res = ranks
    want = _per_shard(lambda t: jdist.all_gather(None, t), x)
    np.testing.assert_array_equal(_got(res, "all_gather"), want)
    np.testing.assert_array_equal(_got(res, "all_gather_list"), want)
    np.testing.assert_array_equal(_got(res, "all_gather_axis1"),
                                  np.swapaxes(want, 1, 2))
    want = _per_shard(lambda t: jdist.reduce_scatter(None, t), x)
    np.testing.assert_array_equal(_got(res, "reduce_scatter"), want)
    np.testing.assert_array_equal(_got(res, "reduce_scatter_list"), want)


def test_broadcast_reduce_and_scatter_equal_the_reference(ranks):
    x, common, res = ranks
    for src in (0, N - 1):
        want = _per_shard(lambda t: jdist.broadcast(t, src=src), x)
        np.testing.assert_array_equal(_got(res, f"broadcast_{src}"), want)
    want = _per_shard(lambda t: jdist.reduce(t, dst=0), x)
    np.testing.assert_array_equal(_got(res, "reduce"), want)

    def scatter(t):
        out = paddle.to_tensor(np.zeros(common.shape[1:], np.float32))
        jdist.scatter(out, [paddle.to_tensor(c) for c in common], src=0)
        return out

    np.testing.assert_array_equal(_got(res, "scatter"),
                                  _per_shard(scatter, x))


def test_all_to_all_equal_the_reference(ranks):
    x, _, res = ranks
    want = _per_shard(lambda t: jdist.alltoall(
        [t.reshape([N, -1])[i] for i in range(N)], group="dp"), x)
    np.testing.assert_array_equal(_got(res, "alltoall"), want)
    np.testing.assert_array_equal(_got(res, "alltoall_list"), want)
    want = _per_shard(lambda t: jdist.alltoall_single(t, group="dp"), x)
    np.testing.assert_array_equal(_got(res, "alltoall_single"), want)


def test_point_to_point_equal_the_reference(ranks):
    x, _, res = ranks
    # the reference's send is a ppermute to the next shard
    want = _per_shard(lambda t: jdist.send(t, group="dp"), x)
    np.testing.assert_array_equal(_got(res, "send_recv"), want)
    for shift in (1, 2):
        want = _per_shard(lambda t: jdist.p2p_shift(t, group="dp",
                                                    shift=shift), x)
        np.testing.assert_array_equal(_got(res, f"p2p_shift_{shift}"), want)


def test_sub_group_and_monitor_counters(ranks):
    x, _, res = ranks
    assert all(str(r["backend"]) == "gloo" for r in res)
    got = _got(res, "new_group_sum")
    pair = x[0] + x[2]
    np.testing.assert_array_equal(got, np.stack([pair, x[1], pair, x[3]]))
    for r in res:
        counters = json.loads(str(r["counters"]))
        # the reference's names (collective.py `_record`), 4 bytes a float
        assert counters["collective.c_allreduce.count"] >= 7
        assert counters["collective.c_allgather.bytes"] == 2 * 8 * 4
        for name in ("c_reducescatter", "c_broadcast", "c_scatter",
                     "alltoall", "alltoall_single", "send_v2", "p2p_shift"):
            assert counters[f"collective.{name}.count"] >= 1, name
        assert counters["collective.count"] == sum(
            v for k, v in counters.items()
            if k.endswith(".count") and k != "collective.count")
