"""`paddle_tpu_torch.parallel.Reducer` and `DataParallel` against the JAX
package's Reducer.

The bucket layout of a tiny ERNIE's parameters equals the reference's at
three bucket sizes and at FLAGS_dp_bucket_mb's default, with no process.
Over two gloo ranks on the CPU (tests/torch_dist_runner.py `job_reducer`):
`reduce()` equals the reference's `Reducer.reduce` inside `shard_map`; an
eager DataParallel loop (backward(), the bucket hooks, step()) ends where
SPMDTrainStep over the same global batch ends; the monitor counts one
`c_allreduce_bucket` per bucket and step, and the flight recorder's dump
holds them as the reference's `[ts, name, nbytes]` entries; a parameter
without a gradient raises, or is reduced as zeros with
find_unused_parameters=True.
"""
import json

import numpy as np
import pytest
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

import paddle_tpu as paddle
from paddle_tpu import models as jmodels
from paddle_tpu.parallel import create_mesh, topology as jtopo
from paddle_tpu.parallel.reducer import Reducer as JReducer
import paddle_tpu_torch as pt
from paddle_tpu_torch.parallel import Reducer, spawn

import torch_dist_runner as runner

N = 2
SHAPES = [(16, 64), (64,), (64, 16), (16,), (16, 4), (4,)]
BUCKET = 64 * 16 * 4 + 16 * 4       # fc2's weight and bias in one bucket


@pytest.fixture(autouse=True)
def _cpu_and_fresh_mesh():
    pt.set_device("cpu")
    saved = (jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0])
    yield
    jtopo._GLOBAL_MESH[0], jtopo._GLOBAL_HCG[0] = saved


def _mlp_state():
    from paddle_tpu import nn as jnn

    class MLP(jnn.Layer):
        def __init__(self, d=16):
            super().__init__()
            self.fc1 = jnn.Linear(d, 4 * d)
            self.fc2 = jnn.Linear(4 * d, d)
            self.act = jnn.GELU()
            self.head = jnn.Linear(d, 4)

        def forward(self, x):
            return self.head(self.fc2(self.act(self.fc1(x))))

    paddle.seed(42)
    return {k: np.asarray(v._value) for k, v in MLP().state_dict().items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("red")
    rng = np.random.default_rng(3)
    grads = {f"g{i}": rng.integers(-8, 8, (N,) + s).astype(np.float32)
             for i, s in enumerate(SHAPES)}
    x = rng.random((16, 16)).astype(np.float32)
    y = rng.integers(0, 4, (16,)).astype(np.int64)
    np.savez(out / "red_in.npz", shapes=json.dumps(SHAPES), x=x, y=y,
             bucket_bytes=BUCKET, **grads)
    np.savez(out / "mlp_init.npz", **_mlp_state())
    spawn(runner.run, args=("reducer", str(out)), nprocs=N, backend="gloo",
          device="cpu", timeout=300)
    res = []
    for r in range(N):
        with np.load(out / f"reducer_{r}.npz") as z:
            res.append({k: z[k] for k in z.files})
        with open(out / f"fr_{r}.json") as f:
            res[-1]["dump"] = json.load(f)
    return grads, res


def _tiny_ernie_params():
    paddle.seed(0)
    jm = jmodels.ErnieForPretraining(jmodels.ErnieModel(**runner.ERNIE_CFG))
    pt.seed(0)
    tm = pt.models.ErnieForPretraining(pt.models.ErnieModel(
        **runner.ERNIE_CFG))
    return [p for p in jm.parameters()], list(tm.parameters())


@pytest.mark.parametrize("bucket_bytes", [4096, 65536, 1 << 20, None])
def test_bucket_layout_equals_the_reference(bucket_bytes):
    jps, tps = _tiny_ernie_params()
    assert [tuple(p.shape) for p in jps] == [tuple(p.shape) for p in tps]
    ref = JReducer(jps, axis="dp", bucket_bytes=bucket_bytes)
    got = Reducer(tps, bucket_bytes=bucket_bytes)
    assert got.bucket_layout() == ref.bucket_layout()
    assert got.bucket_sizes() == ref.bucket_sizes()
    if bucket_bytes == 4096:
        assert len(got.bucket_layout()) > 3


def test_reduce_equals_the_reference_under_shard_map(ranks):
    grads, res = ranks
    ref = JReducer([np.zeros(s, np.float32) for s in SHAPES], axis="dp",
                   bucket_bytes=BUCKET)
    assert json.loads(str(res[0]["layout"])) == ref.bucket_layout()
    mesh = create_mesh({"dp": N})

    def body(*gs):
        return [o[None] for o in ref.reduce([g[0] for g in gs])]

    f = shard_map(body, mesh=mesh, in_specs=tuple(P("dp") for _ in SHAPES),
                  out_specs=[P("dp") for _ in SHAPES], check_rep=False)
    want = f(*[jnp.asarray(grads[f"g{i}"]) for i in range(len(SHAPES))])
    for i, w in enumerate(want):
        got = np.stack([r[f"reduced{i}"] for r in res])
        np.testing.assert_array_equal(got, np.asarray(w))


def test_eager_data_parallel_equals_spmd_train_step(ranks):
    _, res = ranks
    eager = [json.loads(str(r["eager_params"])) for r in res]
    spmd = [json.loads(str(r["spmd_params"])) for r in res]
    for k in eager[0]:
        a = np.asarray(eager[0][k])
        # replicas equal on both ranks, and the eager loop ends where the
        # step does (host and device Adam scalars differ in the last bit)
        np.testing.assert_array_equal(a, np.asarray(eager[1][k]))
        np.testing.assert_array_equal(np.asarray(spmd[0][k]),
                                      np.asarray(spmd[1][k]))
        np.testing.assert_allclose(a, np.asarray(spmd[0][k]), rtol=1e-6,
                                   atol=1e-7)
    local = np.stack([r["eager_local_losses"] for r in res]).mean(0)
    np.testing.assert_allclose(res[0]["spmd_losses"], local, rtol=1e-6)
    assert res[0]["spmd_losses"][-1] < res[0]["spmd_losses"][0]


def test_bucket_collectives_are_counted_and_recorded(ranks):
    _, res = ranks
    for r in res:
        n_buckets = int(r["n_buckets"])
        assert n_buckets == 4           # 1 KiB buckets over the MLP
        assert int(r["bucket_count"]) == 3 * n_buckets
        sig = json.loads(str(r["signature"]))
        assert [s[0] for s in sig] == ["c_allreduce_bucket"] * n_buckets + \
            ["c_allreduce"]
        dump = r["dump"]
        assert dump["schema"] == "paddle_tpu.flight_recorder/5"
        entries = dump["collectives"]
        assert all(len(e) == 3 and isinstance(e[0], float) and
                   isinstance(e[1], str) and isinstance(e[2], int)
                   for e in entries)
        names = [e[1] for e in entries]
        assert names.count("c_allreduce_bucket") == 3 * n_buckets
        assert names.count("c_allreduce") == 3           # the global loss
        assert sum(e[2] for e in entries if e[1] == "c_allreduce_bucket") \
            == 3 * sum(int(np.prod(s)) * 4 for s in SHAPES)
        ts = [e[0] for e in entries]
        assert ts == sorted(ts)
    assert res[0]["signature"] == res[1]["signature"]


def test_spmd_step_books_the_timeline_phases(ranks):
    _, res = ranks
    for r in res:
        recs = json.loads(str(r["phases"]))
        assert len(recs) == 3
        assert {"build", "h2d", "trace_compile", "collective",
                "optimizer"} <= set(recs[0])
        for rec in recs[1:]:
            assert rec == ["collective", "device_compute", "h2d",
                           "optimizer"], rec


def test_unused_parameter_raises_or_reduces_as_zeros(ranks):
    _, res = ranks
    for r in res:
        assert "got no gradient" in str(r["unused_raised"])
        np.testing.assert_array_equal(r["unused_grad"],
                                      np.zeros((4, 4), np.float32))
