"""The port's parameter-server tier (`paddle_tpu_torch.distributed.ps`)
against the JAX package's (`tests/test_ps.py` / `test_ps_native.py`'s
cases, each run in both packages).

- tables: the same pushes give bit-equal rows, slots and stats (every
  optimizer rule, the CTR accessor, the SSD tier, the dense table and its
  shards);
- the wire: the port's `PsClient` against the reference's python and
  native servers and the port's, and the reference's client against the
  port's `PsServer`, pull bit-equal rows after the same pushes;
- the Communicator, the barrier, error frames, graph tables;
- a CTR model trained through the PS on the CPU: the port's losses within
  1e-5 relative of the reference's over 10 steps, from the same tower
  weights and server seeds.

Every server, client and thread is stopped in the test that starts it;
the module's fixture asserts that nothing of the port's PS plane is left
running after each test."""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import ps as jps
from paddle_tpu.distributed.ps import table as jtable
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.distributed import ps as tps
from paddle_tpu_torch.distributed.ps import table as ttable

import torch_ps_parity as psp


@pytest.fixture(autouse=True)
def _cpu_and_no_leak():
    pt.set_device("cpu")
    yield
    psp.check_no_leak()


def _same_table(a, b):
    sa, sb = a.snapshot_arrays(), b.snapshot_arrays()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


PUSHES = [(np.array([7, 9, 7]), 0), (np.array([1, 9]), 1),
          (np.array([3, 7, 3, 3]), 2), (np.array([2 ** 40 + 5, 1]), 3)]


def _grads(ids, seed, dim):
    return np.random.default_rng(seed).standard_normal(
        (len(ids), dim)).astype(np.float32)


@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam", "lazy_adam"])
@pytest.mark.parametrize("accessor", [None, "ctr"])
def test_sparse_tables_are_bit_equal_after_the_same_pushes(opt, accessor):
    kw = dict(dim=5, optimizer=opt, lr=0.05, seed=11, accessor=accessor)
    if accessor:
        kw.update(show_decay_rate=0.5, delete_threshold=0.9, ttl_days=3)
    ref, port = jtable.SparseTable(**kw), ttable.SparseTable(**kw)
    for ids, seed in PUSHES:
        np.testing.assert_array_equal(ref.pull(ids), port.pull(ids))
        for t in (ref, port):
            t.push(ids, _grads(ids, seed, 5))
            if accessor:
                t.push_show_click(ids, np.ones(len(ids)),
                                  np.arange(len(ids)) % 2)
    if accessor:
        for t in (ref, port):
            t.decay()
        assert ref.shrink() == port.shrink()
        assert ref.last_shrink_evicted == port.last_shrink_evicted
    _same_table(ref, port)


def test_dense_tables_and_shards_are_bit_equal():
    for opt in ("sgd", "adagrad", "adam"):
        for shard in (None, (0, 3), (2, 3)):
            kw = dict(optimizer=opt, lr=0.1, initializer="normal",
                      shard=shard)
            ref = jtable.DenseTable((7, 3), **kw)
            port = ttable.DenseTable((7, 3), **kw)
            assert ref.shard_range == port.shard_range
            g = np.random.default_rng(0).standard_normal(
                ref.w.shape).astype(np.float32)
            for t in (ref, port):
                t.push(g)
                t.push(g * 0.5)
            _same_table(ref, port)
    assert [ttable.dense_shard_range(10, i, 3) for i in range(3)] == \
        [jtable.dense_shard_range(10, i, 3) for i in range(3)]


def test_ssd_table_spills_and_saves_like_the_reference(tmp_path):
    tabs = []
    for pkg, d in ((jtable, "ref"), (ttable, "port")):
        t = pkg.SSDSparseTable(3, str(tmp_path / d / "db"), cache_rows=2,
                               optimizer="adagrad", lr=0.1, seed=4,
                               accessor="ctr")
        for ids, seed in PUSHES:
            t.push(ids, _grads(ids, seed, 3))
            t.push_show_click(ids, np.ones(len(ids)), np.zeros(len(ids)))
        t.decay()
        tabs.append(t)
    ref, port = tabs
    assert len(ref) == len(port) and port.resident_rows == 2
    sr, sp = ref.snapshot_arrays(), port.snapshot_arrays()
    order_r, order_p = np.argsort(sr["keys"]), np.argsort(sp["keys"])
    for k in sr:
        np.testing.assert_array_equal(sr[k][order_r], sp[k][order_p])
    # a reference save file loads into the port's table bit-equal
    ref.save(str(tmp_path / "ref_save"))
    fresh = ttable.SparseTable(3, optimizer="adagrad", lr=0.1, seed=4,
                               accessor="ctr")
    pt.utils.convert.load_ps_table(fresh, str(tmp_path / "ref_save.npz"))
    keys = [int(k) for k in sr["keys"]]
    np.testing.assert_array_equal(fresh.pull(keys), port.pull(keys))
    for t in tabs:
        t.close()


def _ref_native():
    return jps.NativePsServer()


SERVERS = {
    "port_py": lambda: tps.PsServer(),
    "ref_py": lambda: jps.PsServer(),
    "port_native": lambda: tps.NativePsServer(),
    "ref_native": _ref_native,
}


def _start(kind):
    s = SERVERS[kind]()
    if kind.endswith("_py"):
        s.run()
    return s


def _pull_trace(client_pkg, kinds):
    """The pulls of one push sequence through `client_pkg`'s PsClient over
    fresh servers of `kinds` (one shard each; ids route by id % 2), the
    tables negotiated over the wire."""
    srvs = [_start(k) for k in kinds]
    c = client_pkg.PsClient([f"{s.host}:{s.port}" for s in srvs])
    out = []
    try:
        c.create_sparse_table("emb", 4, optimizer="adam", lr=0.05, seed=3)
        c.create_dense_table("fc", 12, optimizer="adam", lr=0.05)
        for ids, seed in PUSHES:
            out.append(c.pull_sparse("emb", ids))
            c.push_sparse("emb", ids, _grads(ids, seed, 4))
            c.push_dense("fc", _grads(range(12), seed, 1).reshape(-1))
        out.append(c.pull_sparse(
            "emb", np.unique(np.concatenate([p[0] for p in PUSHES]))))
        out.append(c.pull_dense("fc"))
    finally:
        c.close()
        for s in srvs:
            s.stop()
    return out


def _local_trace():
    """The same sequence on local reference tables, built with the
    hyper-parameters as the config frames carry them (f32)."""
    f32 = lambda v: float(np.float32(v))   # noqa: E731
    hyper = dict(optimizer="adam", lr=f32(0.05), beta1=f32(0.9),
                 beta2=f32(0.999), eps=f32(1e-8))
    local = jtable.SparseTable(dim=4, init_std=f32(0.01), seed=3, **hyper)
    dense = jtable.DenseTable((12,), **hyper)
    out = []
    for ids, seed in PUSHES:
        out.append(local.pull(ids))
        local.push(ids, _grads(ids, seed, 4))
        dense.push(_grads(range(12), seed, 1).reshape(-1))
    out.append(local.pull(np.unique(np.concatenate([p[0] for p in PUSHES]))))
    out.append(dense.pull())
    return out


@pytest.mark.parametrize("kinds", [("port_py", "port_py"),
                                   ("ref_py", "ref_py"),
                                   ("port_native", "port_native"),
                                   ("ref_native", "ref_native"),
                                   ("port_py", "ref_native")],
                         ids=lambda k: "+".join(k))
def test_pulled_rows_are_bit_equal_across_clients_and_servers(kinds):
    """The port's client and the reference's, each over fresh servers of
    the named kinds, pull bit-equal rows after the same pushes; python
    servers give a local reference table's rows (a native server draws
    its rows from its own stream, the same in both packages: one C++
    source)."""
    port, ref = _pull_trace(tps, kinds), _pull_trace(jps, kinds)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)
    if "native" not in "".join(kinds):
        for a, b in zip(port, _local_trace()):
            np.testing.assert_array_equal(a, b)
    if kinds[0] == "port_native":
        for a, b in zip(port, _pull_trace(tps, ("ref_native",) * 2)):
            np.testing.assert_array_equal(a, b)


@pytest.fixture()
def cluster():
    servers = [tps.PsServer() for _ in range(2)]
    for i, s in enumerate(servers):
        s.add_sparse_table("emb", dim=4, lr=0.5)
        s.add_dense_table("fc", (4, 2), lr=0.5, shard=(i, len(servers)))
        s.run()
    client = tps.PsClient([f"{s.host}:{s.port}" for s in servers])
    client.register_sparse_dim("emb", 4)
    yield servers, client
    client.close()
    for s in servers:
        s.stop()


def test_communicator_batches_async_pushes(cluster):
    _, client = cluster
    comm = tps.Communicator(client)
    try:
        base = client.pull_sparse("emb", [42])
        for _ in range(5):
            comm.push_sparse_async("emb", [42], np.ones((1, 4), np.float32))
        comm.flush()
        np.testing.assert_allclose(client.pull_sparse("emb", [42]),
                                   base - 5 * 0.5, rtol=1e-5)
    finally:
        comm.stop()


def test_barrier_holds_until_every_trainer_arrives(cluster):
    servers, client = cluster
    c2 = tps.PsClient([f"{s.host}:{s.port}" for s in servers])
    released = threading.Event()

    def first():
        client.barrier(n_trainers=2)
        released.set()

    th = threading.Thread(target=first)
    th.start()
    try:
        # the first arrival is held while the second has not come
        assert not released.wait(0.3)
        c2.barrier(n_trainers=2)
        psp.wait_until(released.is_set)
    finally:
        th.join(timeout=10)
        c2.close()


def test_error_frames_keep_the_sockets_in_step(cluster):
    servers, client = cluster
    servers[0].add_sparse_table("solo", dim=4, lr=0.5)
    client.register_sparse_dim("solo", 4)
    base = client.pull_sparse("emb", [2, 3])
    with pytest.raises(tps.PsError, match="solo"):
        client.pull_sparse("solo", [2, 3])      # shard 1 lacks the table
    np.testing.assert_allclose(client.pull_sparse("emb", [2, 3]), base)
    comm = tps.Communicator(client)
    try:
        comm.push_sparse_async("no_such_table", [1],
                               np.ones((1, 4), np.float32))
        with pytest.raises((RuntimeError, TimeoutError)):
            comm.flush(timeout=10)
    finally:
        try:
            comm.stop()
        except (RuntimeError, TimeoutError):
            pass
    from paddle_tpu_torch.distributed.ps.service import _tname
    with pytest.raises(ValueError):
        _tname("a_table_name_longer_than_sixteen_bytes")


def test_graph_tables_sample_like_the_reference():
    from paddle_tpu.distributed.ps.graph_table import GraphTable as JG
    from paddle_tpu_torch.distributed.ps.graph_table import GraphTable as TG
    out = []
    for G in (JG, TG):
        g = G(weighted=True, feat_dim=3, seed=0)
        g.add_edges([0, 0, 0, 1], [1, 2, 3, 0], weight=[1.0, 1.0, 98.0, 1.0])
        g.set_node_feat([0, 1], [[1, 2, 3], [4, 5, 6]])
        out.append((*g.sample_neighbors([0, 1, 9], k=16),
                    g.get_node_feat([1, 0, 7])))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    servers = [tps.PsServer() for _ in range(2)]
    client = None
    try:
        for s in servers:
            s.add_graph_table("g", weighted=False, feat_dim=2)
            s.run()
        servers[0].table("g").add_edges([0, 2], [2, 4])
        servers[1].table("g").add_edges([1, 3], [3, 5])
        client = jps.PsClient([f"{s.host}:{s.port}" for s in servers])
        nb, _ = client.sample_neighbors("g", [0, 1, 2, 3], k=4)
        assert (nb[0] == 2).all() and (nb[3] == 5).all()
    finally:
        if client is not None:
            client.close()
        for s in servers:
            s.stop()


def _train_ctr(pkg, nn, emb_cls, to_tensor, steps=10):
    """10 steps of the small CTR model through two servers of `pkg`."""
    servers = [pkg.PsServer() for _ in range(2)]
    for s in servers:
        s.add_sparse_table("emb", dim=4, optimizer="adam", lr=0.05, seed=5)
        s.run()
    client = pkg.PsClient([f"{s.host}:{s.port}" for s in servers])
    comm = pkg.Communicator(client)
    try:
        emb = emb_cls(client, "emb", 4, communicator=comm)
        paddle.seed(0)
        tower = psp.ctr_tower(jnn)
        state = {k: np.asarray(v._value) for k, v in
                 tower.state_dict().items()}
        if nn is tnn:
            tower = psp.ctr_tower(tnn)
            pt.utils.load_numpy_state(tower, state)
        opt = (paddle if nn is jnn else pt).optimizer.SGD(
            parameters=tower.parameters(), learning_rate=0.1)
        ce = nn.CrossEntropyLoss()
        ids, dense, y = psp.ctr_data()
        losses = []
        for _ in range(steps):
            e = emb(to_tensor(ids)).reshape([16, 12])
            feat = (paddle.concat([e, paddle.to_tensor(dense)], axis=1)
                    if nn is jnn else torch.cat([e, torch.from_numpy(dense)],
                                                1))
            loss = ce(tower(feat), to_tensor(y))
            loss.backward()
            opt.step()
            opt.clear_grad()
            comm.flush()
            losses.append(float(loss))
        rows = client.pull_sparse("emb", ids.reshape(-1))
        return np.array(losses), rows
    finally:
        comm.stop()
        client.close()
        for s in servers:
            s.stop()


def test_a_ctr_model_trained_through_the_ps_matches_the_reference():
    jl, jrows = _train_ctr(jps, jnn, jps.DistributedEmbedding,
                           paddle.to_tensor)
    tl, trows = _train_ctr(tps, tnn, tps.DistributedEmbedding,
                           torch.from_numpy)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(trows, jrows, rtol=1e-5, atol=1e-6)


def test_distributed_embedding_pushes_once_per_backward_and_not_under_no_grad(
        cluster):
    _, client = cluster
    emb = tps.DistributedEmbedding(client, "emb", 4)
    before = client.pull_sparse("emb", [5, 6])
    with torch.no_grad():
        out = emb(np.array([5, 6]))
    assert not out.requires_grad and out.device.type == "cpu"
    np.testing.assert_array_equal(client.pull_sparse("emb", [5, 6]), before)
    out = emb(torch.tensor([[5, 6], [6, 6]]))
    assert out.shape == (2, 2, 4)
    out.sum().backward()      # synchronous push: 1 for id 5, 3 for id 6
    np.testing.assert_allclose(client.pull_sparse("emb", [5, 6]),
                               before - np.array([[0.5], [1.5]]), rtol=1e-6)
