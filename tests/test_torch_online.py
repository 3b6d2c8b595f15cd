"""The online-learning serving plane (`serving/online.py`) against the
reference on the CPU.

The same seeded delta batches go into both packages' `OnlineServingTable`:
lookups are bit-equal float32, and the staleness gate (never synced,
reject, serve-stale with one telemetry event per episode) and the poison
count behave alike. A generation written by either package loads in the
other. `OnlineRollbackGuard` takes the reference's verdicts on the same
probe sequence and rolls a poisoned generation back within one interval,
alone and through a FleetRouter's `rollback_model`. Both packages' PS
servers feed their tables through a DeltaSubscriber from the same pushes:
the served rows are bit-equal. The reference's fault-matrix soak is the
slow tier here too, in one process."""
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import monitor as jmonitor
from paddle_tpu.distributed.ps import DeltaSubscriber as JDeltaSubscriber
from paddle_tpu.distributed.ps import PsClient as JPsClient
from paddle_tpu.distributed.ps import PsServer as JPsServer
from paddle_tpu.distributed.ps.delta import DeltaBatch as JDeltaBatch
from paddle_tpu.guard.checkpoint import load_guard_state as jload_guard_state
from paddle_tpu.obs import telemetry as jtelemetry
from paddle_tpu.serving import online as jonline
import paddle_tpu_torch as pt
from paddle_tpu_torch import monitor
from paddle_tpu_torch.distributed.ps import (DeltaSubscriber, PsClient,
                                             PsServer)
from paddle_tpu_torch.distributed.ps.delta import DeltaBatch
from paddle_tpu_torch.guard import (guard_state_version, load_guard_state,
                                    rollback_guard_state, save_guard_state)
from paddle_tpu_torch.obs import telemetry
from paddle_tpu_torch.serving import (EngineConfig, FleetRouter,
                                      ModelTenant, ReplicaAgent, online)

from torch_fleet_parity import (FAST_FLEET, check_no_leak, port_flags,
                                store, wait_until)
from torch_ps_parity import check_no_leak as check_no_ps_leak

DIM = 6


@pytest.fixture(autouse=True)
def _no_leak():
    pt.set_device("cpu")
    yield
    check_no_leak()
    check_no_ps_leak()


class _Events:
    """The process-default exporter's stand-in: records emit() calls."""

    def __init__(self):
        self.events = []

    def event(self, kind, **detail):
        self.events.append((kind, detail))


def _batches(mods, seed=0):
    """The same delta stream for both packages: a full bootstrap, two
    incremental merges, a batch with tombstones, then a full resync."""
    rng = np.random.default_rng(seed)
    out = []
    for version, full, n_live, n_dead in ((3, True, 40, 0),
                                          (5, False, 12, 0),
                                          (6, False, 8, 5),
                                          (9, True, 20, 0)):
        live = rng.choice(60, n_live, replace=False).astype(np.int64)
        rows = rng.standard_normal((n_live, DIM)).astype(np.float32)
        dead = rng.choice(60, n_dead, replace=False).astype(np.int64)
        out.append([m(version=version, dim=DIM, full=full,
                      live_keys=live.copy(), rows=rows.copy(),
                      dead_keys=dead.copy()) for m in mods])
    return out


def test_delta_batches_give_bit_equal_lookups():
    mine = online.OnlineServingTable("emb", DIM)
    ref = jonline.OnlineServingTable("emb", DIM)
    ids = np.arange(-2, 64)
    for b, jb in _batches((DeltaBatch, JDeltaBatch)):
        mine.install_delta(b)
        ref.install_delta(jb)
        mine.mark_fresh()
        ref.mark_fresh()
        got, want = mine.lookup(ids), ref.lookup(ids)
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
        s, js = mine.stats(), ref.stats()
        assert {k: v for k, v in s.items() if k != "staleness_s"} == \
            {k: v for k, v in js.items() if k != "staleness_s"}
        assert len(mine) == len(ref)
    arrays, jarrays = mine.export_arrays(), ref.export_arrays()
    assert sorted(arrays) == sorted(jarrays)
    for k in arrays:
        assert arrays[k].tobytes() == jarrays[k].tobytes()
    # installs are idempotent value writes: a re-pulled batch changes nothing
    again = _batches((DeltaBatch,))[-1][0]
    mine.install_delta(again)
    assert mine.lookup(ids).tobytes() == ref.lookup(ids).tobytes()


@pytest.mark.parametrize("degrade", ["reject", "serve_stale"])
def test_staleness_gate_matches_the_reference(degrade, monkeypatch):
    ev, jev = _Events(), _Events()
    monkeypatch.setattr(telemetry, "_DEFAULT", ev)
    monkeypatch.setattr(jtelemetry, "_DEFAULT", jev)
    mine = online.OnlineServingTable("emb", DIM, max_staleness_s=0.05,
                                     degrade=degrade)
    ref = jonline.OnlineServingTable("emb", DIM, max_staleness_s=0.05,
                                     degrade=degrade)
    assert mine.staleness_s() == ref.staleness_s() == float("inf")
    assert mine.stats()["staleness_s"] is None
    b, jb = _batches((DeltaBatch, JDeltaBatch))[0]
    with port_flags(monitor=True):
        paddle.set_flags({"FLAGS_monitor": True})
        monitor.reset()
        jmonitor.reset()
        try:
            for table, batch in ((mine, b), (ref, jb)):
                table.install_delta(batch)
                table.mark_fresh()
                assert table.lookup([1]).shape == (1, DIM)   # fresh
            time.sleep(0.1)
            outs = []
            for table, err in ((mine, online.StalenessExceededError),
                               (ref, jonline.StalenessExceededError)):
                if degrade == "reject":
                    with pytest.raises(err, match="stale"):
                        table.lookup([1, 2])
                else:
                    outs.append(table.lookup([1, 2]))
                    outs.append(table.lookup([1, 2]))  # same episode
            counters = monitor.snapshot()["counters"]
            jcounters = jmonitor.snapshot()["counters"]
        finally:
            paddle.set_flags({"FLAGS_monitor": False})
            jmonitor.reset()
            monitor.reset()
    keys = ("online.stale_rejects", "online.stale_serves")
    assert {k: counters.get(k) for k in keys} == \
        {k: jcounters.get(k) for k in keys}
    if degrade == "serve_stale":
        assert outs[0].tobytes() == outs[2].tobytes()
        assert [k for k, _ in ev.events] == [k for k, _ in jev.events] == \
            ["online_stale_serve"]
    mine.mark_fresh()          # a sync ends the episode
    assert mine.lookup([1]).shape == (1, DIM)


def test_poison_rows_are_counted_but_installed():
    rows = np.ones((3, DIM), np.float32)
    rows[1, 2] = np.nan
    rows[2, 0] = np.inf
    counts = []
    for mod, batch, mon in ((online, DeltaBatch, monitor),
                            (jonline, JDeltaBatch, jmonitor)):
        t = mod.OnlineServingTable("emb", DIM)
        t.install_delta(batch(version=1, dim=DIM, full=True,
                              live_keys=np.array([1, 2, 3], np.int64),
                              rows=rows, dead_keys=np.zeros(0, np.int64)))
        counts.append((t.stats()["poison_rows"], len(t),
                       np.isnan(t.lookup([2])).any()))
    assert counts[0] == counts[1] == (2, 3, True)


def test_a_generation_loads_in_either_package(tmp_path):
    b, jb = _batches((DeltaBatch, JDeltaBatch))[1]
    mine = online.OnlineServingTable("emb", DIM)
    ref = jonline.OnlineServingTable("emb", DIM)
    mine.install_delta(b)
    ref.install_delta(jb)
    online.save_serving_generation(str(tmp_path / "a"), {"emb": mine},
                                   meta_extra={"note": "port"})
    jonline.save_serving_generation(str(tmp_path / "b"), {"emb": ref},
                                    meta_extra={"note": "ref"})
    ids = np.arange(64)
    for src, load, tables in (("a", jload_guard_state,
                               jonline.load_serving_tables),
                              ("b", load_guard_state,
                               online.load_serving_tables)):
        arrays, meta = load(str(tmp_path / src))
        got = tables(arrays, meta)["emb"]
        assert got.applied_version == 5 and got.staleness_s() < 5.0
        assert got.lookup(ids).tobytes() == mine.lookup(ids).tobytes()


def _probe_sequence():
    return [np.array([0.2, 0.7]), np.array([0.5, np.nan]),
            np.array([0.5, 7.0]), None, np.array([0.1, 0.9])]


def test_rollback_guard_verdicts_match_the_reference():
    """The same probe sequence (good, non-finite, out of range, a dead
    probe, good) gives the same verdicts and ledger entries."""
    ledgers = []
    for mod in (online, jonline):
        seq = iter(_probe_sequence())
        fired = []

        def probe():
            p = next(seq)
            if p is None:
                raise RuntimeError("replica gone")
            return p
        guard = mod.OnlineRollbackGuard(probe, lambda: fired.append(1) or 7)
        verdicts = [guard.check_once() for _ in range(5)]
        ledgers.append((verdicts, fired, guard.rollbacks,
                        [{k: v for k, v in e.items() if k != "ts"}
                         for e in guard.ledger]))
    assert ledgers[0] == ledgers[1]
    assert ledgers[0][0] == [False, True, True, False, False]


def test_poisoned_generation_rolls_back_within_one_interval(tmp_path,
                                                            monkeypatch):
    ev = _Events()
    monkeypatch.setattr(telemetry, "_DEFAULT", ev)
    d = str(tmp_path / "gen")

    def table(val):
        t = online.OnlineServingTable("emb", 4)
        t.install_delta(DeltaBatch(
            version=1, dim=4, full=True, live_keys=np.array([1, 2], np.int64),
            rows=np.full((2, 4), val, np.float32),
            dead_keys=np.zeros(0, np.int64)))
        return t
    online.save_serving_generation(d, {"emb": table(0.25)})      # good v1
    online.save_serving_generation(d, {"emb": table(np.nan)})    # bad v2
    serving = online.load_serving_tables(*load_guard_state(d))

    def probe():
        return serving["emb"].lookup([1, 2]).mean(axis=1)

    def rollback():
        version = rollback_guard_state(d)
        serving.update(online.load_serving_tables(*load_guard_state(d)))
        return version

    with port_flags(monitor=True):
        monitor.reset()
        guard = online.OnlineRollbackGuard(probe, rollback, interval_s=0.05)
        t0 = time.monotonic()
        guard.start()
        try:
            wait_until(lambda: guard.rollbacks >= 1, timeout=5)
            elapsed = time.monotonic() - t0
        finally:
            guard.stop()
        counters = monitor.snapshot()["counters"]
        monitor.reset()
    assert elapsed < 1.0
    np.testing.assert_allclose(probe(), 0.25)
    entry = [e for e in guard.ledger if e["action"] == "rollback"][0]
    assert entry["reason"] == "non-finite predictions"
    assert entry["evidence"]["non_finite"] == 2
    assert entry["outcome"] == "rolled_back:1"
    assert counters["online.rollbacks"] == 1
    assert "online_rollback" in [k for k, _ in ev.events]


def test_fleet_rollback_model_restores_the_previous_generation(tmp_path):
    """The guard's rollback_fn in production shape: two replicas host a
    tenant, a rollout promotes v2, `rollback_model` restores v1 on both."""
    cfg = dict(max_batch_size=8, batch_timeout_ms=1.0, warmup_on_start=False)

    def factory(arrays, meta):
        w = float(np.asarray(arrays["w"]).ravel()[0])
        return lambda x: x * w

    d = str(tmp_path / "model")
    save_guard_state(d, {"w": np.full((1,), 3.0, np.float32)}, {})
    s = store()
    agents, router = [], None
    with port_flags(monitor=True, **FAST_FLEET):
        monitor.reset()
        try:
            for _ in range(2):
                a = ReplicaAgent(lambda x: x * 2.0, s,
                                 engine_config=EngineConfig(**cfg)).start()
                a.host_model(ModelTenant("m", d, factory,
                                         engine_config=EngineConfig(**cfg)))
                agents.append(a)
            router = FleetRouter(s).start()
            res = router.rollout(
                "m", d, {"w": np.full((1,), 5.0, np.float32)}, {},
                probes=[[np.ones((1, 2), np.float32)]] * 4)
            assert res.promoted and guard_state_version(d) == 2
            restored = router.rollback_model("m")
            assert sorted(restored) == [0, 1]
            assert guard_state_version(d) == 1
            assert all(a.tenants["m"].version == 1 for a in agents)
            st, out = router.run([np.ones((1, 2), np.float32)],
                                 deadline_ms=3000, model="m")
            assert st == 0
            np.testing.assert_allclose(out[0], 3.0)
            assert monitor.snapshot()["counters"]["fleet.rollbacks"] == 1
        finally:
            if router is not None:
                router.close()
            [a.stop(drain=False) for a in agents]
            monitor.reset()


def test_delta_feeds_from_both_packages_serve_bit_equal_rows():
    """Each package's PsServer, client and DeltaSubscriber over the same
    pushes (SGD, one seed): the tables' rows are bit-equal."""
    rng = np.random.default_rng(3)
    pushes = [(rng.choice(50, 16, replace=False).astype(np.int64),
               rng.standard_normal((16, DIM)).astype(np.float32))
              for _ in range(5)]
    ids = np.arange(50)
    got = []
    for Server, Client, Sub, mod in ((PsServer, PsClient, DeltaSubscriber,
                                      online),
                                     (JPsServer, JPsClient, JDeltaSubscriber,
                                      jonline)):
        server = Server("127.0.0.1", 0)
        server.run()
        client = Client([f"127.0.0.1:{server.port}"])
        sub = None
        try:
            client.create_sparse_table("emb", DIM, optimizer="sgd", lr=0.5,
                                       seed=7)
            client.pull_sparse("emb", ids)
            table = mod.OnlineServingTable("emb", DIM)
            sub = Sub({"emb": table}, endpoint=f"127.0.0.1:{server.port}",
                      subscriber_id="t", interval_ms=5.0,
                      pull_timeout_s=5.0).start()
            for k, g in pushes:
                client.push_sparse("emb", k, g)
            want = client.pull_sparse("emb", ids)
            wait_until(lambda: np.array_equal(table.lookup(ids), want),
                       timeout=10)
            got.append(table.lookup(ids))
        finally:
            if sub is not None:
                sub.stop()
            client.close()
            server.stop()
    assert got[0].tobytes() == got[1].tobytes()


def test_online_bench_arm_reports_the_references_keys():
    from paddle_tpu_torch.utils import bench
    r = bench.online()
    assert set(r) == {"pushes_per_arm", "batch", "dim", "per_push_us_solo",
                      "per_push_us_tailed", "tail_overhead_pct",
                      "visibility_ms", "staleness_s_at_probe"}
    assert set(r["visibility_ms"]) == {"p50", "p95", "p99"}
    assert 0 < r["visibility_ms"]["p50"] <= r["visibility_ms"]["p99"]
    assert r["staleness_s_at_probe"] < 5.0


# ---- the reference's online soak (slow tier) --------------------------------

def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))


@pytest.mark.slow
def test_online_pipeline_soak_under_a_fault_at_every_seam(tmp_path):
    """A streaming trainer (Communicator pushes) -> a PsServer -> the delta
    stream -> a CTR tenant on two replicas behind a FleetRouter, with a
    fault at each in-process seam (the PS client's send, the delta push,
    the router's dispatch, the serving client's send, the telemetry push).
    Audits: the PS table equals a fault-free oracle row for row (nothing
    lost or applied twice); both replicas' tables converge to the PS rows
    bit-exactly; every prediction was served; each seam fired. The PS
    audit is the reference's: within 1e-4 of the oracle."""
    from paddle_tpu_torch import faults
    from paddle_tpu_torch.distributed.ps import Communicator
    from paddle_tpu_torch.distributed.ps.table import SparseTable
    dim, lr, seed, n_ids = 8, 0.1, 5, 24
    s = store()
    server = PsServer("127.0.0.1", 0)
    server.run()
    client = PsClient([f"127.0.0.1:{server.port}"])
    comm = Communicator(client)
    client.create_sparse_table("emb", dim, optimizer="sgd", lr=lr, seed=seed)
    all_ids = np.arange(n_ids, dtype=np.int64)
    client.pull_sparse("emb", all_ids)
    oracle = SparseTable(dim=dim, optimizer="sgd", lr=lr, seed=seed)
    oracle.pull(all_ids)
    cfg = dict(max_batch_size=8, batch_timeout_ms=1.0, warmup_on_start=False)
    tables, subs, agents, router, col = [], [], [], None, None
    flags_on = dict(FAST_FLEET, telemetry=True, telemetry_interval_s=0.1,
                    ps_rpc_backoff_ms=20.0)
    with port_flags(**flags_on):
        try:
            col = telemetry.TelemetryCollector(s, fleet="fleet").start()
            for i in range(2):
                table = online.OnlineServingTable("emb", dim,
                                                  max_staleness_s=30.0)
                tables.append(table)
                subs.append(DeltaSubscriber(
                    {"emb": table}, endpoint=f"127.0.0.1:{server.port}",
                    subscriber_id=f"r{i}", interval_ms=10.0,
                    pull_timeout_s=5.0).start())
                d = str(tmp_path / f"ctr{i}")
                save_guard_state(d, {"w": np.ones(1, np.float32)}, {})

                def factory(arrays, meta, table=table):
                    def predict(u, it):
                        return _sigmoid(table.lookup(u).mean(1)
                                        + table.lookup(it).mean(1))
                    return predict
                a = ReplicaAgent(lambda x: x, s,
                                 engine_config=EngineConfig(**cfg)).start()
                a.host_model(ModelTenant("ctr", d, factory,
                                         engine_config=EngineConfig(**cfg)))
                agents.append(a)
            router = FleetRouter(s).start()
            wait_until(lambda: len(router.healthy_replicas()) == 2, 20)
            rng = np.random.default_rng(17)
            served = 0
            armed = faults.register(
                "ps.rpc.send:conn_reset:times=2:after=15;"
                "ps.delta.push:conn_reset:times=2:after=20;"
                "router.dispatch:conn_reset:times=2:after=10;"
                "net.serving.send:conn_reset:times=2:after=25;"
                "telemetry.push:conn_reset:times=2:after=2")
            try:
                for _ in range(60):
                    u = rng.integers(0, 12, 6).astype(np.int64)
                    it = rng.integers(12, 24, 6).astype(np.int64)
                    st, out = router.run([u, it], deadline_ms=10000,
                                         model="ctr")
                    assert st == 0 and np.isfinite(out[0]).all()
                    served += 1
                    y = rng.random(6) < 0.5
                    g = np.repeat(((np.asarray(out[0]) - y) * 0.1)[:, None]
                                  .astype(np.float32), dim, 1)
                    ids = np.concatenate([u, it])
                    grads = np.concatenate([g, g])
                    comm.push_sparse_async("emb", ids, grads)
                    oracle.push(ids, grads)
                comm.flush()
                fired = faults.stats()
            finally:
                faults.unregister(armed)
            # the reference's bound: the Communicator merges queued pushes,
            # so the PS sums them in another order than the oracle
            want = client.pull_sparse("emb", all_ids)
            np.testing.assert_allclose(want, oracle.pull(all_ids), atol=1e-4)
            for t in tables:
                wait_until(lambda t=t: t.lookup(all_ids).tobytes() ==
                           want.tobytes(), timeout=20)
                assert t.staleness_s() < 5.0
            assert served == 60
            for site in ("ps.rpc.send", "ps.delta.push", "router.dispatch",
                         "net.serving.send", "telemetry.push"):
                assert fired.get(site, {}).get("injected", 0) >= 1, site
            a = router.ledger.audit()
            assert a["lost"] == 0 and a["open"] == 0, a
        finally:
            if router is not None:
                router.close()
            for a in agents:
                a.stop(drain=False)
            for sub in subs:
                sub.stop()
            if col is not None:
                col.stop()
            comm.stop()
            client.close()
            server.stop()
