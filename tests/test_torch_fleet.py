"""The serving fleet (`serving/fleet.py`) against the reference on the CPU.

The same seeded sequence of ledger operations gives the reference's
settle results and audits; `render_fleet` renders the same doc alike. A
FleetRouter over two in-process port replicas of a 2-layer narrow GPT
(each the live layer's Predictor behind a ReplicaAgent) answers as the
reference's live-layer Predictor does on the same weights (carried by
`load_numpy_state`), within 1e-5 (fp32: summation order only, as
tests/test_torch_net.py); one replica dies mid-run and every sequence
settles exactly once. Beside that, the reference's own cases on the port,
over a `torch.distributed.TCPStore` (whose `get` on a missing key would
block: the router reads through `collective.store_peek`): discovery,
routing by score, failover, the dispatch fault, drain, the register
fault, corpse reaping, the HBM budget, tenant isolation, canary rollouts
promoted and rolled back, the snapshot and `monitor fleet`, and the
device leg of the health probe. The reference's chaos soak is the slow
tier here too."""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import inference as jinference
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.models.gpt import GPTModel as JGPTModel
from paddle_tpu.serving import fleet as jfleet
import paddle_tpu_torch as pt
from paddle_tpu_torch import faults, monitor
from paddle_tpu_torch.guard import guard_state_version, save_guard_state
from paddle_tpu_torch.inference.server import PredictorClient
from paddle_tpu_torch.obs.slo import SloPlane
from paddle_tpu_torch.serving import (EngineConfig, FleetRouter,
                                      HBMBudgetExceededError, ModelTenant,
                                      NoHealthyReplicaError, ReplicaAgent,
                                      SequenceLedger, fleet)
from paddle_tpu_torch.utils import load_numpy_state, syncwatch

from torch_fleet_parity import (FAST_FLEET, check_no_leak, port_flags,
                                store, wait_until)

CFG = dict(max_batch_size=8, batch_timeout_ms=1.0, warmup_on_start=False)
GPT = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=32, dropout=0.0)
TOL = 1e-5
RUNNER = os.path.join(os.path.dirname(__file__), "torch_fleet_runner.py")


@pytest.fixture(autouse=True)
def _no_leak():
    pt.set_device("cpu")
    yield
    check_no_leak()


@pytest.fixture()
def fleet_flags():
    with port_flags(**FAST_FLEET):
        yield


@pytest.fixture()
def monitored():
    monitor.reset()
    with port_flags(monitor=True):
        yield monitor
    monitor.reset()


def _agent(s, handler=None, **kw):
    return ReplicaAgent(handler or (lambda x: x * 2.0), s,
                        engine_config=EngineConfig(**CFG), **kw).start()


def _ones(n=3):
    return [np.ones((1, n), np.float32)]


# ---- the sequence ledger ----------------------------------------------------

def test_ledger_matches_the_reference_on_one_seeded_sequence():
    rng = np.random.default_rng(11)
    ops = []
    for _ in range(300):
        op = rng.choice(["next", "dispatch", "settle", "reject"],
                        p=[0.3, 0.3, 0.3, 0.1])
        ops.append((str(op), int(rng.integers(0, 60)),
                    int(rng.integers(0, 4))))
    trails = []
    for ledger in (SequenceLedger(), jfleet.SequenceLedger()):
        trail = []
        for op, seq, rid in ops:
            if op == "next":
                trail.append(ledger.next_seq())
            elif op == "dispatch":
                ledger.dispatch(seq, rid)
            elif op == "settle":
                trail.append(ledger.settle(seq, rid))
            else:
                ledger.reject(seq, "deadline")
            trail.append(ledger.audit())
        trails.append(trail)
    assert trails[0] == trails[1]
    assert trails[0][-1]["duplicates"] > 0 and trails[0][-1]["rejected"] > 0


def test_concurrent_settles_yield_one_winner():
    ledger = SequenceLedger()
    seq = ledger.next_seq()
    wins = []
    barrier = threading.Barrier(8)

    def settle(r):
        barrier.wait()
        wins.append(ledger.settle(seq, r))
    ts = [threading.Thread(target=settle, args=(r,)) for r in range(8)]
    [t.start() for t in ts]
    [t.join(10) for t in ts]
    assert wins.count(True) == 1
    assert ledger.audit() == {"issued": 1, "settled": 1, "rejected": 0,
                              "open": 0, "duplicates": 7, "lost": 0}


# ---- the GPT fleet against the reference's Predictor -----------------------

def test_a_gpt_fleet_answers_as_the_references_predictor(fleet_flags,
                                                         monitored):
    """Two port replicas of one small GPT behind a router: each reply is
    the reference's live-layer Predictor's within TOL; replica 0 is
    stopped hard mid-run, the rest fail over and the ledger audits
    clean."""
    paddle.seed(7)
    jlm = JGPTForCausalLM(JGPTModel(**GPT))
    jlm.eval()
    state = {k: np.asarray(v._value) for k, v in jlm.state_dict().items()}
    jpred = jinference.Predictor(jlm, input_spec=[
        paddle.static.InputSpec([1, 16], "int32")])
    s = store()
    agents, router = [], None
    try:
        for _ in range(2):
            lm = pt.models.GPTForCausalLM(pt.models.GPTModel(**GPT))
            load_numpy_state(lm, state)
            lm.eval()
            agents.append(_agent(s, pt.inference.Predictor(
                lm, input_spec=[pt.InputSpec([1, 16], "int32")])))
        router = FleetRouter(s).start()
        assert sorted(router.replicas) == [0, 1]
        # the probe checks where the predictor serves
        assert [a.device for a in agents] == [torch.device("cpu")] * 2
        rng = np.random.default_rng(0)
        reqs = [rng.integers(0, 64, (1, 16)).astype(np.int32)
                for _ in range(6)]
        for k, ids in enumerate(reqs):
            if k == 3:                 # replica 0 dies: no drain, no lease
                agents[0]._elastic.stop()
                agents[0].server.stop(drain=False)
            st, out = router.run([ids], deadline_ms=10000)
            assert st == 0
            want = np.asarray(jpred.run([ids])[0].numpy())
            assert out[0].shape == (1, 16, 64)
            np.testing.assert_allclose(out[0], want, rtol=TOL, atol=TOL)
        audit = router.ledger.audit()
        assert audit == {"issued": 6, "settled": 6, "rejected": 0,
                         "open": 0, "duplicates": 0, "lost": 0}
        wait_until(lambda: 0 not in [h.replica_id
                                     for h in router.healthy_replicas()])
    finally:
        if router is not None:
            router.close()
        [a.stop(drain=False) for a in agents]


# ---- routing, failover, drain, faults, reaping ------------------------------

def test_registration_discovery_and_round_trip(fleet_flags):
    s = store()
    agents = [_agent(s) for _ in range(3)]
    router = FleetRouter(s).start()
    try:
        assert sorted(router.replicas) == [0, 1, 2]
        for _ in range(6):
            st, out = router.run(_ones(), deadline_ms=3000)
            assert st == 0
            np.testing.assert_allclose(out[0], 2.0)
        a = router.ledger.audit()
        assert a["settled"] == 6 and a["lost"] == 0
        stats = PredictorClient(agents[0].host, agents[0].port).health()
        # the reference's fields: no device of the agent's own
        assert stats["replica_id"] == 0 and "device" not in stats
        assert agents[0].device is None      # a plain callable: no probe
    finally:
        router.close()
        [ag.stop(drain=False) for ag in agents]


def test_routing_score_matches_the_reference(fleet_flags):
    s = store()
    router = FleetRouter(s)
    try:
        docs = [{"queue_depth": 40, "queue_capacity": 64, "inflight": 8},
                {"queue_depth": 0, "queue_capacity": 64, "inflight": 0},
                {"queue_depth": 0, "queue_capacity": 64, "inflight": 0,
                 "slo": {"burn": {"60": 3.0, "300": 0.5}}},
                {}, {"slo": "garbled"}]
        hs = {}
        for i, d in enumerate(docs):
            h, jh = fleet._ReplicaHandle(i, "h", i), \
                jfleet._ReplicaHandle(i, "h", i)
            h.stats = jh.stats = d
            assert h.score(2.0) == jh.score(2.0)
            hs[i] = h
        router.replicas = hs
        assert router._pick(exclude=set()).replica_id == 1
        assert hs[2].score(2.0) == pytest.approx(6.0)
    finally:
        router.close()


def test_failover_fault_drain_and_the_empty_pool(fleet_flags, monitored):
    s = store()
    agents = [_agent(s) for _ in range(2)]
    router = FleetRouter(s).start()
    try:
        with faults.inject("router.dispatch:conn_reset:times=1"):
            st, _ = router.run(_ones(), deadline_ms=4000)
        assert st == 0 and router.ledger.audit()["duplicates"] == 0
        assert monitor.snapshot()["counters"]["fleet.failovers"] == 1
        victim = agents[0]
        victim._elastic.stop()
        victim.server.stop(drain=False)
        t0 = time.monotonic()
        st, _ = router.run(_ones(), deadline_ms=4000)
        assert st == 0 and time.monotonic() - t0 < 4.0
        wait_until(lambda: victim.replica_id not in [
            h.replica_id for h in router.healthy_replicas()], timeout=5)
        router.drain(1)
        with pytest.raises(NoHealthyReplicaError):
            router.run(_ones())
        a = router.ledger.audit()
        assert a["lost"] == 0 and a["issued"] == a["settled"] + a["rejected"]
    finally:
        router.close()
        [ag.stop(drain=False) for ag in agents]


def test_register_fault_and_the_device_probe(fleet_flags):
    s = store()
    agent = ReplicaAgent(lambda x: x * 2.0, s,
                         engine_config=EngineConfig(**CFG))
    try:
        with faults.inject("replica.register:error"):
            with pytest.raises(faults.InjectedFault):
                agent.start()
    finally:
        agent.stop(drain=False)
    # a replica whose device leg fails answers 'PDHQ' with an error: the
    # router marks it dead instead of routing to it
    agent = _agent(s)
    router = FleetRouter(s)
    try:
        router.refresh()
        assert router.replicas[agent.replica_id].healthy

        def no_card():
            raise RuntimeError("CUDA error: the card is gone")
        agent.server.health_check = no_card
        with pytest.raises(ConnectionError, match="unhealthy"):
            PredictorClient(agent.host, agent.port).health()
        router.refresh()
        assert not router.replicas[agent.replica_id].healthy
    finally:
        router.close()
        agent.stop(drain=False)


def test_corpse_is_reaped_and_a_live_lease_vetoes(fleet_flags, monitored):
    s = store()
    sk = socket.socket()
    sk.bind(("127.0.0.1", 0))
    dead_port = sk.getsockname()[1]
    sk.close()
    s.set("fleet:fleet:replica:3", json.dumps(
        {"host": "127.0.0.1", "port": dead_port, "pid": 0, "ts": 0.0}))
    agent = _agent(s)
    router = FleetRouter(s)
    try:
        t0 = time.monotonic()
        router.refresh()            # 16 ids, 15 missing: no blocking get
        assert time.monotonic() - t0 < 5.0
        assert 3 in router.replicas and not router.replicas[3].healthy
        wait_until(lambda: router.refresh() or 3 not in router.replicas,
                   timeout=5.0, poll=0.1)
        assert s.get("fleet:fleet:replica:3") == b""
        router.refresh()
        assert 3 not in router.replicas
        assert monitor.snapshot()["counters"]["fleet.replicas_reaped"] == 1
        h = router.replicas[agent.replica_id]
        h.healthy = False
        h.detected_dead_at = time.monotonic() - 60.0
        assert router._reap_if_corpse(h) is False
    finally:
        router.close()
        agent.stop(drain=False)


# ---- tenants: the HBM budget, isolation, canary rollouts -------------------

def _weight_factory(arrays, meta):
    w = float(np.asarray(arrays["w"]).ravel()[0])
    if meta.get("poison"):
        def bad(x):
            raise RuntimeError("poisoned model version")
        return bad
    return lambda x: x * w


def _tenant(name, dirname, w, nbytes=None, poison=False):
    if guard_state_version(str(dirname)) == 0:
        save_guard_state(str(dirname),
                         {"w": np.full(((nbytes or 4) // 4,), w,
                                       np.float32)}, {"poison": poison})
    return ModelTenant(name, str(dirname), _weight_factory,
                       engine_config=EngineConfig(**CFG),
                       slo=SloPlane(latency_ms=1000, target=0.9),
                       bytes_hint=nbytes)


def test_hbm_budget_and_tenant_isolation(tmp_path, fleet_flags, monitored):
    s = store()
    agent = _agent(s, hbm_budget_bytes=1000)
    router = FleetRouter(s).start()
    try:
        agent.host_model(_tenant("a", tmp_path / "a", 2.0, nbytes=600))
        agent.host_model(_tenant("b", tmp_path / "b", 3.0, nbytes=600))
        assert "a" not in agent.tenants and "b" in agent.tenants
        with pytest.raises(HBMBudgetExceededError):
            agent.host_model(_tenant("c", tmp_path / "c", 4.0, nbytes=2000))
        assert "b" in agent.tenants
        snap = monitor.snapshot()
        assert snap["counters"]["fleet.models_evicted"] == 1
        assert snap["gauges"]["mem.model.b.bytes"] == 600
        assert snap["gauges"]["mem.model.a.bytes"] == 0
        bad = agent.host_model(_tenant("bad", tmp_path / "x", 1.0,
                                       nbytes=100, poison=True))
        router.refresh()
        st, out = router.run(_ones(2), deadline_ms=3000, model="b")
        assert st == 0
        np.testing.assert_allclose(out[0], 3.0)
        st, msg = router.run(_ones(2), deadline_ms=3000, model="bad")
        assert st == 1 and "poisoned" in msg
        assert bad.slo.stats()["bad"] >= 1
        assert agent.tenants["b"].slo.stats()["bad"] == 0
        st, msg = router.run(_ones(2), deadline_ms=3000, model="ghost")
        assert st == 1 and "unknown model" in msg
        hbm = PredictorClient(agent.host, agent.port).health()["hbm"]
        assert hbm == {"budget_bytes": 1000, "used_bytes": 700}
    finally:
        router.close()
        agent.stop(drain=False)


@pytest.mark.parametrize("poison", [False, True],
                         ids=["promoted", "rolled_back"])
def test_canary_rollout(tmp_path, fleet_flags, monitored, poison):
    s = store()
    d = tmp_path / "model"
    agents = []
    for _ in range(2):
        a = _agent(s)
        a.host_model(_tenant("m", d, 3.0))
        agents.append(a)
    router = FleetRouter(s, slo=SloPlane(latency_ms=1000,
                                         target=0.9)).start()
    try:
        router.refresh()
        canary = router.healthy_replicas()[0].replica_id
        res = router.rollout("m", str(d),
                             {"w": np.full((1,), 9.0 if poison else 5.0,
                                           np.float32)},
                             {"poison": poison},
                             probes=[_ones(2)] * 6)
        st, out = router.run(_ones(2), deadline_ms=3000, model="m")
        assert st == 0
        counters = monitor.snapshot()["counters"]
        if poison:
            assert res.rolled_back and not res.promoted
            assert res.canary_burn > 1.0 and res.canary == canary
            assert guard_state_version(str(d)) == 1
            np.testing.assert_allclose(out[0], 3.0)
            assert all(a.tenants["m"].version == 1 for a in agents
                       if a.replica_id != canary)
            assert counters["fleet.rollbacks"] == 1
            assert router.slo.stats()["bad"] == 0
        else:
            assert res.promoted and res.version == 2
            assert all(a.tenants["m"].version == 2 for a in agents)
            np.testing.assert_allclose(out[0], 5.0)
            assert counters["fleet.promotions"] == 1
    finally:
        router.close()
        [a.stop(drain=False) for a in agents]


# ---- observability -----------------------------------------------------------

def test_snapshot_render_and_cli_match_the_reference(tmp_path, fleet_flags,
                                                     capsys):
    assert fleet.render_fleet(None) == jfleet.render_fleet(None)
    assert "no fleet" in fleet.render_fleet({"replicas": {}})
    s = store()
    agents = [_agent(s) for _ in range(2)]
    router = FleetRouter(s, slo=SloPlane(latency_ms=1000,
                                         target=0.9)).start()
    try:
        router.run(_ones(), deadline_ms=3000)
        snap = router.snapshot()
        assert set(snap["replicas"]) == {"0", "1"}
        text = fleet.render_fleet(snap)
        assert text == jfleet.render_fleet(snap)
        assert "2 replica(s)" in text and "ledger:" in text
        dump = router.dump(str(tmp_path / "fleet-dump.json"), reason="test")
        assert monitor._main(["fleet", dump]) == 0
        out = capsys.readouterr().out
        assert "replica(s)" in out and "settled=1" in out
        h = router.replicas[0]
        assert monitor._main(["fleet", "--probe", f"{h.host}:{h.port}"]) == 0
        out = capsys.readouterr().out
        assert "1 replica(s)" in out and " up " in out
    finally:
        router.close()
        [a.stop(drain=False) for a in agents]


# ---- the reference's chaos soak (slow tier): child processes ---------------

def _spawn_replica(s, fleet_name, tmp_path, tag, replica_id=None):
    port_file = str(tmp_path / f"replica-{tag}.port")
    env = dict(os.environ)
    if replica_id is not None:
        env["FLEET_REPLICA_ID"] = str(replica_id)
    proc = subprocess.Popen(
        [sys.executable, RUNNER, "replica", "127.0.0.1", str(s.port),
         fleet_name, port_file], stdin=subprocess.PIPE, env=env)
    deadline = time.monotonic() + 60
    while not os.path.exists(port_file):
        assert proc.poll() is None, "replica runner died during startup"
        assert time.monotonic() < deadline, "replica never registered"
        time.sleep(0.05)
    rid, host, port = open(port_file).read().split()
    return proc, int(rid)


@pytest.mark.slow
def test_sigkill_midburst_with_injected_resets(tmp_path, fleet_flags,
                                               monitored):
    """SIGKILL one of three child replicas under an 8-client burst with 5%
    injected dispatch resets, respawn it under its id: at most 1% errors,
    the ledger audits clean, the lock order holds."""
    s = store()
    procs = [_spawn_replica(s, "chaos", tmp_path, i) for i in range(3)]
    router = FleetRouter(s, fleet="chaos").start()
    outcomes, lock, stop = [], threading.Lock(), threading.Event()

    def client(i):
        k = 0
        while not stop.is_set():
            k += 1
            try:
                st, _ = router.run([np.full((1, 4), float(i * 1000 + k),
                                            np.float32)], deadline_ms=8000)
                with lock:
                    outcomes.append(st)
            except Exception as e:  # noqa: BLE001 — counted as an outcome
                with lock:
                    outcomes.append(repr(e))
    with port_flags(sync_watch=True, sync_order_fatal=True):
        syncwatch._reset()
        try:
            assert sorted(router.replicas) == [0, 1, 2]
            with faults.inject("router.dispatch:conn_reset:p=0.05:seed=3"):
                ts = [threading.Thread(target=client, args=(i,))
                      for i in range(8)]
                [t.start() for t in ts]
                time.sleep(1.0)
                victim, vid = procs[1]
                os.kill(victim.pid, signal.SIGKILL)
                t0 = time.monotonic()
                wait_until(lambda: vid not in [
                    h.replica_id for h in router.healthy_replicas()], 3.0)
                assert time.monotonic() - t0 < 3.0
                time.sleep(1.0)
                procs.append(_spawn_replica(s, "chaos", tmp_path, "again",
                                            replica_id=vid))
                wait_until(lambda: vid in [
                    h.replica_id for h in router.healthy_replicas()], 20.0)
                time.sleep(1.0)
                stop.set()
                [t.join(30) for t in ts]
            n, bad = len(outcomes), [o for o in outcomes if o != 0]
            assert n > 50 and len(bad) / n <= 0.01, (n, bad[:5])
            a = router.ledger.audit()
            assert a["lost"] == 0 and a["open"] == 0, a
            assert a["settled"] + a["rejected"] == a["issued"], a
            h = router.replicas[vid]
            st, out = PredictorClient(h.host, h.port).run(
                [np.ones((1, 4), np.float32)], deadline_ms=5000)
            assert st == 0
            np.testing.assert_allclose(out[0], 2.0)
            assert syncwatch.violations() == 0
        finally:
            stop.set()
            router.close()
            syncwatch._reset()
            for p, _ in procs:
                if p.poll() is None:
                    try:
                        p.stdin.write(b"done\n")
                        p.stdin.flush()
                        p.wait(timeout=30)
                    except Exception:
                        p.kill()
                        p.wait(timeout=10)
