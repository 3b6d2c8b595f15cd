"""The SLO-driven autoscaler (`serving/autoscaler.py`) against the
reference on the CPU.

`ScalePolicy` is pure decision math: the same seeded sequence of fleet
signals and clock readings gives the reference's decisions exactly
(action, delta, reason and evidence), and so do the reference's own
table-driven traces. Beside that, the reference's cases on the port: the
decision ledger, the pool's scale-out / graceful scale-in, a spawn that
faults or never answers, a victim dying mid-drain, the control loop's
bootstrap, its worst-source sensing, spawn exhaustion with its one alert,
the idle tenant's eviction, the loop thread and its dump, a drill that
scales out under a queue spike and back in with tiny flags, and the
autoscale bench arm. The reference's chaos drill is the slow tier here
too."""
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

from paddle_tpu.serving import autoscaler as jautoscaler
import paddle_tpu_torch as pt
from paddle_tpu_torch import faults, monitor
from paddle_tpu_torch.guard import save_guard_state
from paddle_tpu_torch.obs import telemetry
from paddle_tpu_torch.obs.slo import SloPlane, burn_from_gauges
from paddle_tpu_torch.serving import (Autoscaler, DecisionLedger,
                                      EngineConfig, FleetRouter,
                                      ModelTenant, ReplicaAgent,
                                      ReplicaPool, ScalePolicy)

from torch_fleet_parity import (FAST_FLEET, check_no_leak, port_flags,
                                store, wait_until)

CFG = dict(max_batch_size=8, batch_timeout_ms=1.0, warmup_on_start=False)
POLICY = dict(burn_high=1.0, burn_low=0.25, queue_high=0.8, queue_low=0.2,
              min_replicas=1, max_replicas=4, cooldown_s=5.0,
              idle_after_s=10.0, zero_after_s=30.0, step=1)
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


def _sig(**kw):
    base = {"burn": 0.0, "queue_frac": 0.0, "actual": 2,
            "alive_sources": 2, "pending": 0}
    base.update(kw)
    return base


def _both(**kw):
    """The port's and the reference's policy with the same settings."""
    return (ScalePolicy(**{**POLICY, **kw}),
            jautoscaler.ScalePolicy(**{**POLICY, **kw}))


def _run(policies, trace):
    """Feed (signal, now) pairs to each policy; the decisions as tuples."""
    out = []
    for p in policies:
        out.append([(d.action, d.delta, d.reason, d.evidence)
                    for d in (p.decide(s, now=t) for s, t in trace)])
    return out


def _spawn_fn(s, handler=None, **cfg):
    def spawn():
        agent = ReplicaAgent(handler or (lambda x: x * 2.0), s,
                             engine_config=EngineConfig(**{**CFG, **cfg}))
        try:
            return agent.start()
        except BaseException:
            agent.stop(drain=False)
            raise
    return spawn


def _source(burn=0.0, queue=0, role="replica", alive=True):
    return {"counters": {}, "histograms": {}, "meta": {},
            "gauges": {"slo.burn.60s": burn, "serving.queue_depth": queue},
            "role": role, "alive": alive}


# ---- the policy: a seeded signal sequence and the reference's traces ------

@pytest.mark.parametrize("min_replicas", [0, 1, 2])
def test_policy_decisions_equal_the_reference_on_a_seeded_trace(
        min_replicas):
    rng = np.random.default_rng(min_replicas)
    trace, t = [], 0.0
    for block in range(20):          # calm stretches between hot ones
        calm = block % 2 == 0
        actual = int(rng.integers(0, 6))
        for _ in range(int(rng.integers(10, 40))):
            t += float(rng.choice([0.25, 1.0, 3.0]))
            trace.append((_sig(
                burn=float(rng.uniform(0, 0.2) if calm else
                           rng.uniform(0, 3.0)),
                queue_frac=float(rng.uniform(0, 0.15) if calm else
                                 rng.uniform(0, 1.2)),
                actual=actual,
                alive_sources=int(rng.integers(0, 3) if not calm or
                                  rng.random() < 0.05 else 2),
                pending=int(rng.integers(0, 3))), t))
    mine, ref = _run(_both(min_replicas=min_replicas, step=2), trace)
    assert mine == ref
    assert {d[0] for d in mine} == {"hold", "out", "in"}


TRACES = {
    "burn_spike": (dict(), [(_sig(burn=5.0), float(t)) for t in range(11)]),
    "queue_then_burn": (dict(), [(_sig(queue_frac=0.9), 0.0),
                                 (_sig(burn=2.0, queue_frac=0.9), 6.0)]),
    "hysteresis": (dict(), [(_sig(burn=0.5), float(t)) for t in range(100)]
                   + [(_sig(), 100.0)]),
    "idle": (dict(), [(_sig(), float(t)) for t in range(25)]),
    "blip": (dict(), [(_sig(), float(t)) for t in range(9)]
             + [(_sig(burn=0.5), 9.0)]
             + [(_sig(), float(t)) for t in range(10, 21)]),
    "to_zero": (dict(min_replicas=0),
                [(_sig(actual=2), float(t)) for t in range(11)]
                + [(_sig(actual=1), float(t)) for t in range(11, 41)]),
    "blind": (dict(), [(_sig(), float(t)) for t in range(9)]
              + [(_sig(alive_sources=0), float(t)) for t in range(9, 20)]
              + [(_sig(), 20.0)]),
    "bootstrap": (dict(min_replicas=2),
                  [(_sig(actual=0, alive_sources=0), 0.0)]),
    "cold_start": (dict(min_replicas=0),
                   [(_sig(actual=0, alive_sources=0), 0.0),
                    (_sig(actual=0, alive_sources=0, pending=3), 1.0)]),
    "at_max": (dict(step=3), [(_sig(burn=9.0, actual=4), 0.0),
                              (_sig(burn=9.0, actual=3), 1.0)]),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_policy_traces_match_the_reference(name):
    kw, trace = TRACES[name]
    mine, ref = _run(_both(**kw), trace)
    assert mine == ref
    acts = [(i, d[0], d[2]) for i, d in enumerate(mine) if d[0] != "hold"]
    if name == "burn_spike":
        assert acts == [(0, "out", "burn_high"), (5, "out", "burn_high"),
                        (10, "out", "burn_high")]
    elif name == "idle":
        assert acts == [(10, "in", "sustained_idle"),
                        (20, "in", "sustained_idle")]
    elif name == "to_zero":
        assert acts == [(10, "in", "sustained_idle"),
                        (40, "in", "scale_to_zero")]
    elif name == "at_max":
        assert mine[0][2] == "at_max" and mine[1][:2] == ("out", 1)


def test_burn_from_gauges_and_the_ledger(monitored):
    assert burn_from_gauges({"slo.burn.60s": 2.5,
                             "slo.burn.300s": 1.0}) == 2.5
    assert burn_from_gauges(None) == 0.0
    assert burn_from_gauges({"slo.burn.xs": 1.0, "other": 3}) == 0.0
    snaps = []
    for led in (DecisionLedger(ring=4), jautoscaler.DecisionLedger(ring=4)):
        for i in range(10):
            led.record("out", 1, "burn_high", {"burn": float(i)},
                       "spawned:0", target=2, actual=1)
        led.record("in", -1, "sustained_idle", {}, "drained", 1, 1)
        snap = led.snapshot()
        snaps.append(([{k: v for k, v in e.items() if k != "ts"}
                       for e in snap["decisions"]], snap["counts"],
                      snap["recorded"]))
    assert snaps[0] == snaps[1]
    assert snaps[0][1] == {"out": 10, "in": 1} and snaps[0][2] == 11
    c = monitor.snapshot()["counters"]
    assert c["autoscaler.decisions.out"] == 10
    assert c["autoscaler.decisions.in"] == 1


# ---- the actuator --------------------------------------------------------

def test_pool_scales_out_then_in_and_reaps_failed_spawns(fleet_flags,
                                                         monitored):
    s = store()
    router = FleetRouter(s)
    pool = ReplicaPool(router, _spawn_fn(s), spawn_timeout_s=10.0)
    try:
        res = pool.scale_out(2)
        assert res["failed"] == 0 and len(res["ok"]) == 2
        assert pool.actual() == 2 and set(pool.handles) == set(res["ok"])
        (r,) = pool.scale_in(1)
        assert r["outcome"] == "drained"
        assert s.get(f"fleet:fleet:replica:{r['replica']}") == b""
        assert s.get(f"fleet:fleet:lease:{r['replica']}") == b""
        router.refresh()
        assert pool.actual() == 1 and pool.drained == 1
        # the survivor dies between being picked and its 'PDDR'
        (rid,) = list(pool.handles)
        pool.handles[rid].server.stop(drain=False)
        assert [x["outcome"] for x in pool.scale_in(1)] == \
            ["died_during_drain"]
        assert rid not in router.replicas
        with faults.inject("replica.register:error"):
            res = pool.scale_out(1)
        assert res["ok"] == [] and "InjectedFault" in res["why"][0]
        c = monitor.snapshot()["counters"]
        assert c["autoscaler.spawned"] == 2 and c["autoscaler.drained"] == 2
        assert c["autoscaler.spawn_failures"] == 1
    finally:
        pool.stop_all()
        router.close()


def test_never_healthy_spawn_is_reaped_record_and_all(fleet_flags):
    s = store()
    router = FleetRouter(s)
    sk = socket.socket()
    sk.bind(("127.0.0.1", 0))
    dead_port = sk.getsockname()[1]
    sk.close()

    class Corpse:
        replica_id = 5
        stopped = False

        def stop(self, drain=True):
            self.stopped = True
    corpse = Corpse()

    def spawn():
        s.set("fleet:fleet:replica:5", json.dumps(
            {"host": "127.0.0.1", "port": dead_port, "pid": 0, "ts": 0.0}))
        return corpse
    pool = ReplicaPool(router, spawn, spawn_timeout_s=0.6)
    try:
        res = pool.scale_out(1)
        assert res["ok"] == [] and res["why"] == ["never_healthy"]
        assert corpse.stopped and 5 not in router.replicas
        assert s.get("fleet:fleet:replica:5") == b""
        router.refresh()
        assert 5 not in router.replicas
    finally:
        pool.stop_all()
        router.close()


# ---- the control loop ------------------------------------------------------

def test_bootstrap_and_worst_source_sensing(fleet_flags):
    s = store()
    router = FleetRouter(s)
    pool = ReplicaPool(router, _spawn_fn(s), spawn_timeout_s=10.0)
    col = telemetry.TelemetryCollector(s)     # never started
    col.sources["replica-0"] = _source(burn=0.4, queue=2)
    col.sources["replica-1"] = _source(burn=0.4, queue=4)
    col.sources["trainer-0"] = _source(burn=9.0, role="trainer")
    col.sources["replica-9"] = _source(burn=9.0, alive=False)
    auto = Autoscaler(col, pool, policy=ScalePolicy(**{
        **POLICY, "cooldown_s": 0.0}), interval_s=999.0, queue_capacity=10)
    try:
        sig = auto._sense()
        assert sig["burn"] == pytest.approx(0.4)
        assert sig["alive_sources"] == 2 and sig["actual"] == 0
        assert sig["queue_frac"] == pytest.approx(6 / 20)
        auto.collector = None
        d = auto.tick(now=0.0)
        assert (d.action, d.reason) == ("out", "below_min")
        assert pool.actual() == 1 and auto.target == 1
        assert auto.ledger.last()["outcome"].startswith("spawned:")
        assert auto.tick(now=1.0).action == "hold"
    finally:
        auto.close()
        router.close()


def test_spawn_exhaustion_blocks_alerts_once_and_recovers(fleet_flags,
                                                          monitored):
    s = store()
    router = FleetRouter(s)
    col = telemetry.TelemetryCollector(s)     # never started
    col.sources["replica-0"] = _source(burn=5.0)

    def broken():
        raise RuntimeError("substrate down")
    pool = ReplicaPool(router, broken, spawn_timeout_s=1.0)
    auto = Autoscaler(col, pool, policy=ScalePolicy(**{
        **POLICY, "min_replicas": 0, "cooldown_s": 0.0}), interval_s=999.0)
    try:
        for t in range(auto._spawn_retries + 2):
            auto.tick(now=float(t))
        assert auto._blocked_reason == "spawn_budget_exhausted"
        alerts = [a for a in col.alerts() if a["rule"] == "scale_blocked"]
        assert len(alerts) == 1
        assert len([e for e in col.events if e.get("kind") == "alert"]) == 1
        text = telemetry.render_top(col.snapshot_doc())
        assert "BLOCKED: spawn_budget_exhausted" in text
        pool._spawn = _spawn_fn(s)
        assert auto.tick(now=100.0).action == "out"
        assert pool.actual() == 1 and auto._blocked_reason is None
        assert not [a for a in col.alerts() if a["rule"] == "scale_blocked"]
    finally:
        auto.close()
        router.close()


def test_idle_tenant_eviction_and_the_loop_thread(tmp_path, fleet_flags,
                                                  monitored):
    s = store()
    agent = _spawn_fn(s)()
    router = FleetRouter(s)
    pool = ReplicaPool(router, _spawn_fn(s))
    with port_flags(autoscaler_tenant_idle_s=5.0):
        auto = Autoscaler(None, pool, policy=ScalePolicy(**POLICY),
                          interval_s=999.0)
        try:
            d = str(tmp_path / "m")
            save_guard_state(d, {"w": np.ones((4,), np.float32)}, {})
            tenant = ModelTenant("m", d, lambda arrays, meta:
                                 (lambda x: x * arrays["w"]),
                                 engine_config=EngineConfig(**CFG),
                                 slo=SloPlane(latency_ms=1000, target=0.9))
            agent.host_model(tenant)
            tenant.last_used = time.monotonic() - 100.0
            router.refresh()
            auto.tick(now=0.0)
            assert "m" not in agent.tenants
            router.refresh()
            auto.tick(now=1.0)
            assert monitor.snapshot()["counters"][
                "autoscaler.tenants_evicted"] == 1
        finally:
            auto.close()
    auto = Autoscaler(None, pool, policy=ScalePolicy(**{
        **POLICY, "min_replicas": 0}), interval_s=0.05).start()
    try:
        wait_until(lambda: auto.ticks > 0, timeout=5.0)
        auto.ledger.record("out", 1, "burn_high", {"burn": 2.0},
                           "spawned:0", 1, 1)
        doc = json.load(open(auto.dump(str(tmp_path / "dump.json"))))
        led = doc["extra"]["autoscaler"]["ledger"]
        assert led["decisions"][-1]["reason"] == "burn_high"
        assert doc["extra"]["autoscaler"]["policy"]["max"] == 4
    finally:
        auto.close()
        agent.stop(drain=False)
        router.close()
    assert auto._closed and auto._thread is None


def test_a_queue_spike_scales_out_and_calm_scales_back_in(fleet_flags):
    """The drill with tiny flags: one replica whose handler takes 20 ms,
    eight clients push its queue past the threshold, the loop spawns a
    second; the clients stop and one idle second later it drains one."""
    s = store()
    with port_flags(monitor=True, telemetry=True, telemetry_interval_s=0.05):
        monitor.reset()

        def slow(x):
            time.sleep(0.02)
            return x * 2.0
        col = telemetry.TelemetryCollector(s, fleet="fleet").start()
        router = FleetRouter(s).start()
        # one request a batch: the clients' requests queue behind it
        pool = ReplicaPool(router, _spawn_fn(s, slow, max_batch_size=1),
                           spawn_timeout_s=10.0)
        auto = Autoscaler(col, pool, policy=ScalePolicy(
            burn_high=1e9, burn_low=0.0, queue_high=0.5, queue_low=0.2,
            min_replicas=1, max_replicas=2, cooldown_s=0.3,
            idle_after_s=1.0, zero_after_s=3600.0, step=1),
            interval_s=0.05, queue_capacity=1).start()
        stop = threading.Event()

        def client():
            while not stop.is_set():
                try:
                    router.run([np.ones((1, 4), np.float32)],
                               deadline_ms=8000)
                except Exception:  # noqa: BLE001 — the spike's own load
                    pass
        ts = []
        try:
            wait_until(lambda: pool.actual() == 1, timeout=10)
            ts = [threading.Thread(target=client) for _ in range(8)]
            [t.start() for t in ts]
            wait_until(lambda: pool.actual() == 2, timeout=10)
            stop.set()
            [t.join(30) for t in ts]
            monitor.gauge_set("serving.queue_depth", 0)
            # the scale-in decision, not a probe that failed under load
            wait_until(lambda: auto.ledger.snapshot()["counts"].get(
                "in", 0) >= 1 and pool.actual() == 1, timeout=10)
            counts = auto.ledger.snapshot()["counts"]
            assert counts["out"] >= 2 and counts["in"] >= 1
            a = router.ledger.audit()
            assert a["lost"] == 0 and a["open"] == 0, a
        finally:
            stop.set()
            [t.join(30) for t in ts]
            auto.close(stop_pool=True)
            router.close()
            col.stop()
            monitor.reset()


def test_autoscale_bench_arm_reports_the_references_keys():
    from paddle_tpu_torch.utils import bench
    r = bench.autoscale(big=False)
    assert set(r) == {"grew_to", "time_to_first_new_replica_ms",
                      "recovery_window_ms", "decisions", "requests_per_arm",
                      "ticks_on_arm", "serving_p99_us_off",
                      "serving_p99_us_on", "decision_loop_tax_pct"}
    assert r["grew_to"] >= 2 and r["ticks_on_arm"] > 0


# ---- the reference's chaos drill (slow tier): child processes -------------

class _Child:
    """A replica in its own process (tests/torch_fleet_runner.py)."""

    def __init__(self, s, fleet_name, tmp_path, tag):
        port_file = str(tmp_path / f"replica-{tag}.port")
        self.proc = subprocess.Popen(
            [sys.executable, RUNNER, "replica", "127.0.0.1", str(s.port),
             fleet_name, port_file], stdin=subprocess.PIPE,
            env=dict(os.environ, FLAGS_monitor="1", FLAGS_telemetry="1",
                     FLAGS_telemetry_interval_s="0.05",
                     FLEET_HANDLER_MS="20"))
        deadline = time.monotonic() + 60
        while not os.path.exists(port_file):
            assert self.proc.poll() is None, "replica died during startup"
            assert time.monotonic() < deadline, "replica never registered"
            time.sleep(0.05)
        self.replica_id = int(open(port_file).read().split()[0])

    def poll(self):
        return self.proc.poll()

    def kill(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGKILL)
            self.proc.wait(10)


@pytest.mark.slow
def test_spike_grows_pool_recovers_and_audits_clean(tmp_path, fleet_flags,
                                                    monitored):
    """Child-process replicas under a 16-client spike: the pool grows to
    its ceiling, the spike ends, an idle scale-in is recorded, a spawned
    victim is SIGKILLed mid-scale-in and the pool converges to its floor
    with the victim's record reaped; the ledger audits clean."""
    s = store()
    children = []
    with port_flags(telemetry=True, telemetry_interval_s=0.05):
        col = telemetry.TelemetryCollector(s, fleet="autoscale").start()
        router = FleetRouter(s, fleet="autoscale").start()

        def spawn():
            c = _Child(s, "autoscale", tmp_path, len(children))
            children.append(c)
            return c
        pool = ReplicaPool(router, spawn, spawn_timeout_s=60.0)
        auto = Autoscaler(col, pool, policy=ScalePolicy(
            burn_high=1e9, burn_low=0.0, queue_high=0.5, queue_low=0.2,
            min_replicas=1, max_replicas=3, cooldown_s=1.0,
            idle_after_s=2.0, zero_after_s=3600.0, step=1),
            interval_s=0.1, queue_capacity=1)
        stop, outcomes, lock, ts = threading.Event(), [], threading.Lock(), []

        def client():
            k = 0
            while not stop.is_set():
                k += 1
                try:
                    st, _ = router.run([np.full((1, 4), float(k),
                                                np.float32)],
                                       deadline_ms=8000)
                    with lock:
                        outcomes.append(st)
                except Exception as e:  # noqa: BLE001
                    with lock:
                        outcomes.append(repr(e))
        try:
            auto.start()
            wait_until(lambda: pool.actual() == 1 and children, timeout=60)
            floor = children[0].replica_id
            ts = [threading.Thread(target=client) for _ in range(16)]
            [t.start() for t in ts]
            wait_until(lambda: pool.actual() == 3, timeout=90)
            stop.set()
            [t.join(30) for t in ts]
            wait_until(lambda: auto.ledger.snapshot()["counts"].get(
                "in", 0) >= 1, timeout=60, poll=0.1)
            victim = [c for c in children if c.replica_id != floor and
                      c.poll() is None][0]
            victim.kill()
            wait_until(lambda: pool.actual() == 1, timeout=90, poll=0.1)
            wait_until(lambda: s.get(
                f"fleet:autoscale:replica:{victim.replica_id}") == b"",
                timeout=15, poll=0.1)
            assert victim.replica_id not in router.replicas
            n = len(outcomes)
            errors = [o for o in outcomes if not isinstance(o, int)]
            assert n > 100 and len(errors) / n <= 0.01, (n, errors[:5])
            a = router.ledger.audit()
            assert a["lost"] == 0 and a["open"] == 0, a
            assert a["settled"] + a["rejected"] == a["issued"], a
        finally:
            stop.set()
            [t.join(30) for t in ts]
            auto.close(stop_pool=True)
            for c in children:
                c.kill()
            router.close()
            col.stop()
