"""The fleet telemetry plane (`obs/telemetry.py`) against the reference on
the CPU.

Over the wire in both directions: the reference's exporter into the
port's collector and the port's exporter into the reference's carry the
same seeded counters, gauges, sketch and event, and the two collectors
give the same fleet table and `monitor top` text. Beside that, the
reference's own cases on the port: delta-compressed metrics with a
reconnect resync, events pushed at once, the drop-oldest buffer, the
push fault site, the reaper, the fleet-wide scrape, the top table's
straggler, the alert rules, the correlated incident, the router's push
fast path, `monitor top`, and the telemetry bench arm. The reference's two
SIGKILL drills are the slow tier here too."""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import monitor as jmonitor
from paddle_tpu.obs import telemetry as jtelemetry
import paddle_tpu_torch as pt
from paddle_tpu_torch import faults, monitor, obs
from paddle_tpu_torch.guard import RankDesyncError
from paddle_tpu_torch.obs import telemetry
from paddle_tpu_torch.serving import EngineConfig, FleetRouter, ReplicaAgent

from torch_fleet_parity import check_no_leak, port_flags, store, wait_until

CFG = dict(max_batch_size=8, batch_timeout_ms=1.0, warmup_on_start=False)
FAST = dict(telemetry=True, telemetry_interval_s=0.05)
RUNNER = os.path.join(os.path.dirname(__file__), "torch_fleet_runner.py")


@pytest.fixture(autouse=True)
def _no_leak():
    pt.set_device("cpu")
    yield
    check_no_leak()


@pytest.fixture()
def monitored():
    monitor.reset()
    with port_flags(monitor=True):
        yield monitor
    monitor.reset()


def _fill(mon, seed=5):
    """The same seeded counters, gauges and latency sketch in a monitor."""
    rng = np.random.default_rng(seed)
    mon.count("serving.requests", 40)
    mon.gauge_set("serving.queue_depth", 3)
    mon.gauge_set("slo.burn.2s", 0.5)
    mon.gauge_set("slo.burn.10s", 0.25)
    mon.gauge_set("mem.live_bytes", 3e6)
    for x in rng.lognormal(np.log(0.01), 0.3, 500):
        mon.observe("serving.e2e_latency", float(x))


def _doc_rows(doc):
    return [{k: v for k, v in r.items() if k != "qps"}
            for r in doc["sources"]]


def test_telemetry_rides_between_the_packages():
    """The reference's exporter feeds the port's collector and the port's
    exporter the reference's: both collectors hold the same source record,
    the same event, and give the same fleet table and top text."""
    s = store()
    paddle.set_flags({"FLAGS_monitor": True})
    jmonitor.reset()
    monitor.reset()
    col = jcol = exp = jexp = None
    try:
        with port_flags(monitor=True):
            _fill(monitor)
            _fill(jmonitor)
            col = telemetry.TelemetryCollector(s, fleet="pt").start()
            jcol = jtelemetry.TelemetryCollector(s, fleet="jx").start()
            jexp = jtelemetry.TelemetryExporter(
                s, source="replica-0", role="replica", fleet="pt",
                meta={"replica_id": 0}, interval_s=0.05).start()
            exp = telemetry.TelemetryExporter(
                s, source="replica-0", role="replica", fleet="jx",
                meta={"replica_id": 0}, interval_s=0.05).start()
            for e in (exp, jexp):
                e.event("rollout", model="m", version=2)
            for c in (col, jcol):
                wait_until(lambda: any(ev["kind"] == "rollout"
                                       for ev in c.events) and
                           c.sources.get("replica-0", {}).get(
                               "histograms"), timeout=10)
            rec, jrec = col.sources["replica-0"], jcol.sources["replica-0"]
            for k in ("counters", "gauges", "histograms", "role", "meta",
                      "alive"):
                assert rec[k] == jrec[k], k
            ev = [e for e in col.events if e["kind"] == "rollout"][0]
            jev = [e for e in jcol.events if e["kind"] == "rollout"][0]
            assert ev["detail"] == jev["detail"] == {"model": "m",
                                                     "version": 2}
            doc = telemetry.query_collector(col.host, col.port)
            jdoc = jtelemetry.query_collector(jcol.host, jcol.port)
            assert _doc_rows(doc) == _doc_rows(jdoc)
            row = doc["sources"][0]
            assert row["queue"] == 3 and row["burn"] == 0.5
            assert row["p99_s"] > 0 and row["hbm_bytes"] == 3e6
            for d in (doc, jdoc):
                d["fleet"], d["events"] = "f", []
                for r in d["sources"]:
                    r["qps"] = 0.0
            assert telemetry.render_top(doc) == jtelemetry.render_top(jdoc)
            assert telemetry.render_top(jdoc) == jtelemetry.render_top(doc)
    finally:
        for x in (exp, jexp, col, jcol):
            if x is not None:
                x.stop()
        paddle.set_flags({"FLAGS_monitor": False})
        jmonitor.reset()
        monitor.reset()


def test_metrics_flow_delta_compressed_with_reconnect_resync(monitored):
    s = store()
    with port_flags(**FAST):
        col = telemetry.TelemetryCollector(s, fleet="wp").start()
        exp = telemetry.TelemetryExporter(
            s, source="replica-0", role="replica", fleet="wp",
            meta={"replica_id": 0}).start()
        try:
            monitor.count("reqs", 5)
            monitor.observe("serving.e2e_latency", 0.02)
            wait_until(lambda: col.sources.get("replica-0", {})
                       .get("counters", {}).get("reqs") == 5)
            monitor.count("reqs", 2)            # ships as a delta of 2
            wait_until(lambda: col.sources["replica-0"]["counters"]["reqs"]
                       == 7)
            exp._chan.sock.close()   # a reconnect resends absolutes
            monitor.count("reqs", 1)
            wait_until(lambda: col.sources["replica-0"]["counters"]["reqs"]
                       == 8)
            assert exp.reconnects >= 1
            hist = col.sources["replica-0"]["histograms"][
                "serving.e2e_latency"]
            assert hist["count"] == 1 and "bins" in hist
        finally:
            exp.stop()
            col.stop()


def test_events_push_at_once_and_the_buffer_drops_oldest(monitored):
    s = store()
    with port_flags(telemetry=True, telemetry_interval_s=30.0):
        col = telemetry.TelemetryCollector(s, fleet="ev").start()
        exp = telemetry.TelemetryExporter(s, source="ps-0", role="ps",
                                          fleet="ev").start()
        try:
            t0 = time.monotonic()
            exp.event("role_change", role="primary")
            wait_until(lambda: any(e["kind"] == "role_change"
                                   for e in col.events), timeout=5.0)
            assert time.monotonic() - t0 < 5.0      # not the 30 s tick
            ev = [e for e in col.events if e["kind"] == "role_change"][0]
            assert ev["source"] == "ps-0" and ev["detail"] == {
                "role": "primary"}
        finally:
            exp.stop()
            col.stop()
    with port_flags(telemetry=True, telemetry_interval_s=0.05,
                    telemetry_buffer=4):
        exp = telemetry.TelemetryExporter(s, source="replica-0",
                                          fleet="void").start()
        try:
            for i in range(10):
                exp.event("drain", seq=i)

            def newest_kept():
                with exp._lock:
                    return [e["detail"]["seq"] for e in exp._events] == \
                        [6, 7, 8, 9]
            wait_until(newest_kept, timeout=5.0)
            assert exp.dropped >= 6
            assert monitor.snapshot()["counters"]["telemetry.dropped"] >= 6
        finally:
            exp.stop()


def test_push_fault_site_buffers_and_the_reaper_declares_death(monitored):
    s = store()
    with port_flags(telemetry=True, telemetry_interval_s=0.05,
                    telemetry_death_after_s=0.4):
        col = telemetry.TelemetryCollector(s, fleet="ft").start()
        exp = telemetry.TelemetryExporter(s, source="replica-0", fleet="ft",
                                          meta={"replica_id": 0}).start()
        try:
            wait_until(lambda: "replica-0" in col.sources)
            with faults.inject("telemetry.push:error"):
                exp.event("drain", replica_id=0)
                time.sleep(0.3)
                assert not any(e["kind"] == "drain" for e in col.events)
            wait_until(lambda: any(e["kind"] == "drain" for e in col.events))
            # the faulted pushes dropped the connection (an EOF death);
            # wait until the source is back, then wedge it: the socket
            # stays open, so only the reaper's silence backstop can act
            wait_until(lambda: col.sources["replica-0"]["alive"])
            deaths = sum(e["kind"] == "death" for e in col.events)
            exp.interval_s = 3600.0
            wait_until(lambda: sum(e["kind"] == "death" for e in col.events)
                       > deaths, timeout=5.0)
            assert col.sources["replica-0"]["alive"] is False
        finally:
            exp.stop()
            col.stop()


def _three_source_collector(s, fleet, mon_mod, tel_mod):
    col = tel_mod.TelemetryCollector(s, fleet=fleet).start()
    rng = np.random.default_rng(5)
    pooled = []
    for i in range(3):
        scale = 10.0 if i == 2 else 1.0    # source 2 is the straggler
        xs = rng.lognormal(np.log(0.01 * scale), 0.3, 2000)
        pooled.append(xs)
        h = mon_mod.Histogram("serving.e2e_latency")
        for x in xs:
            h.observe(float(x))
        snap = {"counters": {"serving.requests": 100 * (i + 1)},
                "gauges": {"serving.queue_depth": i, "slo.burn.2s": 0.1,
                           "slo.burn.10s": 0.05,
                           "mem.live_bytes": (i + 1) * 1e6},
                "histograms": {"serving.e2e_latency": h.sketch_payload()}}
        col._on_hello(f"replica-{i}", i + 1,
                      {"role": "replica", "pid": 1000 + i,
                       "meta": {"replica_id": i}})
        col._on_metrics(f"replica-{i}", dict(snap, full=True))
    return col, np.concatenate(pooled)


def test_scrape_top_table_and_cli_match_the_reference(monitored, capsys):
    s = store()
    col, pooled = _three_source_collector(s, "scr", monitor, telemetry)
    jcol, _ = _three_source_collector(s, "jscr", jmonitor, jtelemetry)
    try:
        txt = col.scrape()
        assert txt == jcol.scrape()
        assert txt.count("# TYPE paddle_tpu_serving_requests counter") == 1
        q99 = [ln for ln in txt.splitlines() if ln.startswith(
            'paddle_tpu_serving_e2e_latency_q{quantile="0.99"}')]
        est, true = float(q99[0].split()[-1]), float(np.quantile(pooled,
                                                                 0.99))
        assert abs(est - true) / true <= 0.011
        rows, jrows = col.fleet_table(), jcol.fleet_table()
        assert rows == jrows
        assert [r["straggler"] for r in rows] == [False, False, True]
        assert rows[0]["burn"] == pytest.approx(0.1)
        doc = telemetry.query_collector(col.host, col.port)
        text = telemetry.render_top(doc)
        assert "*straggler*" in text and "3 sources, 3 alive" in text
        assert monitor._main(["top", f"{col.host}:{col.port}"]) == 0
        out = capsys.readouterr().out
        assert "replica-2" in out and "*straggler*" in out
    finally:
        col.stop()
        jcol.stop()


def test_alert_rules_fire_once_per_transition_as_the_reference(monitored):
    s = store()
    seen = []
    for mod in (telemetry, jtelemetry):
        col = mod.TelemetryCollector(s, fleet=f"al-{mod.__name__}").start()
        try:
            col.add_rule("deep_queue", "serving.queue_depth", 10.0)
            col._on_hello("replica-0", 1, {"role": "replica", "pid": 1,
                                           "meta": {}})
            calm = {"full": True, "counters": {}, "histograms": {},
                    "gauges": {"serving.queue_depth": 2, "slo.burn.2s": 0.2,
                               "slo.burn.10s": 0.1}}
            trail = []
            for g in ({"serving.queue_depth": 2, "slo.burn.2s": 5.0,
                       "slo.burn.10s": 0.1},
                      {"serving.queue_depth": 50, "slo.burn.2s": 5.0,
                       "slo.burn.10s": 2.0},
                      {"serving.queue_depth": 50, "slo.burn.2s": 6.0,
                       "slo.burn.10s": 2.5}, calm["gauges"]):
                col._on_metrics("replica-0", dict(calm, gauges=g))
                trail.append((sorted(a["rule"] for a in col.alerts()),
                              len([e for e in col.events
                                   if e["kind"] == "alert"])))
            col.pool_update({"target": 3, "actual": 2, "blocked": True,
                             "blocked_reason": "spawn_budget_exhausted"})
            col.pool_update({"target": 3, "actual": 2, "blocked": True})
            trail.append(len([e for e in col.events
                              if e["kind"] == "alert"]))
            seen.append(trail)
        finally:
            col.stop()
    assert seen[0] == seen[1]
    assert seen[0][1] == (["deep_queue", "slo_burn"], 2)
    assert seen[0][3] == ([], 2) and seen[0][4] == 3


def test_correlated_incident_dumps_share_one_id(monitored, tmp_path,
                                                capsys):
    s = store()
    with port_flags(obs_flight_recorder=True, obs_dump_dir=str(tmp_path),
                    **FAST):
        obs.reset()
        col = telemetry.TelemetryCollector(s, fleet="inc").start()
        exps = [telemetry.TelemetryExporter(
            s, source=f"replica-{i}", fleet="inc",
            meta={"replica_id": i}).start() for i in range(3)]
        try:
            wait_until(lambda: len(col.sources) == 3)
            err = RankDesyncError(step=7, offenders=[1],
                                  fingerprints={0: "a", 1: "b"})
            assert obs.dump_on_error(err) is not None
            wait_until(lambda: len(col.incidents) == 1)
            iid = next(iter(col.incidents))
            wait_until(lambda: len(col.incidents[iid]["dumps"]) == 3,
                       timeout=10.0)
            inc = col.incidents[iid]
            assert sorted(d["source"] for d in inc["dumps"]) == [
                "replica-0", "replica-1", "replica-2"]
            docs = [json.load(open(d["path"])) for d in inc["dumps"]]
            assert {d["incident_id"] for d in docs} == {iid}
            obs.recorder()._last_dump.clear()
            obs.dump_on_error(RankDesyncError(step=8, offenders=[2],
                                              fingerprints={0: "a",
                                                            2: "c"}))
            time.sleep(0.3)
            assert len(col.incidents) == 1        # rate-limited: no storm
            assert monitor._main(["show"] + [d["path"]
                                             for d in inc["dumps"]]) == 0
            out = capsys.readouterr().out
            assert f"correlated incident {iid} (3 dumps):" in out
        finally:
            for e in exps:
                e.stop()
            col.stop()
            obs.reset()


def test_a_drain_event_reaches_the_router_through_the_collector(
        monitored):
    s = store()
    with port_flags(fleet_health_interval_s=30.0, fleet_lease_ttl_s=30.0,
                    fleet_heartbeat_s=0.2, **FAST):
        col = telemetry.TelemetryCollector(s, fleet="fp").start()
        agent = ReplicaAgent(lambda x: x * 2.0, s, fleet="fp",
                             engine_config=EngineConfig(**CFG)).start()
        router = FleetRouter(s, fleet="fp")
        try:
            router.refresh()          # no poll loop, no lease watcher
            router.attach_telemetry(col)
            assert router.replicas[agent.replica_id].healthy
            agent.stop(drain=True)
            wait_until(lambda: router.replicas[agent.replica_id].draining,
                       timeout=5.0)
        finally:
            router.close()
            agent.stop(drain=False)
            col.stop()


def test_telemetry_bench_arm_reports_the_references_keys():
    from paddle_tpu_torch.utils import bench
    # one intra-op thread: the arm's small CPU TrainStep gains nothing
    # from more, and beside other busy processes eight threads make each
    # step ~50x slower
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r = bench.telemetry(big=False)
    finally:
        torch.set_num_threads(threads)
    assert set(r) == {"train_steps_per_arm", "requests_per_arm",
                      "pushes_on_arm", "train_sps_off", "train_sps_on",
                      "train_tax_pct", "serving_p99_us_off",
                      "serving_p99_us_on", "serving_p99_tax_pct"}
    assert r["pushes_on_arm"] > 0 and r["train_sps_on"] > 0


# ---------------------------------------------------------------------------
# the reference's SIGKILL drills (slow tier): child processes
# ---------------------------------------------------------------------------

def _spawn(role, s, fleet, tmp_path, tag, env=None):
    port_file = str(tmp_path / f"{role}-{tag}.port")
    proc = subprocess.Popen(
        [sys.executable, RUNNER, role, "127.0.0.1", str(s.port), fleet,
         port_file], stdin=subprocess.PIPE,
        env=dict(os.environ, FLAGS_monitor="1", FLAGS_telemetry="1",
                 FLAGS_telemetry_interval_s="0.05", **(env or {})))
    deadline = time.monotonic() + 60
    while not os.path.exists(port_file):
        assert proc.poll() is None, f"{role} runner died during startup"
        assert time.monotonic() < deadline, f"{role} never came up"
        time.sleep(0.05)
    return proc, open(port_file).read().split()


def _reap(procs):
    for p in procs:
        if p.poll() is None:
            try:
                p.stdin.write(b"done\n")
                p.stdin.flush()
                p.wait(timeout=30)
            except Exception:
                p.kill()
                p.wait(timeout=10)


def _burst(router, stop, outcomes, lock, i):
    k = 0
    while not stop.is_set():
        k += 1
        try:
            st, _ = router.run([np.full((1, 4), float(i * 100 + k),
                                        np.float32)], deadline_ms=8000)
            with lock:
                outcomes.append(st)
        except Exception as e:  # noqa: BLE001 — counted as an outcome
            with lock:
                outcomes.append(repr(e))


@pytest.mark.slow
def test_sigkill_replica_push_beats_polling_exactly_once(tmp_path,
                                                         monitored):
    """Drill A: a SIGKILLed replica is marked dead through the collector's
    EOF-relayed death (no health loop, a 30 s lease), then the same under
    a burst: failover exactly once per the ledger audit."""
    s = store()
    with port_flags(fleet_health_interval_s=30.0, fleet_lease_ttl_s=30.0,
                    **FAST):
        col = telemetry.TelemetryCollector(s, fleet="chaosA").start()
        procs = [_spawn("replica", s, "chaosA", tmp_path, i)
                 for i in range(3)]
        router = FleetRouter(s, fleet="chaosA")
        stop, outcomes, lock = threading.Event(), [], threading.Lock()
        try:
            router.refresh()
            router.attach_telemetry(col)
            wait_until(lambda: len(col.sources) == 3, timeout=20.0)
            (p0, (r0, _, _)), (p1, (r1, _, _)) = procs[0], procs[1]
            t = time.monotonic()
            os.kill(p0.pid, signal.SIGKILL)
            wait_until(lambda: not router.replicas[int(r0)].healthy, 5.0)
            assert time.monotonic() - t < 1.0
            ts = [threading.Thread(target=_burst,
                                   args=(router, stop, outcomes, lock, i))
                  for i in range(4)]
            [x.start() for x in ts]
            time.sleep(0.7)
            os.kill(p1.pid, signal.SIGKILL)
            wait_until(lambda: not router.replicas[int(r1)].healthy, 5.0)
            time.sleep(0.7)
            stop.set()
            [x.join(30) for x in ts]
            n, bad = len(outcomes), [o for o in outcomes if o != 0]
            assert n > 30 and len(bad) / n <= 0.02, (n, bad[:3])
            a = router.ledger.audit()
            assert a["lost"] == 0 and a["open"] == 0, a
            assert a["settled"] + a["rejected"] == a["issued"], a
        finally:
            stop.set()
            router.close()
            col.stop()
            _reap([p for p, _ in procs])


@pytest.mark.slow
def test_sigkill_collector_midburst_costs_telemetry_not_serving(
        tmp_path, monitored):
    """Drill B: a SIGKILLed collector costs buffered events (counted), not
    one serving error; a restarted one is rediscovered through the
    store."""
    s = store()
    with port_flags(telemetry_buffer=4, fleet_health_interval_s=0.2,
                    fleet_heartbeat_s=0.2, fleet_lease_ttl_s=1.0, **FAST):
        cproc, _ = _spawn("collector", s, "chaosB", tmp_path, "first")
        c2 = None
        agents = [ReplicaAgent(lambda x: x * 2.0, s, fleet="chaosB",
                               engine_config=EngineConfig(**CFG)).start()
                  for _ in range(2)]
        router = FleetRouter(s, fleet="chaosB").start()
        stop, outcomes, lock = threading.Event(), [], threading.Lock()
        try:
            exps = [a._exporter for a in agents]
            wait_until(lambda: all(e.pushes > 0 for e in exps), 20.0)
            ts = [threading.Thread(target=_burst,
                                   args=(router, stop, outcomes, lock, i))
                  for i in range(4)]
            [x.start() for x in ts]
            time.sleep(0.5)
            before = len(outcomes)
            os.kill(cproc.pid, signal.SIGKILL)
            cproc.wait(timeout=10)
            for i in range(12):
                for e in exps:
                    e.event("drain", seq=i)
            time.sleep(1.0)
            assert sum(e.dropped for e in exps) > 0
            assert monitor.snapshot()["counters"]["telemetry.dropped"] > 0
            assert len(outcomes) > before + 20
            c2, (host, port) = _spawn("collector", s, "chaosB", tmp_path,
                                      "second")
            at = [e.pushes for e in exps]
            wait_until(lambda: all(e.pushes > p + 2
                                   for e, p in zip(exps, at)), 20.0)
            wait_until(lambda: len(telemetry.query_collector(host, int(port))
                                   .get("sources") or []) == 2, 20.0)
            stop.set()
            [x.join(30) for x in ts]
            n = len(outcomes)
            assert n > 50 and [o for o in outcomes if o not in (0, 2)] == []
            a = router.ledger.audit()
            assert a["lost"] == 0 and a["open"] == 0, a
        finally:
            stop.set()
            router.close()
            for ag in agents:
                ag.stop(drain=False)
            _reap([p for p in (cproc, c2) if p is not None])
