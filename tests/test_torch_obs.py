"""The observability plane of the port against the reference's: fault
injection's seeded hit sequence, the SLO burn rates, the trace context's
wire bytes and span tree, the step timeline's phase-sum invariant and the
memory census on a tiny TrainStep, the flight recorder's dump keys, the
Prometheus exposition, the syncwatch lock-order sanitizer, and the hooks
threaded through the optimizer, GradScaler and DataLoader."""
import json
import os
import statistics
import threading

import numpy as np
import pytest
import torch

from paddle_tpu import faults as jfaults
from paddle_tpu import monitor as jmonitor
from paddle_tpu import obs as jobs
from paddle_tpu.core import flags as jflags
from paddle_tpu.obs import slo as jslo
from paddle_tpu.obs import trace as jtrace
import paddle_tpu_torch as pt
from paddle_tpu_torch import faults, monitor, obs
from paddle_tpu_torch.core import executable as exe
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.obs import memory as mem
from paddle_tpu_torch.obs import slo, trace
from paddle_tpu_torch.utils import syncwatch


@pytest.fixture(autouse=True, scope="module")
def _no_port_leak():
    """The port's own registries: no thread it spawned and no span it
    opened outlives this file's tests."""
    before = {r["ident"] for r in syncwatch.live_threads()}
    depth = trace.active_depth()
    yield
    for _ in range(50):
        live = [r for r in syncwatch.live_threads()
                if r["ident"] not in before]
        if not live:
            break
        threading.Event().wait(0.1)
    assert not live, [(r["name"], r["owner"]) for r in live]
    assert trace.active_depth() == depth


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


def _flagged(**values):
    """Context: the port's flags set for the block, restored after."""
    class _Ctx:
        def __enter__(self):
            self.old = {k: flags.flag(k) for k in values}
            flags.set_flags(values)

        def __exit__(self, *exc):
            flags.set_flags(self.old)
            return False
    return _Ctx()


@pytest.fixture
def with_monitor():
    flags.set_flags({"monitor": True})
    monitor.reset()
    yield
    monitor.reset()
    flags.set_flags({"monitor": False})


@pytest.fixture
def with_obs(tmp_path):
    flags.set_flags({"obs_timeline": True, "obs_flight_recorder": True,
                     "obs_dump_dir": str(tmp_path / "dumps"),
                     "obs_dump_min_interval_s": 0.0})
    obs.reset()
    yield str(tmp_path / "dumps")
    flags.set_flags({"obs_timeline": False, "obs_flight_recorder": False,
                     "obs_dump_dir": "flight_recorder",
                     "obs_dump_min_interval_s": 30.0})
    obs.reset()


# ---- faults -----------------------------------------------------------------

_SPECS = ["serving.dispatch:error:p=0.3:seed=7",
          "net:conn_reset:p=0.5:seed=1:times=3:after=2",
          "llm.decode:timeout:seed=4:after=5;mem.alloc:error:p=0.25:seed=9",
          "net.serving.send:delay:p=0.4:seed=2:delay=0"]
_SITES = ["serving.dispatch", "net.serving.send", "net.serving.recv",
          "llm.decode", "mem.alloc", "other"]


def _hit_sequence(fmod, spec, n=60):
    out = []
    fmod.clear(flag_specs=False)      # per-site counts from this run only
    with fmod.inject(spec):
        for i in range(n):
            site = _SITES[i % len(_SITES)]
            try:
                fmod.check(site)
                out.append((site, None))
            except Exception as e:  # noqa: BLE001 — the injected kinds
                out.append((site, type(e).__name__))
        stats = fmod.stats()
    fmod.clear()
    return out, stats


@pytest.mark.parametrize("spec", _SPECS)
def test_faults_same_seeded_hit_sequence(spec):
    got, got_stats = _hit_sequence(faults, spec)
    want, want_stats = _hit_sequence(jfaults, spec)
    assert got == want
    assert got_stats == want_stats
    assert any(kind for _, kind in got) or "delay" in spec


def test_faults_grammar_mangle_and_counters(with_monitor):
    with pytest.raises(faults.FaultSpecError):
        faults.register("site_only")
    with pytest.raises(faults.FaultSpecError):
        faults.register("a:nope")
    with faults.inject("ckpt.write:torn:times=1"):
        assert faults.mangle("ckpt.write", b"abcdef") == b"abc"
        assert faults.mangle("ckpt.write", b"abcdef") == b"abcdef"
    with faults.inject("serving.dispatch:error:times=1"):
        with pytest.raises(faults.InjectedFault):
            faults.check("serving.dispatch")
        faults.check("serving.dispatch")
    assert not faults.enabled()
    c = monitor.snapshot()["counters"]
    assert c["faults.injected"] == 2
    assert c["faults.injected.serving.dispatch"] == 1
    faults.clear()


def test_fault_flag_arms_and_disarms():
    with _flagged(fault_inject="a.b:error:times=1"):
        assert faults.enabled() and faults.active()
        with pytest.raises(faults.InjectedFault):
            faults.check("a.b.c")
    assert not faults.enabled()
    faults.clear()


# ---- SLO --------------------------------------------------------------------

def test_slo_burn_rates_match_the_reference():
    rng = np.random.default_rng(0)
    outcomes = ["ok", "slow", "rejected", "deadline", "error"]
    events = [(1000.0 + float(t), outcomes[rng.integers(0, 5)]
               if rng.random() < 0.3 else "ok",
               float(rng.random() * 0.2))
              for t in np.sort(rng.random(400) * 400)]
    mine = slo.SloPlane(50.0, 0.99, [10, 60, 300], shed_burn=2.0)
    ref = jslo.SloPlane(50.0, 0.99, [10, 60, 300], shed_burn=2.0)
    for now, outcome, lat in events:
        assert mine.record(lat, outcome, now=now) == \
            ref.record(lat, outcome, now=now)
    for now in (1100.0, 1250.0, 1399.5, 1401.0):
        assert mine.burn_rates(now) == ref.burn_rates(now)
        assert mine.should_shed(now) == ref.should_shed(now)
        for w in (10, 60, 300):
            assert mine.window_counts(w, now) == ref.window_counts(w, now)
    a, b = mine.stats(now=1401.0), ref.stats(now=1401.0)
    for key in ("objective", "burn", "good", "bad", "bad_by_outcome",
                "shedding"):
        assert a[key] == b[key], key
    assert slo.render_slo(a).splitlines()[1] == \
        jslo.render_slo(b).splitlines()[1]


def test_slo_flag_wires_the_plane():
    assert not slo.enabled() and slo.stats() is None
    with _flagged(slo_latency_ms=5.0, slo_windows="2,30"):
        assert slo.enabled() and slo.plane().windows == [2, 30]
        assert slo.record_request(0.5) is True         # 500 ms: slow
        assert slo.stats()["bad_by_outcome"] == {"slow": 1}
    assert not slo.enabled()


# ---- trace ------------------------------------------------------------------

def test_trace_context_wire_bytes_match_the_reference():
    ctx = trace.TraceContext(trace.new_trace_id(), trace.new_span_id(), 3)
    raw = trace.pack_ctx(ctx)
    jctx = jtrace.TraceContext(ctx.trace_id, ctx.span_id, 3)
    assert len(raw) == trace.CTX_WIRE_LEN == 26
    assert raw == jtrace.pack_ctx(jctx)
    assert trace.unpack_ctx(jtrace.pack_ctx(jctx)) == ctx
    with pytest.raises(ValueError):
        trace.unpack_ctx(b"\x09" + raw[1:])


def test_trace_span_tree_and_parents():
    trace.reset()
    with _flagged(trace=True):
        with trace.span("client.send") as root:
            ctx = trace.context()
            srv = trace.server_span("serving.request", ctx)
            child = trace.server_span("serving.queue_wait", srv.ctx())
            child.end()
            bad = trace.server_span("serving.dispatch", srv.ctx())
            bad.end(status=trace.STATUS_ERROR, error="boom")
            srv.end()
            with trace.span("nested"):
                pass
        assert trace.server_span("x", None) is trace.NULL_SPAN
        docs = trace.traces()
    assert trace.active_depth() == 0
    assert len(docs) == 1
    doc = docs[0]
    assert doc["trace_id"] == root.trace_id and doc["status"] == "error"
    spans = {s["name"]: s for s in doc["spans"]}
    ids = {s["span_id"] for s in doc["spans"]}
    assert spans["client.send"]["parent_id"] is None
    assert spans["serving.request"]["parent_id"] == root.span_id
    assert spans["serving.queue_wait"]["parent_id"] == srv.span_id
    assert spans["nested"]["parent_id"] == root.span_id
    assert all(s["parent_id"] in ids for s in doc["spans"]
               if s["parent_id"] is not None)
    assert all(s["t1"] is not None for s in doc["spans"])
    assert trace.bad_traces()[0]["trace_id"] == root.trace_id
    ev = trace.trace_chrome_events(docs)
    assert {e["name"] for e in ev} == set(spans)
    trace.reset()


def test_trace_disabled_allocates_nothing():
    assert trace.span("a") is trace.NULL_SPAN
    assert trace.context() is None


# ---- timeline + census on a tiny TrainStep ----------------------------------

def _tiny_step(amp_dtype=None):
    pt.seed(0)
    model = pt.models.GPTForCausalLM(pt.models.GPTModel(
        vocab_size=128, hidden_size=64, num_layers=2, num_heads=2,
        max_seq_len=32, dropout=0.0))
    opt = pt.optimizer.AdamW(learning_rate=1e-3,
                             parameters=model.parameters())
    step = pt.jit.TrainStep(model, pt.models.GPTPretrainingCriterion(),
                            opt, amp_dtype=amp_dtype)
    ids = torch.from_numpy(
        np.random.default_rng(0).integers(0, 128, (2, 32)).astype(np.int32))
    return step, ids


def test_timeline_invariant_and_census_on_three_train_steps(with_obs,
                                                            with_monitor):
    with _flagged(mem_census=True):
        mem.reset()
        step, ids = _tiny_step("bfloat16")
        for _ in range(3):
            step(ids, ids)
        rec = mem.census()
    recs = obs.timeline().records()
    assert [r["step"] for r in recs] == [1, 2, 3]
    first = recs[0]["phases"]
    assert "build" in first and "trace_compile" in first
    for r in recs:
        assert sum(r["phases"].values()) <= r["wall"] * 1.02
    steady = recs[1:]
    assert all("device_compute" in r["phases"] and "h2d" in r["phases"]
               and "trace_compile" not in r["phases"] for r in steady)
    cov = statistics.median(sum(r["phases"].values()) / r["wall"]
                            for r in steady)
    assert 0.90 <= cov <= 1.02, cov
    for name in ("params", "opt_slots", "activations", "step_state"):
        assert rec["tags"][name]["bytes"] > 0, name
    params = sum(p.numel() * p.element_size()
                 for p in step.model.parameters())
    assert rec["tags"]["params"]["bytes"] == params
    assert rec["untagged_unknown"] == ["cpu"] and "other" not in rec["tags"]
    c = monitor.snapshot()["counters"]
    assert c["jit.train_step.steps"] == 3
    assert c["jit.train_step.builds"] == 1
    assert c["jit.train_step.traces"] == 1
    assert c["trace_compile.train_step"] == 1
    assert monitor.snapshot()["gauges"]["mem.params.bytes"] == params
    mem.reset()


def test_run_gives_one_step_record_per_step(with_obs):
    step, ids = _tiny_step()
    step.run(ids.expand(3, 2, 32).contiguous(),
             ids.expand(3, 2, 32).contiguous())
    recs = obs.timeline().records()
    assert len(recs) == 3
    assert all("device_compute" in r["phases"] for r in recs)
    # the span's upload happened before the first record opened
    assert "h2d" in recs[0]["between"]
    for r in recs:
        assert sum(r["phases"].values()) <= r["wall"] * 1.02


def test_census_keys_by_storage():
    with _flagged(mem_census=True):
        mem.reset()
        base = torch.zeros(1000)
        view, other = base[10:20], torch.ones(50)
        assert mem.tag("a", [base, view]) == 2
        mem.tag("b", {"x": [other]}, origin="test")
        rec = mem.census(publish=False, store=False)
        assert rec["tags"]["a"] == {"bytes": 4000, "count": 1,
                                    "devices": {"cpu": 4000}}
        assert rec["tags"]["b"]["bytes"] == 200
        assert mem.tag_of(view) == ("a", None)
        assert mem.top_buffers(1)[0]["tag"] == "a"
        del base, view
        assert "a" not in mem.census(publish=False, store=False)["tags"]
        assert mem.tag_of(other) == ("b", "test")
        mem.reset()
    assert mem.tag("c", [torch.zeros(3)]) == 0       # gate off


def test_executable_memory_normalizes_the_reference_keys():
    class Cap:
        def memory_analysis(self):
            return {"argument_size_in_bytes": 100,
                    "output_size_in_bytes": 10, "temp_size_in_bytes": 5,
                    "alias_size_in_bytes": 20,
                    "generated_code_size_in_bytes": 0}
    got = obs.executable_memory(Cap())
    assert got["peak_bytes"] == 95 and got["temp_bytes"] == 5
    assert obs.executable_memory(object()) == {}
    assert obs.roofline_gap({"flops": 989e12}, 2.0)["mfu"] == 0.5


def test_oom_dump_through_the_dispatch_guard(with_obs):
    with faults.inject("mem.alloc:error:times=1"):
        with pytest.raises(faults.InjectedFault) as ei:
            with exe.dispatch_guard("unit", report=lambda: {"x": 1}):
                pass
    faults.clear()
    doc = json.load(open(ei.value.dump_path))
    assert doc["reason"] == "oom"
    assert doc["extra"]["memory"]["executables"] == {"unit": {"x": 1}}


def test_booking_renames_and_suppresses_nested(with_obs, with_monitor):
    tl = obs.timeline()
    with tl.step_record():
        with exe.booking("k") as bk:
            bk.compiled()
            with exe.booking("inner"):
                pass
    rec = tl.records()[-1]
    assert set(rec["phases"]) == {"trace_compile"}
    assert monitor.snapshot()["counters"]["trace_compile.k"] == 1


# ---- flight recorder --------------------------------------------------------

def test_recorder_dump_keys_equal_the_reference(with_obs, tmp_path):
    assert obs.DUMP_SCHEMA == jobs.DUMP_SCHEMA
    mine = obs.FlightRecorder(obs.StepTimeline()).payload(extra={"a": 1})
    ref = jobs.FlightRecorder(jobs.StepTimeline()).payload(extra={"a": 1})
    assert set(mine) == set(ref)
    assert set(mine["monitor"]) == set(ref["monitor"])
    assert set(mine["memory"]) == set(ref["memory"])
    assert set(mine["traces"]) == set(ref["traces"])
    assert set(mine["sync"]) == set(ref["sync"])
    with obs.timeline().step_record():
        with obs.phase("device_compute"):
            pass
    path = obs.dump(path=str(tmp_path / "d.json"), reason="unit")
    doc = json.load(open(path))
    assert doc["schema"] == jobs.DUMP_SCHEMA and doc["steps"]
    events = obs.dump_to_chrome_events(doc)
    assert any(e["name"] == "device_compute" for e in events)
    assert monitor._main(["show", path]) == 0
    out = str(tmp_path / "t.json")
    assert monitor._main(["trace", path, "-o", out]) == 0
    assert json.load(open(out))["traceEvents"]


def test_concurrent_dumps_to_one_path_do_not_collide(with_obs, tmp_path):
    """The reference renames one shared `<path>.tmp`: three threads
    dumping one path in one millisecond lose files to each other
    (tests/test_obs.py's desync dump test, ROADMAP Queue 3)."""
    path = str(tmp_path / "same.json")
    errs = []

    def dump():
        try:
            obs.dump(path=path, reason="race")
        except OSError as e:
            errs.append(e)

    ts = [threading.Thread(target=dump) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert not errs and not any(t.is_alive() for t in ts)
    assert json.load(open(path))["reason"] == "race"
    assert os.listdir(tmp_path) == ["same.json"]


def test_overload_dump_is_rate_limited(with_obs):
    from paddle_tpu_torch.serving import ServerOverloadedError
    assert obs.trigger_reason(ServerOverloadedError) == "serving_overload"
    flags.set_flags({"obs_dump_min_interval_s": 60.0})
    a = obs.dump_on_error(ServerOverloadedError("full"))
    b = obs.dump_on_error(ServerOverloadedError("full"))
    assert a and os.path.exists(a) and b is None


# ---- monitor ----------------------------------------------------------------

def _record(mod):
    mod.count("serving.requests", 3)
    mod.count("span.a.b")
    mod.count("span.a_b", 2)
    mod.gauge_set("serving.queue_depth", 4)
    for v in (0.001, 0.02, 0.3, 2e-5, 0.02):
        mod.observe("serving.e2e_latency", v)
    mod.record_retrace("train_step", ("(2, 3):float32",), first=True)
    mod.record_retrace("train_step", ("(4, 3):float32",), first=False)


def test_prometheus_text_equals_the_reference(with_monitor):
    jflags.set_flags({"monitor": True})
    jmonitor.reset()
    try:
        _record(monitor)
        _record(jmonitor)
        assert monitor.prometheus_text() == jmonitor.prometheus_text()
        snaps = {"a": monitor.mergeable_snapshot(),
                 "b": monitor.mergeable_snapshot()}
        jsnaps = {"a": jmonitor.mergeable_snapshot(),
                  "b": jmonitor.mergeable_snapshot()}
        assert monitor.prometheus_text_multi(snaps) == \
            jmonitor.prometheus_text_multi(jsnaps)
        merged = monitor.merge_snapshots(snaps.values())
        assert merged["counters"]["serving.requests"] == 6
        assert merged["histograms"]["serving.e2e_latency"].count == 10
        assert monitor.events()[-1]["event"] == "jit.retrace"
    finally:
        jmonitor.reset()
        jflags.set_flags({"monitor": False})
    text = monitor.prometheus_text()
    names = [ln.split()[2] for ln in text.splitlines()
             if ln.startswith("# TYPE")]
    assert len(names) == len(set(names))


def test_monitor_cli_show_diff_slo(with_monitor, tmp_path, capsys):
    monitor.count("x", 1)
    a = monitor.export_json(str(tmp_path / "a.json"))
    monitor.count("x", 2)
    b = monitor.export_json(str(tmp_path / "b.json"))
    assert monitor._main(["show", a]) == 0
    assert monitor._main(["diff", a, b]) == 0
    assert monitor._main(["slo"]) == 0
    assert monitor._main(["threads"]) == 0
    out = capsys.readouterr().out
    assert "paddle_tpu_torch.monitor" in out and "+2" in out
    assert "no SLO configured" in out
    assert "x" in monitor.report()


# ---- syncwatch --------------------------------------------------------------

def test_syncwatch_catches_a_lock_order_inversion():
    syncwatch._reset()
    with _flagged(sync_watch=True):
        a, b = syncwatch.lock("A"), syncwatch.rlock("B")
        with a:
            with b:
                pass
        errs = []

        def inverted():
            try:
                with b:
                    with a:
                        pass
            except syncwatch.SyncOrderError as e:
                errs.append(e)

        t = syncwatch.Thread(target=inverted, name="inverter")
        t.start()
        t.join(10)
        assert not t.is_alive()
        assert len(errs) == 1 and errs[0].cycle == ["A", "B"]
        assert "lock-order cycle" in str(errs[0])
        assert syncwatch.order_edges() == {"A": ["B"]}
        assert syncwatch.violations() == 1
        assert syncwatch.dump_sync()["violations"] == 1
    assert isinstance(syncwatch.lock("C"), type(threading.Lock()))
    syncwatch._reset()


def test_syncwatch_registry_names_the_owner():
    done = threading.Event()
    t = syncwatch.Thread(target=done.wait, args=(10,), name="w")
    t.start()
    try:
        rows = [r for r in syncwatch.live_threads() if r["name"] == "w"]
        assert rows and rows[0]["owner"] == __name__
    finally:
        done.set()
        t.join(10)
    assert not t.is_alive()


# ---- hooks in the optimizer, GradScaler and DataLoader ----------------------

def test_optimizer_scaler_and_dataloader_hooks(with_monitor, with_obs):
    lin = pt.nn.Linear(4, 4)
    opt = pt.optimizer.SGD(learning_rate=0.1, parameters=lin.parameters())
    scaler = pt.amp.GradScaler(init_loss_scaling=2.0 ** 10,
                               incr_every_n_steps=1)
    x = torch.ones(2, 4)
    with obs.step_record():
        scaler.scale(lin(x).sum()).backward()
        scaler.step(opt)                      # finite: the scale grows
    opt.clear_grad()
    x_inf = x.clone()
    x_inf[0, 0] = float("inf")
    scaler.scale(lin(x_inf).sum()).backward()
    scaler.step(opt)                          # an inf grad: skipped
    c = monitor.snapshot()["counters"]
    assert c["optimizer.steps"] == 2
    assert c["amp.skipped_steps"] == 1
    assert c["amp.scale_updates"] == 1

    class DS(pt.io.Dataset):
        def __getitem__(self, i):
            return np.full((2,), i, np.float32)

        def __len__(self):
            return 8

    loader = pt.io.DataLoader(DS(), batch_size=2, num_workers=1,
                              use_buffer_reader=False)
    assert len(list(loader)) == 4
    h = monitor.snapshot()["histograms"]
    assert h["io.dataloader.queue_wait"]["count"] >= 4
    assert h["io.dataloader.worker_batch"]["count"] == 4
    assert "optimizer" in obs.timeline().records()[0]["phases"]
    with obs.step_record():
        pass
    assert "data_wait" in obs.timeline().records()[-1]["between"]
