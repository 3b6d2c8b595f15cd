"""`PredictorServer` / `PredictorClient` of the port on the CPU: every verb
of the wire ('PDRQ', 'PDRD' expiry, 'PDHQ', 'PDDR', 'PDMV', 'PDMQ'
routing), a 'PDSQ' stream against the reference's greedy decode on the
same weights, overload and an injected dispatch fault, the flight
recorder's overload dump, and the C client that `paddle_tpu_torch._native`
builds from `csrc/predict_capi.cpp`, driven through ctypes."""
import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.models.gpt import GPTModel as JGPTModel
import paddle_tpu_torch as pt
from paddle_tpu_torch import _native, monitor, obs
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.inference.server import PredictorClient, PredictorServer
from paddle_tpu_torch.obs import memory as mem
from paddle_tpu_torch.obs import trace
from paddle_tpu_torch.serving import (EngineConfig, LLMConfig, LLMEngine,
                                      ServingEngine)
from paddle_tpu_torch.utils import load_numpy_state, net, syncwatch

CFG = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=64, dropout=0.0)
WAIT = 30.0   # every socket wait, join and future wait here is bounded


@pytest.fixture(autouse=True, scope="module")
def _no_port_leak():
    before = {r["ident"] for r in syncwatch.live_threads()}
    depth = trace.active_depth()
    yield
    for _ in range(50):
        live = [r for r in syncwatch.live_threads()
                if r["ident"] not in before]
        if not live:
            break
        time.sleep(0.1)
    assert not live, [(r["name"], r["owner"]) for r in live]
    assert trace.active_depth() == depth


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture
def with_monitor():
    flags.set_flags({"monitor": True})
    monitor.reset()
    yield
    monitor.reset()
    flags.set_flags({"monitor": False})


def _double(x):
    return x * 2.0


def _server(predictor=_double, **cfg):
    cfg.setdefault("warmup_on_start", False)
    return PredictorServer(predictor,
                           engine_config=EngineConfig(**cfg)).start()


def _client(srv, **kw):
    return PredictorClient(srv.host, srv.port, timeout=WAIT, **kw)


def _x(n=4, seed=0):
    return np.random.default_rng(seed).random((1, n)).astype(np.float32)


class _Gate:
    """A predictor that parks every call until released, so a test can
    hold a batch on the device and fill the queue behind it."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def __call__(self, x):
        self.entered.set()
        assert self.release.wait(WAIT)
        return x + 1.0


def _run_async(client, x, **kw):
    out = {}
    t = threading.Thread(target=lambda: out.update(r=client.run([x], **kw)),
                         daemon=True)
    t.start()
    return t, out


def _wait_until(cond):
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.01)


# ---- the verbs ---------------------------------------------------------------

def test_request_health_drain_and_refused_connect(with_monitor):
    srv = _server()
    c = _client(srv)
    try:
        x = _x()
        status, outs = c.run([x])
        assert status == 0
        np.testing.assert_array_equal(outs[0], x * 2.0)
        status, outs = c.run([x], deadline_ms=WAIT * 1e3)   # 'PDRD'
        assert status == 0
        h = c.health(deadline_ms=WAIT * 1e3)
        assert h["counters"]["completed"] == 2 and h["running"]
        assert not h["draining"] and h["slo"] is None
        assert h["monitor"]["counters"]["serving.completed"] == 2
        report = _client(srv).drain(deadline_ms=WAIT * 1e3)
        assert report["drained"] and report["completed"]["default"] == 2
        with pytest.raises(OSError):
            socket.create_connection((srv.host, srv.port), timeout=2).close()
        # a live connection is told to go elsewhere, not served
        status, msg = c.run([x])
        assert status == net.STATUS_OVERLOADED and "draining" in msg
    finally:
        c.close()
        srv.stop()


def test_deadline_expiry_in_the_queue_is_status_3():
    """The engine's implicit deadline: the Python client's own 'PDRD'
    deadline would also end its local wait, so the queued request's
    expiry is read here with no client deadline (the C client's 'PDRD'
    expiry is below)."""
    gate = _Gate()
    srv = _server(gate, max_batch_size=1, default_deadline_ms=1000)
    a, b = _client(srv), _client(srv)
    try:
        t1, r1 = _run_async(a, _x())
        assert gate.entered.wait(WAIT)
        t2, r2 = _run_async(b, _x())
        _wait_until(lambda: srv.engine.stats()["queue_depth"] == 1)
        time.sleep(1.2)                      # the queued one expires
        gate.release.set()
        t1.join(WAIT)
        t2.join(WAIT)
        assert not t1.is_alive() and not t2.is_alive()
        assert r1["r"][0] == 0
        assert r2["r"][0] == net.STATUS_DEADLINE
        assert srv.engine.stats()["counters"]["expired"] == 1
    finally:
        gate.release.set()
        a.close()
        b.close()
        srv.stop()


def test_overload_is_status_2_and_dumps_the_flight_recorder(tmp_path):
    flags.set_flags({"obs_flight_recorder": True,
                     "obs_dump_dir": str(tmp_path),
                     "obs_dump_min_interval_s": 0.0})
    obs.reset()
    gate = _Gate()
    srv = _server(gate, max_batch_size=1, queue_depth=1)
    clients = [_client(srv) for _ in range(3)]
    try:
        t1, r1 = _run_async(clients[0], _x())
        assert gate.entered.wait(WAIT)
        t2, r2 = _run_async(clients[1], _x())
        _wait_until(lambda: srv.engine.stats()["queue_depth"] == 1)
        status, msg = clients[2].run([_x()])
        assert status == net.STATUS_OVERLOADED and "capacity" in msg
        gate.release.set()
        t1.join(WAIT)
        t2.join(WAIT)
        assert r1["r"][0] == 0 and r2["r"][0] == 0
        dumps = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
        assert len(dumps) == 1 and "serving_overload" in dumps[0]
        doc = json.load(open(tmp_path / dumps[0]))
        assert doc["reason"] == "serving_overload"
        assert doc["events"][-1]["event"] == "serving.overload"
    finally:
        gate.release.set()
        for c in clients:
            c.close()
        srv.stop()
        flags.set_flags({"obs_flight_recorder": False,
                         "obs_dump_dir": "flight_recorder",
                         "obs_dump_min_interval_s": 30.0})
        obs.reset()


def test_injected_dispatch_fault_is_status_1_then_0(with_monitor):
    srv = _server()
    c = _client(srv)
    flags.set_flags({"fault_inject": "serving.dispatch:error:times=1"})
    try:
        status, msg = c.run([_x()])
        assert status == net.STATUS_ERROR and "serving.dispatch" in msg
        status, outs = c.run([_x()])
        assert status == 0
        assert c.health()["counters"]["failed"] == 1
        assert monitor.snapshot()["counters"][
            "faults.injected.serving.dispatch"] == 1
    finally:
        flags.set_flags({"fault_inject": ""})
        c.close()
        srv.stop()


def test_model_routing_and_model_ctl():
    ctl = []
    srv = PredictorServer(_double, engine_config=EngineConfig(
        warmup_on_start=False), on_model_ctl=lambda req: ctl.append(req) or
        {"ok": True, "version": 3}).start()
    srv.register_model("plus", ServingEngine(
        lambda x: x + 10.0, EngineConfig(warmup_on_start=False)))
    c = _client(srv)
    try:
        x = _x()
        np.testing.assert_array_equal(c.run([x], model="plus")[1][0], x + 10)
        np.testing.assert_array_equal(c.run([x])[1][0], x * 2)
        status, msg = c.run([x], model="nope")
        assert status == net.STATUS_ERROR and "unknown model" in msg
        assert c.model_ctl("reload", "plus") == {"ok": True, "version": 3}
        assert ctl == [{"op": "reload", "model": "plus"}]
        assert c.health()["models"]["plus"]["counters"]["completed"] == 1
        srv.unregister_model("plus")
    finally:
        c.close()
        srv.stop()
    bare = _server()
    c = _client(bare)
    try:
        with pytest.raises(ConnectionError, match="not supported"):
            c.model_ctl("rollback", "x")
    finally:
        c.close()
        bare.stop()


def test_traced_request_is_one_complete_trace():
    trace.reset()
    flags.set_flags({"trace": True})
    srv = _server()
    c = _client(srv)
    try:
        assert c.run([_x()])[0] == 0
    finally:
        c.close()
        srv.stop()
        flags.set_flags({"trace": False})
    docs = trace.traces()
    assert len(docs) == 1
    spans = docs[0]["spans"]
    by = {s["name"]: s for s in spans}
    assert set(by) == {"client.send", "serving.request",
                       "serving.queue_wait", "serving.batch",
                       "serving.dispatch", "serving.reply"}
    ids = {s["span_id"] for s in spans}
    assert all(s["t1"] is not None for s in spans)
    assert all(s["parent_id"] in ids for s in spans
               if s["name"] != "client.send")
    req = by["serving.request"]["span_id"]
    assert by["serving.request"]["parent_id"] == by["client.send"]["span_id"]
    assert all(by[n]["parent_id"] == req for n in (
        "serving.queue_wait", "serving.batch", "serving.dispatch",
        "serving.reply"))
    trace.reset()


def test_slo_shed_and_census_tag_of_the_bucket_pool():
    class Pooled:
        """A predictor that keeps a device buffer per call, like a
        captured graph's static outputs."""

        def __init__(self):
            self.kept = []

        def __call__(self, x):
            self.kept.append(torch.from_numpy(x * 3.0))
            return self.kept[-1]

        def bucket_buffers(self):
            return self.kept

    flags.set_flags({"mem_census": True, "slo_latency_ms": 1e-6,
                     "slo_shed_burn": 1.0, "slo_windows": "60"})
    mem.reset()
    pred = Pooled()
    srv = _server(pred)
    c = _client(srv)
    try:
        assert c.run([_x()])[0] == 0          # slower than 1 ns: bad
        assert mem.census(publish=False)["tags"]["serving_bucket"][
            "bytes"] == 16
        h = c.health()
        assert h["slo"]["burn"]["60"] > 1.0 and h["slo"]["shedding"]
        status, msg = c.run([_x()])
        assert status == net.STATUS_OVERLOADED and "shedding" in msg
    finally:
        c.close()
        srv.stop()
        flags.set_flags({"mem_census": False, "slo_latency_ms": 0.0,
                         "slo_shed_burn": 0.0, "slo_windows": "60,300,3600"})
        mem.reset()


# ---- 'PDSQ' streaming through LLMEngine ---------------------------------------

@pytest.fixture(scope="module")
def lm_pair():
    paddle.seed(7)
    jlm = JGPTForCausalLM(JGPTModel(**CFG))
    jlm.eval()
    lm = pt.models.GPTForCausalLM(pt.models.GPTModel(**CFG))
    load_numpy_state(lm, {k: np.asarray(v._value)
                          for k, v in jlm.state_dict().items()})
    lm.eval()
    return jlm, lm


def _reference_greedy(jlm, prompt, tokens):
    """The reference's greedy decode condition: one full forward of the
    JAX model over prompt + tokens[:-1]; its argmax at every generated
    position is the next token."""
    seq = np.asarray([list(prompt) + list(tokens[:-1])], np.int32)
    logits = jlm(paddle.to_tensor(seq)).numpy()[0]
    return list(logits[len(prompt) - 1:].argmax(-1))


def test_stream_tokens_match_the_reference_greedy_decode(lm_pair):
    jlm, lm = lm_pair
    eng = LLMEngine(lm, LLMConfig(num_slots=2, max_len=48,
                                  max_new_tokens=12), device="cpu")
    srv = PredictorServer(_double, engine_config=EngineConfig(
        warmup_on_start=False), llm_engine=eng).start()
    c = _client(srv)
    try:
        prompt = [5, 17, 3, 8, 9, 1, 22]
        seen = []
        status, tokens = c.generate(prompt, 12, deadline_ms=WAIT * 1e3,
                                    on_token=lambda i, t: seen.append((i, t)))
        assert status == 0 and len(tokens) == 12
        assert seen == list(enumerate(tokens))     # in order, one per token
        assert [int(t) for t in _reference_greedy(jlm, prompt, tokens)] \
            == tokens
        st, direct = eng.submit(prompt, 12).result(WAIT)
        assert st == "done" and direct == tokens
        status, msg = c.generate(list(range(60)), 4)
        assert status == net.STATUS_ERROR and "bucket" in msg
        assert c.health()["llm"]["counters"]["completed"] == 2
    finally:
        c.close()
        srv.stop()
    no_llm = _server()
    c = _client(no_llm)
    try:
        status, msg = c.generate([1, 2], 2)
        assert status == net.STATUS_ERROR and "no llm engine" in msg
    finally:
        c.close()
        no_llm.stop()


# ---- the C client ------------------------------------------------------------

def test_c_client_built_from_csrc_gives_the_same_bytes():
    lib = _native.load()
    path = _native.library_path()
    assert os.path.exists(path) and "_native" + os.sep + "build" in path
    assert lib.PD_PredictorCreate.restype is not None
    srv = _server()
    c = _client(srv)
    try:
        x = np.random.default_rng(1).random((1, 3, 5)).astype(np.float32)
        rc, outs = _native.run(srv.host, srv.port, [x])
        status, want = c.run([x])
        assert rc == 0 and status == 0
        assert outs[0].tobytes() == want[0].tobytes()
        assert outs[0].shape == (1, 3, 5) and outs[0].dtype == np.float32
        rc, outs = _native.run(srv.host, srv.port, [x], deadline_ms=30000)
        assert rc == 0 and outs[0].tobytes() == want[0].tobytes()
        ids = np.arange(6, dtype=np.int64).reshape(1, 6)
        rc, outs = _native.run(srv.host, srv.port, [ids])
        assert rc == 0 and outs[0].dtype == np.float32   # x * 2.0
    finally:
        c.close()
        srv.stop()


def test_c_client_status_codes():
    gate = _Gate()
    srv = _server(gate, max_batch_size=1, queue_depth=1)
    a = _client(srv)
    try:
        t1, r1 = _run_async(a, _x())
        assert gate.entered.wait(WAIT)
        r2 = {}
        t2 = threading.Thread(target=lambda: r2.update(r=_native.run(
            srv.host, srv.port, [_x()], deadline_ms=50)), daemon=True)
        t2.start()
        _wait_until(lambda: srv.engine.stats()["queue_depth"] == 1)
        rc, msg = _native.run(srv.host, srv.port, [_x()])
        assert rc == 4 and "capacity" in msg          # overloaded
        time.sleep(0.1)
        gate.release.set()
        t1.join(WAIT)
        t2.join(WAIT)
        assert not t1.is_alive() and not t2.is_alive()
        assert r1["r"][0] == 0
        assert r2["r"][0] == 5 and "deadline" in r2["r"][1]   # expired
    finally:
        gate.release.set()
        a.close()
        srv.stop()
    with pytest.raises(ConnectionError):
        _native.run(srv.host, srv.port, [_x()])       # drained: refused
