"""The port's wire (`paddle_tpu_torch.utils.net`, the serving codec of
`inference.server`) against the reference's: every frame encodes to the
reference's bytes, each package's client talks to the other's server with
the same logits (a small GPT, its weights moved across by name), and the
HMAC token and the 'PDDL' deadline wire work in both directions."""
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import flags as jflags
from paddle_tpu.inference import server as jserver
from paddle_tpu.models.gpt import GPTForCausalLM as JGPTForCausalLM
from paddle_tpu.models.gpt import GPTModel as JGPTModel
from paddle_tpu.obs import trace as jtrace
from paddle_tpu.serving import EngineConfig as JEngineConfig
from paddle_tpu.utils import net as jnet
import paddle_tpu_torch as pt
from paddle_tpu_torch import monitor
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.inference import server
from paddle_tpu_torch.obs import trace
from paddle_tpu_torch.serving import EngineConfig
from paddle_tpu_torch.utils import load_numpy_state, net, syncwatch

CFG = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=2,
           max_seq_len=32, dropout=0.0)
# fp32 logits of the small GPT: XLA and PyTorch differ only in summation
# order (tests/test_torch_llm_serving.py observes <= 5e-6)
TOL = 1e-5
WAIT = 30.0   # every socket wait and join in this file is bounded


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


class _Sink:
    def __init__(self):
        self.data = b""

    def sendall(self, b):
        self.data += bytes(b)


def _encode(fn, *args):
    sink = _Sink()
    fn(sink, *args)
    return sink.data


def _both_flags(**values):
    """Context: the same flags set in both packages, restored after."""
    class _Ctx:
        def __enter__(self):
            self.old = {k: flags.flag(k) for k in values}
            self.jold = {k: jflags.flag(k) for k in values}
            flags.set_flags(values)
            jflags.set_flags(values)

        def __exit__(self, *exc):
            flags.set_flags(self.old)
            jflags.set_flags(self.jold)
            return False
    return _Ctx()


# ---- golden bytes: every frame ----------------------------------------------

_CTX = ("0123456789abcdef0123456789abcdef", "fedcba9876543210", 1)
_X = np.arange(12, dtype=np.float32).reshape(1, 3, 4)


def _frame_cases():
    def request(m):
        return lambda s: (s.sendall(struct.pack("<II", m._REQ_MAGIC, 2)),
                          m._write_tensor(s, _X),
                          m._write_tensor(s, np.arange(5, dtype=np.int64)))

    def deadline_request(m):
        return lambda s: (s.sendall(struct.pack(
            "<III", m._REQ_DEADLINE_MAGIC, 250, 1)),
            m._write_tensor(s, np.arange(3, dtype=np.int32)))

    def ok_response(m):
        return lambda s: (s.sendall(struct.pack("<IBI", m._RESP_MAGIC, 0, 1)),
                          m._write_tensor(s, _X * 2))

    def cast_response(m):   # float64 goes out as float32, as the codec says
        return lambda s: m._write_tensor(s, np.linspace(0, 1, 7))

    def trace_frame(n, t):
        return lambda s: n.send_trace_frame(s, t.TraceContext(*_CTX))

    return {
        "request": (request(server), request(jserver)),
        "deadline_request": (deadline_request(server),
                             deadline_request(jserver)),
        "ok_response": (ok_response(server), ok_response(jserver)),
        "cast_response": (cast_response(server), cast_response(jserver)),
        "status_error": (lambda s: net.send_status_frame(s, 1, "boom"),
                         lambda s: jnet.send_status_frame(s, 1, "boom")),
        "status_overloaded": (
            lambda s: net.send_status_frame(s, 2, b"full"),
            lambda s: jnet.send_status_frame(s, 2, b"full")),
        "status_deadline": (lambda s: net.send_status_frame(s, 3),
                            lambda s: jnet.send_status_frame(s, 3)),
        "trace_frame": (trace_frame(net, trace), trace_frame(jnet, jtrace)),
        "crc_telemetry": (
            lambda s: net.send_crc_frame(s, net.PDTM_MAGIC, b'{"op":1}'),
            lambda s: jnet.send_crc_frame(s, jnet.PDTM_MAGIC, b'{"op":1}')),
        "crc_ack": (lambda s: net.send_crc_frame(s, net.PDTA_MAGIC, b""),
                    lambda s: jnet.send_crc_frame(s, jnet.PDTA_MAGIC, b"")),
        "deadline_prefix": (lambda s: net.send_deadline(s, 102.5),
                            lambda s: jnet.send_deadline(s, 102.5)),
        "auth_records": (
            lambda s: net._AuthSocket(s, b"tok").sendall(b"x" * 70000),
            lambda s: jnet._AuthSocket(s, b"tok").sendall(b"x" * 70000)),
        "magics": (lambda s: s.sendall(struct.pack(
            "<9I", net.TRACE_MAGIC, net.DRAIN_MAGIC, net.MODEL_MAGIC,
            net.MODEL_CTL_MAGIC, net.STREAM_REQ_MAGIC, net.STREAM_MAGIC,
            net.AUTH_MAGIC, net.AUTH_REC_MAGIC, net.DEADLINE_MAGIC)),
            lambda s: s.sendall(struct.pack(
                "<9I", jnet.TRACE_MAGIC, jnet.DRAIN_MAGIC, jnet.MODEL_MAGIC,
                jnet.MODEL_CTL_MAGIC, jnet.STREAM_REQ_MAGIC,
                jnet.STREAM_MAGIC, jnet.AUTH_MAGIC, jnet.AUTH_REC_MAGIC,
                jnet.DEADLINE_MAGIC))),
    }


@pytest.mark.parametrize("frame", sorted(_frame_cases()))
def test_frame_bytes_equal_the_reference(frame, monkeypatch):
    monkeypatch.setattr(time, "monotonic", lambda: 100.0)
    mine, ref = _frame_cases()[frame]
    got, want = _encode(mine), _encode(ref)
    assert got and got == want


def test_decoders_read_the_reference_frames():
    raw = _encode(lambda s: jserver._write_tensor(s, _X))
    a, b = socket.socketpair()
    try:
        a.sendall(raw + jtrace.pack_ctx(jtrace.TraceContext(*_CTX)))
        got = server._read_tensor(b, time.monotonic() + WAIT)
        ctx = net.recv_trace_frame(b, time.monotonic() + WAIT)
    finally:
        a.close()
        b.close()
    np.testing.assert_array_equal(got, _X)
    assert ctx == trace.TraceContext(*_CTX)


def test_crc_frame_round_trip_and_corruption():
    a, b = socket.socketpair()
    try:
        jnet.send_crc_frame(a, jnet.PDTM_MAGIC, b"payload")
        assert net.recv_crc_frame(b, net.PDTM_MAGIC,
                                  time.monotonic() + WAIT) == b"payload"
        raw = _encode(lambda s: jnet.send_crc_frame(s, jnet.PDTM_MAGIC,
                                                    b"payload"))
        a.sendall(raw[:-1] + b"X")
        with pytest.raises(ValueError, match="checksum"):
            net.recv_crc_frame(b, net.PDTM_MAGIC, time.monotonic() + WAIT)
    finally:
        a.close()
        b.close()


def test_recv_exact_deadline_and_send_frames():
    a, b = socket.socketpair()
    try:
        with pytest.raises(TimeoutError):
            net.recv_exact(b, 4, time.monotonic() + 0.05)
        net.send_frames(a, [b"ab", bytearray(b"cd"), memoryview(b"ef"), b""])
        assert net.recv_exact(b, 6, time.monotonic() + WAIT) == b"abcdef"
    finally:
        a.close()
        b.close()


def _request_bytes(client_mod, **kw):
    """The byte stream `client_mod`'s PredictorClient sends for one
    request, read by a raw listener that answers a fixed response."""
    x = np.arange(8, dtype=np.float32).reshape(1, 8)
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    lsock.settimeout(WAIT)
    got = {}
    resp = _encode(lambda s: (s.sendall(struct.pack("<IBI", 0x50445253, 0,
                                                    1)),
                              jserver._write_tensor(s, x * 2.0)))

    def old_server():
        conn, _ = lsock.accept()
        conn.settimeout(WAIT)
        buf = b""
        want = len(_encode(lambda s: (
            s.sendall(struct.pack("<II", 0, 1)),
            jserver._write_tensor(s, x)))) + (4 if "deadline_ms" in kw
                                              else 0)
        while len(buf) < want:
            chunk = conn.recv(want - len(buf))
            if not chunk:
                break
            buf += chunk
        got["bytes"] = buf
        conn.sendall(resp)
        conn.close()

    t = threading.Thread(target=old_server, daemon=True)
    t.start()
    c = client_mod.PredictorClient(*lsock.getsockname(), timeout=WAIT)
    try:
        status, outs = c.run([x], **kw)
    finally:
        c.close()
        lsock.close()
        t.join(WAIT)
    assert not t.is_alive()
    assert status == 0
    np.testing.assert_array_equal(outs[0], x * 2.0)
    return got["bytes"]


@pytest.mark.parametrize("kw", [{}, {"deadline_ms": 5000}],
                         ids=["PDRQ", "PDRD"])
def test_client_request_bytes_equal_the_reference_clients(kw):
    assert _request_bytes(server, **kw) == _request_bytes(jserver, **kw)


# ---- clients and servers across the packages --------------------------------

@pytest.fixture(scope="module")
def gpt_pair():
    paddle.seed(7)
    jlm = JGPTForCausalLM(JGPTModel(**CFG))
    jlm.eval()
    lm = pt.models.GPTForCausalLM(pt.models.GPTModel(**CFG))
    load_numpy_state(lm, {k: np.asarray(v._value)
                          for k, v in jlm.state_dict().items()})
    lm.eval()

    def port_fn(ids):
        with torch.no_grad():
            return lm(torch.from_numpy(np.asarray(ids))).numpy()

    def ref_fn(ids):
        return jlm(paddle.to_tensor(np.asarray(ids))).numpy()

    return port_fn, ref_fn


def _servers(gpt_pair):
    port_fn, ref_fn = gpt_pair
    srv = server.PredictorServer(port_fn, engine_config=EngineConfig(
        max_batch_size=1, warmup_on_start=False)).start()
    jsrv = jserver.PredictorServer(ref_fn, engine_config=JEngineConfig(
        max_batch_size=1, warmup_on_start=False)).start()
    return srv, jsrv


def _ids(seed):
    return np.random.default_rng(seed).integers(
        0, 64, (1, 32)).astype(np.int32)


def test_clients_and_servers_interoperate_both_ways(gpt_pair):
    srv, jsrv = _servers(gpt_pair)
    clients = []
    try:
        cross = server.PredictorClient(jsrv.host, jsrv.port, timeout=WAIT)
        jcross = jserver.PredictorClient(srv.host, srv.port, timeout=WAIT)
        own = server.PredictorClient(srv.host, srv.port, timeout=WAIT)
        clients = [cross, jcross, own]
        for seed in range(3):
            ids = _ids(seed)
            s1, ref_logits = cross.run([ids])        # port -> reference
            s2, port_logits = jcross.run([ids])      # reference -> port
            s3, own_logits = own.run([ids])
            assert (s1, s2, s3) == (0, 0, 0)
            assert port_logits[0].shape == (1, 32, 64)
            np.testing.assert_allclose(port_logits[0], ref_logits[0],
                                       rtol=TOL, atol=TOL)
            np.testing.assert_array_equal(own_logits[0], port_logits[0])
        h, jh = jcross.health(deadline_ms=WAIT * 1e3), \
            cross.health(deadline_ms=WAIT * 1e3)
        assert h["counters"]["completed"] == 6
        assert jh["counters"]["completed"] == 3
        bad = jserver.PredictorClient(srv.host, srv.port, timeout=WAIT)
        clients.append(bad)
        # longer than max_seq_len: the model's error reaches the client
        status, msg = bad.run([np.zeros((1, 40), np.int32)])
        assert status == 1 and msg
    finally:
        for c in clients:
            c.close()
        srv.stop()
        jsrv.stop()


def test_trace_frame_rides_between_the_packages(gpt_pair):
    srv, jsrv = _servers(gpt_pair)
    trace.reset()
    jtrace.reset()
    try:
        with _both_flags(trace=True):
            c = server.PredictorClient(jsrv.host, jsrv.port, timeout=WAIT)
            jc = jserver.PredictorClient(srv.host, srv.port, timeout=WAIT)
            try:
                assert c.run([_ids(0)])[0] == 0
                assert jc.run([_ids(1)])[0] == 0
            finally:
                c.close()
                jc.close()
            mine, ref = trace.traces(), jtrace.traces()
    finally:
        srv.stop()
        jsrv.stop()
    # each side holds the client span of its own request and the server
    # spans of the other package's, under ONE trace id per request
    roots = {d["trace_id"] for d in mine
             if any(s["name"] == "client.send" for s in d["spans"])}
    jroots = {d["trace_id"] for d in ref
              if any(s["name"] == "client.send" for s in d["spans"])}
    served = {d["trace_id"] for d in mine
              if any(s["name"] == "serving.request" for s in d["spans"])}
    jserved = {d["trace_id"] for d in ref
               if any(s["name"] == "serving.request" for s in d["spans"])}
    assert roots == jserved and jroots == served and len(roots) == 1
    names = {s["name"] for d in mine for s in d["spans"]
             if d["trace_id"] in served}
    assert {"serving.request", "serving.queue_wait", "serving.batch",
            "serving.dispatch", "serving.reply"} <= names
    trace.reset()
    jtrace.reset()


@pytest.mark.parametrize("direction", ["port_client", "reference_client"])
def test_hmac_token_and_deadline_wire_both_ways(gpt_pair, direction):
    flags.set_flags({"monitor": True})
    monitor.reset()
    with _both_flags(net_auth_token="s3cret", net_deadline_wire=True):
        srv, jsrv = _servers(gpt_pair)
        try:
            if direction == "port_client":
                mod, host, port = server, jsrv.host, jsrv.port
            else:
                mod, host, port = jserver, srv.host, srv.port
            c = mod.PredictorClient(host, port, timeout=WAIT)
            try:
                status, outs = c.run([_ids(2)], deadline_ms=WAIT * 1e3)
                assert status == 0 and outs[0].shape == (1, 32, 64)
                assert c.health(deadline_ms=WAIT * 1e3)["running"]
            finally:
                c.close()
            # a peer without the token is refused and counted
            raw = socket.create_connection((host, port), timeout=WAIT)
            try:
                raw.sendall(struct.pack("<II", net.AUTH_MAGIC, 0)
                            + b"\0" * 28)
                assert raw.recv(1) in (b"\x00", b"")
            finally:
                raw.close()
            # an already-expired 'PDDL' deadline is dropped, not computed
            sock = (net if mod is server else jnet).dial((host, port),
                                                         timeout=WAIT)
            try:
                sock.sendall(struct.pack("<Id", net.DEADLINE_MAGIC, -1.0))
                sock.settimeout(WAIT)
                with pytest.raises(OSError):   # the server hung up
                    sock.recv(64)
            finally:
                sock.close()
        finally:
            srv.stop()
            jsrv.stop()
    c = monitor.snapshot()["counters"]
    flags.set_flags({"monitor": False})
    monitor.reset()
    if direction == "reference_client":      # the port's server counted
        assert c["net.auth_rejects"] >= 1
        assert c["net.serving.auth_rejects"] >= 1
        assert c["net.deadline_drops"] == 1


def test_retry_substrate_counts_and_gives_up():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionResetError("reset")
        return "ok"

    flags.set_flags({"monitor": True})
    monitor.reset()
    try:
        assert net.call_with_retry(flaky, plane="t", backoff_s=0.001) == "ok"
        with pytest.raises(ConnectionRefusedError):
            net.call_with_retry(
                lambda: (_ for _ in ()).throw(ConnectionRefusedError()),
                plane="t", max_retries=1, backoff_s=0.001)
        c = monitor.snapshot()["counters"]
    finally:
        flags.set_flags({"monitor": False})
        monitor.reset()
    assert c["net.retries"] == 3 and c["net.t.retries"] == 3
    lsock = net.make_listener("127.0.0.1", 0)
    port = lsock.getsockname()[1]
    lsock.close()
    with pytest.raises(server.ReplicaConnectError):
        server.PredictorClient("127.0.0.1", port, max_retries=1,
                               backoff_ms=1.0, connect_timeout=1.0)
    assert os.environ.get("FLAGS_net_auth_token") is None
