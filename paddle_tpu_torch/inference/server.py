"""Predictor service — the server side of the C inference API.

Counterpart of `paddle_tpu/inference/server.py`, byte for byte on the
wire: C/Go apps (csrc/predict_capi.cpp, built by `paddle_tpu_torch.
_native`) and `PredictorClient` run inference against the process that
owns the card. Connection handler threads never run the Predictor
themselves: every request is submitted to `serving.ServingEngine`, which
coalesces concurrent requests into padded shape-bucket batches, enforces
deadlines and queue-depth backpressure, and drives the Predictor (a
captured CUDA graph per bucket for a loaded artifact) from its worker
loop. 'PDSQ' generation goes to `serving.LLMEngine`.

Wire protocol (little-endian), on top of csrc/predict_capi.cpp's framing:
  trace:     u32 'PDTC', 26-byte trace context (OPTIONAL prefix a tracing
             client sends immediately before its request frame; absence
             means "no trace" — untraced exchanges are byte-identical to
             the plain protocol)
  model:     u32 'PDMQ', u32 len, utf-8 model name (OPTIONAL prefix:
             routes the following request to a named hosted model;
             absence = the default model)
  request:   u32 'PDRQ', u32 n_tensors, tensors
  deadline:  u32 'PDRD', u32 deadline_ms, u32 n_tensors, tensors
  health:    u32 'PDHQ' (no body)
  drain:     u32 'PDDR' (no body) — graceful drain: the listening port
             closes, queued+in-flight work completes; answers status 0 +
             u32 len + JSON drain report
  model ctl: u32 'PDMV', u32 len, JSON {op: reload|rollback, model};
             answers status 0 + u32 len + JSON {ok, version, ...}
  stream:    u32 'PDSQ', u32 max_new_tokens, u32 deadline_ms (0 = none),
             u32 n_tensors (=1), one 1-D i32 prompt tensor — continuous-
             batching LLM generation (serving/llm.py, pass `llm_engine=`).
             Each generated token is pushed the moment the scheduler
             emits it as u32 'PDST' + u32 index + i32 token; the exchange
             then ends in a standard 'PDRS' frame (status 0 + the full
             token tensor, or error/overloaded/deadline + message)
  response:  u32 'PDRS', u8 status;
             status 0: u32 n_tensors + tensors ('PDHQ': u32 len + JSON)
             status 1 (error) / 2 (overloaded/draining, retryable) /
             status 3 (deadline expired): u32 len + utf-8 message

Tensors travel as f32 / i32 / i64 (a bf16 artifact's logits go out as
f32, as `Predictor.run_batch` reads them back).

Under `FLAGS_trace` one request produces one trace: the client's
`client.send` root span, the server's `serving.request` child carried
over by 'PDTC', the engine's queue_wait/batch/dispatch spans under it,
and `serving.reply` around the response write (obs/trace.py).
"""
from __future__ import annotations

import json
import random
import socket
import struct
import threading
import time
from typing import Dict, Optional

import numpy as np

# The serving codec reads/writes frames on connections the substrate
# (utils/net.py RpcChannel / secure_server) owns and hands out — those
# raw send/recv calls are the plane's wire format, not a bypass.

_REQ_MAGIC = 0x50445251       # 'PDRQ'
_REQ_DEADLINE_MAGIC = 0x50445244  # 'PDRD': u32 deadline_ms precedes count
_HEALTH_MAGIC = 0x50444851    # 'PDHQ': health/stats probe, no tensor body
_RESP_MAGIC = 0x50445253      # 'PDRS'
_DTYPES = {0: np.float32, 1: np.int32, 2: np.int64}
_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.int32): 1,
                np.dtype(np.int64): 2}
_MAX_NDIM = 8
_MAX_TENSOR_BYTES = 1 << 32  # sanity cap against corrupt headers
_MAX_NAME_LEN = 1 << 16      # cap on control-frame string bodies

from ..core import flags as _flags  # noqa: E402
from ..core.place import resolve_device  # noqa: E402
from ..obs import trace as _trace  # noqa: E402
from ..serving import (  # noqa: E402
    DeadlineExceededError, EngineConfig, EngineStoppedError,
    ServerOverloadedError, ServingEngine)
from ..utils import net as _net  # noqa: E402
from ..utils.net import (  # noqa: E402
    DRAIN_MAGIC as _DRAIN_MAGIC, MODEL_CTL_MAGIC as _MODEL_CTL_MAGIC,
    MODEL_MAGIC as _MODEL_MAGIC, STATUS_DEADLINE, STATUS_ERROR, STATUS_OK,
    STATUS_OVERLOADED, STREAM_MAGIC as _STREAM_MAGIC,
    STREAM_REQ_MAGIC as _STREAM_REQ_MAGIC, TRACE_MAGIC as _TRACE_MAGIC,
    recv_exact as _recv_exact, recv_trace_frame, send_status_frame,
    send_trace_frame)
from ..utils import syncwatch as _syncwatch  # noqa: E402
from .. import monitor as _monitor  # noqa: E402


def _read_tensor(conn, deadline: Optional[float] = None) -> np.ndarray:
    dt, ndim = struct.unpack("<II", _recv_exact(conn, 8, deadline))
    if dt not in _DTYPES or ndim > _MAX_NDIM:
        raise ValueError(f"bad tensor header dtype={dt} ndim={ndim}")
    dims = struct.unpack(f"<{ndim}q", _recv_exact(conn, 8 * ndim, deadline))
    dtype = _DTYPES[dt]
    if any(d < 0 for d in dims):
        raise ValueError(f"bad tensor dims {dims}")
    count = int(np.prod(dims)) if dims else 1
    nbytes = count * dtype().itemsize
    if nbytes > _MAX_TENSOR_BYTES:
        raise ValueError(f"tensor payload {nbytes} bytes exceeds cap")
    payload = _recv_exact(conn, nbytes, deadline)
    return np.frombuffer(payload, dtype).reshape(dims).copy()


def _write_tensor(conn, arr: np.ndarray):
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _DTYPE_CODES:
        arr = arr.astype(np.float32)
    conn.sendall(struct.pack("<II", _DTYPE_CODES[arr.dtype], arr.ndim)
                 + struct.pack(f"<{arr.ndim}q", *arr.shape)
                 + arr.tobytes())


class PredictorServer:
    """Serve a Predictor (or any callable of numpy arrays) over the C-API
    wire protocol, with the ServingEngine between connections and the
    card. Pass `engine=` to share a pre-configured engine, or
    `engine_config=` to tune the built-in one; the default reads the
    FLAGS_serving_* flags. Like every entry point of the port it serves
    from the current place: without a card it raises unless the CPU was
    asked for (`set_device('cpu')`)."""

    # handler threads park on the response future at most this long — a
    # wedged predictor must not leak handler threads forever
    _RESULT_TIMEOUT_S = 600.0
    # once a request's magic arrives, the REST of the frame must follow
    # within this budget — a client that stalls (not closes) mid-request
    # must not pin a handler thread forever (idle BETWEEN requests is
    # fine and unbounded)
    _READ_TIMEOUT_S = 60.0

    def __init__(self, predictor, host="127.0.0.1", port=0,
                 engine: Optional[ServingEngine] = None,
                 engine_config: Optional[EngineConfig] = None,
                 llm_engine=None, on_drain=None, on_model_ctl=None,
                 stats_extra=None, health_check=None):
        resolve_device()   # no card and no CPU request: raise here
        self.predictor = predictor
        self.engine = engine or ServingEngine(predictor, engine_config)
        # continuous-batching generation plane (serving/llm.py): serves
        # 'PDSQ' streaming requests when present; absent -> 'PDSQ' gets a
        # clean STATUS_ERROR and the batch protocol is untouched
        self.llm_engine = llm_engine
        # named hosted models (multi-model replicas): 'PDMQ'-selected
        # requests route to engines[name]; the unnamed default stays
        # `self.engine` so single-model callers are untouched
        self.engines: Dict[str, ServingEngine] = {}
        # hooks, all optional: `on_drain()` runs between the port closing
        # and the engines draining; `on_model_ctl(req: dict) -> dict`
        # answers 'PDMV'; `stats_extra() -> dict` is merged into the
        # 'PDHQ' payload; `health_check()` raising fails the 'PDHQ' probe
        # (an error status, so the fleet routes around the replica)
        self.on_drain = on_drain
        self.on_model_ctl = on_model_ctl
        self.stats_extra = stats_extra
        self.health_check = health_check
        self.drain_info: dict = {}  # merged into the 'PDDR' drain report
        self._sock = _net.make_listener(host, port, backlog=64)
        self.host, self.port = self._sock.getsockname()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._draining = False
        self._drain_lock = threading.Lock()

    def start(self):
        self.engine.start()
        if self.llm_engine is not None:
            self.llm_engine.start()
        self._thread = _syncwatch.Thread(target=self._serve, daemon=True,
                                        name="predictor-serve")
        self._thread.start()
        return self

    def register_model(self, name: str, engine: ServingEngine):
        """Host an additional named model; its engine is started here and
        drained with the server's own."""
        engine.start()
        self.engines[name] = engine
        return engine

    def unregister_model(self, name: str, drain: bool = True):
        eng = self.engines.pop(name, None)
        if eng is not None:
            eng.stop(drain=drain)

    def _engine_for(self, model: Optional[str]) -> Optional[ServingEngine]:
        if model is None:
            return self.engine
        return self.engines.get(model)

    def _serve(self):
        try:
            self._sock.settimeout(0.2)
        except OSError:
            return  # drained/stopped before this thread first ran
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                conn = _net.secure_server(conn, "serving")
            except (_net.AuthError, OSError, ValueError):
                continue  # unauthenticated/broken peer: counted + dropped
            _syncwatch.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle_one(self, conn) -> bool:
        """One request/response exchange; False = close the connection."""
        # recv_head strips any 'PDDL' deadline prefix: expired work is
        # dropped HERE (DeadlineExpiredError -> _handle closes the conn)
        # instead of computed.
        head, _req_deadline = _net.recv_head(conn, 4, plane="serving")
        magic, = struct.unpack("<I", head)
        tctx = None
        model: Optional[str] = None
        read_deadline = None
        # OPTIONAL prefix frames ('PDTC' trace, 'PDMQ' model select) in
        # any order, then the verb magic. The first prefix arms the
        # read deadline: once a multi-frame exchange starts, the rest
        # must follow promptly.
        while magic in (_TRACE_MAGIC, _MODEL_MAGIC):
            if read_deadline is None:
                read_deadline = time.monotonic() + self._READ_TIMEOUT_S
            if magic == _TRACE_MAGIC:
                tctx = recv_trace_frame(conn, read_deadline)
            else:
                ln, = struct.unpack("<I", _recv_exact(conn, 4,
                                                      read_deadline))
                if ln > _MAX_NAME_LEN:
                    return False  # corrupt header: unrecoverable stream
                model = _recv_exact(conn, ln, read_deadline).decode(
                    "utf-8", "replace")
            magic, = struct.unpack("<I", _recv_exact(conn, 4,
                                                     read_deadline))
        if magic == _HEALTH_MAGIC:
            if self.health_check is not None:
                try:
                    self.health_check()
                except Exception as e:
                    send_status_frame(conn, STATUS_ERROR,
                                      f"unhealthy: {type(e).__name__}: "
                                      f"{str(e)[:200]}")
                    return True
            stats = self.stats()
            payload = json.dumps(stats, default=str).encode()
            conn.sendall(struct.pack("<IB", _RESP_MAGIC, STATUS_OK)
                         + struct.pack("<I", len(payload)) + payload)
            return True
        if magic == _DRAIN_MAGIC:
            report = self.drain()
            payload = json.dumps(report, default=str).encode()
            conn.sendall(struct.pack("<IB", _RESP_MAGIC, STATUS_OK)
                         + struct.pack("<I", len(payload)) + payload)
            return False  # drained: nothing more to serve
        if magic == _MODEL_CTL_MAGIC:
            return self._handle_model_ctl(conn)
        if magic == _STREAM_REQ_MAGIC:
            rspan = _trace.server_span("serving.stream", tctx)
            try:
                keep = self._handle_stream(conn, rspan)
            except BaseException as e:
                rspan.end(status=_trace.STATUS_ERROR,
                          error=f"{type(e).__name__}: {str(e)[:200]}")
                raise
            rspan.end()
            return keep
        # serving.request: the server-side root of this request's trace,
        # parented on the client's wire context; closes with the same
        # status the wire response carries (absence of 'PDTC' -> no-op)
        rspan = _trace.server_span("serving.request", tctx)
        try:
            keep = self._handle_request(conn, magic, rspan, model)
        except BaseException as e:
            rspan.end(status=_trace.STATUS_ERROR,
                      error=f"{type(e).__name__}: {str(e)[:200]}")
            raise
        rspan.end()  # idempotent: error paths already set their status
        return keep

    def _handle_model_ctl(self, conn) -> bool:
        read_deadline = time.monotonic() + self._READ_TIMEOUT_S
        ln, = struct.unpack("<I", _recv_exact(conn, 4, read_deadline))
        if ln > _MAX_NAME_LEN:
            return False
        try:
            req = json.loads(_recv_exact(conn, ln, read_deadline).decode())
        except ValueError:
            send_status_frame(conn, STATUS_ERROR, "bad model-ctl body")
            return False
        if self.on_model_ctl is None:
            send_status_frame(conn, STATUS_ERROR,
                              "model control not supported here")
            return True
        try:
            resp = self.on_model_ctl(req)
        except Exception as e:
            send_status_frame(conn, STATUS_ERROR,
                              f"{type(e).__name__}: {str(e)[:300]}")
            return True
        payload = json.dumps(resp, default=str).encode()
        conn.sendall(struct.pack("<IB", _RESP_MAGIC, STATUS_OK)
                     + struct.pack("<I", len(payload)) + payload)
        return True

    def _handle_request(self, conn, magic, rspan,
                        model: Optional[str] = None) -> bool:
        read_deadline = time.monotonic() + self._READ_TIMEOUT_S
        deadline_ms = None
        if magic == _REQ_DEADLINE_MAGIC:
            dl, = struct.unpack("<I", _recv_exact(conn, 4, read_deadline))
            deadline_ms = float(dl) if dl else None
        elif magic != _REQ_MAGIC:
            rspan.end(status=_trace.STATUS_ERROR, error="bad magic")
            return False  # protocol violation: drop the connection
        n, = struct.unpack("<I", _recv_exact(conn, 4, read_deadline))
        try:
            inputs = [_read_tensor(conn, read_deadline) for _ in range(n)]
        except ValueError as e:
            # header was bad: stream unrecoverable, report + close
            rspan.end(status=_trace.STATUS_ERROR, error=str(e)[:200])
            send_status_frame(conn, STATUS_ERROR, str(e))
            return False
        if self._draining:
            # tensors were consumed (stream stays framed) but no new work
            # is accepted: overloaded is the retry-elsewhere signal
            rspan.end(status=_trace.STATUS_REJECTED)
            send_status_frame(conn, STATUS_OVERLOADED, "replica draining")
            return True
        engine = self._engine_for(model)
        if engine is None:
            rspan.end(status=_trace.STATUS_ERROR, error="unknown model")
            send_status_frame(conn, STATUS_ERROR,
                              f"unknown model {model!r}")
            return True
        try:
            fut = engine.submit(inputs, deadline_ms=deadline_ms,
                                trace_ctx=rspan.ctx())
            outs = fut.result(timeout=self._RESULT_TIMEOUT_S)
        except (ServerOverloadedError, EngineStoppedError) as e:
            # a stopped/draining engine is backpressure, not failure:
            # the client should fail over to another replica
            rspan.end(status=_trace.STATUS_REJECTED)
            send_status_frame(conn, STATUS_OVERLOADED, str(e))
            return True
        except DeadlineExceededError as e:
            rspan.end(status=_trace.STATUS_DEADLINE)
            send_status_frame(conn, STATUS_DEADLINE, str(e))
            return True
        except Exception as e:  # surface model errors to the C app
            rspan.end(status=_trace.STATUS_ERROR,
                      error=f"{type(e).__name__}: {str(e)[:200]}")
            send_status_frame(conn, STATUS_ERROR, str(e))
            return True
        with _trace.server_span("serving.reply", rspan.ctx(),
                                attrs={"n_outputs": len(outs)}):
            conn.sendall(struct.pack("<IBI", _RESP_MAGIC, STATUS_OK,
                                     len(outs)))
            for o in outs:
                _write_tensor(conn, np.asarray(o))
        return True

    def _handle_stream(self, conn, rspan) -> bool:
        """'PDSQ' streaming generation. This handler thread is the SINGLE
        socket writer: it drains the LLMStream's token queue and pushes a
        'PDST' frame per token, then the terminal 'PDRS' — the scheduler
        thread never touches the connection."""
        read_deadline = time.monotonic() + self._READ_TIMEOUT_S
        max_new, dl, n = struct.unpack(
            "<III", _recv_exact(conn, 12, read_deadline))
        try:
            inputs = [_read_tensor(conn, read_deadline) for _ in range(n)]
        except ValueError as e:
            rspan.end(status=_trace.STATUS_ERROR, error=str(e)[:200])
            send_status_frame(conn, STATUS_ERROR, str(e))
            return False
        if self.llm_engine is None:
            send_status_frame(conn, STATUS_ERROR,
                              "no llm engine hosted here")
            return True
        if n != 1 or self._draining:
            if self._draining:
                rspan.end(status=_trace.STATUS_REJECTED)
                send_status_frame(conn, STATUS_OVERLOADED,
                                  "replica draining")
            else:
                send_status_frame(conn, STATUS_ERROR,
                                  f"stream request wants 1 prompt "
                                  f"tensor, got {n}")
            return True
        from ..serving import ServingError
        try:
            stream = self.llm_engine.submit(
                np.asarray(inputs[0]).reshape(-1),
                max_new_tokens=int(max_new) or None,
                deadline_ms=float(dl) if dl else None)
        except (ServerOverloadedError, EngineStoppedError) as e:
            rspan.end(status=_trace.STATUS_REJECTED)
            send_status_frame(conn, STATUS_OVERLOADED, str(e))
            return True
        except ServingError as e:
            rspan.end(status=_trace.STATUS_ERROR, error=str(e)[:200])
            send_status_frame(conn, STATUS_ERROR, str(e))
            return True
        try:
            for idx, tok in enumerate(stream.iter(
                    timeout=self._RESULT_TIMEOUT_S)):
                conn.sendall(struct.pack("<IIi", _STREAM_MAGIC, idx, tok))
        except Exception:
            # consumer gone or queue starved: the sequence keeps running
            # server-side until its own budget/deadline evicts it
            rspan.end(status=_trace.STATUS_ERROR, error="stream broken")
            raise
        status, tokens = stream.result(timeout=1.0)
        if status == "done":
            conn.sendall(struct.pack("<IBI", _RESP_MAGIC, STATUS_OK, 1))
            _write_tensor(conn, np.asarray(tokens, np.int32))
        elif status == "deadline":
            rspan.end(status=_trace.STATUS_DEADLINE)
            send_status_frame(conn, STATUS_DEADLINE,
                              "generation deadline exceeded")
        elif status == "stopped":
            rspan.end(status=_trace.STATUS_REJECTED)
            send_status_frame(conn, STATUS_OVERLOADED, "engine stopped")
        else:
            rspan.end(status=_trace.STATUS_ERROR,
                      error=(stream.error or status)[:200])
            send_status_frame(conn, STATUS_ERROR, stream.error or status)
        return True

    def _handle(self, conn):
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            while self._handle_one(conn):
                pass
        except (ConnectionError, OSError, struct.error):
            pass
        finally:
            conn.close()

    def stats(self):
        """Engine health snapshot (what the 'PDHQ' wire probe returns):
        queue/bucket/deadline counters, `warm_start_ms` and the
        `compile_cache` hit/miss stats (a replica that warm-started from
        the persistent program cache against one that paid its own
        exports), the SLO burn windows (`slo`), the LLM engine's stats (`llm`) and the monitor
        snapshot (`monitor`, when FLAGS_monitor is on). Hosted models
        appear under `models`; a `stats_extra()` hook merges on top."""
        stats = self.engine.stats()
        stats["draining"] = self._draining
        if _monitor._ENABLED:
            snap = _monitor.snapshot()
            stats["monitor"] = {k: snap[k] for k in
                                ("counters", "gauges", "histograms")}
        if self.llm_engine is not None:
            stats["llm"] = self.llm_engine.stats()
        if self.engines:
            stats["models"] = {name: eng.stats()
                               for name, eng in self.engines.items()}
        if self.stats_extra is not None:
            try:
                stats.update(self.stats_extra())
            except Exception:
                pass  # a broken hook must not break the health probe
        return stats

    def _close_listener(self):
        # shutdown() BEFORE close(): close() alone only drops this
        # process's fd — a parked accept() or a connecting peer can keep
        # the port half-alive. shutdown() tears the socket down
        # immediately so the port is observably closed.
        self._stop.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=2)

    def drain(self) -> dict:
        """Graceful drain ('PDDR'): every ACCEPTED request completes or is
        rejected with the overloaded status — never silently dropped.
        Ordering: (1) mark draining so requests still arriving on live
        connections get STATUS_OVERLOADED, (2) close the listening port
        (no new connections), (3) `on_drain()`, (4) every engine finishes
        its queued work
        (`stop(drain=True)`). Idempotent; returns the drain report."""
        with self._drain_lock:
            already = self._draining
            self._draining = True
        if already:
            return {"drained": True, "already": True}
        self._close_listener()
        if self.on_drain is not None:
            try:
                self.on_drain()
            except Exception:
                pass  # the drain itself must still complete
        report = {"drained": True, "completed": {}, "port": self.port,
                  **self.drain_info}
        for name, eng in [("", self.engine), *self.engines.items()]:
            eng.stop(drain=True)
            counts = eng.stats().get("counters", {})
            report["completed"][name or "default"] = \
                counts.get("completed", 0)
        if self.llm_engine is not None:
            self.llm_engine.stop(drain=True)
            report["completed"]["llm"] = self.llm_engine.stats()[
                "counters"].get("completed", 0)
        return report

    def stop(self, drain: bool = True):
        if drain:
            self.drain()
            return
        self._draining = True
        self._close_listener()
        self.engine.stop(drain=False)
        for eng in self.engines.values():
            eng.stop(drain=False)
        if self.llm_engine is not None:
            self.llm_engine.stop(drain=False)


class ReplicaConnectError(ConnectionError):
    """No replica accepted a connection within the retry budget."""


class PredictorClient:
    """Python-side client of the wire protocol (the C client in
    csrc/predict_capi.cpp, `paddle_tpu_torch._native`, is the production
    ABI; this one drives tests and tooling — including the health probe).

    Connects are BOUNDED — `FLAGS_serving_client_max_retries` attempts
    with exponential backoff and full jitter, each capped at
    `FLAGS_serving_client_connect_timeout_s` — and every call takes an
    optional deadline that bounds the wire wait, so a wedged replica
    surfaces as TimeoutError instead of a hang.

    Construct with a single `(host, port)` (back-compat) or
    `replicas=[(h, p), ...]`; with several replicas, transport errors
    transparently fail over to the next one (`failover=False` for
    at-most-one-attempt callers)."""

    def __init__(self, host=None, port=None, timeout: float = 60.0,
                 replicas=None, failover: Optional[bool] = None,
                 max_retries: Optional[int] = None,
                 backoff_ms: Optional[float] = None,
                 connect_timeout: Optional[float] = None):
        if replicas is None:
            if host is None or port is None:
                raise ValueError("need (host, port) or replicas=[...]")
            replicas = [(host, int(port))]
        self.replicas = [(h, int(p)) for h, p in replicas]
        self.timeout = timeout
        self.failover = (len(self.replicas) > 1) if failover is None \
            else failover
        self._max_retries = int(_flags.flag("serving_client_max_retries")
                                if max_retries is None else max_retries)
        self._backoff_ms = float(_flags.flag("serving_client_backoff_ms")
                                 if backoff_ms is None else backoff_ms)
        self._connect_timeout = float(
            _flags.flag("serving_client_connect_timeout_s")
            if connect_timeout is None else connect_timeout)
        self._idx = 0  # replica the live connection points at
        # the serving plane's substrate channel: the resolver serves the
        # replica list rotated to start at the current index, so failover
        # (`self._idx += 1`) naturally re-resolves to the next replica
        self._chan = _net.RpcChannel(
            "serving", resolver=self._rotation,
            connect_timeout=self._connect_timeout,
            on_connect=self._note_connected)
        self._connect()

    # wire status -> terminal span status for the client.send root span
    _SPAN_STATUS = {STATUS_OK: _trace.STATUS_OK,
                    STATUS_ERROR: _trace.STATUS_ERROR,
                    STATUS_OVERLOADED: _trace.STATUS_REJECTED,
                    STATUS_DEADLINE: _trace.STATUS_DEADLINE}

    @property
    def endpoint(self):
        """(host, port) the live connection points at."""
        return self.replicas[self._idx % len(self.replicas)]

    def _rotation(self):
        n = len(self.replicas)
        return [self.replicas[(self._idx + k) % n] for k in range(n)]

    def _note_connected(self, chan):
        # channel landed somewhere in the rotation: remember which
        # replica, and arm the per-call read timeout on the live socket
        self._idx = self.replicas.index(chan.endpoint)
        chan.sock.settimeout(self.timeout)

    def _connect(self, deadline: Optional[float] = None):
        """Bounded connect: up to max_retries+1 rounds over the replica
        list (one RpcChannel.connect sweep per round), exponential
        backoff with FULL jitter between rounds (decorr against
        thundering-herd reconnects), the whole dance optionally bounded
        by an absolute `deadline`."""
        self._disconnect()
        last: Optional[Exception] = None
        for attempt in range(self._max_retries + 1):
            try:
                self._chan.connect(deadline)
                return
            except _net.ConnectDeadlineError:
                raise
            except OSError as e:
                last = e
            if attempt < self._max_retries:
                # full jitter: sleep U(0, base * 2^attempt)
                delay = random.random() * (self._backoff_ms / 1000.0
                                           ) * (2 ** attempt)
                if deadline is not None:
                    delay = min(delay,
                                max(0.0, deadline - time.monotonic()))
                time.sleep(delay)
        raise ReplicaConnectError(
            f"no replica reachable after {self._max_retries + 1} "
            f"rounds over {self.replicas}") from last

    def _disconnect(self):
        self._chan.drop()

    def _ensure(self, deadline: Optional[float] = None):
        if not self._chan.connected:
            self._connect(deadline)
        return self._chan.sock

    def run(self, arrays, deadline_ms: Optional[float] = None,
            model: Optional[str] = None):
        """Returns (status, payload): payload is the output list on
        STATUS_OK, else the server's utf-8 message. `deadline_ms` rides
        the wire ('PDRD') AND bounds the local wait; `model` sends the
        'PDMQ' prefix to pick a hosted model on a multi-model replica.

        With several replicas (and `failover` on), a transport error
        moves to the next replica and retries the WHOLE request within
        the original deadline. That is at-least-once: a reply lost in
        flight may mean the work ran twice — callers needing
        exactly-once set failover=False and keep a sequence ledger.

        Under `FLAGS_trace` each call mints a new trace: a `client.send`
        root span whose context rides a 'PDTC' prefix frame, so the
        server (and engine) spans land in the SAME trace. Tracing off =
        byte-identical frames to the untraced protocol."""
        deadline = (time.monotonic() + deadline_ms / 1000.0
                    if deadline_ms is not None else None)
        attempts = len(self.replicas) if self.failover else 1
        last: Optional[Exception] = None
        for attempt in range(attempts):
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError("client deadline exceeded") from last
            try:
                return self._run_once(arrays, deadline_ms, deadline, model)
            except (ConnectionError, TimeoutError, OSError,
                    struct.error) as e:
                last = e
                self._disconnect()
                self._idx += 1  # next attempt starts at the next replica
        raise last  # type: ignore[misc]

    def _run_once(self, arrays, deadline_ms, deadline, model):
        sock = self._ensure(deadline)
        with _trace.span("client.send",
                         attrs={"n_tensors": len(arrays)}) as sp:
            if deadline is not None and _net.deadline_wire_enabled():
                _net.send_deadline(sock, deadline)
            if sp.trace_id is not None:
                send_trace_frame(sock, sp.ctx())
            if model is not None:
                name = model.encode()
                sock.sendall(struct.pack("<II", _MODEL_MAGIC, len(name))
                             + name)
            if deadline_ms is not None:
                hdr = struct.pack("<III", _REQ_DEADLINE_MAGIC,
                                  int(deadline_ms), len(arrays))
            else:
                hdr = struct.pack("<II", _REQ_MAGIC, len(arrays))
            hdr = self._chan.check_send_faults(hdr)
            sock.sendall(hdr)
            for a in arrays:
                _write_tensor(sock, np.asarray(a))
            self._chan.check_recv_faults()
            magic, status = struct.unpack(
                "<IB", _recv_exact(sock, 5, deadline))
            if magic != _RESP_MAGIC:
                raise ConnectionError(f"bad response magic {magic:#x}")
            if status != STATUS_OK:
                ln, = struct.unpack("<I", _recv_exact(sock, 4, deadline))
                msg = _recv_exact(sock, ln, deadline).decode()
                sp.end(status=self._SPAN_STATUS.get(
                    status, _trace.STATUS_ERROR))
                return status, msg
            n, = struct.unpack("<I", _recv_exact(sock, 4, deadline))
            return status, [_read_tensor(sock, deadline)
                            for _ in range(n)]

    def generate(self, prompt_ids, max_new_tokens: int = 32,
                 deadline_ms: Optional[float] = None, on_token=None):
        """Streaming LLM generation over 'PDSQ'. Returns (status,
        payload): the full token list on STATUS_OK, else the server's
        message. `on_token(index, token)` fires per 'PDST' frame as it
        arrives, which is the streaming part — by the time this returns,
        the generation is over.

        No failover: a stream is stateful on its replica, so a transport
        error mid-generation surfaces to the caller instead of silently
        re-running the prompt elsewhere (tokens already delivered cannot
        be un-streamed)."""
        deadline = (time.monotonic() + deadline_ms / 1000.0
                    if deadline_ms is not None else None)
        sock = self._ensure(deadline)
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if deadline is not None and _net.deadline_wire_enabled():
            _net.send_deadline(sock, deadline)
        hdr = self._chan.check_send_faults(
            struct.pack("<IIII", _STREAM_REQ_MAGIC, int(max_new_tokens),
                        int(deadline_ms or 0), 1))
        sock.sendall(hdr)
        _write_tensor(sock, prompt)
        self._chan.check_recv_faults()
        tokens = []
        while True:
            magic, = struct.unpack("<I", _recv_exact(sock, 4, deadline))
            if magic == _STREAM_MAGIC:
                idx, tok = struct.unpack(
                    "<Ii", _recv_exact(sock, 8, deadline))
                tokens.append(tok)
                if on_token is not None:
                    on_token(idx, tok)
                continue
            if magic != _RESP_MAGIC:
                raise ConnectionError(f"bad stream magic {magic:#x}")
            status, = struct.unpack("<B", _recv_exact(sock, 1, deadline))
            if status != STATUS_OK:
                ln, = struct.unpack("<I", _recv_exact(sock, 4, deadline))
                return status, _recv_exact(sock, ln, deadline).decode()
            n, = struct.unpack("<I", _recv_exact(sock, 4, deadline))
            final = [_read_tensor(sock, deadline) for _ in range(n)]
            if final:
                tokens = [int(t) for t in np.asarray(final[0]).reshape(-1)]
            return status, tokens

    def _json_exchange(self, magic: int, body: bytes = b"",
                       deadline_ms: Optional[float] = None) -> dict:
        deadline = (time.monotonic() + deadline_ms / 1000.0
                    if deadline_ms is not None else None)
        sock = self._ensure(deadline)
        if deadline is not None and _net.deadline_wire_enabled():
            _net.send_deadline(sock, deadline)
        if body:
            hdr = struct.pack("<II", magic, len(body)) + body
        else:
            hdr = struct.pack("<I", magic)
        sock.sendall(self._chan.check_send_faults(hdr))
        self._chan.check_recv_faults()
        rmagic, status = struct.unpack("<IB", _recv_exact(sock, 5,
                                                          deadline))
        if rmagic != _RESP_MAGIC:
            raise ConnectionError(f"bad response magic {rmagic:#x}")
        ln, = struct.unpack("<I", _recv_exact(sock, 4, deadline))
        payload = _recv_exact(sock, ln, deadline).decode()
        if status != STATUS_OK:
            raise ConnectionError(f"status {status}: {payload}")
        return json.loads(payload)

    def health(self, deadline_ms: Optional[float] = None) -> dict:
        return self._json_exchange(_HEALTH_MAGIC, deadline_ms=deadline_ms)

    def drain(self, deadline_ms: Optional[float] = None) -> dict:
        """Graceful drain ('PDDR'); returns the replica's drain report.
        The server closes the connection afterwards."""
        report = self._json_exchange(_DRAIN_MAGIC, deadline_ms=deadline_ms)
        self._disconnect()
        return report

    def model_ctl(self, op: str, model: str,
                  deadline_ms: Optional[float] = None) -> dict:
        """'PDMV' model-version control: op is `reload` or `rollback`."""
        body = json.dumps({"op": op, "model": model}).encode()
        return self._json_exchange(_MODEL_CTL_MAGIC, body,
                                   deadline_ms=deadline_ms)

    def close(self):
        self._disconnect()
