"""One wire: the RPC substrate the serving plane dispatches through.

Counterpart of `paddle_tpu/utils/net.py`, byte for byte on the wire:
framing helpers (exact-read, CRC frames, the inference status frame,
trace frames) plus the connection-owning substrate — `RpcChannel` on the
client side, `RpcServer` / `make_listener` / `secure_server` on the
server side. The port's serving plane ('PD??' verbs,
`inference/server.py`) runs over it; the reference's PS, bus and
telemetry planes wait for the distributed slice.

The substrate owns the transport concerns: connect/reconnect, resolver
re-resolution, bounded retry with exponential backoff + full jitter,
absolute-deadline bookkeeping (and optional on-wire propagation so a
server drops expired work instead of computing it), named `faults.py`
sites (`net.<plane>.send` / `net.<plane>.recv`), monitor counters
(`net.retries` / `net.reconnects` / `net.crc_errors` /
`net.deadline_drops` / `net.auth_rejects`), and optional per-frame HMAC
auth (`FLAGS_net_auth_token`) and TLS (`FLAGS_net_tls_cert/key/ca`). With
auth/TLS off the wire bytes are exactly the plain protocol's, so the
port's clients and servers interoperate with the reference's
(golden-bytes tested in tests/test_torch_net.py).

Inference response statuses (csrc/predict_capi.cpp mirrors these): a
client must be able to tell backpressure (retryable, the server is
healthy) from failure — overload and deadline expiry get their own codes
instead of riding the generic error status.
"""
from __future__ import annotations

import hashlib
import hmac as _hmac_mod
import os
import random
import socket as _socket_mod
import struct
import threading
import time
import weakref

# response status byte of the inference wire protocol
STATUS_OK = 0            # payload: u32 n_tensors + tensors
STATUS_ERROR = 1         # payload: u32 len + utf-8 message
STATUS_OVERLOADED = 2    # payload: u32 len + message; retry with backoff
STATUS_DEADLINE = 3      # payload: u32 len + message; request expired

_RESP_MAGIC = 0x50445253  # 'PDRS'

# 'PDTC' — OPTIONAL trace-context prefix frame: u32 magic + the 26-byte
# context of obs/trace.py (u8 version, 16B trace id, 8B span id, u8
# flags), sent by a tracing client immediately BEFORE its 'PDRQ'/'PDRD'
# request frame. Absence means "no trace": an untraced exchange is
# byte-identical to the pre-PDTC protocol, so old clients and servers
# interoperate with new ones.
TRACE_MAGIC = 0x50445443  # 'PDTC'

# Control frames. Same discipline as 'PDTC': every frame is opt-in, and
# absence means the single-replica protocol.
#
# 'PDDR' — graceful drain (no body). The replica stops accepting new
#   work (its listening port CLOSES, new requests on live connections
#   get STATUS_OVERLOADED), finishes every in-flight/queued batch,
#   deregisters its lease, then answers STATUS_OK + u32 len + JSON drain
#   report on the control connection.
DRAIN_MAGIC = 0x50444452  # 'PDDR'
# 'PDMQ' — OPTIONAL model-select prefix: u32 len + utf-8 model name,
#   sent before 'PDRQ'/'PDRD' to route the request to a named hosted
#   model (multi-model replicas). Absence = the default model.
MODEL_MAGIC = 0x50444D51  # 'PDMQ'
# 'PDMV' — model version control: u32 len + JSON {op: reload|rollback,
#   model: name}; answers STATUS_OK + u32 len + JSON {ok, version, ...}.
#   `reload` re-reads the newest committed generation of the tenant's
#   versioned weight store; `rollback` promotes the guard checkpoint
#   .bak generation first (instant rollback of a bad push).
MODEL_CTL_MAGIC = 0x50444D56  # 'PDMV'
# LLM streaming-generation frames (serving/llm.py). Opt-in like every
# extension above: a client that never sends 'PDSQ' sees the exact
# batch protocol, and the stream itself ends in a standard 'PDRS' status
# frame so error/overload/deadline handling is shared with the batch
# path.
#
# 'PDSQ' — streaming generation request: u32 magic + u32 max_new_tokens
#   + u32 deadline_ms (0 = none) + u32 n_tensors (=1) + one 1-D i32
#   prompt tensor in the standard tensor framing.
STREAM_REQ_MAGIC = 0x50445351  # 'PDSQ'
# 'PDST' — one streamed token, sent the moment the scheduler emits it:
#   u32 magic + u32 token index + i32 token id. The terminal 'PDRS'
#   carries STATUS_OK + u32 n=1 + the full i32 token tensor (so a
#   non-incremental caller can ignore 'PDST' frames it already read),
#   or STATUS_ERROR/OVERLOADED/DEADLINE + message.
STREAM_MAGIC = 0x50445354  # 'PDST'
# Telemetry frames (the reference's obs/telemetry.py; the port's waits for
# the distributed slice). Unlike the serving frames above these carry a
# CRC: a half-written frame must be detected and dropped, never
# half-parsed.
#
# 'PDTM' — telemetry push (exporter -> collector): CRC frame whose JSON
#   body is {"op": hello|metrics|events|query, ...}.
PDTM_MAGIC = 0x5044544D  # 'PDTM'
# 'PDTA' — telemetry ack (collector -> exporter): CRC frame whose JSON
#   body is {"ok": bool, "commands": [...]} — the ack doubles as the
#   collector's command channel (correlated incident dump fan-out).
PDTA_MAGIC = 0x50445441  # 'PDTA'


def send_crc_frame(sock, magic: int, payload: bytes) -> None:
    """Send `magic + crc32(payload) + len + payload` (all u32 LE)."""
    import zlib
    sock.sendall(struct.pack("<III", magic, zlib.crc32(payload),
                             len(payload)) + payload)


def recv_crc_frame(sock, expect_magic: int,
                   deadline: float | None = None) -> bytes:
    """Read one CRC frame; verify magic and checksum. Raises ValueError
    on either mismatch (caller drops the connection — a telemetry stream
    is resynchronized by reconnecting, not by scanning for a magic)."""
    import zlib
    magic, crc, n = struct.unpack("<III", recv_exact(sock, 12, deadline))
    if magic != expect_magic:
        _count("net.crc_errors")
        raise ValueError(f"crc frame: magic 0x{magic:08X} != "
                         f"expected 0x{expect_magic:08X}")
    if n > (64 << 20):
        _count("net.crc_errors")
        raise ValueError(f"crc frame: implausible length {n}")
    payload = recv_exact(sock, n, deadline)
    if zlib.crc32(payload) != crc:
        _count("net.crc_errors")
        raise ValueError("crc frame: checksum mismatch")
    return payload


def send_trace_frame(sock, ctx) -> None:
    """Send the 'PDTC' prefix for a traced request (`ctx` is an
    obs.trace.TraceContext)."""
    from ..obs import trace as _trace
    sock.sendall(struct.pack("<I", TRACE_MAGIC) + _trace.pack_ctx(ctx))


def recv_trace_frame(sock, deadline: float | None = None):
    """Read the 'PDTC' body (the magic itself was already consumed by the
    caller's dispatch read). Returns a TraceContext, or None on a corrupt
    body (a trace must never break serving)."""
    from ..obs import trace as _trace
    raw = recv_exact(sock, _trace.CTX_WIRE_LEN, deadline)
    try:
        return _trace.unpack_ctx(raw)
    except (ValueError, struct.error):
        return None


def send_status_frame(sock, status: int, msg: bytes | str = b"") -> None:
    """Send a non-OK inference response frame: magic + status + message.
    One implementation so the server cannot desynchronize the stream by
    hand-rolling a frame per call site."""
    if isinstance(msg, str):
        msg = msg.encode()
    sock.sendall(struct.pack("<IB", _RESP_MAGIC, status)
                 + struct.pack("<I", len(msg)) + msg)


def recv_exact(sock, n: int, deadline: float | None = None) -> bytes:
    """Read exactly n bytes. `deadline` (absolute `time.monotonic()`
    seconds) bounds the TOTAL wait: a peer that stalls without closing —
    invisible to a plain blocking recv — raises TimeoutError instead of
    hanging the reader forever. The socket's own timeout is restored on
    exit, so callers with persistent connections are unaffected."""
    if n < 0:
        raise ValueError(f"recv_exact: negative length {n}")
    buf = bytearray()
    old_timeout = sock.gettimeout() if deadline is not None else None
    try:
        while len(buf) < n:
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"recv_exact: deadline exceeded with "
                        f"{n - len(buf)} of {n} bytes outstanding")
                sock.settimeout(remaining)
            try:
                chunk = sock.recv(n - len(buf))
            except TimeoutError:  # socket.timeout aliases this on 3.10+
                raise TimeoutError(
                    f"recv_exact: peer stalled with {n - len(buf)} of {n} "
                    "bytes outstanding") from None
            if not chunk:
                raise ConnectionError("peer closed")
            buf.extend(chunk)
    finally:
        if deadline is not None:
            try:
                sock.settimeout(old_timeout)
            except OSError:
                pass
    return bytes(buf)


# sendmsg takes at most IOV_MAX iovecs per call; batch conservatively so
# a huge replication frame list never trips EINVAL on a small-limit OS.
_IOV_BATCH = 1024


def send_frames(sock, frames) -> None:
    """Send a list of bytes-like frames as one contiguous wire stream.

    On a plain TCP socket this is vectored I/O (`sendmsg`, i.e.
    writev): the kernel gathers the frames, so a caller holding N
    already-encoded records never pays the O(total) `b"".join` copy.
    Any wrapped socket (auth record layer, TLS) only exposes
    `sendall` semantics — there the frames are joined and sent
    through the wrapper, which keeps its framing/HMAC intact. The
    receiver cannot tell the difference: the bytes on the wire are
    identical either way.
    """
    frames = [f if isinstance(f, (bytes, bytearray, memoryview))
              else bytes(f) for f in frames]
    frames = [f for f in frames if len(f)]
    if not frames:
        return
    if type(sock) is not _socket_mod.socket or \
            not hasattr(sock, "sendmsg"):
        sock.sendall(b"".join(frames))
        return
    views = [memoryview(f).cast("B") for f in frames]
    idx = 0
    while idx < len(views):
        batch = views[idx:idx + _IOV_BATCH]
        sent = sock.sendmsg(batch)
        # Advance past whole frames the kernel took, then trim the
        # partial one; short sends are normal under backpressure.
        while batch and sent >= len(batch[0]):
            sent -= len(batch[0])
            batch.pop(0)
            idx += 1
        if batch and sent:
            views[idx] = batch[0][sent:]


# =============================================================================
# The RPC substrate. Everything below is shared by the wire planes;
# everything above is the framing vocabulary they speak over it.
# =============================================================================

from .. import faults as _faults      # noqa: E402
from .. import monitor as _monitor    # noqa: E402
from ..core import flags as _flags    # noqa: E402
from . import syncwatch as _syncwatch  # noqa: E402

# 'PDAH' — auth handshake, sent by the client immediately after connect
# when FLAGS_net_auth_token is set: u32 magic + 16B nonce + 16B
# HMAC-SHA256(token, "hs" + nonce) truncated tag. The server answers one
# byte: 0x01 accepted (both sides then switch to 'PDAR' records), else
# the connection closes and `net.auth_rejects` counts the peer.
AUTH_MAGIC = 0x50444148
# 'PDAR' — one authenticated record: u32 magic + u32 len + 16B
# HMAC-SHA256(token, u64 seq + payload) tag + payload. The per-direction
# sequence number is implicit (both sides count), so replayed or
# reordered records fail the tag check and drop the connection.
AUTH_REC_MAGIC = 0x50444152
# 'PDDL' — OPTIONAL absolute-deadline prefix (FLAGS_net_deadline_wire):
# u32 magic + f64 remaining seconds, sent before a request's first frame
# so the server drops already-expired work (`net.deadline_drops`)
# instead of computing it. Off by default: old peers reject the unknown
# magic, and absence keeps the wire byte-identical to the pre-substrate
# protocols.
DEADLINE_MAGIC = 0x5044444C
_DEADLINE_HEAD = struct.pack("<I", DEADLINE_MAGIC)

_TAG_LEN = 16
_AUTH_HELLO_LEN = 4 + 16 + _TAG_LEN
_HANDSHAKE_TIMEOUT_S = 5.0
_AUTH_RECORD_MAX = 1 << 20


def _count(name: str) -> None:
    if _monitor._ENABLED:
        _monitor.count(name)


class AuthError(ConnectionError):
    """Peer failed the 'PDAH' handshake or a 'PDAR' record tag check."""


class DeadlineExpiredError(ConnectionError):
    """A 'PDDL'-carried deadline had already passed when the request
    reached the server: the work is dropped, not computed."""


class ConnectDeadlineError(TimeoutError):
    """RpcChannel.connect ran out of deadline before any endpoint
    answered (distinct from a per-endpoint connect timeout, which feeds
    the round-robin retry instead of aborting the call)."""


# ---- TLS --------------------------------------------------------------------

def _tls_enabled() -> bool:
    return bool(str(_flags.flag("net_tls_cert") or "")
                or str(_flags.flag("net_tls_ca") or ""))


def _tls_wrap(sock, server_side: bool):
    import ssl
    cert = str(_flags.flag("net_tls_cert") or "")
    key = str(_flags.flag("net_tls_key") or "")
    ca = str(_flags.flag("net_tls_ca") or "")
    if server_side:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(cert, key or None)
        if ca:
            ctx.load_verify_locations(ca)
            ctx.verify_mode = ssl.CERT_REQUIRED
        return ctx.wrap_socket(sock, server_side=True)
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False   # fleet endpoints are bare IPs
    if ca:
        ctx.load_verify_locations(ca)
        ctx.verify_mode = ssl.CERT_REQUIRED
    else:
        ctx.verify_mode = ssl.CERT_NONE
    if cert:  # mutual TLS when the client also holds a cert
        ctx.load_cert_chain(cert, key or None)
    return ctx.wrap_socket(sock)


# ---- per-frame HMAC auth ----------------------------------------------------

def _auth_token() -> str:
    return str(_flags.flag("net_auth_token") or "")


def _auth_tag(token: bytes, *parts: bytes) -> bytes:
    mac = _hmac_mod.new(token, digestmod=hashlib.sha256)
    for p in parts:
        mac.update(p)
    return mac.digest()[:_TAG_LEN]


class _AuthSocket:
    """Record-layer socket wrapper: every outgoing buffer is chunked into
    'PDAR' records carrying a truncated HMAC-SHA256 over (direction
    sequence + payload); incoming records are verified and re-buffered,
    so the plane codecs' recv()/sendall() calls work unchanged on top.
    A bad tag (tamper, replay, reorder, truncation) raises AuthError and
    the connection drops — never a silently accepted byte."""

    def __init__(self, sock, token: bytes):
        self._sock = sock
        self._token = token
        self._rbuf = bytearray()
        self._send_seq = 0
        self._recv_seq = 0
        self._send_lock = threading.Lock()

    def sendall(self, data) -> None:
        data = bytes(data)
        out = bytearray()
        with self._send_lock:
            for off in range(0, len(data), _AUTH_RECORD_MAX) or (0,):
                chunk = data[off:off + _AUTH_RECORD_MAX]
                seq = struct.pack("<Q", self._send_seq)
                self._send_seq += 1
                out += struct.pack("<II", AUTH_REC_MAGIC, len(chunk))
                out += _auth_tag(self._token, seq, chunk)
                out += chunk
            self._sock.sendall(bytes(out))

    def _fill(self) -> None:
        hdr = recv_exact(self._sock, 8 + _TAG_LEN)
        magic, n = struct.unpack("<II", hdr[:8])
        if magic != AUTH_REC_MAGIC or n > _AUTH_RECORD_MAX:
            _count("net.auth_rejects")
            raise AuthError(f"auth record: bad header 0x{magic:08X}/{n}")
        payload = recv_exact(self._sock, n)
        seq = struct.pack("<Q", self._recv_seq)
        if not _hmac_mod.compare_digest(
                hdr[8:], _auth_tag(self._token, seq, payload)):
            _count("net.auth_rejects")
            raise AuthError("auth record: tag mismatch")
        self._recv_seq += 1
        self._rbuf += payload

    def recv(self, n: int) -> bytes:
        if not self._rbuf:
            self._fill()
        take = bytes(self._rbuf[:n])
        del self._rbuf[:n]
        return take

    # the substrate's recv_exact() and the plane codecs only touch this
    # surface; anything else (fileno, getpeername, ...) passes through
    def settimeout(self, t) -> None:
        self._sock.settimeout(t)

    def gettimeout(self):
        return self._sock.gettimeout()

    def setsockopt(self, *args) -> None:
        self._sock.setsockopt(*args)

    def shutdown(self, how) -> None:
        self._sock.shutdown(how)

    def close(self) -> None:
        self._sock.close()

    def __getattr__(self, name):
        return getattr(self._sock, name)


def secure_client(sock):
    """Apply the one-flag-flip security stack to a freshly connected
    client socket: TLS wrap (FLAGS_net_tls_*), then the 'PDAH' auth
    handshake + 'PDAR' record layer (FLAGS_net_auth_token). With both
    flags off this is the identity — the wire stays byte-identical to
    the pre-substrate protocols."""
    if _tls_enabled():
        sock = _tls_wrap(sock, server_side=False)
    token = _auth_token()
    if token:
        nonce = os.urandom(16)
        tok = token.encode()
        sock.sendall(struct.pack("<I", AUTH_MAGIC) + nonce
                     + _auth_tag(tok, b"hs", nonce))
        ack = recv_exact(sock, 1,
                         time.monotonic() + _HANDSHAKE_TIMEOUT_S)
        if ack != b"\x01":
            raise AuthError("net: server rejected auth handshake")
        sock = _AuthSocket(sock, tok)
    return sock


def secure_server(conn, plane: str = "net"):
    """Server-side mirror of `secure_client` for one accepted
    connection. A peer that fails the TLS handshake or the 'PDAH' check
    is counted (`net.auth_rejects`) and its connection closed — the
    accept loop moves on, the server never serves an unauthenticated
    byte."""
    if _tls_enabled():
        try:
            conn = _tls_wrap(conn, server_side=True)
        except OSError:
            _count("net.auth_rejects")
            _count(f"net.{plane}.auth_rejects")
            try:
                conn.close()
            except OSError:
                pass
            raise AuthError("net: TLS handshake failed") from None
    token = _auth_token()
    if token:
        tok = token.encode()
        ok = False
        try:
            hello = recv_exact(conn, _AUTH_HELLO_LEN,
                               time.monotonic() + _HANDSHAKE_TIMEOUT_S)
            (magic,) = struct.unpack("<I", hello[:4])
            ok = (magic == AUTH_MAGIC and _hmac_mod.compare_digest(
                hello[20:], _auth_tag(tok, b"hs", hello[4:20])))
        except (OSError, ValueError):
            ok = False
        if not ok:
            _count("net.auth_rejects")
            _count(f"net.{plane}.auth_rejects")
            try:
                conn.sendall(b"\x00")
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
            raise AuthError("net: client failed auth handshake")
        conn.sendall(b"\x01")
        conn = _AuthSocket(conn, tok)
    return conn


def security_on() -> bool:
    """True when either security flag is flipped (the wire is no longer
    byte-compatible with pre-substrate peers)."""
    return bool(_auth_token()) or _tls_enabled()


# ---- absolute-deadline propagation ------------------------------------------

def deadline_wire_enabled() -> bool:
    return bool(_flags.flag("net_deadline_wire"))


def send_deadline(sock, deadline: float | None) -> None:
    """Prefix the next request with its remaining budget ('PDDL'). The
    wire carries RELATIVE seconds — monotonic clocks do not compare
    across hosts — and the server re-anchors on its own clock."""
    if deadline is None:
        return
    sock.sendall(struct.pack("<Id", DEADLINE_MAGIC,
                             deadline - time.monotonic()))


def recv_head(sock, n: int, deadline: float | None = None,
              plane: str = "net"):
    """Read an n-byte (n >= 4) message head, transparently consuming an
    optional 'PDDL' deadline prefix. Returns `(head, request_deadline)`
    where request_deadline is an absolute monotonic time or None. An
    already-expired deadline raises DeadlineExpiredError after counting
    `net.deadline_drops` — the caller drops the connection's pending
    work instead of computing it."""
    head = recv_exact(sock, 4, deadline)
    req_deadline = None
    while head == _DEADLINE_HEAD:
        (remaining,) = struct.unpack("<d", recv_exact(sock, 8, deadline))
        if remaining <= 0:
            _count("net.deadline_drops")
            _count(f"net.{plane}.deadline_drops")
            raise DeadlineExpiredError(
                f"net: request expired {-remaining:.3f}s before the "
                "server read it")
        req_deadline = time.monotonic() + remaining
        head = recv_exact(sock, 4, deadline)
    if n > 4:
        head += recv_exact(sock, n - 4, deadline)
    return head, req_deadline


# ---- bounded retry with exponential backoff + full jitter -------------------

def _span(span_name):
    if span_name is None:
        return None
    from ..obs import trace as _trace
    return _trace.span(span_name)


def call_with_retry(attempt_fn, *, plane: str = "net", op: str = "call",
                    max_retries: int = 3, backoff_s: float = 0.05,
                    max_backoff_s: float = 2.0,
                    deadline: float | None = None,
                    retry_on=(OSError,), no_retry=(),
                    on_transport_error=None, span_name=None,
                    legacy_retry_counter: str | None = None):
    """THE retry loop: run
    `attempt_fn()`; on a transport failure back off
    `backoff_s * 2^k * (1 + U[0,1))` (full jitter, capped at
    `max_backoff_s`) and retry. With `deadline` (absolute monotonic) the
    budget is the CALL DEADLINE — resolver-backed planes keep retrying
    until failover lands or the deadline expires; otherwise the budget
    is `max_retries` attempts. Exceptions in `no_retry` (application
    errors the peer reported) raise immediately. `on_transport_error`
    runs between attempts (drop the connection, re-resolve endpoints).
    Under FLAGS_trace the WHOLE call is one `span_name` span that closes
    with error status when the call ultimately fails."""
    sp = _span(span_name)
    delay = backoff_s
    last: BaseException | None = None
    try:
        attempt = 0
        while True:
            if attempt:
                _count("net.retries")
                _count(f"net.{plane}.retries")
                if legacy_retry_counter is not None:
                    _count(legacy_retry_counter)
                # full jitter; host RNG is the point — this never traces
                time.sleep(delay * (1.0 + random.random()))
                delay = min(delay * 2, max_backoff_s)
            try:
                out = attempt_fn()
                if sp is not None:
                    sp.end(retries=attempt)
                return out
            except no_retry:
                raise
            except retry_on as e:
                last = e
                if on_transport_error is not None:
                    on_transport_error()
            attempt += 1
            if deadline is not None:
                if time.monotonic() >= deadline:
                    break
            elif attempt > max_retries:
                break
        raise last
    except BaseException as e:
        if sp is not None:  # idempotent: no-op when the success path ran
            from ..obs import trace as _trace
            sp.end(status=_trace.STATUS_ERROR,
                   error=f"{type(e).__name__}: {str(e)[:200]}")
        raise


# ---- client side: RpcChannel ------------------------------------------------

def _parse_endpoint(ep):
    if isinstance(ep, (tuple, list)):
        return str(ep[0]), int(ep[1])
    host, port = str(ep).rsplit(":", 1)
    return host, int(port)


def dial(endpoint, timeout: float | None = None, plane: str = "net"):
    """One-shot secured connection without channel bookkeeping, for
    control-plane exchanges that own their socket's lifetime."""
    host, port = _parse_endpoint(endpoint)
    s = _socket_mod.create_connection((host, port), timeout=timeout)
    s.setsockopt(_socket_mod.IPPROTO_TCP, _socket_mod.TCP_NODELAY, 1)
    try:
        return secure_client(s)
    except BaseException:
        try:
            s.close()
        except OSError:
            pass
        raise


class RpcChannel:
    """One logical client connection for one plane: owns the socket, the
    resolver hook (failover re-resolves through it), transparent
    reconnect (counted), the plane's fault sites, and
    the security stack. The plane's verb framing runs THROUGH the
    channel (`sendall` / `recv_exact` / `recv_crc`), so the bytes on the
    wire are exactly the plane's own protocol unless auth/TLS is on.

    Fault sites: `net.<plane>.send` and `net.<plane>.recv` always fire;
    `legacy_sites=(send_site, recv_site)` adds a plane's own site names.
    `torn` specs mangle the outgoing payload through either site name.
    """

    def __init__(self, plane: str, resolver=None, endpoint=None,
                 connect_timeout: float = 2.0, nodelay: bool = True,
                 legacy_sites=(None, None),
                 legacy_reconnect_counter: str | None = None,
                 on_connect=None):
        if resolver is None and endpoint is None:
            raise ValueError("RpcChannel needs an endpoint or a resolver")
        self.plane = plane
        self._resolver = resolver
        self._endpoint = endpoint
        self.connect_timeout = connect_timeout
        self._nodelay = nodelay
        self._send_site, self._recv_site = legacy_sites
        self._legacy_reconnect_counter = legacy_reconnect_counter
        self._on_connect = on_connect
        self._sock = None
        self._connected_once = False

    # -- connection ownership --
    def endpoints(self):
        if self._resolver is not None:
            eps = self._resolver()
            return [eps] if isinstance(eps, (str, tuple)) else list(eps)
        return [self._endpoint]

    @property
    def endpoint(self):
        return self._endpoint

    @endpoint.setter
    def endpoint(self, ep):
        if ep != self._endpoint:
            self.drop()
        self._endpoint = ep

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def connect(self, deadline: float | None = None):
        """Connect (or return the cached connection) to the first
        reachable resolved endpoint, apply TCP_NODELAY + the security
        stack, and count a reconnect when this channel had a connection
        before. Raises the last endpoint's error when none answers, or
        ConnectDeadlineError when an absolute `deadline` expires first."""
        if self._sock is not None:
            return self._sock
        last: BaseException | None = None
        for ep in self.endpoints():
            host, port = _parse_endpoint(ep)
            ct = self.connect_timeout
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ConnectDeadlineError(
                        "connect deadline exceeded") from last
                ct = min(ct, remaining)
            try:
                s = _socket_mod.create_connection((host, port), timeout=ct)
            except OSError as e:
                last = e
                continue
            s.setsockopt(_socket_mod.IPPROTO_TCP,
                         _socket_mod.TCP_NODELAY, 1)
            try:
                s = secure_client(s)
            except (OSError, ValueError) as e:
                try:
                    s.close()
                except OSError:
                    pass
                last = e
                continue
            if self._connected_once:
                _count("net.reconnects")
                _count(f"net.{self.plane}.reconnects")
                if self._legacy_reconnect_counter is not None:
                    _count(self._legacy_reconnect_counter)
            self._connected_once = True
            self._sock = s
            self._endpoint = ep
            if self._on_connect is not None:
                self._on_connect(self)
            return s
        raise last if last is not None else ConnectionError(
            f"net.{self.plane}: no endpoint resolved")

    def drop(self) -> None:
        """Forget the connection so the next request starts clean."""
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    close = drop

    # -- channel I/O (the plane codecs call these) --
    def check_send_faults(self, data=None):
        """Fire this channel's send fault sites; `torn` specs mangle and
        return the payload."""
        if _faults._ENABLED:
            _faults.check(f"net.{self.plane}.send")
            if data is not None:
                data = _faults.mangle(f"net.{self.plane}.send", data)
            if self._send_site is not None:
                _faults.check(self._send_site)
                if data is not None:
                    data = _faults.mangle(self._send_site, data)
        return data

    def check_recv_faults(self) -> None:
        if _faults._ENABLED:
            _faults.check(f"net.{self.plane}.recv")
            if self._recv_site is not None:
                _faults.check(self._recv_site)

    def sendall(self, data, deadline: float | None = None) -> None:
        data = self.check_send_faults(data)
        sock = self.connect()
        if deadline is not None and deadline_wire_enabled():
            send_deadline(sock, deadline)
        sock.sendall(data)

    def send_frames(self, frames, deadline: float | None = None) -> None:
        """Scatter-gather `sendall`: identical wire bytes, no join copy
        on the fault-free plain-TCP path. With fault injection armed the
        frames are joined first so `torn` mangling keeps its documented
        truncate-the-whole-payload semantics."""
        if _faults._ENABLED:
            self.sendall(b"".join(
                bytes(f) if not isinstance(f, (bytes, bytearray, memoryview))
                else f for f in frames), deadline)
            return
        sock = self.connect()
        if deadline is not None and deadline_wire_enabled():
            send_deadline(sock, deadline)
        send_frames(sock, frames)

    def recv_exact(self, n: int, deadline: float | None = None) -> bytes:
        self.check_recv_faults()
        return recv_exact(self.connect(), n, deadline)

    def recv_crc(self, expect_magic: int,
                 deadline: float | None = None) -> bytes:
        self.check_recv_faults()
        return recv_crc_frame(self.connect(), expect_magic, deadline)

    @property
    def sock(self):
        return self.connect()

    # -- retries --
    def call(self, attempt_fn, *, op: str = "call",
             max_retries: int = 3, backoff_s: float = 0.05,
             deadline: float | None = None, no_retry=(),
             span_name=None, legacy_retry_counter: str | None = None,
             on_transport_error=None):
        """Run `attempt_fn()` under the substrate retry loop; transport
        failures drop this channel's connection (so the next attempt
        reconnects, possibly at a re-resolved endpoint) before the
        caller's own `on_transport_error` hook runs."""
        def _on_err():
            self.drop()
            if on_transport_error is not None:
                on_transport_error()

        return call_with_retry(
            attempt_fn, plane=self.plane, op=op, max_retries=max_retries,
            backoff_s=backoff_s, deadline=deadline, no_retry=no_retry,
            span_name=span_name, legacy_retry_counter=legacy_retry_counter,
            on_transport_error=_on_err)


# ---- server side: RpcServer -------------------------------------------------

def make_listener(host: str, port: int, backlog: int = 64):
    """One implementation of listener setup (SO_REUSEADDR, bind, listen)
    for the planes that keep a bespoke accept loop."""
    sock = _socket_mod.socket(_socket_mod.AF_INET,
                              _socket_mod.SOCK_STREAM)
    sock.setsockopt(_socket_mod.SOL_SOCKET, _socket_mod.SO_REUSEADDR, 1)
    sock.bind((host, port))
    sock.listen(backlog)
    return sock


class RpcServer:
    """Accept-loop harness for one plane's server: owns the listener,
    polls accept with a timeout (so stop() is prompt), applies the
    security stack to every accepted connection (rejecting + counting
    unauthenticated peers), tracks live connections so stop() can close
    them out from under blocked reads, and runs the plane's
    `handler(conn, addr)` on a daemon thread per connection."""

    def __init__(self, handler, host: str = "127.0.0.1", port: int = 0,
                 plane: str = "net", backlog: int = 64,
                 poll_s: float = 0.2, name: str | None = None):
        self._handler = handler
        self.plane = plane
        self._poll_s = poll_s
        self._name = name or f"net-{plane}"
        self._listener = make_listener(host, port, backlog)
        self.host, self.port = self._listener.getsockname()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._conns: "weakref.WeakSet" = weakref.WeakSet()
        self._listener_closed = False

    def start(self) -> "RpcServer":
        self._thread = _syncwatch.Thread(
            target=self._accept_loop, daemon=True, name=self._name)
        self._thread.start()
        return self

    def _accept_loop(self) -> None:
        self._listener.settimeout(self._poll_s)
        while not self._stop.is_set():
            try:
                conn, addr = self._listener.accept()
            except _socket_mod.timeout:
                continue
            except OSError:
                return   # listener closed (drain/stop)
            try:
                conn = secure_server(conn, self.plane)
            except (AuthError, OSError, ValueError):
                continue  # counted in secure_server; peer is gone
            self._conns.add(conn)
            _syncwatch.Thread(target=self._run_handler, args=(conn, addr),
                             daemon=True,
                             name=f"{self._name}-conn").start()

    def _run_handler(self, conn, addr) -> None:
        try:
            self._handler(conn, addr)
        except (OSError, ValueError):
            pass   # connection-scoped failure: the server stays up
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close_listener(self) -> None:
        """Stop accepting (the port closes NOW — drain semantics) while
        existing connections keep being served."""
        if self._listener_closed:
            return
        self._listener_closed = True
        try:
            self._listener.shutdown(_socket_mod.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass

    def stop(self) -> None:
        self._stop.set()
        self.close_listener()
        for conn in list(self._conns):
            try:
                conn.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
