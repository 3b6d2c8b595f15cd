"""Request-scoped distributed tracing — per-request spans across the wire.

Counterpart of `paddle_tpu/obs/trace.py`: one trace per client request,
spans covering client-send → queue_wait → batch-coalesce → predictor
dispatch → reply, across processes, with the reference's wire form, so a
port client and a reference server (or the other way round) share one
trace.

Model (OpenTelemetry-shaped, dependency-free):

  - `TraceContext(trace_id, span_id, flags)` — what crosses a process
    boundary. 26 bytes on the wire (`pack_ctx`/`unpack_ctx`): u8 version,
    16-byte trace id, 8-byte span id, u8 flags. The serving protocol
    carries it in an optional `'PDTC'` prefix frame
    (`inference/server.py`); ABSENCE means "no trace", so untraced
    exchanges are byte-identical to the plain protocol.
  - `Span` — one timed operation: (trace_id, span_id, parent_id, name,
    status, attrs, links). `links` lets a batch span reference the member
    request spans it coalesced.
  - per-thread ACTIVE SPAN STACK: `span(name)` parents onto the innermost
    open span (or the explicit `ctx=`), so call sites never thread ids by
    hand. `active_depth()` counts open spans (the tests' leak fixtures
    read it): an error path that forgets to close a span is a bug.
  - TAIL-SAMPLED RING: finished traces land in two bounded rings — one
    for healthy traces, one PROTECTED ring for traces that ended
    over-deadline, rejected, errored, or slower than the SLO objective.
    Both rings join the flight-recorder dump and export to chrome-trace
    events.

Finished spans also feed `monitor.record_span` (`span.trace.<name>.dur`
histograms).

Hot-path contract: instrumented sites check ONE module attribute
(`_trace._ENABLED`) and allocate nothing on the disabled path — `span()`
returns a shared no-op context.
"""
from __future__ import annotations

import os
import struct
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..core import flags as _flags

__all__ = [
    "TraceContext", "Span", "span", "server_span", "current", "context",
    "pack_ctx", "unpack_ctx", "CTX_WIRE_LEN", "new_trace_id", "new_span_id",
    "traces", "bad_traces", "ring_payload", "trace_chrome_events",
    "active_depth", "reset", "enabled",
    "STATUS_OK", "STATUS_ERROR", "STATUS_DEADLINE", "STATUS_REJECTED",
    "STATUS_SLO_VIOLATION",
]

# span terminal statuses. "ok" traces ride the sampled ring; every other
# status lands in the protected ring (tail sampling keeps failures).
STATUS_OK = "ok"
STATUS_ERROR = "error"
STATUS_DEADLINE = "deadline"
STATUS_REJECTED = "rejected"
STATUS_SLO_VIOLATION = "slo_violation"

_BAD_STATUSES = (STATUS_ERROR, STATUS_DEADLINE, STATUS_REJECTED,
                 STATUS_SLO_VIOLATION)

# ---- gate -------------------------------------------------------------------

_ENABLED: bool = bool(_flags.flag("trace"))


def _on_flag(value) -> None:
    global _ENABLED
    _ENABLED = bool(value)


_flags.watch_flag("trace", _on_flag)


def enabled() -> bool:
    return _ENABLED


# ---- ids + wire context -----------------------------------------------------

_CTX_VERSION = 1
CTX_WIRE_LEN = 26  # u8 version + 16B trace id + 8B span id + u8 flags


def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


class TraceContext:
    """What crosses a process boundary: enough to parent a remote span."""

    __slots__ = ("trace_id", "span_id", "flags")

    def __init__(self, trace_id: str, span_id: str, flags: int = 0):
        self.trace_id = trace_id
        self.span_id = span_id
        self.flags = flags

    def __repr__(self):
        return (f"TraceContext({self.trace_id[:8]}…, "
                f"{self.span_id}, flags={self.flags})")

    def __eq__(self, other):
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id
                and self.flags == other.flags)


def pack_ctx(ctx: TraceContext) -> bytes:
    """26-byte wire form of a trace context (the 'PDTC' frame body and
    the bus message trailer)."""
    return struct.pack("<B16s8sB", _CTX_VERSION,
                       bytes.fromhex(ctx.trace_id),
                       bytes.fromhex(ctx.span_id), ctx.flags & 0xFF)


def unpack_ctx(raw: bytes) -> TraceContext:
    version, tid, sid, fl = struct.unpack("<B16s8sB", raw)
    if version != _CTX_VERSION:
        raise ValueError(f"unknown trace context version {version}")
    return TraceContext(tid.hex(), sid.hex(), fl)


# ---- spans ------------------------------------------------------------------

_TLS = threading.local()


def _stack() -> List["Span"]:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def active_depth() -> int:
    """Open spans on the CALLING thread (the `_no_trace_leak` fixture
    asserts 0 after every test) plus every span opened but not yet closed
    process-wide (cross-thread request spans held by the engine)."""
    return len(_stack()) + len(_BUFFER.open_spans())


class Span:
    """One timed operation inside a trace. Close with `end(status=...)` or
    use as a context manager (an exception sets status=error)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t0", "t1",
                 "status", "attrs", "links", "_on_stack")

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str],
                 attrs: Optional[Dict[str, Any]] = None,
                 links: Optional[List[Tuple[str, str]]] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = new_span_id()
        self.parent_id = parent_id
        self.t0 = time.time()
        self.t1: Optional[float] = None
        self.status = STATUS_OK
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.links: List[Tuple[str, str]] = list(links) if links else []
        self._on_stack = False
        _BUFFER.opened(self)   # leak watch: closed again in end()

    # -- wire handoff --
    def ctx(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def link(self, other: "Span") -> None:
        """Reference another span without parenting it (batch spans link
        the member request spans they coalesced)."""
        self.links.append((other.trace_id, other.span_id))

    def link_ctx(self, ctx: TraceContext) -> None:
        self.links.append((ctx.trace_id, ctx.span_id))

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    # -- lifecycle --
    def end(self, status: Optional[str] = None, **attrs) -> None:
        if self.t1 is not None:   # idempotent: error paths may race reply
            return
        self.t1 = time.time()
        if status is not None:
            self.status = status
        if attrs:
            self.attrs.update(attrs)
        _BUFFER.finish(self)
        from .. import monitor as _monitor
        if _monitor._ENABLED:
            _monitor.record_span(f"trace.{self.name}", self.t0, self.t1)

    def __enter__(self) -> "Span":
        _stack().append(self)
        self._on_stack = True
        return self

    def __exit__(self, exc_type, exc, tb):
        st = _stack()
        if self._on_stack and self in st:
            st.remove(self)
        self._on_stack = False
        if exc is not None and self.status == STATUS_OK:
            self.end(status=STATUS_ERROR,
                     error=f"{type(exc).__name__}: {str(exc)[:200]}")
        else:
            self.end()
        return False

    def to_dict(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "t0": self.t0, "t1": self.t1, "status": self.status,
                "attrs": self.attrs, "links": self.links}


class _NullSpan:
    """Shared no-op span: the disabled path allocates nothing."""

    __slots__ = ()
    trace_id = None
    span_id = None
    status = STATUS_OK

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self, status=None, **attrs):
        pass

    def set(self, **attrs):
        return self

    def link(self, other):
        pass

    def link_ctx(self, ctx):
        pass

    def ctx(self):
        return None


NULL_SPAN = _NullSpan()


def span(name: str, ctx: Optional[TraceContext] = None,
         attrs: Optional[Dict[str, Any]] = None,
         links: Optional[List[Tuple[str, str]]] = None):
    """Open a span: child of `ctx` when given, else of the calling
    thread's innermost open span, else the root of a NEW trace. Disabled
    -> shared no-op span (one module-attribute check)."""
    if not _ENABLED:
        return NULL_SPAN
    if ctx is not None:
        return Span(name, ctx.trace_id, ctx.span_id, attrs, links)
    st = _stack()
    if st:
        parent = st[-1]
        return Span(name, parent.trace_id, parent.span_id, attrs, links)
    return Span(name, new_trace_id(), None, attrs, links)


def server_span(name: str, ctx: Optional[TraceContext],
                attrs: Optional[Dict[str, Any]] = None):
    """Span for the receiving side of a wire hop: ONLY opens when the
    caller actually sent a context (absence means "no trace" — an
    untraced request must not mint server-side garbage traces)."""
    if not _ENABLED or ctx is None:
        return NULL_SPAN
    return Span(name, ctx.trace_id, ctx.span_id, attrs)


def current() -> Optional[Span]:
    st = _stack()
    return st[-1] if st else None


def context() -> Optional[TraceContext]:
    """Wire context of the calling thread's innermost open span (what a
    client injects into the 'PDTC' frame / bus message), or None."""
    if not _ENABLED:
        return None
    sp = current()
    return sp.ctx() if sp is not None else None


# ---- tail-sampled trace ring ------------------------------------------------

class TraceBuffer:
    """Finished spans grouped per trace, in two bounded rings: `ok`
    (healthy traces — evictable) and `bad` (over-deadline / rejected /
    errored / SLO-violating — protected: an overload storm of healthy
    traffic cannot evict the forensic traces). A trace moves rings the
    moment any of its spans ends non-ok."""

    def __init__(self, capacity: int = 64):
        self._lock = threading.Lock()
        cap = max(1, int(capacity))
        self._ok: "deque[Dict[str, Any]]" = deque(maxlen=cap)
        self._bad: "deque[Dict[str, Any]]" = deque(maxlen=cap)
        self._open: Dict[int, Span] = {}   # id(span) -> span (leak watch)

    # -- open-span accounting (the no-leak fixture reads this) --
    def opened(self, sp: Span) -> None:
        with self._lock:
            self._open[id(sp)] = sp

    def open_spans(self) -> List[Span]:
        with self._lock:
            return list(self._open.values())

    def finish(self, sp: Span) -> None:
        with self._lock:
            self._open.pop(id(sp), None)
            rec = self._find(sp.trace_id)
            if rec is None:
                rec = {"trace_id": sp.trace_id, "status": STATUS_OK,
                       "t0": sp.t0, "t1": sp.t1, "spans": []}
                self._ok.append(rec)
            rec["spans"].append(sp.to_dict())
            rec["t0"] = min(rec["t0"], sp.t0)
            rec["t1"] = max(rec["t1"] or sp.t1, sp.t1)
            if sp.status != STATUS_OK and rec["status"] == STATUS_OK:
                rec["status"] = sp.status
                # promote to the protected ring
                try:
                    self._ok.remove(rec)
                except ValueError:
                    pass
                self._bad.append(rec)
            from .. import monitor as _monitor
            if _monitor._ENABLED:
                _monitor.count("trace.spans")
                if sp.status != STATUS_OK:
                    _monitor.count(f"trace.spans.{sp.status}")

    def _find(self, trace_id: str) -> Optional[Dict[str, Any]]:
        for ring in (self._bad, self._ok):
            for rec in reversed(ring):
                if rec["trace_id"] == trace_id:
                    return rec
        return None

    def trace(self, trace_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            rec = self._find(trace_id)
            return dict(rec, spans=list(rec["spans"])) if rec else None

    def traces(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r, spans=list(r["spans"]))
                    for r in list(self._ok) + list(self._bad)]

    def bad_traces(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r, spans=list(r["spans"])) for r in self._bad]

    def payload(self) -> Dict[str, Any]:
        """The flight-recorder dump section (schema v3)."""
        with self._lock:
            return {"ring": [dict(r, spans=list(r["spans"]))
                             for r in list(self._ok)],
                    "kept": [dict(r, spans=list(r["spans"]))
                             for r in list(self._bad)]}

    def reset(self) -> None:
        with self._lock:
            self._ok.clear()
            self._bad.clear()
            self._open.clear()


def _make_buffer() -> TraceBuffer:
    return TraceBuffer(capacity=int(_flags.flag("trace_ring")))


_BUFFER = _make_buffer()


def _on_ring_flag(_v) -> None:
    global _BUFFER
    _BUFFER = _make_buffer()


_flags.watch_flag("trace_ring", _on_ring_flag)


def buffer() -> TraceBuffer:
    return _BUFFER


def traces() -> List[Dict[str, Any]]:
    return _BUFFER.traces()


def bad_traces() -> List[Dict[str, Any]]:
    return _BUFFER.bad_traces()


def ring_payload() -> Dict[str, Any]:
    return _BUFFER.payload()


def reset() -> None:
    _BUFFER.reset()
    _TLS.stack = []


# ---- export -----------------------------------------------------------------

def trace_chrome_events(trace_docs: List[Dict[str, Any]],
                        pid: int = 0) -> List[Dict[str, Any]]:
    """Trace-ring entries -> chrome `ph:"X"` events. Each trace gets its
    own tid lane so concurrent requests read as parallel tracks; span args
    carry ids + status so a slow request can be chased across processes."""
    events: List[Dict[str, Any]] = []
    for lane, doc in enumerate(trace_docs):
        for sp in doc.get("spans", []):
            t0 = float(sp.get("t0", 0.0))
            t1 = float(sp.get("t1") or t0)
            events.append({
                "name": sp.get("name", "span"), "ph": "X", "cat": "trace",
                "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6,
                "pid": pid, "tid": 100 + lane,
                "args": {"trace_id": doc.get("trace_id"),
                         "span_id": sp.get("span_id"),
                         "parent_id": sp.get("parent_id"),
                         "status": sp.get("status"),
                         **(sp.get("attrs") or {})}})
    return events


def render_traces(trace_docs: List[Dict[str, Any]], limit: int = 8) -> str:
    """Text rendering for `monitor show`/`slo` — worst (slowest non-ok
    first) traces with their span waterfall."""
    def _key(doc):
        dur = (doc.get("t1") or 0.0) - (doc.get("t0") or 0.0)
        return (0 if doc.get("status") != STATUS_OK else 1, -dur)

    lines: List[str] = []
    for doc in sorted(trace_docs, key=_key)[:limit]:
        dur = ((doc.get("t1") or 0.0) - (doc.get("t0") or 0.0)) * 1e3
        lines.append(f"trace {doc.get('trace_id', '?')[:16]}  "
                     f"status={doc.get('status')}  {dur:.2f}ms  "
                     f"{len(doc.get('spans', []))} spans")
        t_base = doc.get("t0") or 0.0
        for sp in sorted(doc.get("spans", []),
                         key=lambda s: s.get("t0", 0.0)):
            t0 = float(sp.get("t0", 0.0))
            t1 = float(sp.get("t1") or t0)
            mark = "" if sp.get("status") == STATUS_OK \
                else f"  !{sp.get('status')}"
            lines.append(f"  +{(t0 - t_base) * 1e3:8.2f}ms "
                         f"{(t1 - t0) * 1e3:8.2f}ms  "
                         f"{sp.get('name')}{mark}")
    return "\n".join(lines)
