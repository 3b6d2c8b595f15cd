"""Push-based fleet telemetry plane — the cluster-visible monitor tier.

Counterpart of `paddle_tpu/obs/telemetry.py`, byte for byte on the wire:
the port's exporter feeds the reference's collector and back. The
rendezvous store is a `torch.distributed.TCPStore`, whose `get` waits on
a missing key until the store's timeout, so discovery reads the
collector's record through `collective.store_peek`.

Every observability plane before this one is per-process: the FleetRouter
polls 'PDHQ' on a multi-second interval, fleet-wide p99 does not exist
(per-replica p99s cannot be averaged), and an incident on one replica
produces one blind local dump. This module closes all three gaps:

  - `TelemetryExporter` — one per process (ReplicaAgent, PS primary and
    standby, trainers under TrainGuard). Ships (a) delta-compressed
    monitor counters, (b) mergeable DDSketch histograms
    (`monitor.Histogram.merge()` — bin-wise sums, so the collector's
    fleet quantiles keep the sketch's <=1% bound), and (c) an immediate
    event channel (death, drain, rollout, lease_expiry, guard
    divergence/stall, oom, slo_burn, dump) over CRC-framed 'PDTM' pushes
    with a `telemetry.push` fault site. Events buffer into a bounded
    drop-oldest ring: a SIGKILLed collector costs telemetry
    (`telemetry.dropped` counts exactly what), never serving throughput.
  - `TelemetryCollector` — discovered via the existing TCPStore
    rendezvous (`telemetry:{fleet}:collector`). Bounded time-series ring
    per (source, metric), ONE fleet-wide Prometheus scrape
    (`monitor.prometheus_text_multi`: `source=` labels + merged-sketch
    quantile families), the live `python -m paddle_tpu_torch.monitor top`
    fleet table (stragglers via obs/merge.py skew logic), threshold +
    multi-window-burn alert rules (obs/slo.py semantics), and correlated
    incidents: any dump-triggering error fans a dump command to every
    live source under one shared `incident_id`, so a desync yields
    time-aligned flight-recorder dumps from the whole fleet.
  - Push-fed death detection: a SIGKILL closes the exporter's socket,
    the collector's connection reader sees EOF immediately, and a
    subscribed FleetRouter marks the replica dead in well under a
    second — no waiting out the lease TTL or the poll interval (both are
    retained as fallback).

Wire protocol ('PDHQ'/CMD_REPLICATE style, but CRC-framed — see
utils/net.py): exporter sends 'PDTM' frames whose JSON body is
{"op": hello|metrics|events|query|bye, ...}; the collector answers each
with a 'PDTA' ack {"ok": true, "commands": [...]} that doubles as its
command channel (incident dump fan-out rides the acks).

Gate: `FLAGS_telemetry`. Off = zero telemetry threads and sockets.
"""
from __future__ import annotations

import json
import os
import re
import socket
import threading
import time
import uuid
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import monitor as _monitor
from ..core import flags as _flags
from ..utils import net as _net
from ..utils import syncwatch as _syncwatch

__all__ = ["TelemetryExporter", "TelemetryCollector", "emit",
           "get_default", "query_collector", "render_top"]

# live exporters/collectors — the conftest leak fixture reaps stragglers
_LIVE: "weakref.WeakSet" = weakref.WeakSet()

# the process-default exporter (recorder.dump and guard sites emit here)
_DEFAULT: Optional["TelemetryExporter"] = None

_IO_TIMEOUT_S = 5.0


def emit(kind: str, **detail) -> None:
    """Fire an event on the process-default exporter; no-op without one
    (one module-attribute read on the disabled path)."""
    exp = _DEFAULT
    if exp is not None:
        exp.event(kind, **detail)


def get_default() -> Optional["TelemetryExporter"]:
    return _DEFAULT


def _store_key(fleet: str) -> str:
    return f"telemetry:{fleet}:collector"


def _safe_name(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "-", str(s))


def _now() -> float:
    return time.time()


# ---------------------------------------------------------------------------
# exporter
# ---------------------------------------------------------------------------

class TelemetryExporter:
    """Per-process telemetry pusher. One background thread owns every
    socket operation: `event()` (callable from any thread, including the
    serving hot path) only appends to a bounded deque and sets a wake
    flag — it can never block on the network or a dead collector."""

    def __init__(self, store, source: str, role: str = "process",
                 fleet: str = "default",
                 meta: Optional[Dict[str, Any]] = None,
                 interval_s: Optional[float] = None):
        self.store = store
        self.source = str(source)
        self.role = role
        self.fleet = fleet
        self.meta = dict(meta or {})
        self.interval_s = float(interval_s
                                if interval_s is not None
                                else _flags.flag("telemetry_interval_s"))
        self._events: deque = deque(
            maxlen=max(1, int(_flags.flag("telemetry_buffer"))))
        self._lock = _syncwatch.lock("telemetry.TelemetryExporter._lock")
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the telemetry plane's substrate channel: resolver re-discovers
        # the collector through the store on every (re)connect, the
        # legacy `telemetry.push` fault site keeps firing alongside
        # `net.telemetry.send`
        self._chan = _net.RpcChannel(
            "telemetry", resolver=self._resolve,
            connect_timeout=_IO_TIMEOUT_S,
            legacy_sites=("telemetry.push", None))
        self._addr: Optional[Tuple[str, int]] = None
        self._need_hello = True
        self._last_counters: Dict[str, Any] = {}
        # own tallies (tests read these without the monitor flag on)
        self.pushes = 0
        self.dropped = 0
        self.reconnects = 0

    # -- lifecycle --
    def start(self) -> "TelemetryExporter":
        global _DEFAULT
        if self._thread is not None:
            return self
        self._thread = _syncwatch.Thread(
            target=self._run, name=f"telemetry-export-{self.source}",
            daemon=True)
        self._thread.start()
        _LIVE.add(self)
        if _DEFAULT is None:
            _DEFAULT = self
        return self

    def stop(self, timeout: float = 5.0) -> None:
        global _DEFAULT
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None
        self._close_sock()
        if _DEFAULT is self:
            _DEFAULT = None

    close = stop

    # -- producers (any thread) --
    def event(self, kind: str, **detail) -> None:
        """Queue an immediate-push event. Drop-oldest under overflow:
        losing the oldest buffered event to a dead collector is the
        designed cost; blocking the caller never is."""
        ev = {"kind": str(kind), "ts": _now(), "detail": detail}
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
                if _monitor._ENABLED:
                    _monitor.count("telemetry.dropped")
            self._events.append(ev)
        self._wake.set()

    # -- export thread --
    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=self.interval_s)
            self._wake.clear()
            if self._stop.is_set():
                break
            self._flush()
        # final best-effort flush + graceful goodbye (a 'bye' lets the
        # collector tell shutdown from death)
        self._flush(final=True)
        self._close_sock()

    def _close_sock(self) -> None:
        self._chan.drop()
        self._need_hello = True

    def _resolve(self) -> List[Tuple[str, int]]:
        addr = self._discover()
        return [addr] if addr is not None else []

    def _discover(self) -> Optional[Tuple[str, int]]:
        from ..parallel.collective import store_peek
        try:
            raw = store_peek(self.store, _store_key(self.fleet))
        except Exception:
            return None  # store gone
        if raw is None:
            return None  # not published yet
        if isinstance(raw, bytes):
            raw = raw.decode()
        parts = str(raw).split()
        if len(parts) != 2:
            return None
        try:
            return parts[0], int(parts[1])
        except ValueError:
            return None

    def _ensure_conn(self) -> bool:
        if self._chan.connected and not self._need_hello:
            return True
        addr = self._discover()
        if addr is None:
            return False
        if not self._chan.connected or addr != self._addr:
            self._close_sock()
            try:
                self._chan.connect()
            except OSError:
                return False
            self._addr = addr
        try:
            self._exchange({"op": "hello", "source": self.source,
                            "role": self.role, "pid": os.getpid(),
                            "meta": self.meta})
        except Exception:
            self._close_sock()
            return False
        self._need_hello = False
        # a (re)connect invalidates the delta baseline: resend absolutes
        self._last_counters = {}
        return True

    def _exchange(self, body: Dict[str, Any]) -> Dict[str, Any]:
        self._chan.check_send_faults()
        if not self._chan.connected:
            raise ConnectionError("no collector connection")
        sock = self._chan.sock
        _net.send_crc_frame(sock, _net.PDTM_MAGIC,
                            json.dumps(body, default=str).encode())
        self._chan.check_recv_faults()
        ack = json.loads(_net.recv_crc_frame(
            sock, _net.PDTA_MAGIC,
            deadline=time.monotonic() + _IO_TIMEOUT_S))
        self.pushes += 1
        if _monitor._ENABLED:
            _monitor.count("telemetry.pushes")
        for cmd in ack.get("commands") or []:
            try:
                self._handle_command(cmd)
            except Exception:
                pass  # a bad command must not kill the export loop
        return ack

    def _flush(self, final: bool = False) -> None:
        with self._lock:
            events = list(self._events)
            self._events.clear()
        try:
            if not self._ensure_conn():
                raise ConnectionError("collector unavailable")
            snap = _monitor.mergeable_snapshot()
            counters = snap["counters"]
            delta = {k: v - self._last_counters.get(k, 0)
                     for k, v in counters.items()
                     if v != self._last_counters.get(k, 0)}
            full = not self._last_counters
            self._exchange({"op": "metrics", "source": self.source,
                            "full": full,
                            "counters": counters if full else delta,
                            "gauges": snap["gauges"],
                            "histograms": snap["histograms"]})
            self._last_counters = counters
            if events:
                self._exchange({"op": "events", "source": self.source,
                                "events": events})
            if final:
                self._exchange({"op": "bye", "source": self.source})
        except Exception:
            # network failure (or injected telemetry.push fault): drop
            # the connection, re-buffer the drained events (drop-oldest
            # still bounds them), and let the next tick retry
            had_conn = self._chan.connected
            self._close_sock()
            if had_conn:
                self.reconnects += 1
                if _monitor._ENABLED:
                    _monitor.count("telemetry.reconnects")
            if events and not final:
                with self._lock:
                    room = self._events.maxlen - len(self._events)
                    lost = max(0, len(events) - room)
                    if lost:
                        self.dropped += lost
                        if _monitor._ENABLED:
                            _monitor.count("telemetry.dropped", lost)
                    for ev in events[lost:][::-1]:
                        self._events.appendleft(ev)

    # -- collector commands (ride the acks) --
    def _handle_command(self, cmd: Dict[str, Any]) -> None:
        if not isinstance(cmd, dict):
            return
        if cmd.get("op") == "dump":
            iid = str(cmd.get("incident_id") or "incident")
            reason = str(cmd.get("reason") or "incident")
            from . import dump as _dump
            d = str(_flags.flag("obs_dump_dir")) or "flight_recorder"
            # EXPLICIT path: an incident dump must never be suppressed by
            # the per-reason rate limiter (the whole point is every
            # member dumping at once)
            path = os.path.join(
                d, f"flightrec_{_safe_name(iid)}_"
                   f"{_safe_name(self.source)}.json")
            _dump(path=path, reason=reason, incident_id=iid,
                  source=self.source)


# ---------------------------------------------------------------------------
# collector
# ---------------------------------------------------------------------------

class TelemetryCollector:
    """The fleet's one aggregation point. Accepts 'PDTM' pushes, keeps a
    bounded ring per (source, metric), serves the fleet-wide scrape and
    `monitor top` doc, evaluates alert rules, relays events to
    subscribers (the FleetRouter fast path), and fans out correlated
    incident dump commands."""

    def __init__(self, store, fleet: str = "default",
                 host: str = "127.0.0.1", port: int = 0):
        self.store = store
        self.fleet = fleet
        self.host = host
        self.port = port
        self._lock = _syncwatch.lock("telemetry.TelemetryCollector._lock")
        self._stop = threading.Event()
        self._listener: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        ring = max(4, int(_flags.flag("telemetry_ring")))
        self._ring = ring
        # per-source state: meta/role/pid, reconstructed-absolute
        # counters, gauges, histogram payloads, liveness
        self.sources: Dict[str, Dict[str, Any]] = {}
        self.series: Dict[Tuple[str, str], deque] = {}
        self.events: deque = deque(maxlen=ring)
        self._commands: Dict[str, deque] = {}
        self._subscribers: List[Callable[[Dict[str, Any]], None]] = []
        self._rules: List[Dict[str, Any]] = []
        self._active_alerts: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.burn_threshold = 1.0   # multi-window burn rule (obs/slo.py)
        self._pool: Dict[str, Any] = {}   # autoscaler pool state
        self.incidents: Dict[str, Dict[str, Any]] = {}
        self._last_incident = 0.0
        self._conn_seq = 0

    # -- lifecycle --
    def start(self) -> "TelemetryCollector":
        if self._listener is not None:
            return self
        srv = _net.make_listener(self.host, self.port, backlog=64)
        # poll-style accept: closing a listener does not reliably wake a
        # thread blocked in accept(), so the loop must time out to see
        # the stop flag
        srv.settimeout(0.2)
        self.port = srv.getsockname()[1]
        self._listener = srv
        t = _syncwatch.Thread(target=self._accept_loop,
                             name="telemetry-accept", daemon=True)
        t.start()
        self._threads.append(t)
        r = _syncwatch.Thread(target=self._reap_loop,
                             name="telemetry-reap", daemon=True)
        r.start()
        self._threads.append(r)
        # publish the rendezvous record LAST: a discoverable collector
        # is an accepting collector
        self.store.set(_store_key(self.fleet), f"{self.host} {self.port}")
        _LIVE.add(self)
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        try:  # stop advertising (the store has no delete)
            self.store.set(_store_key(self.fleet), b"")
        except Exception:
            pass
        srv, self._listener = self._listener, None
        if srv is not None:
            try:
                srv.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout)
        self._threads = []

    close = stop

    # -- ingest --
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                srv = self._listener
                if srv is None:
                    return
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed
            try:
                conn = _net.secure_server(conn, "telemetry")
            except (_net.AuthError, OSError, ValueError):
                continue  # unauthenticated peer: counted + dropped
            conn.settimeout(None)
            with self._lock:
                self._conns.append(conn)
                self._conn_seq += 1
                cid = self._conn_seq
            t = _syncwatch.Thread(target=self._conn_loop,
                                 args=(conn, cid),
                                 name=f"telemetry-conn-{cid}", daemon=True)
            t.start()
            self._threads.append(t)

    def _conn_loop(self, conn: socket.socket, cid: int) -> None:
        src: Optional[str] = None
        graceful = False
        try:
            while not self._stop.is_set():
                body = json.loads(_net.recv_crc_frame(
                    conn, _net.PDTM_MAGIC))
                op = body.get("op")
                if op == "hello":
                    src = str(body.get("source"))
                    self._on_hello(src, cid, body)
                elif op == "metrics" and src is not None:
                    self._on_metrics(src, body)
                elif op == "events" and src is not None:
                    for ev in body.get("events") or []:
                        self._dispatch_event(src, ev)
                elif op == "bye":
                    graceful = True
                elif op == "query":
                    _net.send_crc_frame(
                        conn, _net.PDTA_MAGIC,
                        json.dumps({"ok": True, "doc": self.snapshot_doc()},
                                   default=str).encode())
                    continue
                cmds = self._drain_commands(src) if src else []
                _net.send_crc_frame(
                    conn, _net.PDTA_MAGIC,
                    json.dumps({"ok": True, "commands": cmds}).encode())
                if graceful:
                    break
        except (ConnectionError, ValueError, OSError, json.JSONDecodeError,
                TimeoutError):
            pass  # EOF / corrupt frame / teardown — handled below
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            if src is not None:
                self._on_disconnect(src, cid, graceful)

    def _on_hello(self, src: str, cid: int, body: Dict[str, Any]) -> None:
        with self._lock:
            rec = self.sources.setdefault(src, {
                "counters": {}, "gauges": {}, "histograms": {}})
            rec.update({"role": body.get("role"), "pid": body.get("pid"),
                        "meta": body.get("meta") or {}, "alive": True,
                        "graceful": False, "conn_id": cid,
                        "last_seen": _now()})

    def _on_metrics(self, src: str, body: Dict[str, Any]) -> None:
        ts = _now()
        with self._lock:
            rec = self.sources.setdefault(src, {
                "counters": {}, "gauges": {}, "histograms": {},
                "alive": True, "meta": {}})
            if body.get("full"):
                rec["counters"] = dict(body.get("counters") or {})
            else:
                for k, d in (body.get("counters") or {}).items():
                    rec["counters"][k] = rec["counters"].get(k, 0) + d
            rec["gauges"] = dict(body.get("gauges") or {})
            rec["histograms"] = dict(body.get("histograms") or {})
            rec["last_seen"] = ts
            rec["alive"] = True
            for k, v in rec["counters"].items():
                self._series_append(src, k, ts, v)
            for k, v in rec["gauges"].items():
                self._series_append(src, k, ts, v)
            for k, h in rec["histograms"].items():
                if isinstance(h, dict) and "count" in h:
                    self._series_append(src, k + ".count", ts, h["count"])
        self._eval_rules(src)

    def _series_append(self, src, metric, ts, value) -> None:
        # caller holds self._lock
        key = (src, metric)
        ring = self.series.get(key)
        if ring is None:
            ring = self.series[key] = deque(maxlen=self._ring)
        ring.append((ts, value))

    def _on_disconnect(self, src: str, cid: int, graceful: bool) -> None:
        with self._lock:
            rec = self.sources.get(src)
            # a stale connection's EOF must not kill a reconnected source
            if rec is None or rec.get("conn_id") != cid:
                return
            was_alive = rec.get("alive", False)
            rec["alive"] = False
            rec["graceful"] = graceful or self._stop.is_set()
            meta = dict(rec.get("meta") or {})
        if was_alive and not graceful and not self._stop.is_set():
            # SIGKILL fast path: EOF -> death event in milliseconds
            self._dispatch_event(src, {"kind": "death", "ts": _now(),
                                       "detail": meta})

    def _reap_loop(self) -> None:
        """Wedged-not-dead backstop: a source that stops pushing without
        its socket dying is declared dead after telemetry_death_after_s."""
        while not self._stop.is_set():
            after = float(_flags.flag("telemetry_death_after_s"))
            self._stop.wait(max(0.05, after / 3.0))
            if self._stop.is_set():
                return
            now, dead = _now(), []
            with self._lock:
                for src, rec in self.sources.items():
                    if rec.get("alive") and \
                            now - rec.get("last_seen", now) > after:
                        rec["alive"] = False
                        dead.append((src, dict(rec.get("meta") or {})))
            for src, meta in dead:
                self._dispatch_event(src, {"kind": "death", "ts": _now(),
                                           "detail": meta})

    # -- events / incidents / subscribers --
    def subscribe(self, fn: Callable[[Dict[str, Any]], None]) -> None:
        with self._lock:
            self._subscribers.append(fn)

    def _dispatch_event(self, src: str, ev: Dict[str, Any]) -> None:
        if not isinstance(ev, dict):
            return
        ev = dict(ev)
        ev["source"] = src
        ev.setdefault("ts", _now())
        with self._lock:
            self.events.append(ev)
            subs = list(self._subscribers)
        for fn in subs:
            try:
                fn(ev)
            except Exception:
                pass  # a bad subscriber must not break ingest
        detail = ev.get("detail") or {}
        if ev.get("kind") == "dump":
            iid = detail.get("incident_id")
            if iid:
                with self._lock:
                    inc = self.incidents.get(str(iid))
                    if inc is not None and detail.get("path"):
                        # the event rides the process-DEFAULT exporter's
                        # connection; the dump's own source wins
                        inc["dumps"].append(
                            {"source": detail.get("source") or src,
                             "path": detail["path"]})
            else:
                self._start_incident(src, str(detail.get("reason")
                                              or "incident"))

    def _start_incident(self, origin: str, reason: str) -> None:
        """Fan a correlated dump command to every live source (origin
        included — its incident dump carries the shared id, unlike the
        local one that started this). Rate-limited: a crash loop makes
        one fleet dump set per window, not a storm."""
        now = time.monotonic()
        with self._lock:
            min_s = float(_flags.flag("telemetry_incident_min_interval_s"))
            if now - self._last_incident < min_s:
                return
            self._last_incident = now
            iid = "inc-" + uuid.uuid4().hex[:12]
            targets = [s for s, r in self.sources.items() if r.get("alive")]
            self.incidents[iid] = {"id": iid, "ts": _now(),
                                   "origin": origin, "reason": reason,
                                   "targets": targets, "dumps": []}
            for s in targets:
                self._commands.setdefault(s, deque(maxlen=32)).append(
                    {"op": "dump", "incident_id": iid, "reason": reason})

    def _drain_commands(self, src: str) -> List[Dict[str, Any]]:
        with self._lock:
            q = self._commands.get(src)
            if not q:
                return []
            out = list(q)
            q.clear()
            return out

    # -- alert rules --
    def add_rule(self, name: str, metric: str, threshold: float,
                 kind: str = "gauge") -> None:
        """Threshold rule: fires (one 'alert' event per transition) when
        `metric` in a source's gauges/counters exceeds `threshold`."""
        with self._lock:
            self._rules.append({"name": name, "metric": metric,
                                "threshold": float(threshold),
                                "kind": kind})

    def _eval_rules(self, src: str) -> None:
        with self._lock:
            rec = self.sources.get(src) or {}
            gauges = dict(rec.get("gauges") or {})
            counters = dict(rec.get("counters") or {})
            rules = list(self._rules)
        fired: List[Tuple[str, Dict[str, Any]]] = []
        cleared: List[str] = []
        for rule in rules:
            vals = counters if rule["kind"] == "counter" else gauges
            v = vals.get(rule["metric"])
            self._transition(
                src, rule["name"], v is not None and v > rule["threshold"],
                {"metric": rule["metric"], "value": v,
                 "threshold": rule["threshold"]}, fired, cleared)
        # built-in multi-window burn rule (obs/slo.py publishes one
        # slo.burn.<w>s gauge per window): EVERY window above threshold
        # means a sustained budget burn, not a blip
        burns = {k: v for k, v in gauges.items()
                 if k.startswith("slo.burn.")}
        self._transition(
            src, "slo_burn",
            bool(burns) and min(burns.values()) > self.burn_threshold,
            {"burn": burns, "threshold": self.burn_threshold},
            fired, cleared)
        for name, detail in fired:
            self._dispatch_event(src, {"kind": "alert", "ts": _now(),
                                       "detail": dict(detail, rule=name)})

    def _transition(self, src, name, active, detail, fired, cleared):
        key = (src, name)
        with self._lock:
            was = key in self._active_alerts
            if active and not was:
                self._active_alerts[key] = {"source": src, "rule": name,
                                            "since": _now(), **detail}
                fired.append((name, detail))
            elif not active and was:
                del self._active_alerts[key]
                cleared.append(name)
            elif active:
                self._active_alerts[key].update(detail)

    def alerts(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(a) for a in self._active_alerts.values()]

    # -- autoscaler integration --
    def pool_update(self, doc: Dict[str, Any]) -> None:
        """The co-located Autoscaler publishes its pool state here after
        every tick (target vs actual replicas, last decision + trigger,
        blocked verdict); `monitor top` renders it, and the built-in
        `scale_blocked` rule fires ONE alert event per transition into a
        scale-out that cannot be satisfied (spawn budget exhausted / HBM
        refused)."""
        with self._lock:
            self._pool = dict(doc)
        fired: List[Tuple[str, Dict[str, Any]]] = []
        cleared: List[str] = []
        self._transition(
            "autoscaler", "scale_blocked", bool(doc.get("blocked")),
            {"reason": doc.get("blocked_reason"),
             "target": doc.get("target"), "actual": doc.get("actual")},
            fired, cleared)
        for name, detail in fired:
            self._dispatch_event("autoscaler",
                                 {"kind": "alert", "ts": _now(),
                                  "detail": dict(detail, rule=name)})

    # -- read side --
    def mergeable_snapshots(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {src: {"counters": dict(rec.get("counters") or {}),
                          "gauges": dict(rec.get("gauges") or {}),
                          "histograms": dict(rec.get("histograms") or {})}
                    for src, rec in self.sources.items()}

    def merged(self) -> Dict[str, Any]:
        """True fleet-wide view: counters/gauges summed, histograms
        merged bin-wise (monitor.merge_snapshots)."""
        return _monitor.merge_snapshots(
            self.mergeable_snapshots().values())

    def scrape(self) -> str:
        """ONE Prometheus scrape for the whole fleet: every source's
        series under `source=` labels + merged-sketch `_q` quantile
        families (monitor.prometheus_text_multi)."""
        return _monitor.prometheus_text_multi(self.mergeable_snapshots())

    def _rate(self, src: str, metric: str) -> float:
        # caller holds self._lock
        ring = self.series.get((src, metric))
        if not ring or len(ring) < 2:
            return 0.0
        (t0, v0), (t1, v1) = ring[0], ring[-1]
        return (v1 - v0) / (t1 - t0) if t1 > t0 else 0.0

    def fleet_table(self) -> List[Dict[str, Any]]:
        from . import merge as _merge
        from . import slo as _slo
        rows: List[Dict[str, Any]] = []
        with self._lock:
            items = [(s, dict(r)) for s, r in sorted(self.sources.items())]
            rates = {s: self._rate(s, "serving.e2e_latency.count")
                     for s, _ in items}
        p99s: Dict[str, float] = {}
        for src, rec in items:
            gauges = rec.get("gauges") or {}
            hist = (rec.get("histograms") or {}).get("serving.e2e_latency")
            p99 = 0.0
            if isinstance(hist, dict) and hist.get("count"):
                p99 = _monitor.Histogram.from_payload(
                    "serving.e2e_latency", hist).quantile(0.99)
            hbm = max([v for k, v in gauges.items()
                       if k.startswith("mem.") and k.endswith("bytes")]
                      or [0])
            p99s[src] = p99
            rows.append({"source": src, "role": rec.get("role"),
                         "alive": bool(rec.get("alive")),
                         "qps": rates.get(src, 0.0),
                         "queue": gauges.get("serving.queue_depth", 0),
                         "p99_s": p99,
                         "burn": _slo.burn_from_gauges(gauges),
                         "hbm_bytes": hbm})
        worst, _, _, skew = _merge.skew_over_median(
            {s: v for s, v in p99s.items() if v > 0})
        for row in rows:
            row["straggler"] = (row["source"] == worst and skew >= 1.5)
        return rows

    def snapshot_doc(self) -> Dict[str, Any]:
        """The `monitor top` document (served over the query verb)."""
        rows = self.fleet_table()
        with self._lock:
            events = list(self.events)[-16:]
            incidents = [dict(i) for i in self.incidents.values()]
            pool = dict(self._pool)
        return {"fleet": self.fleet, "ts": _now(), "sources": rows,
                "events": events, "incidents": incidents,
                "alerts": self.alerts(), "pool": pool}


# ---------------------------------------------------------------------------
# CLI helpers (python -m paddle_tpu_torch.monitor top)
# ---------------------------------------------------------------------------

def query_collector(host: str, port: int,
                    timeout_s: float = _IO_TIMEOUT_S) -> Dict[str, Any]:
    """One query round-trip: 'PDTM' {"op": "query"} -> the collector's
    snapshot_doc in the 'PDTA' body."""
    sock = _net.dial((host, int(port)), timeout=timeout_s,
                     plane="telemetry")
    try:
        _net.send_crc_frame(sock, _net.PDTM_MAGIC,
                            json.dumps({"op": "query"}).encode())
        ack = json.loads(_net.recv_crc_frame(
            sock, _net.PDTA_MAGIC,
            deadline=time.monotonic() + timeout_s))
    finally:
        sock.close()
    return ack.get("doc") or {}


def render_top(doc: Dict[str, Any]) -> str:
    """The live fleet table: one row per source (qps / queue / p99 / burn
    / HBM / role), stragglers starred, recent events and open incidents
    below."""
    rows = doc.get("sources") or []
    lines = ["-" * 78,
             f"fleet '{doc.get('fleet', '?')}' — {len(rows)} sources, "
             f"{sum(1 for r in rows if r.get('alive'))} alive",
             "-" * 78,
             f"{'Source':<18}{'Role':<10}{'QPS':>8}{'Queue':>7}"
             f"{'p99(ms)':>9}{'Burn':>7}{'HBM(MB)':>9}  State"]
    for r in rows:
        state = "up" if r.get("alive") else "DOWN"
        if r.get("straggler"):
            state += " *straggler*"
        lines.append(
            f"{str(r.get('source'))[:17]:<18}"
            f"{str(r.get('role') or '-')[:9]:<10}"
            f"{r.get('qps', 0.0):>8.1f}{r.get('queue', 0):>7}"
            f"{r.get('p99_s', 0.0) * 1e3:>9.2f}"
            f"{r.get('burn', 0.0):>7.2f}"
            f"{r.get('hbm_bytes', 0) / 1e6:>9.1f}  {state}")
    pool = doc.get("pool") or {}
    if pool:
        line = (f"pool: target={pool.get('target')} "
                f"actual={pool.get('actual')}")
        if pool.get("blocked"):
            line += f"  [BLOCKED: {pool.get('blocked_reason') or '?'}]"
        last = pool.get("last") or {}
        if last:
            delta = last.get("delta") or 0
            line += (f"  last={last.get('action')}"
                     f"{delta:+d} trigger={last.get('reason')}"
                     f" outcome={last.get('outcome')}")
        lines.append(line)
    alerts = doc.get("alerts") or []
    for a in alerts:
        lines.append(f"ALERT {a.get('rule')} on {a.get('source')}: "
                     + ", ".join(f"{k}={v}" for k, v in sorted(a.items())
                                 if k not in ("rule", "source", "since")))
    evs = doc.get("events") or []
    if evs:
        lines.append(f"recent events ({len(evs)}):")
        for ev in evs[-8:]:
            lines.append(f"  {ev.get('kind')} source={ev.get('source')} "
                         f"{ev.get('detail') or {}}")
    for inc in doc.get("incidents") or []:
        lines.append(f"incident {inc.get('id')} reason={inc.get('reason')} "
                     f"origin={inc.get('origin')} "
                     f"dumps={len(inc.get('dumps') or [])}/"
                     f"{len(inc.get('targets') or [])}")
    lines.append("-" * 78)
    return "\n".join(lines)
