"""Black-box flight recorder — forensic ring buffers dumped on failure.

Counterpart of `paddle_tpu/obs/recorder.py`, writing the same dump
schema (`DUMP_SCHEMA`, the same top-level keys), so
`python -m paddle_tpu_torch.monitor show` and the reference's CLI read
either package's dumps. The black box holds

  - the last N step-timeline records (shared ring with `obs/timeline.py`),
  - the last M per-step monitor-counter deltas,
  - the reference's collective-sequence key, empty until the
    distributed slice ports `parallel.collective`,
  - recent events (serving overloads, injected faults),

plus the in-flight phase, the still-open step record, the memory census
ring, the request-trace rings, the SLO state and the thread/lock table at
dump time. `dump(path, reason)` writes ONE JSON artifact; automatic dumps
fire for registered error types (`obs.register_dump_trigger`): serving
overload (`ServerOverloadedError`) and OOM (`obs.memory.maybe_dump_oom`).

Automatic dumps are rate-limited per reason (`FLAGS_obs_dump_min_interval_s`)
so an overload storm cannot flood the disk; explicit `dump(path=...)` calls
never are.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["FlightRecorder", "DUMP_SCHEMA", "dump_to_chrome_events"]

# /2 added the "memory" section: the mem-census ring + per-phase HBM peaks
# (obs/memory.py). /3 adds "traces" (the tail-sampled request-trace rings,
# obs/trace.py) and "slo" (error-budget burn, obs/slo.py). /4 adds the
# OPTIONAL correlated-incident identity: "incident_id" (shared by every
# fleet member's dump of one incident, obs/telemetry.py fan-out) and
# "source" (the dumping process's telemetry source name). /5 adds "sync"
# (the runtime deadlock sanitizer's view, utils/syncwatch.py: live
# registered threads with held locks, the observed lock-order graph, and
# any recorded order violations — {"enabled": False} when FLAGS_sync_watch
# is off). `monitor show` renders every version — an older dump is simply
# one without the section.
DUMP_SCHEMA = "paddle_tpu.flight_recorder/5"

_EVENT_RING = 128


def _rank() -> int:
    try:
        return int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    except ValueError:
        return 0


class FlightRecorder:
    """One per process. Reads the step ring off the shared StepTimeline;
    owns the monitor-delta and event rings."""

    def __init__(self, timeline, snapshot_ring: int = 16):
        self.timeline = timeline
        self._lock = threading.Lock()
        self._deltas: deque = deque(maxlen=max(1, int(snapshot_ring)))
        self._events: deque = deque(maxlen=_EVENT_RING)
        self._last_counters: Optional[Dict[str, Any]] = None
        self._last_dump: Dict[str, float] = {}   # reason -> monotonic ts
        self.dumps: List[str] = []               # paths written this process

    # ---- feeders ----
    def on_step_end(self, record: Dict[str, Any]) -> None:
        """Timeline close hook: capture the monitor-counter delta this step
        produced."""
        from .. import monitor as _monitor
        counters = _monitor.snapshot()["counters"]
        with self._lock:
            prev = self._last_counters or {}
            delta = {k: v - prev.get(k, 0) for k, v in counters.items()
                     if v != prev.get(k, 0)}
            self._last_counters = counters
            self._deltas.append({"step": record.get("step"),
                                 "ts": record.get("t1"), "delta": delta})

    def record_event(self, kind: str, **payload) -> None:
        ev = {"ts": time.time(), "event": kind}
        ev.update(payload)
        with self._lock:
            self._events.append(ev)

    # ---- dump ----
    def _rate_limited(self, reason: str) -> bool:
        from ..core import flags as _flags
        min_s = float(_flags.flag("obs_dump_min_interval_s"))
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(reason)
            if last is not None and now - last < min_s:
                return True
            self._last_dump[reason] = now
            return False

    def dump(self, path: Optional[str] = None, reason: str = "manual",
             extra: Optional[Dict[str, Any]] = None,
             incident_id: Optional[str] = None,
             source: Optional[str] = None) -> Optional[str]:
        """Write the black box as one JSON artifact. Returns the path, or
        None when an automatic (path-less) dump was rate-limited.
        `incident_id`/`source` stamp a correlated incident (schema /4)."""
        auto = path is None
        if auto and self._rate_limited(reason):
            return None
        if path is None:
            from ..core import flags as _flags
            d = str(_flags.flag("obs_dump_dir")) or "flight_recorder"
            path = os.path.join(
                d, f"flightrec_{int(time.time() * 1000)}_{reason}"
                   f"_p{os.getpid()}.json")
        payload = self.payload(reason=reason, extra=extra,
                               incident_id=incident_id, source=source)
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        # a temporary name of this thread's own: dumps that land on one path
        # in one millisecond (ranks of one process, racing threads) must
        # not rename each other's temporary file away
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, default=str)
        os.replace(tmp, path)
        with self._lock:
            self.dumps.append(path)
        from .. import monitor as _monitor
        if _monitor._ENABLED:
            _monitor.count("obs.dumps")
            _monitor.log_event("obs.dump", reason=reason, path=path)
        return path

    def payload(self, reason: str = "manual",
                extra: Optional[Dict[str, Any]] = None,
                incident_id: Optional[str] = None,
                source: Optional[str] = None) -> Dict[str, Any]:
        from .. import monitor as _monitor
        tl = self.timeline
        with self._lock:
            deltas = list(self._deltas)
            events = list(self._events)
        snap = _monitor.snapshot()
        out = {
            "schema": DUMP_SCHEMA,
            "reason": reason,
            "ts": time.time(),
            "pid": os.getpid(),
            "rank": _rank(),
            "inflight_phase": tl.inflight_phase(),
            "open_step": tl.open_record(),
            "steps": tl.records(),
            "monitor_deltas": deltas,
            # the reference's collective ring: nothing feeds it until the
            # distributed slice ports parallel.collective
            "collectives": [],
            "events": events,
            "monitor": {"counters": snap["counters"],
                        "gauges": snap["gauges"],
                        "events": snap["events"][-32:]},
        }
        if incident_id is not None:
            out["incident_id"] = incident_id
        if source is not None:
            out["source"] = source
        from . import memory as _memory
        out["memory"] = {"census": _memory.census_ring(),
                         "phase_peaks": _memory.phase_peaks()}
        from . import slo as _slo
        from . import trace as _trace
        out["traces"] = _trace.ring_payload()
        out["slo"] = _slo.stats()
        from ..utils import syncwatch as _syncwatch
        out["sync"] = _syncwatch.dump_sync()
        if extra:
            out["extra"] = extra
        return out


def dump_to_chrome_events(dump: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Flight-recorder dump -> chrome trace events (the
    `python -m paddle_tpu_torch.monitor trace` conversion): step/phase
    spans from the records, instant events for events and collectives,
    and the request traces."""
    from .timeline import records_to_chrome_events
    pid = int(dump.get("pid", 0))
    rank = int(dump.get("rank", 0))
    records = list(dump.get("steps", []))
    if dump.get("open_step"):
        records.append(dump["open_step"])
    events = records_to_chrome_events(records, pid=pid, rank=rank)
    for ev in dump.get("events", []):
        events.append({"name": ev.get("event", "event"), "ph": "i",
                       "s": "p", "ts": float(ev.get("ts", 0.0)) * 1e6,
                       "pid": pid, "tid": rank * 10 + 3,
                       "args": {k: v for k, v in ev.items()
                                if k not in ("ts", "event")}})
    for ts, name, nbytes in dump.get("collectives", []):
        events.append({"name": name, "ph": "i", "s": "t",
                       "ts": float(ts) * 1e6, "pid": pid,
                       "tid": rank * 10 + 4, "args": {"bytes": nbytes}})
    if dump.get("inflight_phase"):
        events.append({"name": f"INFLIGHT: {dump['inflight_phase']}",
                       "ph": "i", "s": "g",
                       "ts": float(dump.get("ts", 0.0)) * 1e6,
                       "pid": pid, "tid": rank * 10})
    traces = dump.get("traces") or {}
    if traces:
        from .trace import trace_chrome_events
        events.extend(trace_chrome_events(
            list(traces.get("kept", [])) + list(traces.get("ring", [])),
            pid=pid))
    return events
