"""Step timeline — per-step phase attribution for the training hot loop.

Counterpart of `paddle_tpu/obs/timeline.py`. One record per training step:

    {"step": 17, "t0": ..., "t1": ..., "wall": 0.0123,
     "phases":  {"h2d": 0.0004, "device_compute": 0.0115, ...},
     "spans":   [["h2d", t0, t1], ...],          # for chrome export
     "between": {"data_wait": 0.0021, ...}}      # time spent BETWEEN steps

`phases` holds only time spent inside the step window, so
`sum(phases.values()) ≈ wall` is an invariant (tested); work that happens
between steps (DataLoader queue wait) accumulates in a pending bucket and
is folded into the NEXT record's `between` dict — visible, but never
double-counted against wall.

Records live in a bounded ring (`FLAGS_obs_ring_steps`); the flight
recorder (`obs/recorder.py`) shares the same ring. Chrome-trace export
(`ph:"X"`) carries steps and phases.

Device work is asynchronous: a phase that launches it ends only after
`fence()` has synchronized the CUDA stream the work was launched on (the
serving worker's stream, the stream a `run()` replay was issued to, or the
current stream), so its time is not booked to whatever phase synchronizes
next. The reference fences with `block_until_ready`.

Phase vocabulary used by the instrumented call sites:
  data_wait       DataLoader consumer stalled on the worker queue (io/)
  h2d             batch → device tensors (jit/train_step.py)
  build           TrainStep._build: module-tree walk + slot init
  trace_compile   the first step of a novel signature (eager warm-up +
                  CUDA-graph capture in run(); the first eager step of
                  __call__)
  device_compute  steady-state dispatch, fenced on its stream
  optimizer       eager Optimizer.step (TrainStep fuses it into
                  device_compute)
  decode_step     one LLMEngine decode step
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = ["StepTimeline", "PHASES", "fence"]

PHASES = ("data_wait", "h2d", "prefetch_h2d", "build", "trace_compile",
          "device_compute", "collective", "optimizer", "snapshot",
          "checkpoint", "desync")


def fence(device=None) -> None:
    """End the device work of a phase: synchronize the CUDA stream that is
    current on `device` (the stream the phase launched on). No-op on the
    CPU, where the work is done when the call returns."""
    import torch
    if device is not None and torch.device(device).type != "cuda":
        return
    if torch.cuda.is_available():
        torch.cuda.current_stream(device).synchronize()

_MAX_SPANS_PER_STEP = 128

# Per-thread count of open `with phase(...)` contexts. The executable
# substrate (core/executable.py) reads this to suppress a nested booking:
# when a dispatch site already sits inside an enclosing phase, opening a
# second phase would book the same wall time twice and break the
# phase-sum≈wall invariant.
_PHASE_TLS = threading.local()


def thread_phase_depth() -> int:
    return getattr(_PHASE_TLS, "depth", 0)


class _NullCtx:
    """Shared no-op context: disabled phase()/step_record() allocate nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_CTX = _NullCtx()


class _Phase:
    __slots__ = ("_tl", "name", "_t0", "_token")

    def __init__(self, tl: "StepTimeline", name: str):
        self._tl = tl
        self.name = name

    def __enter__(self):
        self._t0 = time.time()
        self._token = self._tl._enter_phase(self.name, self._t0)
        return self

    def __exit__(self, *exc):
        self._tl._exit_phase(self._token, self.name, self._t0, time.time())
        return False


class _StepCtx:
    __slots__ = ("_tl",)

    def __init__(self, tl: "StepTimeline"):
        self._tl = tl

    def __enter__(self):
        self._tl._step_enter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tl._step_exit(exc)
        return False


class StepTimeline:
    """Bounded ring of per-step phase records. Thread-safe: phases may be
    reported from DataLoader consumer threads while the step record is
    owned by the training thread. Reentrant: nested step_record() calls
    share one record — the outermost owner opens and closes it."""

    def __init__(self, capacity: int = 64):
        self._lock = threading.RLock()
        self._ring: deque = deque(maxlen=max(1, int(capacity)))
        self._open: Optional[Dict[str, Any]] = None
        self._depth = 0
        self._step_no = 0
        self._pending: Dict[str, float] = {}
        self._pending_spans: List[List] = []
        self._open_spans: Dict[int, tuple] = {}   # token -> (name, t0)
        self._next_token = 0
        self._marker: Optional[tuple] = None      # (name, ts) from mark()
        # recorder hook: called with the closed record (obs wires this)
        self.on_close: Optional[Callable[[Dict[str, Any]], None]] = None
        # phase-boundary hook: called as (name, t0, t1) at every phase
        # exit (obs wires the memory plane's peak-HBM sampler here when
        # both FLAGS_obs_timeline and FLAGS_mem_census are on)
        self.on_phase: Optional[Callable[[str, float, float], None]] = None

    # ---- step record lifecycle ----
    def step_record(self) -> _StepCtx:
        return _StepCtx(self)

    def _step_enter(self) -> None:
        with self._lock:
            self._depth += 1
            if self._depth > 1:
                return
            self._step_no += 1
            self._open = {
                "step": self._step_no,
                "t0": time.time(),
                "phases": {},
                "spans": [],
                "between": self._pending,
                "between_spans": self._pending_spans[:_MAX_SPANS_PER_STEP],
            }
            self._pending = {}
            self._pending_spans = []

    def _step_exit(self, exc) -> None:
        with self._lock:
            self._depth -= 1
            if self._depth > 0 or self._open is None:
                return
            rec = self._open
            self._open = None
            rec["t1"] = time.time()
            rec["wall"] = rec["t1"] - rec["t0"]
            if exc is not None:
                rec["error"] = f"{type(exc).__name__}: {str(exc)[:200]}"
                rec["inflight"] = self.inflight_phase()
            self._ring.append(rec)
            hook = self.on_close
        if hook is not None:
            hook(rec)

    # ---- phases ----
    def phase(self, name: str) -> _Phase:
        return _Phase(self, name)

    def _enter_phase(self, name: str, t0: float) -> int:
        _PHASE_TLS.depth = getattr(_PHASE_TLS, "depth", 0) + 1
        with self._lock:
            self._next_token += 1
            self._open_spans[self._next_token] = (name, t0)
            return self._next_token

    def _exit_phase(self, token: int, name: str, t0: float, t1: float) -> None:
        _PHASE_TLS.depth = max(0, getattr(_PHASE_TLS, "depth", 1) - 1)
        with self._lock:
            self._open_spans.pop(token, None)
        self.add_phase(name, t1 - t0, t0, t1)
        hook = self.on_phase
        if hook is not None:
            hook(name, t0, t1)

    def add_phase(self, name: str, dur: float,
                  t0: Optional[float] = None,
                  t1: Optional[float] = None) -> None:
        """Fold a measured duration into the open step record, or into the
        pending between-steps bucket when no step is open."""
        with self._lock:
            rec = self._open
            if rec is not None:
                phases, spans = rec["phases"], rec["spans"]
            else:
                phases, spans = self._pending, self._pending_spans
            phases[name] = phases.get(name, 0.0) + float(dur)
            if t0 is not None and len(spans) < _MAX_SPANS_PER_STEP:
                spans.append([name, t0, t1 if t1 is not None else t0 + dur])

    def add_async_phase(self, name: str, dur: float,
                        t0: Optional[float] = None,
                        t1: Optional[float] = None) -> None:
        """Book time that ran CONCURRENTLY with steps on another thread
        (prefetch feeder h2d, background checkpoint IO). It always lands in
        the pending between-steps bucket — never inside the open step
        record — so hidden work stays visible in summaries without breaking
        the in-window phases-sum≈wall invariant or double-counting against
        device_compute."""
        with self._lock:
            phases, spans = self._pending, self._pending_spans
            phases[name] = phases.get(name, 0.0) + float(dur)
            if t0 is not None and len(spans) < _MAX_SPANS_PER_STEP:
                spans.append([name, t0, t1 if t1 is not None else t0 + dur])

    def mark(self, name: str) -> None:
        """Cheap progress marker (no duration), so a wedged step's dump
        can name where it hung even between timeline phase spans."""
        self._marker = (name, time.time())

    def inflight_phase(self) -> Optional[str]:
        """Name of the innermost currently-open phase span, falling back
        to the last mark() — the 'where were we' field of a crash dump."""
        with self._lock:
            if self._open_spans:
                return max(self._open_spans.values(), key=lambda v: v[1])[0]
        if self._marker is not None:
            return self._marker[0]
        return None

    # ---- read side ----
    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def last(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def open_record(self) -> Optional[Dict[str, Any]]:
        """Shallow snapshot of the in-flight (unclosed) step record — what
        the flight recorder captures when a step dies mid-way."""
        with self._lock:
            if self._open is None:
                return None
            rec = dict(self._open)
            rec["phases"] = dict(rec["phases"])
            rec["spans"] = list(rec["spans"])
            return rec

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._open = None
            self._depth = 0
            self._step_no = 0
            self._pending = {}
            self._pending_spans = []
            self._open_spans = {}
            self._marker = None

    # ---- aggregation / reports ----
    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-phase aggregate over the ring: {phase: {count, total, mean}}.
        Between-steps phases (data_wait) are included
        under their own names — they are real wall time, just not inside
        any step window."""
        agg: Dict[str, Dict[str, float]] = {}
        for rec in self.records():
            for src in ("phases", "between"):
                for name, dur in rec.get(src, {}).items():
                    a = agg.setdefault(name,
                                       {"count": 0, "total": 0.0, "mean": 0.0})
                    a["count"] += 1
                    a["total"] += dur
        for a in agg.values():
            a["mean"] = a["total"] / a["count"] if a["count"] else 0.0
        return agg

    def report(self, time_unit: str = "ms") -> str:
        scale = {"s": 1.0, "ms": 1e3, "us": 1e6}.get(time_unit, 1e3)
        recs = self.records()
        lines = ["-" * 64,
                 f"step timeline ({len(recs)} steps in ring)",
                 "-" * 64,
                 f"{'Phase':<24}{'Steps':>8}{'Total(' + time_unit + ')':>14}"
                 f"{'Mean':>12}"]
        agg = self.summary()
        for name in sorted(agg, key=lambda n: -agg[n]["total"]):
            a = agg[name]
            lines.append(f"{name[:23]:<24}{a['count']:>8}"
                         f"{a['total'] * scale:>14.3f}"
                         f"{a['mean'] * scale:>12.3f}")
        if recs:
            walls = [r["wall"] for r in recs]
            lines.append("-" * 64)
            lines.append(f"{'step wall':<24}{len(walls):>8}"
                         f"{sum(walls) * scale:>14.3f}"
                         f"{sum(walls) / len(walls) * scale:>12.3f}")
        lines.append("-" * 64)
        return "\n".join(lines)

    # ---- chrome export ----
    def chrome_events(self, pid: Optional[int] = None) -> List[Dict[str, Any]]:
        pid = os.getpid() if pid is None else pid
        return records_to_chrome_events(self.records(), pid=pid)

    def export_chrome(self, path: str) -> str:
        """Write a chrome://tracing JSON: step + phase `ph:"X"` events and
        the monitor counter snapshot — one artifact, both planes."""
        import json
        events = self.chrome_events()
        from .. import monitor as _monitor
        snap = _monitor.snapshot()
        events.append({"name": "paddle_tpu_torch.monitor", "ph": "M",
                       "pid": os.getpid(), "tid": 0, "args": snap})
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"},
                      f, default=str)
        return path


def records_to_chrome_events(records, pid: int = 0,
                             rank: Optional[int] = None):
    """Step records -> chrome trace `ph:"X"` events. Steps land on tid 0,
    in-step phase spans on tid 1, between-step spans on tid 2 (rank*10
    offsets keep a merged pod timeline readable)."""
    base = (rank or 0) * 10
    events = []
    for rec in records:
        name = f"step {rec.get('step', '?')}"
        if rank is not None:
            name = f"r{rank} {name}"
        if "t0" in rec:
            events.append({"name": name, "ph": "X", "cat": "step",
                           "ts": rec["t0"] * 1e6,
                           "dur": rec.get("wall", 0.0) * 1e6,
                           "pid": pid, "tid": base,
                           "args": {"phases": rec.get("phases", {}),
                                    "error": rec.get("error")}})
        for tid_off, key in ((1, "spans"), (2, "between_spans")):
            for span in rec.get(key, []):
                sname, t0, t1 = span[0], span[1], span[2]
                events.append({"name": sname, "ph": "X", "cat": "phase",
                               "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6,
                               "pid": pid, "tid": base + tid_off})
    return events
