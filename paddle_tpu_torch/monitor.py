"""paddle_tpu_torch.monitor — the port's telemetry plane.

Counterpart of `paddle_tpu/monitor.py`: one process-wide registry of
thread-safe counters, gauges and histograms (with the DDSketch-style
p50/p95/p99 sketch) that every ported layer reports into — the serving
engines (`serving.*`, `llm.*`), the wire (`net.*`), the request traces
(`trace.*`, `span.trace.*`), the SLO plane (`slo.*`), the memory census
(`mem.*`), `jit.TrainStep` (`jit.train_step.*`), the optimizer
(`optimizer.*`), `amp.GradScaler` (`amp.*`), the DataLoader
(`io.dataloader.*`), fault injection (`faults.injected.*`) and the Tensor
API's eager ops (`dispatch.*`) — plus a bounded event ring (retrace
signatures, dumps).

Everything is gated by `FLAGS_monitor` (off by default): instrumented call
sites check the module attribute `_ENABLED`, one attribute load on the
disabled path. `core.flags.watch_flag` keeps `_ENABLED` in sync with
`set_flags({"FLAGS_monitor": ...})`.

Outputs: `snapshot()` (nested dict), `report()` (rendered table),
`export_json(path)`, `prometheus_text()` / `export_prometheus(path)` /
`prometheus_text_multi`, `mergeable_snapshot()` / `merge_snapshots()`,
and `span(name)` ranges. Prometheus names keep the reference's
`paddle_tpu_` prefix, so one dashboard reads either package.

`python -m paddle_tpu_torch.monitor show|diff|trace|mem|slo|threads`
inspects snapshot exports and flight-recorder dumps; `cache` lists,
verifies and garbage-collects a persistent compile-cache directory
(`core/compile_cache.py`); `ps` renders a PS durability directory;
`fleet` renders a replica table (a `FleetRouter.dump` or live 'PDHQ'
probes) and `top` the live fleet table of a `TelemetryCollector`.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .core import flags as _flags

__all__ = [
    "Counter", "Gauge", "Histogram", "StatRegistry",
    "enabled", "enable", "disable",
    "counter", "gauge", "histogram",
    "count", "gauge_set", "observe", "log_event", "record_op",
    "record_retrace", "record_span",
    "span", "snapshot", "report", "reset",
    "mergeable_snapshot", "merge_snapshots",
    "export_json", "prometheus_text", "prometheus_text_multi",
    "export_prometheus",
]

# Hot-path gate: instrumented sites read this module attribute directly.
_ENABLED: bool = bool(_flags.flag("monitor"))


def _on_flag(value) -> None:
    global _ENABLED
    _ENABLED = bool(value)


_flags.watch_flag("monitor", _on_flag)


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    _flags.set_flags({"monitor": True})


def disable() -> None:
    _flags.set_flags({"monitor": False})


# ---- metric primitives (monitor.h StatValue role) -------------------------

class Counter:
    """Monotonic int/float accumulator (STAT_ADD)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def add(self, delta=1) -> None:
        with self._lock:
            self.value += delta

    def get(self):
        return self.value

    def reset(self) -> None:
        with self._lock:
            self.value = 0


class Gauge:
    """Last-write-wins instantaneous value (queue depth, cache size)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def set(self, value) -> None:
        with self._lock:
            self.value = value

    def add(self, delta=1) -> None:
        with self._lock:
            self.value += delta

    def get(self):
        return self.value

    def reset(self) -> None:
        with self._lock:
            self.value = 0


# Default buckets suit durations in seconds: 1us .. 10s, exponential.
_DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)

# DDSketch-style quantile sketch parameters: log buckets of ratio gamma
# guarantee |estimate - true| <= alpha * true for every quantile — the 8
# fixed exponential buckets above are fine for a Prometheus scrape but
# cannot produce the accurate p99 SLO routing needs. alpha=0.005 -> <=1%
# relative error with two sketch buckets to spare.
_SKETCH_ALPHA = 0.005
_SKETCH_GAMMA = (1.0 + _SKETCH_ALPHA) / (1.0 - _SKETCH_ALPHA)
_SKETCH_LOG_GAMMA = math.log(_SKETCH_GAMMA)
# ~2048 bins cover >10 orders of magnitude at 1% error; beyond that the
# LOWEST bins collapse together (the tail quantiles everyone routes on
# live in the highest bins, which never lose precision)
_SKETCH_MAX_BINS = 2048


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each bucket counts
    observations <= its upper bound; +Inf is implicit via `count`) plus a
    bounded-relative-error log-bucket quantile sketch (DDSketch-style):
    `quantile(q)` is within `_SKETCH_ALPHA` relative error of the exact
    value, at O(bins) memory independent of observation count."""

    __slots__ = ("name", "buckets", "bucket_counts", "count", "sum",
                 "min", "max", "_sketch", "_sketch_zero", "_lock")

    def __init__(self, name: str, buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.buckets = tuple(sorted(buckets or _DEFAULT_BUCKETS))
        self.bucket_counts = [0] * len(self.buckets)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = 0.0
        self._sketch: Dict[int, int] = {}   # log-bin index -> count
        self._sketch_zero = 0               # observations <= 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += value
            if value < self.min:
                self.min = value
            if value > self.max:
                self.max = value
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    self.bucket_counts[i] += 1
            if value > 0.0:
                idx = math.ceil(math.log(value) / _SKETCH_LOG_GAMMA)
                self._sketch[idx] = self._sketch.get(idx, 0) + 1
                if len(self._sketch) > _SKETCH_MAX_BINS:
                    self._collapse_locked()
            else:
                self._sketch_zero += 1

    def _collapse_locked(self) -> None:
        # fold the two lowest bins together (DDSketch collapse rule):
        # precision degrades only at the extreme LOW tail
        lo = sorted(self._sketch)
        a, b = lo[0], lo[1]
        self._sketch[b] += self._sketch.pop(a)

    def quantile(self, q: float) -> float:
        """Sketch quantile estimate: <= _SKETCH_ALPHA relative error.
        q in [0, 1]; returns 0.0 on an empty histogram."""
        with self._lock:
            return self._quantile_locked(q)

    def _quantile_locked(self, q: float) -> float:
        total = self._sketch_zero + sum(self._sketch.values())
        if total == 0:
            return 0.0
        rank = q * (total - 1)
        seen = self._sketch_zero
        if rank < seen:
            return 0.0
        for idx in sorted(self._sketch):
            seen += self._sketch[idx]
            if rank < seen:
                # midpoint of (gamma^(i-1), gamma^i] in relative terms
                return 2.0 * _SKETCH_GAMMA ** idx / (_SKETCH_GAMMA + 1.0)
        return self.max

    def quantiles(self, qs=(0.5, 0.95, 0.99)) -> Dict[float, float]:
        with self._lock:
            return {q: self._quantile_locked(q) for q in qs}

    # -- mergeable form (the fleet telemetry plane ships these) --

    def sketch_payload(self) -> Dict[str, Any]:
        """JSON-able mergeable form: the raw log-bins plus the running
        aggregates. `merge()` on the receiving side reconstructs EXACT
        fleet-wide quantiles (bin-wise sums preserve the <=1% bound —
        averaging per-source p99s would not)."""
        with self._lock:
            return {
                "bins": {str(i): c for i, c in self._sketch.items()},
                "zero": self._sketch_zero,
                "count": self.count,
                "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max,
                "buckets": list(self.buckets),
                "bucket_counts": list(self.bucket_counts),
            }

    @classmethod
    def from_payload(cls, name: str,
                     payload: Dict[str, Any]) -> "Histogram":
        h = cls(name, buckets=tuple(payload.get("buckets")
                                    or _DEFAULT_BUCKETS))
        h.merge(payload)
        return h

    def merge(self, other) -> "Histogram":
        """Fold another histogram (or a `sketch_payload()` dict) into this
        one. Sketches merge exactly: per-bin counts add, so the merged
        quantiles carry the same <=1% relative-error bound as a single
        sketch fed the pooled observations. Returns self."""
        if isinstance(other, Histogram):
            other = other.sketch_payload()
        cnt = int(other.get("count", 0))
        obuckets = tuple(other.get("buckets") or ())
        ocounts = list(other.get("bucket_counts") or ())
        with self._lock:
            if cnt:
                self.count += cnt
                self.sum += float(other.get("sum", 0.0))
                omin = other.get("min")
                if omin is not None and float(omin) < self.min:
                    self.min = float(omin)
                omax = float(other.get("max", 0.0))
                if omax > self.max:
                    self.max = omax
            if obuckets == self.buckets and len(ocounts) == len(self.buckets):
                for i, c in enumerate(ocounts):
                    self.bucket_counts[i] += int(c)
            elif ocounts:
                # boundary mismatch: re-bucket the other side's per-bucket
                # deltas at their upper bounds (cumulative stays monotone;
                # the sketch below keeps the accurate quantiles)
                prev = 0
                for ub, c in zip(obuckets, ocounts):
                    delta = int(c) - prev
                    prev = int(c)
                    if delta <= 0:
                        continue
                    for i, mine in enumerate(self.buckets):
                        if ub <= mine:
                            self.bucket_counts[i] += delta
            self._sketch_zero += int(other.get("zero", 0))
            for idx, c in (other.get("bins") or {}).items():
                i = int(idx)
                self._sketch[i] = self._sketch.get(i, 0) + int(c)
            while len(self._sketch) > _SKETCH_MAX_BINS:
                self._collapse_locked()
        return self

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            cnt = self.count
            return {
                "count": cnt,
                "sum": self.sum,
                "avg": (self.sum / cnt) if cnt else 0.0,
                "min": self.min if cnt else 0.0,
                "max": self.max,
                "buckets": dict(zip(self.buckets, self.bucket_counts)),
                "p50": self._quantile_locked(0.5),
                "p95": self._quantile_locked(0.95),
                "p99": self._quantile_locked(0.99),
            }

    def reset(self) -> None:
        with self._lock:
            self.bucket_counts = [0] * len(self.buckets)
            self.count = 0
            self.sum = 0.0
            self.min = float("inf")
            self.max = 0.0
            self._sketch = {}
            self._sketch_zero = 0


# ---- registry (monitor.h StatRegistry role) --------------------------------

_EVENT_RING_CAP = 256


class StatRegistry:
    """Thread-safe get-or-create store of named metrics + an event ring
    (bounded structured log — retrace causes, anomalies)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._events: List[Dict[str, Any]] = []

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name,
                                                Histogram(name, buckets))
        return h

    def log_event(self, name: str, **payload) -> None:
        ev = {"ts": time.time(), "event": name}
        ev.update(payload)
        with self._lock:
            self._events.append(ev)
            if len(self._events) > _EVENT_RING_CAP:
                del self._events[: len(self._events) - _EVENT_RING_CAP]

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counters = {n: c.get() for n, c in self._counters.items()}
            gauges = {n: g.get() for n, g in self._gauges.items()}
            hists = list(self._histograms.items())
            events = list(self._events)
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": {n: h.stats() for n, h in hists},
            "events": events,
        }

    def mergeable_snapshot(self) -> Dict[str, Any]:
        """Like snapshot(), but histograms come as `sketch_payload()` dicts
        so the receiving side can `merge_snapshots()` them into true
        fleet-wide quantiles (a stats() dict cannot be merged — its
        quantiles are already collapsed)."""
        with self._lock:
            counters = {n: c.get() for n, c in self._counters.items()}
            gauges = {n: g.get() for n, g in self._gauges.items()}
            hists = list(self._histograms.items())
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": {n: h.sketch_payload() for n, h in hists},
        }

    def reset(self) -> None:
        """Drop every metric (STAT_RESET role): a fresh snapshot after
        reset carries no stale zero-valued names. Holders of metric objects
        obtained before the reset keep functioning but are detached."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._events.clear()


_REGISTRY = StatRegistry()


def registry() -> StatRegistry:
    return _REGISTRY


def counter(name: str) -> Counter:
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return _REGISTRY.gauge(name)


def histogram(name: str, buckets=None) -> Histogram:
    return _REGISTRY.histogram(name, buckets)


# ---- instrumentation entry points (the STAT_ADD call sites use these) ------

def count(name: str, delta=1) -> None:
    _REGISTRY.counter(name).add(delta)


def gauge_set(name: str, value) -> None:
    _REGISTRY.gauge(name).set(value)


def observe(name: str, value: float) -> None:
    _REGISTRY.histogram(name).observe(value)


def log_event(name: str, **payload) -> None:
    _REGISTRY.log_event(name, **payload)


def record_op(name: str, dur: float) -> None:
    """One eager op of the Tensor API (`ops._dispatch.op`)."""
    _REGISTRY.counter("dispatch.op_count").add(1)
    _REGISTRY.counter(f"dispatch.op.{name}").add(1)
    _REGISTRY.histogram(f"dispatch.dur.{name}").observe(dur)


def record_collective(name: str, nbytes: int) -> None:
    """One collective API call moving (logically) `nbytes`."""
    _REGISTRY.counter("collective.count").add(1)
    _REGISTRY.counter("collective.bytes").add(nbytes)
    _REGISTRY.counter(f"collective.{name}.count").add(1)
    _REGISTRY.counter(f"collective.{name}.bytes").add(nbytes)


def record_retrace(kind: str, signature, first: bool) -> None:
    """A dispatch-cache event. first=True is the first signature (the
    expected build: a CUDA-graph capture or an export); first=False is a
    novel argument shape/dtype signature that forced another one. The
    signature is logged so the offending input can be padded/bucketed
    away."""
    if first:
        _REGISTRY.counter(f"jit.{kind}.traces").add(1)
    else:
        _REGISTRY.counter(f"jit.{kind}.retraces").add(1)
        _REGISTRY.counter("jit.retraces").add(1)
        _REGISTRY.log_event("jit.retrace", kind=kind,
                            signature=list(signature))


def arg_signature(arrays) -> Tuple[str, ...]:
    """Hashable (shape, dtype) signature of a flat array/tensor list."""
    sig = []
    for a in arrays:
        v = getattr(a, "_value", a)
        sig.append(f"{tuple(getattr(v, 'shape', ()))}:"
                   f"{getattr(v, 'dtype', type(v).__name__)}")
    return tuple(sig)


# ---- trace spans (event_tracing.h RecordEvent role) ------------------------

class _NullSpan:
    """Shared no-op context: the disabled span() path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def record_span(name: str, t0: float, t1: float) -> None:
    """Book one completed range: `span.<name>.count`/`.dur` metrics.
    `monitor.span()` and the request-trace spans (obs/trace.py) both land
    here."""
    _REGISTRY.counter(f"span.{name}.count").add(1)
    _REGISTRY.histogram(f"span.{name}.dur").observe(t1 - t0)


class _Span:
    __slots__ = ("name", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        record_span(self.name, self._t0, time.time())
        return False


def span(name: str):
    """Instrumentation range: `with monitor.span("stage"): ...`. Duration
    lands in `span.<name>.dur`. Disabled -> shared no-op context."""
    if not _ENABLED:
        return _NULL_SPAN
    return _Span(name)


# ---- snapshots / reports / exporters ---------------------------------------

def snapshot() -> Dict[str, Any]:
    """Nested dict of every metric: {counters, gauges, histograms, events}."""
    return _REGISTRY.snapshot()


def mergeable_snapshot() -> Dict[str, Any]:
    """snapshot() with histograms in `Histogram.sketch_payload()` form —
    the shape `merge_snapshots()` consumes and the telemetry exporter
    ships over the wire."""
    return _REGISTRY.mergeable_snapshot()


def merge_snapshots(snaps) -> Dict[str, Any]:
    """Fold mergeable snapshots (see `mergeable_snapshot()`) from several
    sources into one fleet-wide view: counters and gauges SUM (a fleet
    queue depth is the sum of per-replica depths), histograms merge
    bin-wise into `Histogram` objects whose quantiles keep the sketch's
    <=1% relative-error bound — the one aggregation averaging per-source
    p99s can never give you."""
    counters: Dict[str, Any] = {}
    gauges: Dict[str, Any] = {}
    hists: Dict[str, Histogram] = {}
    for snap in snaps:
        if not isinstance(snap, dict):
            continue
        for name, v in (snap.get("counters") or {}).items():
            counters[name] = counters.get(name, 0) + v
        for name, v in (snap.get("gauges") or {}).items():
            gauges[name] = gauges.get(name, 0) + v
        for name, payload in (snap.get("histograms") or {}).items():
            if not isinstance(payload, dict) or "bins" not in payload:
                continue   # stats()-shaped entry: not mergeable, skip
            h = hists.get(name)
            if h is None:
                hists[name] = Histogram.from_payload(name, payload)
            else:
                h.merge(payload)
    return {"counters": counters, "gauges": gauges, "histograms": hists}


def events() -> List[Dict[str, Any]]:
    return _REGISTRY.events()


def reset() -> None:
    _REGISTRY.reset()


def report(time_unit: str = "ms") -> str:
    """Rendered stats table of the live registry."""
    return render_snapshot(
        _REGISTRY.snapshot(), time_unit=time_unit,
        title_right=f"(FLAGS_monitor={'1' if _ENABLED else '0'})")


def render_snapshot(snap: Dict[str, Any], time_unit: str = "ms",
                    title_right: str = "") -> str:
    """Render ANY snapshot()-shaped dict (live registry, or a JSON artifact
    loaded back by the `python -m paddle_tpu_torch.monitor show` CLI)."""
    scale = {"s": 1.0, "ms": 1e3, "us": 1e6}.get(time_unit, 1e3)
    width = 78
    lines = ["-" * width,
             f"{'paddle_tpu_torch.monitor':<58}{title_right:>20}",
             "-" * width]
    if snap.get("counters"):
        lines.append(f"{'Counter':<52}{'Value':>24}")
        for name in sorted(snap["counters"]):
            lines.append(f"{name[:51]:<52}{snap['counters'][name]:>24}")
        lines.append("-" * width)
    if snap.get("gauges"):
        lines.append(f"{'Gauge':<52}{'Value':>24}")
        for name in sorted(snap["gauges"]):
            lines.append(f"{name[:51]:<52}{snap['gauges'][name]:>24}")
        lines.append("-" * width)
    if snap.get("histograms"):
        lines.append(f"{'Histogram':<38}{'Count':>8}"
                     f"{'Avg(' + time_unit + ')':>11}"
                     f"{'Min':>10}{'Max':>11}")
        for name in sorted(snap["histograms"]):
            st = snap["histograms"][name]
            lines.append(
                f"{name[:37]:<38}{st['count']:>8}{st['avg'] * scale:>11.3f}"
                f"{st['min'] * scale:>10.3f}{st['max'] * scale:>11.3f}")
        lines.append("-" * width)
    if snap.get("events"):
        lines.append(f"events: {len(snap['events'])} "
                     f"(last: {snap['events'][-1].get('event')})")
        lines.append("-" * width)
    if len(lines) == 3:
        lines.append("(no stats recorded)")
        lines.append("-" * width)
    return "\n".join(lines)


def export_json(path: str) -> str:
    """Write snapshot() as a JSON artifact."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(snapshot(), f, indent=1, default=str)
    return path


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch == "_") else "_")
    n = "".join(out)
    if n and n[0].isdigit():
        n = "_" + n
    return "paddle_tpu_" + n


def _prom_uniq(pn: str, seen: Dict[str, int]) -> str:
    """Sanitization can collide distinct metric names (`span.a.b` and
    `span.a_b` both map to `..._span_a_b`); a duplicate family is a
    format violation, so later arrivals get a deterministic suffix."""
    n = seen.get(pn, 0)
    seen[pn] = n + 1
    return pn if n == 0 else f"{pn}_dup{n}"


def prometheus_text() -> str:
    """Prometheus text exposition format (text/plain; version 0.0.4).

    Histograms emit the full conforming family — cumulative
    `_bucket{le=...}` including `le="+Inf"`, `_sum`, `_count` — plus a
    sibling `<name>_q` summary family carrying the sketch quantiles
    (p50/p95/p99 at <=1% relative error). The summary is a separate
    family because mixing sample types under one metric name is
    non-conforming."""
    snap = _REGISTRY.snapshot()
    seen: Dict[str, int] = {}
    lines: List[str] = []
    for name in sorted(snap["counters"]):
        pn = _prom_uniq(_prom_name(name), seen)
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {snap['counters'][name]}")
    for name in sorted(snap["gauges"]):
        pn = _prom_uniq(_prom_name(name), seen)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {snap['gauges'][name]}")
    for name in sorted(snap["histograms"]):
        st = snap["histograms"][name]
        pn = _prom_uniq(_prom_name(name), seen)
        lines.append(f"# TYPE {pn} histogram")
        for ub, c in st["buckets"].items():
            lines.append(f'{pn}_bucket{{le="{ub}"}} {c}')
        lines.append(f'{pn}_bucket{{le="+Inf"}} {st["count"]}')
        lines.append(f"{pn}_sum {st['sum']}")
        lines.append(f"{pn}_count {st['count']}")
        if "p50" in st:
            qn = _prom_uniq(pn + "_q", seen)
            lines.append(f"# TYPE {qn} summary")
            for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                lines.append(f'{qn}{{quantile="{q}"}} {st[key]}')
            lines.append(f"{qn}_sum {st['sum']}")
            lines.append(f"{qn}_count {st['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


def export_prometheus(path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(prometheus_text())
    return path


def _prom_escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def prometheus_text_multi(per_source: Dict[str, Dict[str, Any]]) -> str:
    """ONE fleet-wide Prometheus scrape over many sources' snapshots
    (snapshot()- or mergeable_snapshot()-shaped, keyed by source name).

    The multi-source fix: the same metric from N sources becomes N samples
    of ONE family distinguished by a `source` label — NOT N name-mangled
    `_dup` families (the single-process `_prom_uniq` collision rule stays
    for sanitization collisions WITHIN a source, where no label can help).

    Histograms additionally emit a fleet-wide `<name>_q` summary family
    (no source label): quantiles of the bin-wise MERGED sketch, the true
    fleet p50/p95/p99 that per-source quantiles cannot be averaged into.
    Requires mergeable (sketch_payload) histogram entries; stats()-shaped
    entries still export their per-source bucket family."""
    # family order: union of names, counters then gauges then histograms,
    # one TYPE line per family with every source's sample under it
    names: Dict[str, List[str]] = {"counters": [], "gauges": [],
                                   "histograms": []}
    for kind in names:
        seen_names = set()
        for snap in per_source.values():
            seen_names.update((snap.get(kind) or {}).keys())
        names[kind] = sorted(seen_names)
    # sanitization collisions within the union get the _dup suffix once,
    # consistently across sources (same raw name -> same family)
    seen: Dict[str, int] = {}
    fam: Dict[Tuple[str, str], str] = {}
    for kind in ("counters", "gauges", "histograms"):
        for name in names[kind]:
            fam[(kind, name)] = _prom_uniq(_prom_name(name), seen)
    lines: List[str] = []
    sources = sorted(per_source)
    for name in names["counters"]:
        pn = fam[("counters", name)]
        lines.append(f"# TYPE {pn} counter")
        for src in sources:
            vals = per_source[src].get("counters") or {}
            if name in vals:
                lines.append(f'{pn}{{source="{_prom_escape(src)}"}} '
                             f"{vals[name]}")
    for name in names["gauges"]:
        pn = fam[("gauges", name)]
        lines.append(f"# TYPE {pn} gauge")
        for src in sources:
            vals = per_source[src].get("gauges") or {}
            if name in vals:
                lines.append(f'{pn}{{source="{_prom_escape(src)}"}} '
                             f"{vals[name]}")
    merged_q: List[Tuple[str, Histogram]] = []
    for name in names["histograms"]:
        pn = fam[("histograms", name)]
        lines.append(f"# TYPE {pn} histogram")
        merged: Optional[Histogram] = None
        for src in sources:
            entry = (per_source[src].get("histograms") or {}).get(name)
            if entry is None:
                continue
            if isinstance(entry, Histogram):
                entry = entry.sketch_payload()
            lab = f'source="{_prom_escape(src)}"'
            if "bins" in entry:       # mergeable form
                buckets = dict(zip(entry.get("buckets") or (),
                                   entry.get("bucket_counts") or ()))
                count, total = entry.get("count", 0), entry.get("sum", 0.0)
                if merged is None:
                    merged = Histogram.from_payload(name, entry)
                else:
                    merged.merge(entry)
            else:                     # stats() form: no merged quantiles
                buckets = entry.get("buckets") or {}
                count, total = entry.get("count", 0), entry.get("sum", 0.0)
            for ub, c in buckets.items():
                lines.append(f'{pn}_bucket{{le="{ub}",{lab}}} {c}')
            lines.append(f'{pn}_bucket{{le="+Inf",{lab}}} {count}')
            lines.append(f"{pn}_sum{{{lab}}} {total}")
            lines.append(f"{pn}_count{{{lab}}} {count}")
        if merged is not None:
            merged_q.append((pn, merged))
    for pn, merged in merged_q:
        qn = _prom_uniq(pn + "_q", seen)
        lines.append(f"# TYPE {qn} summary")
        for q in (0.5, 0.95, 0.99):
            lines.append(f'{qn}{{quantile="{q}"}} {merged.quantile(q)}')
        lines.append(f"{qn}_sum {merged.sum}")
        lines.append(f"{qn}_count {merged.count}")
    return "\n".join(lines) + ("\n" if lines else "")


# ---- CLI: the CI-artifact inspection tool ----------------------------------
# `python -m paddle_tpu_torch.monitor show|diff|trace ...` — pretty-print a
# snapshot JSON (or flight-recorder dump), diff two snapshots (what did
# this run do that the good run didn't?), and convert a flight-recorder
# dump into a chrome://tracing file.

def _load_artifact(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _is_flight_dump(doc: Dict[str, Any]) -> bool:
    return str(doc.get("schema", "")).startswith("paddle_tpu.flight_recorder")


def _render_flight_dump(doc: Dict[str, Any]) -> str:
    lines = ["-" * 78,
             f"flight recorder dump — reason: {doc.get('reason')!r}  "
             f"rank {doc.get('rank')}  pid {doc.get('pid')}",
             "-" * 78,
             f"in-flight phase: {doc.get('inflight_phase')!r}"]
    # schema /4 correlated-incident identity (absent in /1–/3 dumps)
    if doc.get("incident_id") or doc.get("source"):
        lines.insert(3, f"incident: {doc.get('incident_id') or '-'}  "
                        f"source: {doc.get('source') or '-'}")
    steps = doc.get("steps", [])
    open_step = doc.get("open_step")
    lines.append(f"step records: {len(steps)}"
                 + (" (+1 open/in-flight)" if open_step else ""))
    for rec in ([open_step] if open_step else []) + steps[-3:][::-1]:
        phases = ", ".join(f"{k}={v * 1e3:.2f}ms"
                           for k, v in sorted(rec.get("phases", {}).items(),
                                              key=lambda kv: -kv[1]))
        tag = "OPEN " if rec is open_step else ""
        wall = rec.get("wall")
        lines.append(f"  {tag}step {rec.get('step')}: "
                     f"wall={wall * 1e3:.2f}ms " if wall is not None
                     else f"  {tag}step {rec.get('step')} (unfinished) ")
        if phases:
            lines[-1] += f"[{phases}]"
        if rec.get("error"):
            lines.append(f"    error: {rec['error']}")
    evs = doc.get("events", [])
    if evs:
        lines.append(f"events ({len(evs)}, newest last):")
        for ev in evs[-8:]:
            extra = {k: v for k, v in ev.items() if k not in ("ts", "event")}
            lines.append(f"  {ev.get('event')} {extra}")
    colls = doc.get("collectives", [])
    if colls:
        lines.append(f"recent collectives ({len(colls)}): "
                     + ", ".join(f"{c[1]}({c[2]}B)" for c in colls[-8:]))
    counters = doc.get("monitor", {}).get("counters", {})
    if counters:
        lines.append(f"monitor counters: {len(counters)} "
                     f"(use `show` on a snapshot export for the full table)")
    # schema /2 memory section (a /1 dump simply has none of these keys)
    mem_lines = _render_dump_memory(doc)
    if mem_lines:
        lines.extend(mem_lines)
    # schema /3 trace + SLO sections (older dumps simply lack the keys)
    lines.extend(_render_dump_traces(doc))
    slosec = doc.get("slo")
    if slosec:
        from .obs import slo as _slo
        lines.extend(_slo.render_slo(slosec).splitlines())
    # schema /5 sync section (older dumps simply lack the key); one
    # summary line here — `monitor threads <dump>` renders the full table
    syncsec = doc.get("sync")
    if syncsec and syncsec.get("enabled"):
        nviol = len(syncsec.get("violations") or [])
        lines.append(f"sync: {len(syncsec.get('threads') or [])} registered "
                     f"threads, {len(syncsec.get('lock_order') or [])} "
                     f"lock-order edges, {nviol} violation(s)"
                     + (" — see `monitor threads <dump>`" if nviol else ""))
    lines.append("-" * 78)
    return "\n".join(lines)


def _render_dump_traces(doc: Dict[str, Any]) -> List[str]:
    """Render the schema-/3 trace ring of a flight dump: tail-sampled
    request traces (protected bad traces first) as span waterfalls.
    Returns [] for a /1 or /2 dump — `show` stays version-agnostic."""
    tracesec = doc.get("traces") or {}
    kept = tracesec.get("kept") or []
    ring = tracesec.get("ring") or []
    if not kept and not ring:
        return []
    from .obs import trace as _trace
    lines = [f"request traces: {len(ring)} in ring, "
             f"{len(kept)} kept (bad/slow, evict-protected)"]
    lines.extend(_trace.render_traces(kept + ring).splitlines())
    return lines


def _render_dump_memory(doc: Dict[str, Any]) -> List[str]:
    """Render the schema-/2 memory section of a flight dump: last census,
    phase peaks, and (OOM dumps) top buffers + per-executable temp bytes.
    Returns [] for a /1 dump — `show` stays version-agnostic."""
    from .obs import memory as _memory
    lines: List[str] = []
    memsec = doc.get("memory") or {}
    oom = (doc.get("extra") or {}).get("memory") or {}
    census = oom.get("census_at_dump") or \
        (memsec.get("census") or [None])[-1]
    if census:
        tags = census.get("tags", {})
        shares = ", ".join(
            f"{n}={_memory._fmt_bytes(tags[n]['bytes'])}"
            for n in sorted(tags, key=lambda n: -tags[n]["bytes"])[:6])
        lines.append(
            f"memory census ({len(memsec.get('census') or [])} in ring): "
            f"total {_memory._fmt_bytes(census.get('total_bytes', 0))}"
            + (f" [{shares}]" if shares else ""))
    peaks = oom.get("phase_peaks") or memsec.get("phase_peaks") or {}
    if peaks:
        lines.append("phase HBM peaks: " + ", ".join(
            f"{k}={_memory._fmt_bytes(v)}"
            for k, v in sorted(peaks.items(), key=lambda kv: -kv[1])))
    for row in (oom.get("top_buffers") or [])[:8]:
        origin = f" ({row['origin']})" if row.get("origin") else ""
        lines.append(f"  top buffer {_memory._fmt_bytes(row['bytes'])}  "
                     f"{row.get('dtype')}{row.get('shape')}  "
                     f"tag={row.get('tag')}{origin}")
    for name, rep in (oom.get("executables") or {}).items():
        if isinstance(rep, dict) and rep:
            body = ", ".join(f"{k}={v}" for k, v in sorted(rep.items()))
            lines.append(f"  executable {name}: {body}")
    return lines


def _diff_snapshots(a: Dict[str, Any], b: Dict[str, Any]) -> str:
    """b - a for counters/gauges and histogram count/sum: what happened
    between the two exports."""
    lines = ["-" * 78, f"{'monitor diff (b - a)':<52}{'a':>8}{'b':>9}{'Δ':>9}",
             "-" * 78]
    for kind in ("counters", "gauges"):
        ka, kb = a.get(kind, {}), b.get(kind, {})
        names = sorted(set(ka) | set(kb))
        rows = []
        for n in names:
            va, vb = ka.get(n, 0), kb.get(n, 0)
            if va != vb:
                rows.append((n, va, vb))
        if rows:
            lines.append(kind + ":")
            for n, va, vb in rows:
                try:
                    delta = f"{vb - va:+}"
                except TypeError:
                    delta = "?"
                lines.append(f"  {n[:49]:<50}{va:>8}{vb:>9}{delta:>9}")
    ha, hb = a.get("histograms", {}), b.get("histograms", {})
    rows = []
    for n in sorted(set(ha) | set(hb)):
        ca = ha.get(n, {}).get("count", 0)
        cb = hb.get(n, {}).get("count", 0)
        if ca != cb:
            rows.append(f"  {n[:49]:<50}{ca:>8}{cb:>9}{cb - ca:>+9}")
    if rows:
        lines.append("histogram counts:")
        lines.extend(rows)
    if len(lines) == 3:
        lines.append("(no differences)")
    lines.append("-" * 78)
    return "\n".join(lines)


def _slo_main(args) -> int:
    """`python -m paddle_tpu_torch.monitor slo [path]` — render burn rates and
    latency quantiles from a flight dump's `slo` section, a snapshot's
    `slo.*` gauges, or (no path) this process's live SLO plane."""
    from .obs import slo as _slo
    if args.path is None:
        print(_slo.render_slo(_slo.stats()))
        return 0
    doc = _load_artifact(args.path)
    if _is_flight_dump(doc):
        print(_slo.render_slo(doc.get("slo")))
        return 0
    print(_slo.render_slo(_slo.doc_from_snapshot(doc)))
    return 0


def _ps_main(args) -> int:
    """`python -m paddle_tpu_torch.monitor ps <wal-dir>`: render a PS
    durability directory — snapshot generations, the WAL segment chain
    (per-segment intactness), and the HA role/watermark side-file."""
    import sys as _sys
    if not os.path.isdir(args.dir):
        print(f"error: {args.dir} is not a directory", file=_sys.stderr)
        return 2
    from .distributed.ps.wal import wal_status
    doc = wal_status(args.dir)
    print(f"ps durability dir {doc['dir']}: last_lsn={doc['last_lsn']}")
    snap = doc.get("snapshot")
    if snap:
        tables = ", ".join(snap["tables"]) or "-"
        print(f"snapshot: v{snap['version']} @ lsn {snap['lsn']} "
              f"(tables: {tables})")
        if snap.get("bak_version") is not None:
            print(f"  previous generation (.bak): v{snap['bak_version']} "
                  f"@ lsn {snap['bak_lsn']}")
    else:
        print("snapshot: none (recovery would replay the WAL from lsn 0)")
    segs = doc["segments"]
    print(f"wal segments: {len(segs)}")
    if segs:
        print(f"  {'file':<24} {'start':>8} {'last':>8} {'records':>8} "
              f"{'bytes':>10}  state")
        for s in segs:
            last = s["last_lsn"] if s["last_lsn"] is not None else "-"
            state = "intact" if s["intact"] else "TORN (truncates at replay)"
            print(f"  {s['file']:<24} {s['start_lsn']:>8} {last:>8} "
                  f"{s['records']:>8} {s['bytes']:>10}  {state}")
    ha = doc.get("ha")
    if ha:
        print(f"ha: role={ha.get('role')} node={ha.get('node_id')} "
              f"epoch={ha.get('epoch')} applied_lsn={ha.get('applied_lsn')} "
              f"endpoint={ha.get('endpoint')}")
        acks = ha.get("acks") or {}
        for sid, lsn in sorted(acks.items()):
            lag = None
            try:
                lag = int(ha.get("applied_lsn", 0)) - int(lsn)
            except (TypeError, ValueError):
                pass
            lag_s = f" (lag {lag})" if lag is not None else ""
            print(f"  standby {sid}: acked lsn {lsn}{lag_s}")
    return 0


def _fleet_main(args) -> int:
    """`python -m paddle_tpu_torch.monitor fleet [path] [--probe HOST:PORT ...]`
    — render the replica table from a flight dump's `fleet` section
    (FleetRouter.dump), or build one live by probing each `--probe`
    replica's 'PDHQ' endpoint."""
    import sys as _sys
    from .serving.fleet import render_fleet
    if args.probe:
        from .inference.server import PredictorClient
        doc = {"fleet": "probe", "replicas": {}}
        for i, spec in enumerate(args.probe):
            host, _, port = spec.rpartition(":")
            row = {"host": host or "127.0.0.1", "port": int(port),
                   "healthy": False, "draining": False, "score": 0.0,
                   "served": 0, "failures": 0, "queue_depth": 0,
                   "warm_start_ms": None, "tenants": []}
            try:
                c = PredictorClient(row["host"], row["port"],
                                    connect_timeout=2.0, max_retries=0)
                s = c.health(deadline_ms=3000)
                c.close()
                rid = s.get("replica_id", i)
                row.update(healthy=True,
                           draining=bool(s.get("draining")),
                           queue_depth=s.get("queue_depth", 0),
                           warm_start_ms=s.get("warm_start_ms"),
                           tenants=sorted((s.get("tenants") or {}).keys()))
            except Exception as e:
                rid = i
                row["error"] = f"{type(e).__name__}"
            doc["replicas"][str(rid)] = row
        print(render_fleet(doc))
        return 0
    if args.path is None:
        print("error: pass a flight dump path or --probe HOST:PORT",
              file=_sys.stderr)
        return 2
    doc = _load_artifact(args.path)
    # FleetRouter.dump passes the snapshot via the recorder's `extra`
    # channel, which lands under "extra" in the artifact
    fleet_doc = doc.get("fleet") or (doc.get("extra") or {}).get("fleet")
    print(render_fleet(fleet_doc))
    return 0



def _cache_main(args) -> int:
    """`python -m paddle_tpu_torch.monitor cache [dir] [--gc] [--verify]`."""
    from .core import compile_cache as _cc
    d = args.dir or _cc.cache_dir()
    if not d:
        import sys as _sys
        print("error: no cache dir (pass one or set "
              "FLAGS_compile_cache_dir)", file=_sys.stderr)
        return 2
    if args.verify:
        ok, bad = _cc.verify(d)
        print(f"verify: {ok} ok, {len(bad)} corrupt pruned")
        for key in bad:
            print(f"  pruned {key}")
    if args.gc:
        evicted = _cc.gc(d, cap_mb=args.cap_mb)
        print(f"gc: {len(evicted)} entries evicted")
        for key in evicted:
            print(f"  evicted {key}")
    rows = _cc.entries(d)
    total = sum(max(0, r["disk_bytes"]) for r in rows)
    print(f"compile cache {d}: {len(rows)} entries, "
          f"{total / 1e6:.1f} MB")
    print(f"{'key':<42} {'kind':<14} {'topology':<30} "
          f"{'bytes':>10} {'age':>8} {'hits':>5}")
    for r in rows:
        age = r["age_s"]
        age_s = f"{age / 3600:.1f}h" if age >= 3600 else f"{age:.0f}s"
        print(f"{r['key']:<42} {r.get('kind', ''):<14} "
              f"{r.get('topology', ''):<30} {r['disk_bytes']:>10} "
              f"{age_s:>8} {r.get('hits', 0):>5}")
    return 0


def _main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.monitor",
        description="inspect monitor/flight-recorder CI artifacts")
    sub = p.add_subparsers(dest="cmd", required=True)
    p_show = sub.add_parser(
        "show", help="pretty-print a monitor snapshot JSON or a "
                     "flight-recorder dump; multiple paths render a "
                     "correlated-incident group (sorted by source)")
    p_show.add_argument("path", nargs="+")
    p_diff = sub.add_parser(
        "diff", help="diff two monitor snapshot JSONs (b - a)")
    p_diff.add_argument("a")
    p_diff.add_argument("b")
    p_trace = sub.add_parser(
        "trace", help="convert a flight-recorder dump to a chrome trace")
    p_trace.add_argument("dump")
    p_trace.add_argument("-o", "--out", default=None,
                         help="output path (default: <dump>.trace.json)")
    p_mem = sub.add_parser(
        "mem", help="render a flight-recorder dump's memory census "
                    "(no path: take a live census of this process)")
    p_mem.add_argument("path", nargs="?", default=None)
    p_slo = sub.add_parser(
        "slo", help="render SLO state: error-budget burn rates, bad-request "
                    "breakdown, sketch latency quantiles (from a "
                    "flight-recorder dump, a monitor snapshot's slo.* "
                    "gauges, or — with no path — this live process)")
    p_slo.add_argument("path", nargs="?", default=None)
    p_fleet = sub.add_parser(
        "fleet", help="render a fleet replica table: from a flight dump's "
                      "`fleet` section (FleetRouter.dump), or live via "
                      "--probe HOST:PORT health probes")
    p_fleet.add_argument("path", nargs="?", default=None)
    p_fleet.add_argument("--probe", action="append", default=[],
                         metavar="HOST:PORT",
                         help="probe a replica's 'PDHQ' endpoint "
                              "(repeatable)")
    p_top = sub.add_parser(
        "top", help="live fleet table from a TelemetryCollector: per-source "
                    "qps / queue / p99 / burn / HBM / role, stragglers "
                    "highlighted (obs/telemetry.py)")
    p_top.add_argument("addr", help="collector HOST:PORT (the address it "
                                    "published in the TCPStore)")
    p_top.add_argument("-n", "--iterations", type=int, default=1,
                       help="refresh N times (default 1: one-shot)")
    p_top.add_argument("--interval", type=float, default=1.0,
                       help="seconds between refreshes")
    p_threads = sub.add_parser(
        "threads", help="render the thread/lock table: registered threads "
                        "with owners, held locks, the observed lock-order "
                        "graph, and recorded order violations — from a "
                        "flight dump's `sync` section, or (no path) this "
                        "live process (utils/syncwatch.py)")
    p_threads.add_argument("path", nargs="?", default=None)
    p_threads.add_argument("--hold-warn-ms", type=float, default=None,
                           help="dump acquisition stacks for locks held "
                                "longer than this (default: "
                                "FLAGS_sync_hold_warn_ms)")
    p_cache = sub.add_parser(
        "cache", help="inspect a persistent compile-cache directory "
                      "(core/compile_cache.py): list entries; --gc to "
                      "enforce the size cap, --verify to CRC-check and "
                      "prune corrupt entries")
    p_cache.add_argument("dir", nargs="?", default=None,
                         help="cache directory (default: "
                              "FLAGS_compile_cache_dir)")
    p_cache.add_argument("--gc", action="store_true",
                         help="evict LRU entries beyond FLAGS_compile_cache_mb")
    p_cache.add_argument("--cap-mb", type=float, default=None,
                         help="override the size cap for --gc")
    p_cache.add_argument("--verify", action="store_true",
                         help="CRC-check every entry and prune corrupt ones")
    p_ps = sub.add_parser(
        "ps", help="render a parameter-server durability directory "
                   "(distributed/ps/wal.py): snapshot generations, WAL "
                   "segment chain with intactness, HA role + replication "
                   "watermark")
    p_ps.add_argument("dir", help="a PsServer wal_dir (FLAGS_ps_wal_dir)")
    args = p.parse_args(argv)
    if args.cmd == "top":
        from .obs import telemetry as _telemetry
        host, _, port = args.addr.rpartition(":")
        for i in range(max(1, args.iterations)):
            if i:
                time.sleep(args.interval)
            doc = _telemetry.query_collector(host or "127.0.0.1", int(port))
            print(_telemetry.render_top(doc))
        return 0
    if args.cmd == "fleet":
        return _fleet_main(args)
    if args.cmd == "ps":
        return _ps_main(args)
    if args.cmd == "cache":
        return _cache_main(args)
    if args.cmd == "threads":
        from .utils import syncwatch as _syncwatch
        if args.path is None:
            print(_syncwatch.render_threads(hold_warn_ms=args.hold_warn_ms))
            return 0
        doc = _load_artifact(args.path)
        if not _is_flight_dump(doc):
            print(f"error: {args.path} is not a flight-recorder dump "
                  f"(schema: {doc.get('schema')!r})")
            return 2
        syncsec = doc.get("sync")
        if not syncsec:
            print(f"no sync section in dump "
                  f"(schema: {doc.get('schema')!r} — /1–/4 dumps predate "
                  "it, or the dumping process ran without FLAGS_sync_watch)")
            return 0
        print(_syncwatch.render_threads(syncsec,
                                        hold_warn_ms=args.hold_warn_ms))
        return 0
    if args.cmd == "slo":
        return _slo_main(args)
    if args.cmd == "show":
        docs = [(pth, _load_artifact(pth)) for pth in args.path]
        if len(docs) > 1:
            # incident-group rendering: sort by source so the same fleet
            # reads the same top-to-bottom every time
            docs.sort(key=lambda pd: str(pd[1].get("source") or pd[0]))
            ids = {d.get("incident_id") for _, d in docs
                   if d.get("incident_id")}
            if len(ids) == 1:
                print(f"correlated incident {ids.pop()} "
                      f"({len(docs)} dumps):")
        for pth, doc in docs:
            if _is_flight_dump(doc):
                print(_render_flight_dump(doc))
            else:
                print(render_snapshot(doc, title_right=f"({pth})"))
        return 0
    if args.cmd == "diff":
        print(_diff_snapshots(_load_artifact(args.a),
                              _load_artifact(args.b)))
        return 0
    if args.cmd == "trace":
        doc = _load_artifact(args.dump)
        if not _is_flight_dump(doc):
            print(f"error: {args.dump} is not a flight-recorder dump "
                  f"(schema: {doc.get('schema')!r})")
            return 2
        from .obs import dump_to_chrome_events
        out = args.out or (args.dump + ".trace.json")
        events = dump_to_chrome_events(doc)
        os.makedirs(os.path.dirname(os.path.abspath(out)) or ".",
                    exist_ok=True)
        with open(out, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        print(out)
        return 0
    if args.cmd == "mem":
        from .obs import memory as _memory
        if args.path is None:
            print(_memory.render_census(
                _memory.census(publish=False, store=False),
                top=_memory.top_buffers()))
            return 0
        doc = _load_artifact(args.path)
        if not _is_flight_dump(doc):
            print(f"error: {args.path} is not a flight-recorder dump "
                  f"(schema: {doc.get('schema')!r})")
            return 2
        oom = (doc.get("extra") or {}).get("memory") or {}
        memsec = doc.get("memory") or {}
        census = oom.get("census_at_dump") or \
            (memsec.get("census") or [None])[-1]
        if not census:
            print(f"no memory census in dump "
                  f"(schema: {doc.get('schema')!r} — /1 dumps predate the "
                  "memory section, or FLAGS_mem_census was off)")
            return 0
        print(_memory.render_census(census, top=oom.get("top_buffers")))
        for name, rep in (oom.get("executables") or {}).items():
            if isinstance(rep, dict) and rep:
                body = ", ".join(f"{k}={v}" for k, v in sorted(rep.items()))
                print(f"executable {name}: {body}")
        return 0
    return 2


if __name__ == "__main__":
    import sys as _sys
    _sys.exit(_main())
