"""paddle_tpu_torch.monitor — the port's stats registry.

Counterpart of the part of `paddle_tpu/monitor.py` that the serving
engines and the bench read (:53-615): thread-safe counters, gauges and
histograms (with the DDSketch-style p50/p95/p99 sketch), the process-wide
`StatRegistry`, the `count` / `gauge_set` / `observe` entry points,
`span()` ranges (booked as `span.<name>.count` / `.dur`), `snapshot()`
and `reset()`.

Everything is gated by `FLAGS_monitor` (off by default): instrumented call
sites check the module attribute `_ENABLED`, one attribute load on the
disabled path. `core.flags.watch_flag` keeps `_ENABLED` in sync with
`set_flags({"FLAGS_monitor": ...})`.

`record_op` books the Tensor API's eager ops (`dispatch.op_count`,
`dispatch.op.<name>`, `dispatch.dur.<name>`).

Not ported yet: the event ring, the collective / retrace recorders,
the Profiler hook of `span()`, `report()` / `render_snapshot`, the JSON and
Prometheus exporters and the mergeable snapshots.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, Tuple

from .core import flags as _flags

__all__ = ["Counter", "Gauge", "Histogram", "StatRegistry", "count",
           "gauge_set", "observe", "record_op", "span", "snapshot", "reset"]

# Hot-path gate: instrumented sites read this module attribute directly.
_ENABLED: bool = bool(_flags.flag("monitor"))


def _on_flag(value) -> None:
    global _ENABLED
    _ENABLED = bool(value)


_flags.watch_flag("monitor", _on_flag)


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


class Gauge:
    """Last-write-wins instantaneous value (queue depth, slots active)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def set(self, value) -> None:
        with self._lock:
            self.value = value

    def get(self):
        return self.value


# Default buckets suit durations in seconds: 1us .. 10s, exponential.
_DEFAULT_BUCKETS: Tuple[float, ...] = (
    1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)

# DDSketch-style quantile sketch: log bins of ratio gamma keep
# |estimate - true| <= alpha * true for every quantile
_SKETCH_ALPHA = 0.005
_SKETCH_GAMMA = (1.0 + _SKETCH_ALPHA) / (1.0 - _SKETCH_ALPHA)
_SKETCH_LOG_GAMMA = math.log(_SKETCH_GAMMA)
# beyond this many bins the LOWEST bins collapse together (the tail
# quantiles live in the highest bins, which never lose precision)
_SKETCH_MAX_BINS = 2048


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics: each bucket counts
    observations <= its upper bound) plus a bounded-relative-error log-bin
    quantile sketch: the p50 / p95 / p99 of `stats()` are within
    `_SKETCH_ALPHA` relative error of the exact values, at O(bins)
    memory."""

    __slots__ = ("name", "buckets", "bucket_counts", "count", "sum",
                 "min", "max", "_sketch", "_sketch_zero", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.buckets = _DEFAULT_BUCKETS
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
                    lo = sorted(self._sketch)
                    self._sketch[lo[1]] += self._sketch.pop(lo[0])
            else:
                self._sketch_zero += 1

    def _quantile_locked(self, q: float) -> float:
        """Sketch quantile estimate, q in [0, 1]; 0.0 when empty."""
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


class StatRegistry:
    """Thread-safe get-or-create store of named metrics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

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

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name))
        return h

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counters = {n: c.get() for n, c in self._counters.items()}
            gauges = {n: g.get() for n, g in self._gauges.items()}
            hists = list(self._histograms.items())
        return {"counters": counters, "gauges": gauges,
                "histograms": {n: h.stats() for n, h in hists}}

    def reset(self) -> None:
        """Drop every metric: a fresh snapshot after reset carries no stale
        names. Metric objects obtained before keep working, detached."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_REGISTRY = StatRegistry()


def count(name: str, delta=1) -> None:
    _REGISTRY.counter(name).add(delta)


def gauge_set(name: str, value) -> None:
    _REGISTRY.gauge(name).set(value)


def observe(name: str, value: float) -> None:
    _REGISTRY.histogram(name).observe(value)


def record_op(name: str, dur: float) -> None:
    """One eager op of the Tensor API (`ops._dispatch.op`)."""
    _REGISTRY.counter("dispatch.op_count").add(1)
    _REGISTRY.counter(f"dispatch.op.{name}").add(1)
    _REGISTRY.histogram(f"dispatch.dur.{name}").observe(dur)


class _NullSpan:
    """Shared no-op context: the disabled span() path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        _REGISTRY.counter(f"span.{self.name}.count").add(1)
        _REGISTRY.histogram(f"span.{self.name}.dur").observe(
            time.time() - self._t0)
        return False


def span(name: str):
    """Instrumentation range: `with monitor.span("stage"): ...`. Duration
    lands in `span.<name>.dur` (seconds). Disabled -> shared no-op."""
    if not _ENABLED:
        return _NULL_SPAN
    return _Span(name)


def snapshot() -> Dict[str, Any]:
    """Nested dict of every metric: {counters, gauges, histograms}."""
    return _REGISTRY.snapshot()


def reset() -> None:
    _REGISTRY.reset()
