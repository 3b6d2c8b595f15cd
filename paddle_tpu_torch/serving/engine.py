"""ServingEngine: dynamic batching in front of the Predictor.

Counterpart of `paddle_tpu/serving/engine.py` (ServingEngine :177).
Concurrent requests are coalesced into padded shape-bucket batches:

  - bounded request queue with explicit overload rejection
    (`ServerOverloadedError`: backpressure, not failure)
  - per-request deadlines: expired requests are dropped before batching
    (`DeadlineExceededError`)
  - shape buckets (declared or learned) warmed at start
  - graceful drain on shutdown; a stats snapshot for probes

A Predictor declares its buckets (`serving_buckets`): a live layer's take
the engine's batch ladder; a saved artifact's (`inference.create_predictor`)
take only its exported batch, and shorter batches pad up to it.

Thread model: `submit()` is called from any number of threads; worker
loops (`syncwatch.Thread`s) assemble batches per bucket lane; the
predictor call is serialized by a dispatch lock (`syncwatch.lock`). On a
CUDA machine each worker launches on its own CUDA stream, which first
waits for the work already queued on the default stream (the weights'
upload); the timeline's `device_compute` fences that stream.

The reference's hooks, each behind its flag's one attribute check: the
`serving.*` monitor metrics; the SLO shed at admission and the outcome of
every request (`obs/slo.py`); the `serving.queue_wait` /
`serving.batch` / `serving.dispatch` trace spans under the request's
wire context; the `serving.dispatch` fault site; `booking(
"serving_bucket")` around the predictor call; the `serving_bucket`
memory tag on the device buffers a dispatch pins; and a flight-recorder
dump on overload (`ServerOverloadedError` is a registered trigger). The
reference's persistent compile cache waits for the `to_static` slice.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import faults as _faults
from .. import monitor as _monitor
from .. import obs as _obs
from ..core import executable as _exe
from ..core import flags as _flags
from ..obs import memory as _mem
from ..obs import slo as _slo
from ..obs import trace as _trace
from ..utils import syncwatch as _syncwatch
from .bucket import BucketSet, ShapeBucket, default_batch_sizes, signature_of

__all__ = [
    "EngineConfig", "ServingEngine", "ResponseFuture",
    "ServingError", "ServerOverloadedError", "DeadlineExceededError",
    "EngineStoppedError", "NoBucketError",
]


class ServingError(RuntimeError):
    """Base of every engine-raised request failure."""
    wire_status = 1


class ServerOverloadedError(ServingError):
    """Queue at capacity: explicit backpressure — the client should back
    off and retry (wire status 2)."""
    wire_status = 2


class DeadlineExceededError(ServingError):
    """The request's deadline passed before it reached the device (wire
    status 3)."""
    wire_status = 3


class EngineStoppedError(ServingError):
    """Submitted after stop(): the engine is draining or down (wire status
    2, retryable elsewhere)."""
    wire_status = 2


class NoBucketError(ServingError):
    """No declared bucket accepts this shape and learning is disabled."""
    wire_status = 1


# an overloaded engine dumps the flight recorder (rate-limited — one dump
# per FLAGS_obs_dump_min_interval_s, not one per rejected request)
_obs.register_dump_trigger(ServerOverloadedError, "serving_overload")


class ResponseFuture:
    """Per-request response slot resolved by a worker thread."""

    __slots__ = ("_event", "_outputs", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._outputs: Optional[List[np.ndarray]] = None
        self._error: Optional[BaseException] = None

    def _set_result(self, outputs: List[np.ndarray]) -> None:
        self._outputs = outputs
        self._event.set()

    def _set_exception(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def exception(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("response not ready")
        return self._error

    def result(self, timeout: Optional[float] = None) -> List[np.ndarray]:
        if not self._event.wait(timeout):
            raise TimeoutError("response not ready")
        if self._error is not None:
            raise self._error
        return self._outputs


class _Request:
    __slots__ = ("inputs", "rows", "bucket", "future", "enqueue_t",
                 "deadline", "trace_ctx", "qw_span")

    def __init__(self, inputs, rows, bucket, deadline, trace_ctx=None):
        self.inputs = inputs
        self.rows = rows
        self.bucket = bucket
        self.future = ResponseFuture()
        self.enqueue_t = time.monotonic()
        self.deadline = deadline  # absolute monotonic, or None
        self.trace_ctx = trace_ctx  # obs.trace.TraceContext, or None
        # queue_wait child span: opened at enqueue, closed at dispatch
        # pick-up (ok) or expiry (deadline status -> protected trace ring)
        self.qw_span = _trace.server_span("serving.queue_wait", trace_ctx)


@dataclass
class EngineConfig:
    """Knobs, each also a FLAGS_serving_* flag (`from_flags`)."""

    max_batch_size: int = 8
    batch_timeout_ms: float = 2.0       # max coalescing wait per batch
    queue_depth: int = 256              # pending-request cap (backpressure)
    default_deadline_ms: float = 0.0    # 0 = no implicit deadline
    num_workers: int = 1
    learn_buckets: bool = True          # novel signatures become buckets
    warmup_on_start: bool = True        # pre-run declared buckets
    batch_sizes: Optional[Sequence[int]] = field(default=None)

    @classmethod
    def from_flags(cls) -> "EngineConfig":
        return cls(
            max_batch_size=int(_flags.flag("serving_max_batch_size")),
            batch_timeout_ms=float(_flags.flag("serving_batch_timeout_ms")),
            queue_depth=int(_flags.flag("serving_queue_depth")),
            default_deadline_ms=float(
                _flags.flag("serving_default_deadline_ms")),
            num_workers=int(_flags.flag("serving_num_workers")),
            learn_buckets=bool(_flags.flag("serving_learn_buckets")),
            warmup_on_start=bool(_flags.flag("serving_warmup")),
        )

    def ladder(self) -> Tuple[int, ...]:
        return tuple(self.batch_sizes) if self.batch_sizes else \
            default_batch_sizes(self.max_batch_size)


class ServingEngine:
    """Dynamic batcher + worker loop(s) over one Predictor (or any callable
    of numpy arrays returning an array / list of arrays)."""

    def __init__(self, predictor, config: Optional[EngineConfig] = None):
        self.config = config or EngineConfig.from_flags()
        self.predictor = predictor
        self._call = self._make_call(predictor)
        self.buckets = BucketSet(learn=self.config.learn_buckets,
                                 default_batch_sizes_=self.config.ladder())
        # a Predictor knows its input specs: they become declared buckets
        derive = getattr(predictor, "serving_buckets", None)
        if callable(derive):
            for item_shapes, dtypes, sizes in derive(self.config.ladder()):
                self.buckets.declare(item_shapes, dtypes, sizes)
        self._cv = threading.Condition()
        self._lanes: Dict[Any, "List[_Request]"] = {}
        self._pending = 0
        self._inflight = 0
        self._stopping = False
        self._workers: List[threading.Thread] = []
        self._dispatch_lock = _syncwatch.lock(
            "engine.ServingEngine._dispatch_lock")
        # (batch, item-sig) ledger: a novel signature is one build of the
        # predictor's program (its eager first run + CUDA-graph capture)
        self._ledger = _exe.ExecutableLedger("serving_bucket")
        self._warm_start_ms: Optional[float] = None
        self._counts: Dict[str, int] = {
            "requests": 0, "completed": 0, "failed": 0, "rejected": 0,
            "expired": 0, "batches": 0, "rows": 0, "padded_rows": 0,
            "padding_waste_elems": 0, "compiles": 0, "warmup_runs": 0,
        }

    # ---- construction helpers ----
    @staticmethod
    def _make_call(predictor) -> Callable[[List[np.ndarray]],
                                          List[np.ndarray]]:
        run_batch = getattr(predictor, "run_batch", None)
        if callable(run_batch):
            return run_batch

        def call(arrays: List[np.ndarray]) -> List[np.ndarray]:
            out = predictor(*arrays)
            outs = out if isinstance(out, (list, tuple)) else [out]
            if _mem._ENABLED:
                _mem.tag("serving_bucket",
                         [o for o in outs if isinstance(o, torch.Tensor)],
                         origin="ServingEngine")
            return [np.asarray(o) for o in outs]

        return call

    # ---- bucket declaration / warmup ----
    def declare_bucket(self, item_shapes, dtypes,
                       batch_sizes=None) -> ShapeBucket:
        """Pre-declare a padded lane (shapes are per-item, no batch dim).
        Declared buckets are what warmup() runs."""
        return self.buckets.declare(item_shapes, dtypes,
                                    batch_sizes or self.config.ladder())

    def warmup(self) -> int:
        """Run the predictor once per (bucket, batch size) on zeros, so the
        first requests pay no one-time cost (kernel build, library
        handles, allocator growth). Returns runs performed."""
        t0 = time.time()
        runs = 0
        for bucket in self.buckets.buckets():
            for bs in bucket.batch_sizes:
                arrays = [np.zeros((bs,) + shape, dtype=np.dtype(dt))
                          for shape, dt in zip(bucket.item_shapes,
                                               bucket.dtypes)]
                self._dispatch_to_predictor(bucket, bs, arrays)
                runs += 1
        self._warm_start_ms = (time.time() - t0) * 1000.0
        self._bump("warmup_runs", runs)
        if _monitor._ENABLED and runs:
            _monitor.count("serving.warmup_runs", runs)
            _monitor.gauge_set("serving.warm_start_ms", self._warm_start_ms)
        return runs

    # ---- lifecycle ----
    def start(self) -> "ServingEngine":
        if self._workers:
            return self
        self._stopping = False
        if self.config.warmup_on_start:
            self.warmup()
        for i in range(max(1, self.config.num_workers)):
            t = _syncwatch.Thread(target=self._worker_loop,
                                  name=f"serving-worker-{i}", daemon=True)
            t.start()
            self._workers.append(t)
        return self

    def stop(self, drain: bool = True, timeout: float = 10.0) -> None:
        """Stop accepting requests; drain=True completes what is queued,
        drain=False fails queued futures with EngineStoppedError."""
        with self._cv:
            self._stopping = True
            if not drain:
                for lane in self._lanes.values():
                    for req in lane:
                        req.future._set_exception(EngineStoppedError(
                            "engine stopped before dispatch"))
                        self._pending -= 1
                    lane.clear()
            self._cv.notify_all()
        deadline = time.monotonic() + timeout
        for t in self._workers:
            t.join(max(0.0, deadline - time.monotonic()))
        self._workers = []
        self._set_queue_gauge()

    @property
    def running(self) -> bool:
        return bool(self._workers) and not self._stopping

    # ---- request intake ----
    def submit(self, inputs: Sequence[np.ndarray],
               deadline_ms: Optional[float] = None,
               trace_ctx=None) -> ResponseFuture:
        """Enqueue one request (arrays share a leading batch dim, usually
        1; a `Tensor` is read through its `numpy()`, the Tensor API's
        boundary here). Raises ServerOverloadedError / EngineStoppedError /
        NoBucketError / ValueError synchronously; everything later lands
        on the returned future. `trace_ctx` (an obs.trace.TraceContext,
        normally the server-side request span's context) parents the
        engine's queue_wait/batch/dispatch spans."""
        arrays = [np.ascontiguousarray(a) for a in inputs]
        if not arrays:
            raise ValueError("empty request")
        rows = int(arrays[0].shape[0]) if arrays[0].ndim else 0
        if rows < 1 or any(a.ndim == 0 or a.shape[0] != rows
                           for a in arrays):
            raise ValueError(
                "request inputs must share a leading batch dim >= 1")
        if _slo._ENABLED and _slo.should_shed():
            # burn-rate admission control (FLAGS_slo_shed_burn)
            self._bump("rejected")
            if _monitor._ENABLED:
                _monitor.count("serving.rejected")
                _monitor.count("serving.shed")
            _slo.record_request(None, _slo.OUTCOME_REJECTED)
            raise ServerOverloadedError(
                "shedding: SLO error-budget burn rate over "
                "FLAGS_slo_shed_burn; back off and retry")
        sig = signature_of(arrays)
        bucket = self.buckets.resolve(sig)
        if bucket is None:
            self._bump("rejected")
            if _monitor._ENABLED:
                _monitor.count("serving.rejected")
            if _slo._ENABLED:
                _slo.record_request(None, _slo.OUTCOME_REJECTED)
            raise NoBucketError(
                f"no declared bucket accepts {sig} and bucket learning "
                "is disabled (FLAGS_serving_learn_buckets)")
        if rows > bucket.max_batch_size:
            raise ValueError(
                f"request batch {rows} exceeds bucket max "
                f"{bucket.max_batch_size}")
        if deadline_ms is None and self.config.default_deadline_ms > 0:
            deadline_ms = self.config.default_deadline_ms
        deadline = (time.monotonic() + deadline_ms / 1e3
                    if deadline_ms and deadline_ms > 0 else None)
        req = _Request(arrays, rows, bucket, deadline, trace_ctx=trace_ctx)
        try:
            with self._cv:
                if self._stopping:
                    raise EngineStoppedError("engine is stopped/draining")
                if self._pending >= self.config.queue_depth:
                    self._counts["rejected"] += 1
                    if _monitor._ENABLED:
                        _monitor.count("serving.rejected")
                    if _slo._ENABLED:
                        _slo.record_request(None, _slo.OUTCOME_REJECTED)
                    err = ServerOverloadedError(
                        f"queue at capacity ({self.config.queue_depth} "
                        "pending); back off and retry")
                    if _obs._FR_ENABLED:
                        _obs.record_event(
                            "serving.overload",
                            queue_depth=self.config.queue_depth,
                            pending=self._pending)
                        _obs.dump_on_error(err)
                    raise err
                self._lanes.setdefault(bucket.key(), []).append(req)
                self._pending += 1
                self._counts["requests"] += 1
                self._cv.notify()
        except ServingError:
            req.qw_span.end(status=_trace.STATUS_REJECTED)
            raise
        if _monitor._ENABLED:
            _monitor.count("serving.requests")
        self._set_queue_gauge()
        return req.future

    # ---- worker side ----
    def _worker_loop(self) -> None:
        stream = None
        if torch.cuda.is_available():
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.default_stream())
        with torch.cuda.stream(stream):  # no-op for None
            while True:
                batch, bucket = self._collect_batch()
                if batch is None:
                    return
                if batch:
                    self._dispatch(bucket, batch)

    def _collect_batch(self):
        """Block for work, pick the lane with the oldest head request,
        coalesce up to max batch within batch_timeout (clipped to the
        earliest member deadline). Returns (None, None) on shutdown,
        ([], None) when everything pulled had expired."""
        cfg = self.config
        with self._cv:
            while self._pending == 0:
                if self._stopping:
                    return None, None
                self._cv.wait(0.05)
            key = min((k for k, lane in self._lanes.items() if lane),
                      key=lambda k: self._lanes[k][0].enqueue_t)
            lane = self._lanes[key]
            bucket = lane[0].bucket
            batch: List[_Request] = []
            rows = 0
            t_close = time.monotonic() + cfg.batch_timeout_ms / 1e3
            while True:
                now = time.monotonic()
                while lane and rows + lane[0].rows <= bucket.max_batch_size:
                    req = lane.pop(0)
                    self._pending -= 1
                    if req.deadline is not None and now > req.deadline:
                        self._expire(req)
                        continue
                    batch.append(req)
                    rows += req.rows
                    if req.deadline is not None:
                        t_close = min(t_close, req.deadline)
                if (rows >= bucket.max_batch_size or self._stopping
                        or not batch):
                    break
                now = time.monotonic()
                if now >= t_close:
                    break
                self._cv.wait(t_close - now)
            self._inflight += len(batch)
        self._set_queue_gauge()
        return batch, bucket

    def _expire(self, req: _Request) -> None:
        self._counts["expired"] += 1
        req.future._set_exception(DeadlineExceededError(
            "deadline expired before dispatch"))
        req.qw_span.end(status=_trace.STATUS_DEADLINE)
        if _slo._ENABLED:
            _slo.record_request(time.monotonic() - req.enqueue_t,
                                _slo.OUTCOME_DEADLINE)
        if _monitor._ENABLED:
            _monitor.count("serving.deadline_expired")

    def _dispatch(self, bucket: ShapeBucket, batch: List[_Request]) -> None:
        # deadlines re-checked at the last host moment: an entry that
        # expired while the batch was coalescing is dropped before padding
        now = time.monotonic()
        live = []
        with self._cv:
            for req in batch:
                if req.deadline is not None and now > req.deadline:
                    self._expire(req)
                    self._inflight -= 1
                else:
                    live.append(req)
        if not live:
            return
        batch_span = _trace.NULL_SPAN
        disp_spans = None
        if _trace._ENABLED:
            # the batch belongs to no single trace: it parents onto the
            # OLDEST member's request span and LINKS every member span
            batch_span = _trace.server_span("serving.batch",
                                            live[0].trace_ctx)
            for r in live:
                if r.trace_ctx is not None:
                    batch_span.link_ctx(r.trace_ctx)
            batch_span.set(rows=sum(r.rows for r in live),
                           requests=len(live))
            # per-member dispatch spans: each trace's waterfall shows the
            # (shared) predictor call it rode
            disp_spans = [_trace.server_span("serving.dispatch",
                                             r.trace_ctx) for r in live]
        for r in live:
            r.qw_span.end()
        try:
            rows = sum(r.rows for r in live)
            bs = bucket.round_up_batch(rows)
            arrays, waste = self._assemble(bucket, live, rows, bs)
            t_disp = time.monotonic()
            outs = self._dispatch_to_predictor(bucket, bs, arrays)
            t_done = time.monotonic()
            if not outs or any(o.shape[:1] != (bs,) for o in outs):
                raise ServingError(
                    f"predictor returned shapes "
                    f"{[getattr(o, 'shape', None) for o in outs]} for a "
                    f"batch of {bs}: the serving engine requires every "
                    "output to keep the leading batch dim")
            off = 0
            for req in live:
                req.future._set_result([o[off:off + req.rows]
                                        for o in outs])
                off += req.rows
            if disp_spans is not None:
                for sp in disp_spans:
                    sp.end()
                batch_span.end(batch=bs)
            self._record_batch(live, rows, bs, waste, t_disp, t_done)
        except Exception as e:  # noqa: BLE001 — model errors go to callers
            self._fail_batch(live, e, disp_spans, batch_span)
        finally:
            with self._cv:
                self._inflight -= len(live)

    def _assemble(self, bucket: ShapeBucket, live: List[_Request],
                  rows: int, bs: int):
        arrays: List[np.ndarray] = []
        waste = 0
        for slot, (shape, dt) in enumerate(zip(bucket.item_shapes,
                                               bucket.dtypes)):
            parts = [bucket.pad_item(r.inputs[slot], slot) for r in live]
            if bs > rows:
                parts.append(np.zeros((bs - rows,) + shape,
                                      dtype=np.dtype(dt)))
            col = np.concatenate(parts, axis=0) if len(parts) > 1 \
                else parts[0]
            arrays.append(col)
            item_elems = int(np.prod(shape)) if shape else 1
            real = sum(int(np.prod(r.inputs[slot].shape))
                       for r in live)
            waste += bs * item_elems - real
        return arrays, waste

    def _dispatch_to_predictor(self, bucket: ShapeBucket, bs: int,
                               arrays: List[np.ndarray]) -> List[np.ndarray]:
        sig = (bs,) + bucket.key()
        novel = self._ledger.note(sig, retrace=False)
        if novel:
            # first time this padded signature reaches the predictor: its
            # program runs eagerly and is captured (warm-up, in steady
            # state this never fires)
            self._bump("compiles")
            if _monitor._ENABLED:
                _monitor.count("serving.compiles")
                _monitor.log_event("serving.compile", batch=bs,
                                   signature=[f"{s}:{d}" for s, d in
                                              bucket.signature])
        with self._dispatch_lock:
            if _faults._ENABLED:
                # an injected dispatch failure fails THIS batch's futures
                # (via _dispatch's error path); the engine keeps serving
                _faults.check("serving.dispatch")
            with _exe.booking("serving_bucket") as bk, \
                    _monitor.span("serving.predict"):
                # a live layer's to_static books its own export and capture
                # (nested, this booking's phase keeps the wall time): the
                # build counts once (reference engine.py:203, :557)
                if novel and not getattr(self.predictor, "books_compiles",
                                         False):
                    bk.compiled()
                outs = [np.asarray(o) for o in self._call(arrays)]
                if _obs._TL_ENABLED:
                    _obs.fence()   # this worker's stream
            if _mem._ENABLED:
                self._tag_pool()
            return outs

    def _tag_pool(self) -> None:
        """Tag the device buffers the predictor keeps for the buckets
        dispatched so far (a loaded artifact's captured graphs: static
        inputs and outputs) as `serving_bucket`."""
        pool = getattr(self.predictor, "bucket_buffers", None)
        if callable(pool):
            _mem.tag("serving_bucket", pool(), origin="ServingEngine")

    def _fail_batch(self, live: List[_Request], err: BaseException,
                    disp_spans=None, batch_span=_trace.NULL_SPAN) -> None:
        self._bump("failed", len(live))
        if _monitor._ENABLED:
            _monitor.count("serving.failed", len(live))
        msg = f"{type(err).__name__}: {str(err)[:200]}"
        if disp_spans is not None:
            # a dispatch fault must close every member's span with error
            # status — a leaked open span is a bug
            for sp in disp_spans:
                sp.end(status=_trace.STATUS_ERROR, error=msg)
        batch_span.end(status=_trace.STATUS_ERROR, error=msg)
        if _slo._ENABLED:
            for _ in live:
                _slo.record_request(None, _slo.OUTCOME_ERROR)
        for req in live:
            req.future._set_exception(err)

    # ---- accounting ----
    def _bump(self, name: str, delta: int = 1) -> None:
        with self._cv:
            self._counts[name] += delta

    def _set_queue_gauge(self) -> None:
        if _monitor._ENABLED:
            _monitor.gauge_set("serving.queue_depth", self._pending)

    def _record_batch(self, live, rows, bs, waste, t_disp, t_done) -> None:
        with self._cv:
            self._counts["completed"] += len(live)
            self._counts["batches"] += 1
            self._counts["rows"] += rows
            self._counts["padded_rows"] += bs - rows
            self._counts["padding_waste_elems"] += waste
        if _slo._ENABLED:
            for req in live:
                bad = _slo.record_request(t_done - req.enqueue_t)
                if bad and _trace._ENABLED and req.trace_ctx is not None:
                    # over the latency objective: an instant marker span
                    # keeps this trace in the protected ring
                    _trace.server_span(
                        "serving.slo_violation", req.trace_ctx,
                        attrs={"e2e_ms": (t_done - req.enqueue_t) * 1e3},
                    ).end(status=_trace.STATUS_SLO_VIOLATION)
        if not _monitor._ENABLED:
            return
        _monitor.count("serving.completed", len(live))
        _monitor.count("serving.batches")
        _monitor.count("serving.padded_rows", bs - rows)
        _monitor.count("serving.padding_waste_elems", waste)
        _monitor.observe("serving.batch_size", rows)
        for req in live:
            _monitor.observe("serving.queue_wait", t_disp - req.enqueue_t)
            _monitor.observe("serving.e2e_latency", t_done - req.enqueue_t)

    def bucket_pool_bytes(self) -> int:
        """Bytes of one padded input set per (batch size, item signature)
        ever dispatched — the inputs each captured program re-feeds.
        Gauged as `serving.bucket_pool.bytes`."""
        total = 0
        for sig in self._ledger.seen_sigs():
            bs = int(sig[0])
            for shape, dt in sig[1:]:
                elems = int(np.prod(shape)) if shape else 1
                total += bs * elems * np.dtype(dt).itemsize
        return total

    # ---- health / stats ----
    def stats(self) -> Dict[str, Any]:
        """Health snapshot for probes."""
        with self._cv:
            counts = dict(self._counts)
            pending = self._pending
            inflight = self._inflight
        pool_bytes = self.bucket_pool_bytes()
        if _monitor._ENABLED:
            _monitor.gauge_set("serving.bucket_pool.bytes", pool_bytes)
        return {
            "running": self.running,
            "queue_depth": pending,
            "inflight": inflight,
            "queue_capacity": self.config.queue_depth,
            "max_batch_size": self.config.max_batch_size,
            "batch_timeout_ms": self.config.batch_timeout_ms,
            "workers": len(self._workers),
            "buckets": [b.describe() for b in self.buckets.buckets()],
            "bucket_pool_bytes": pool_bytes,
            "counters": counts,
            "warm_start_ms": self._warm_start_ms,
            # error-budget burn (None = no SLO configured)
            "slo": _slo.stats(),
        }
