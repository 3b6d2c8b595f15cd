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
loops assemble batches per bucket lane; the predictor call is serialized
by a dispatch lock. On a CUDA machine each worker launches on its own
CUDA stream, which first waits for the work already queued on the
default stream (the weights' upload).

Not ported yet: the monitor, SLO, trace, memory-census, fault-injection,
compile-cache, executable-ledger and syncwatch hooks of the JAX engine.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import flags as _flags
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
                 "deadline")

    def __init__(self, inputs, rows, bucket, deadline):
        self.inputs = inputs
        self.rows = rows
        self.bucket = bucket
        self.future = ResponseFuture()
        self.enqueue_t = time.monotonic()
        self.deadline = deadline  # absolute monotonic, or None


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
        self._dispatch_lock = threading.Lock()
        self._warm_start_ms: Optional[float] = None
        self._counts: Dict[str, int] = {
            "requests": 0, "completed": 0, "failed": 0, "rejected": 0,
            "expired": 0, "batches": 0, "rows": 0, "padded_rows": 0,
            "padding_waste_elems": 0, "warmup_runs": 0,
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
                self._dispatch_to_predictor(arrays)
                runs += 1
        self._warm_start_ms = (time.time() - t0) * 1000.0
        self._bump("warmup_runs", runs)
        return runs

    # ---- lifecycle ----
    def start(self) -> "ServingEngine":
        if self._workers:
            return self
        self._stopping = False
        if self.config.warmup_on_start:
            self.warmup()
        for i in range(max(1, self.config.num_workers)):
            t = threading.Thread(target=self._worker_loop,
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

    @property
    def running(self) -> bool:
        return bool(self._workers) and not self._stopping

    # ---- request intake ----
    def submit(self, inputs: Sequence[np.ndarray],
               deadline_ms: Optional[float] = None) -> ResponseFuture:
        """Enqueue one request (arrays share a leading batch dim, usually
        1; a `Tensor` is read through its `numpy()`, the Tensor API's
        boundary here). Raises ServerOverloadedError / EngineStoppedError /
        NoBucketError / ValueError synchronously; everything later lands
        on the returned future."""
        arrays = [np.ascontiguousarray(a) for a in inputs]
        if not arrays:
            raise ValueError("empty request")
        rows = int(arrays[0].shape[0]) if arrays[0].ndim else 0
        if rows < 1 or any(a.ndim == 0 or a.shape[0] != rows
                           for a in arrays):
            raise ValueError(
                "request inputs must share a leading batch dim >= 1")
        sig = signature_of(arrays)
        bucket = self.buckets.resolve(sig)
        if bucket is None:
            self._bump("rejected")
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
        req = _Request(arrays, rows, bucket, deadline)
        with self._cv:
            if self._stopping:
                raise EngineStoppedError("engine is stopped/draining")
            if self._pending >= self.config.queue_depth:
                self._counts["rejected"] += 1
                raise ServerOverloadedError(
                    f"queue at capacity ({self.config.queue_depth} "
                    "pending); back off and retry")
            self._lanes.setdefault(bucket.key(), []).append(req)
            self._pending += 1
            self._counts["requests"] += 1
            self._cv.notify()
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
        return batch, bucket

    def _expire(self, req: _Request) -> None:
        self._counts["expired"] += 1
        req.future._set_exception(DeadlineExceededError(
            "deadline expired before dispatch"))

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
        try:
            rows = sum(r.rows for r in live)
            bs = bucket.round_up_batch(rows)
            arrays, waste = self._assemble(bucket, live, rows, bs)
            outs = self._dispatch_to_predictor(arrays)
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
            self._record_batch(live, rows, bs, waste)
        except Exception as e:  # noqa: BLE001 — model errors go to callers
            self._bump("failed", len(live))
            for req in live:
                req.future._set_exception(e)
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

    def _dispatch_to_predictor(self, arrays: List[np.ndarray]
                               ) -> List[np.ndarray]:
        with self._dispatch_lock:
            return [np.asarray(o) for o in self._call(arrays)]

    # ---- accounting ----
    def _bump(self, name: str, delta: int = 1) -> None:
        with self._cv:
            self._counts[name] += delta

    def _record_batch(self, live, rows, bs, waste) -> None:
        with self._cv:
            self._counts["completed"] += len(live)
            self._counts["batches"] += 1
            self._counts["rows"] += rows
            self._counts["padded_rows"] += bs - rows
            self._counts["padding_waste_elems"] += waste

    # ---- health / stats ----
    def stats(self) -> Dict[str, Any]:
        """Health snapshot for probes."""
        with self._cv:
            counts = dict(self._counts)
            pending = self._pending
            inflight = self._inflight
        return {
            "running": self.running,
            "queue_depth": pending,
            "inflight": inflight,
            "queue_capacity": self.config.queue_depth,
            "max_batch_size": self.config.max_batch_size,
            "batch_timeout_ms": self.config.batch_timeout_ms,
            "workers": len(self._workers),
            "buckets": [b.describe() for b in self.buckets.buckets()],
            "counters": counts,
            "warm_start_ms": self._warm_start_ms,
        }
