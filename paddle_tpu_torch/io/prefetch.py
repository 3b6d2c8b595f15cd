"""Double-buffered host-to-device prefetch: the device feed queue.

Counterpart of `paddle_tpu/io/prefetch.py` (`maybe_wrap`,
`DevicePrefetcher` :195-246): a feeder thread stages the next
FLAGS_prefetch_depth batches on the device while the current step
computes, so the copy and the host's batch assembly stay off the step's
critical path. On a CUDA device the feeder copies each tensor into pinned
host memory, then to the device on a side stream, and records an event;
the consumer's stream waits on that event, and `record_stream` keeps the
staged buffers alive until the consumer's work on them is done. On the CPU
the batches pass through as tensors.

Contract, as the reference's: re-iterable (each `iter()` starts a fresh
feeder session), `stats()`, and `close()` drops the staged batches, so a
resume cursor that counts consumed batches loses none.

Plane hooks, as the reference's, each one attribute check when off: the
staged tensors are tagged `prefetch_staging` for the memory census
(FLAGS_mem_census), the staging time books a `prefetch_h2d` phase into
the timeline's between-steps bucket (FLAGS_obs_timeline), and the
monitor gets `io.prefetch.h2d` / `io.prefetch.batches` (FLAGS_monitor).
On a card the time is the feeder's host time to queue the copies on its
side stream, as the reference's is that of its asynchronous device put.
"""
from __future__ import annotations

import queue
import threading
import time as _time
from typing import Optional

import numpy as np
import torch

from .. import monitor as _monitor
from .. import obs as _obs
from ..core import flags as _flags
from ..core.enforce import UnimplementedError
from ..core.place import resolve_device
from ..obs import memory as _mem
from ..utils import syncwatch as _syncwatch

__all__ = ["DevicePrefetcher", "maybe_wrap"]


def maybe_wrap(source, step=None, depth: Optional[int] = None):
    """Wrap `source` in a DevicePrefetcher when FLAGS_prefetch is on;
    return it unchanged otherwise (no allocation, no thread)."""
    if not _flags.flag("prefetch"):
        return source
    return DevicePrefetcher(source, step=step, depth=depth)


def _tensors(obj):
    """The tensors of a batch structure, in order."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def _stage(obj, device):
    """numpy / tensor batch structure -> tensors on `device`. On CUDA the
    caller has made the side stream current: host tensors go through
    pinned memory and copy asynchronously."""
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        t = torch.as_tensor(obj)
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_stage(o, device) for o in obj)
    if isinstance(obj, dict):
        return {k: _stage(v, device) for k, v in obj.items()}
    return obj


class _Session:
    """One epoch's feeder thread and bounded queue of staged batches."""

    _END = object()

    def __init__(self, it, depth: int, device: torch.device):
        self._it = it
        self._device = device
        self._stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._produced = 0
        self._consumed = 0
        self._thread = _syncwatch.Thread(target=self._feed, daemon=True,
                                        name="prefetch-feeder")
        self._thread.start()

    # ---- feeder side ----
    def _staged(self, batch):
        if self._stream is None:
            return _stage(batch, self._device), None
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            staged = _stage(batch, self._device)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return staged, ready

    def _feed(self) -> None:
        mon = _monitor._ENABLED
        try:
            for batch in self._it:
                if self._stop.is_set():
                    return
                _t0 = _time.time()
                item = self._staged(batch)
                _t1 = _time.time()
                if _mem._ENABLED:
                    _mem.tag("prefetch_staging", item[0],
                             origin="DevicePrefetcher")
                if _obs._TL_ENABLED:
                    # hidden time: ran under the previous step, so it books
                    # through add_async_phase (between bucket), never inside
                    # a step window
                    _obs.add_async_phase("prefetch_h2d", _t1 - _t0, _t0, _t1)
                if mon:
                    _monitor.observe("io.prefetch.h2d", _t1 - _t0)
                    _monitor.count("io.prefetch.batches")
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        self._produced += 1
                        break
                    except queue.Full:
                        pass
        except Exception as e:  # noqa: BLE001 — raised in the consumer
            self._q.put(e)
            return
        self._q.put(self._END)

    # ---- consumer side ----
    def next(self):
        item = self._q.get()
        if item is self._END:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        staged, ready = item
        if ready is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(ready)
            for t in _tensors(staged):
                t.record_stream(current)
        self._consumed += 1
        return staged

    @property
    def in_flight(self) -> int:
        return self._produced - self._consumed

    def close(self) -> None:
        self._stop.set()
        # drain so a feeder blocked on put() can observe the stop event
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


class DevicePrefetcher:
    """Re-iterable device feed queue over any batch iterable. Each
    `iter()` starts a fresh feeder session (one per epoch); `close()`
    stops the active session and discards staged batches.

    The device is that of `step`'s parameters, else the current place.
    `shardings` (the reference's SPMD input layouts) comes with the
    distributed slice."""

    def __init__(self, source, step=None, depth: Optional[int] = None,
                 shardings=None):
        if shardings is not None:
            raise UnimplementedError(
                "DevicePrefetcher(shardings=...): sharded input layouts come "
                "with the distributed slice")
        self.source = source
        self.depth = int(depth) if depth is not None \
            else int(_flags.flag("prefetch_depth"))
        self._step = step
        self._session: Optional[_Session] = None

    def _target(self) -> torch.device:
        ps = getattr(self._step, "_ptensors", None) \
            if getattr(self._step, "_built", False) else None
        return ps[0].device if ps else resolve_device()

    def __iter__(self):
        if self._session is not None:
            self._session.close()
        self._session = _Session(iter(self.source), self.depth,
                                 self._target())
        return self

    def __next__(self):
        if self._session is None:
            iter(self)
        return self._session.next()

    def __len__(self):
        return len(self.source)

    def stats(self) -> dict:
        s = self._session
        return {"depth": self.depth,
                "in_flight": s.in_flight if s is not None else 0,
                "produced": s._produced if s is not None else 0,
                "consumed": s._consumed if s is not None else 0}

    def close(self) -> None:
        """Stop the feeder and DROP staged batches: a resume cursor that
        counts consumed batches re-produces them from the source."""
        if self._session is not None:
            self._session.close()
            self._session = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass
