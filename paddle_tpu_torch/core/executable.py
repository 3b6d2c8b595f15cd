"""One executable substrate under the port's dispatch regimes.

Counterpart of `paddle_tpu/core/executable.py`: what `jit.TrainStep`,
`serving.ServingEngine` and `serving.LLMEngine` parameterize instead of
each keeping its own signature cache, timeline booking and OOM seam.

- `ExecutableLedger` — the signature ledger + retrace accounting, one
  implementation. `note(sig)` answers "novel?" and books the retrace
  counters under the regime's kind string (`jit.<kind>.traces` /
  `.retraces`). What counts as the compile in the port: a CUDA-graph
  capture (`TrainStep.run`, `jit.TranslatedLayer`, the LLM decode step)
  and the first eager step of a signature; the reference counts its XLA
  compile.
- `booking(kind)` — the timeline phase around a dispatch. Opens
  `device_compute`; if the regime reports `bk.compiled()` the phase is
  renamed to `trace_compile` in place, so a build is attributed exactly
  where it happened. A booking that finds the calling thread ALREADY
  inside an open phase suppresses its own phase entirely, so nested
  dispatches never book the same wall seconds twice. Monitor counters
  (`trace_compile`, `trace_compile.<kind>`) are still counted when
  nested.
- `dispatch_guard(label, report)` — the OOM forensics seam: the
  `mem.alloc` fault drill site plus `obs.memory.maybe_dump_oom` on the
  way out of a failed dispatch.

The reference's `acquire` (the persistent compile cache,
`core/compile_cache.py`) and the ledger's LRU cache of the executables it
deserializes wait for the `to_static` slice, where the port
has a program to compile and keep across processes. The cache is off by
default in the reference too, so the dispatch path here is the
reference's default path.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from .. import faults as _faults
from .. import monitor as _monitor
from .. import obs as _obs
from ..obs import memory as _mem

__all__ = ["ExecutableLedger", "booking", "dispatch_guard"]


class ExecutableLedger:
    """Signature ledger for one dispatch regime (TrainStep, ServingEngine):
    `note(sig)` is the novelty test + retrace bookkeeping. The reference's
    LRU cache of executables beside it holds what `acquire` deserializes,
    and waits with it."""

    def __init__(self, kind: str):
        self.kind = kind
        self._lock = threading.Lock()
        self._seen: set = set()

    def note(self, sig, detail=None, retrace: bool = True) -> bool:
        """Record `sig` as dispatched; True when it was novel (the call
        ahead pays the build: an eager first run and a CUDA-graph capture
        or an export). Books monitor retrace counters under this ledger's
        kind — `detail` overrides the signature logged."""
        with self._lock:
            novel = sig not in self._seen
            first = not self._seen
            if novel:
                self._seen.add(sig)
        if novel and retrace and _monitor._ENABLED:
            _monitor.record_retrace(self.kind,
                                    sig if detail is None else detail,
                                    first=first)
        return novel

    def seen(self, sig) -> bool:
        with self._lock:
            return sig in self._seen

    def seen_sigs(self) -> set:
        with self._lock:
            return set(self._seen)

    def clear(self) -> None:
        with self._lock:
            self._seen.clear()


class _Booking:
    """Timeline booking around one dispatch. Opens `device_compute`,
    renamed in place to `trace_compile` if the regime calls
    `compiled()`. Nested inside an already-open phase on this thread →
    no phase of its own (the enclosing phase owns the wall time; monitor
    compile counters still fire). The regime fences its stream before
    the booking closes (`obs.fence`)."""

    __slots__ = ("kind", "did_compile", "_ctx")

    def __init__(self, kind: str):
        self.kind = kind
        self.did_compile = False
        self._ctx = None

    def __enter__(self):
        if _obs._TL_ENABLED and not _obs.in_phase():
            self._ctx = _obs.timeline().phase("device_compute")
            self._ctx.__enter__()
        return self

    def compiled(self) -> None:
        """The dispatch underway built a novel program (an eager first run
        plus a CUDA-graph capture or an export): rename the open phase and
        count it. This is THE compile counter (`trace_compile`)."""
        if self.did_compile:
            return
        self.did_compile = True
        if self._ctx is not None:
            self._ctx.name = "trace_compile"
        if _monitor._ENABLED:
            _monitor.count("trace_compile")
            _monitor.count(f"trace_compile.{self.kind}")

    def __exit__(self, *exc):
        if self._ctx is not None:
            self._ctx.__exit__(*exc)
            self._ctx = None
        return False


def booking(kind: str) -> _Booking:
    return _Booking(kind)


class _DispatchGuard:
    """OOM forensics around one dispatch: the `mem.alloc` fault drill
    site on the way in, `maybe_dump_oom` (`torch.cuda.OutOfMemoryError`
    dump) on the way out of a failure. `report` is a zero-arg lambda
    producing the executable memory breakdown — only called when
    dumping."""

    __slots__ = ("label", "report")

    def __init__(self, label: str, report: Optional[Callable] = None):
        self.label = label
        self.report = report

    def __enter__(self):
        if _faults._ENABLED:
            try:
                _faults.check("mem.alloc")
            except Exception as exc:
                # an __enter__ raise skips __exit__ — dump here so the
                # injected fault exercises the same forensics path
                _mem.maybe_dump_oom(exc, executable=self.label,
                                    report=self.report)
                raise
        return self

    def __exit__(self, etype, exc, tb):
        if exc is not None:
            _mem.maybe_dump_oom(exc, executable=self.label,
                                report=self.report)
        return False


def dispatch_guard(label: str, report: Optional[Callable] = None):
    return _DispatchGuard(label, report)
