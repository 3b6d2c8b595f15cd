"""One executable substrate under the port's dispatch regimes.

Counterpart of `paddle_tpu/core/executable.py`: what `jit.to_static`,
`jit.TrainStep`, `serving.ServingEngine` and `serving.LLMEngine`
parameterize instead of each keeping its own signature cache, timeline
booking and OOM seam.

- `ExecutableLedger` — the signature ledger + retrace accounting + LRU
  cache of built programs, one implementation. `note(sig)` answers
  "novel?" and books the retrace counters under the regime's kind string
  (`jit.<kind>.traces` / `.retraces`); `get` / `put` keep what the regime
  built per signature (LRU when `cap` is set); `current_sig` is the
  signature of the regime's published program. What counts as the compile
  in the port: a `torch.export`, a CUDA-graph capture (`TrainStep.run`,
  `jit.TranslatedLayer`, `jit.to_static`, the LLM decode step) and the
  first eager step of a signature; the reference counts its XLA compile.
- `booking(kind)` — the timeline phase around a dispatch. Opens
  `device_compute`; if the regime reports `bk.compiled()` the phase is
  renamed to `trace_compile` in place, so a build is attributed exactly
  where it happened. A booking that finds the calling thread ALREADY
  inside an open phase suppresses its own phase entirely, so nested
  dispatches never book the same wall seconds twice. Monitor counters
  (`trace_compile`, `trace_compile.<kind>`) are still counted when
  nested.
- `acquire(kind, build, key_material, dumps=, loads=)` — the
  persistent-cache build step (core/compile_cache.py): load a prior
  process's program on a hit, build + persist on a miss; the regime
  passes its serializer and its rule of what may persist, so this layer
  knows no program format. Cache off = one module-attribute check, zero
  overhead.
- `dispatch_guard(label, report)` — the OOM forensics seam: the
  `mem.alloc` fault drill site plus `obs.memory.maybe_dump_oom` on the
  way out of a failed dispatch.

`TrainStep` and `SPMDTrainStep` call no `acquire`: their build is an eager
first step plus a CUDA-graph capture, and nothing of it persists.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, List, Optional, Tuple, Union

from .. import faults as _faults
from .. import monitor as _monitor
from .. import obs as _obs
from ..obs import memory as _mem
from . import compile_cache as _cc

__all__ = ["ExecutableLedger", "booking", "acquire", "dispatch_guard"]


class ExecutableLedger:
    """Signature ledger + optional LRU cache of built programs for one
    dispatch regime (to_static, TrainStep, ServingEngine).

    `note(sig)` is the novelty test + retrace bookkeeping; `get`/`put`
    manage cached programs (LRU when `cap` is set, `evictions` counted,
    `on_evict(sig, value)` fired outside the lock — callers use it to
    mirror eviction counters)."""

    def __init__(self, kind: str, cap: Optional[int] = None,
                 on_evict: Optional[Callable[[Any, Any], None]] = None):
        self.kind = kind
        self._lock = threading.RLock()
        self._seen: set = set()
        self._cache: "OrderedDict[Any, Any]" = OrderedDict()
        self._cap = cap
        self.on_evict = on_evict
        self.evictions = 0
        # the signature the regime's published program was built for
        self.current_sig: Any = None

    # ---- novelty / retrace accounting ----
    def note(self, sig, detail=None, retrace: bool = True) -> bool:
        """Record `sig` as dispatched; True when it was novel (the call
        ahead pays the build: an export, an eager first run and a CUDA-graph
        capture). Books monitor retrace counters under this ledger's kind
        — `detail` overrides the signature logged."""
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

    # ---- cached programs (LRU) ----
    def get(self, sig):
        with self._lock:
            if sig not in self._cache:
                return None
            self._cache.move_to_end(sig)
            return self._cache[sig]

    def put(self, sig, value) -> None:
        with self._lock:
            self._cache[sig] = value
            self._cache.move_to_end(sig)
        self._sweep()

    def set_cap(self, cap: Optional[int]) -> None:
        """A new cap; a lower one evicts at once."""
        with self._lock:
            self._cap = cap
        self._sweep()

    def _sweep(self) -> None:
        evicted: List[Tuple[Any, Any]] = []
        with self._lock:
            if self._cap is not None:
                while len(self._cache) > max(1, int(self._cap)):
                    evicted.append(self._cache.popitem(last=False))
                    self.evictions += 1
        for esig, evalue in evicted:
            if self.on_evict is not None:
                self.on_evict(esig, evalue)

    def keys(self) -> list:
        with self._lock:
            return list(self._cache.keys())

    def items(self) -> list:
        with self._lock:
            return list(self._cache.items())

    def clear(self, seen: bool = True) -> None:
        with self._lock:
            self._cache.clear()
            if seen:
                self._seen.clear()
            self.current_sig = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._cache)

    def __contains__(self, sig) -> bool:
        with self._lock:
            return sig in self._cache


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


# ---- persistent-cache build step -------------------------------------------

def acquire(kind: str, build: Callable[[], Any],
            key_material: Union[str, Callable[[], str]], *,
            dumps: Callable[[Any], bytes],
            loads: Callable[[bytes], Any],
            not_persistable: Optional[Callable[[Any], Optional[str]]] = None,
            label: str = "", mesh_shape=None):
    """Build step for a novel signature: `(program, source)`.

    With the persistent cache off (default) this is `(build(), "fresh")`
    after one module-attribute check. With `FLAGS_compile_cache_dir` set:
    key `key_material` (a string, or a callable computing it, run only
    then; `compile_cache.cache_key` adds the port's sources, topology,
    versions and flags), and either load a prior process's program
    (source `"disk"`) or build it and persist it for the next process
    (source `"fresh"`). The regime owns its programs' format and rules:
    `dumps(program) -> bytes`; `loads(blob) -> program`, None for a
    program that does not fit the call (fallback `input_mismatch`), an
    exception for an unreadable one (`deserialize_failed`); a fallback
    prunes the entry. `not_persistable(program) -> reason | None`, a key
    material that raises and a program `dumps` refuses leave the program
    unpersisted, counted as `export_skips`. Every failure path degrades to
    the fresh build — the cache can only ever save work. With the monitor
    on, each load logs a `compile_cache.hit` event and each store a
    `compile_cache.store` event with its seconds and bytes."""
    if not _cc._DIR:
        return build(), "fresh"
    name = label or kind
    try:
        text = key_material() if callable(key_material) else key_material
        key = _cc.cache_key(text, mesh_shape=mesh_shape, extra=(kind,))
    except Exception as e:   # noqa: BLE001 — counted, never fatal
        _cc.note_export_skip(f"{name}: key: {type(e).__name__}: {e}")
        return build(), "fresh"
    blob = _cc.lookup(key, mesh_shape=mesh_shape)
    if blob is not None:
        t0 = time.perf_counter()
        try:
            program = loads(blob)
        except Exception:   # noqa: BLE001 — a bad entry falls back
            _cc._fallback(key, "deserialize_failed")
        else:
            if program is not None:
                if _monitor._ENABLED:
                    _monitor.log_event(
                        "compile_cache.hit", kind=kind, key=key, label=label,
                        load_s=time.perf_counter() - t0, bytes=len(blob))
                return program, "disk"
            _cc._fallback(key, "input_mismatch")
    _cc.note_miss()
    t0 = time.perf_counter()
    program = build()
    export_s = time.perf_counter() - t0
    why = not_persistable(program) if not_persistable is not None else None
    if why:
        _cc.note_export_skip(f"{name}: {why}")
        return program, "fresh"
    try:
        blob = dumps(program)
    except Exception as e:   # noqa: BLE001 — counted, never fatal
        _cc.note_export_skip(f"{name}: save: {type(e).__name__}: {e}")
        return program, "fresh"
    if _cc.store(key, blob, kind=kind, label=label,
                 mesh_shape=mesh_shape) and _monitor._ENABLED:
        _monitor.log_event("compile_cache.store", kind=kind, key=key,
                           label=label, export_s=export_s, bytes=len(blob))
    return program, "fresh"
