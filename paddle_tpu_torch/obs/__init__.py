"""paddle_tpu_torch.obs — step-timeline attribution + black-box flight
recorder, and the planes beside them.

Counterpart of `paddle_tpu/obs/__init__.py`, over `monitor.py`'s flat
counters and spans:

  - `StepTimeline` (`obs/timeline.py`): per-step phase records (build,
    h2d, trace_compile, device_compute fenced on the stream that did the
    work, optimizer, data_wait) threaded through `jit/train_step.py`, the
    `io` DataLoader, `optimizer/` and the serving engines; bounded ring;
    chrome-trace export. Gate: `FLAGS_obs_timeline`.
  - `FlightRecorder` (`obs/recorder.py`): black-box rings (step records,
    monitor-counter deltas, events) with `dump(path, reason)`; automatic
    dumps registered per error type (`register_dump_trigger`) fire on
    serving overload and OOM. Gate: `FLAGS_obs_flight_recorder`.
  - `memory` (device memory attribution), `trace` (request tracing),
    `slo` (error-budget burn), `cost` (attributed MFU, roofline gap).

The reference's cross-rank merge (`obs/merge.py`, over
`parallel.collective`) and fleet telemetry (`obs/telemetry.py`) wait for
the distributed slice.

Hot-path contract: instrumented sites check ONE module attribute
(`_obs._TL_ENABLED` / `_obs._FR_ENABLED` / `_obs._ENABLED`) and call
nothing else on the disabled path.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Type

from ..core import flags as _flags
from . import memory  # noqa: F401  (the HBM attribution plane)
from . import slo  # noqa: F401  (error-budget burn rate plane)
from . import trace  # noqa: F401  (request-scoped distributed tracing)
from .cost import attributed_mfu, executable_cost, roofline_gap  # noqa: F401
from .memory import (census, executable_memory, maybe_dump_oom,  # noqa: F401
                     top_buffers)
from .recorder import (DUMP_SCHEMA, FlightRecorder,  # noqa: F401
                       dump_to_chrome_events)
from .timeline import NULL_CTX, PHASES, StepTimeline, fence  # noqa: F401

__all__ = [
    "StepTimeline", "FlightRecorder", "PHASES", "DUMP_SCHEMA",
    "enabled", "enable", "disable", "timeline", "recorder",
    "phase", "step_record", "add_phase", "add_async_phase", "mark",
    "in_phase", "fence", "record_event",
    "dump", "dump_on_error", "register_dump_trigger", "dump_triggers",
    "trigger_reason", "executable_cost",
    "attributed_mfu", "roofline_gap", "dump_to_chrome_events",
    "memory", "census", "top_buffers", "executable_memory",
    "maybe_dump_oom", "trace", "slo",
]

# ---- gates + singletons ----------------------------------------------------
# Instrumented call sites read these module attributes directly; watch_flag
# keeps them in sync with paddle.set_flags. The timeline singleton exists
# whenever either plane is on (the recorder reads its rings).

_TL_ENABLED: bool = False
_FR_ENABLED: bool = False
_ENABLED: bool = False   # either plane on (sites that feed both check this)

_TIMELINE: Optional[StepTimeline] = None
_RECORDER: Optional[FlightRecorder] = None


def _rewire() -> None:
    global _TL_ENABLED, _FR_ENABLED, _ENABLED, _TIMELINE, _RECORDER
    tl_on = bool(_flags.flag("obs_timeline"))
    fr_on = bool(_flags.flag("obs_flight_recorder"))
    if (tl_on or fr_on) and _TIMELINE is None:
        _TIMELINE = StepTimeline(capacity=int(_flags.flag("obs_ring_steps")))
    if fr_on and _RECORDER is None and _TIMELINE is not None:
        _RECORDER = FlightRecorder(
            _TIMELINE, snapshot_ring=int(_flags.flag("obs_ring_snapshots")))
    if _TIMELINE is not None:
        _TIMELINE.on_close = _RECORDER.on_step_end if (fr_on and _RECORDER) \
            else None
        # peak-HBM per phase: sample total live bytes at phase boundaries
        # when the memory plane is also on (obs/memory.on_phase)
        _TIMELINE.on_phase = memory.on_phase if (tl_on and memory._ENABLED) \
            else None
    _TL_ENABLED = tl_on
    _FR_ENABLED = fr_on
    _ENABLED = tl_on or fr_on


for _name in ("obs_timeline", "obs_flight_recorder", "mem_census"):
    _flags.watch_flag(_name, lambda _v: _rewire())
_rewire()


def enabled() -> bool:
    return _ENABLED


def enable(timeline: bool = True, flight_recorder: bool = True) -> None:
    _flags.set_flags({"obs_timeline": timeline,
                      "obs_flight_recorder": flight_recorder})


def disable() -> None:
    _flags.set_flags({"obs_timeline": False, "obs_flight_recorder": False})


def reset() -> None:
    """Drop the singletons (tests): a fresh enable() starts clean rings."""
    global _TIMELINE, _RECORDER
    _TIMELINE = None
    _RECORDER = None
    _rewire()


def timeline() -> StepTimeline:
    """The process StepTimeline (created on first use even when disabled,
    so read-side tooling never needs a flag check)."""
    global _TIMELINE
    if _TIMELINE is None:
        _TIMELINE = StepTimeline(capacity=int(_flags.flag("obs_ring_steps")))
        _rewire()
    return _TIMELINE


def recorder() -> FlightRecorder:
    global _RECORDER
    if _RECORDER is None:
        _RECORDER = FlightRecorder(
            timeline(), snapshot_ring=int(_flags.flag("obs_ring_snapshots")))
        _rewire()
    return _RECORDER


# ---- instrumentation entry points (the threaded call sites use these) ------

def phase(name: str):
    """`with obs.phase("h2d"): ...` — folds the duration into the open step
    record (or the between-steps bucket). Disabled -> shared no-op ctx."""
    tl = _TIMELINE
    if tl is None or not _TL_ENABLED:
        return NULL_CTX
    return tl.phase(name)


def step_record():
    """Open (or join — reentrant) the per-step record around one training
    step. Disabled -> shared no-op ctx."""
    tl = _TIMELINE
    if tl is None or not _TL_ENABLED:
        return NULL_CTX
    return tl.step_record()


def in_phase() -> bool:
    """True when the calling thread is already inside an open `phase()`
    context. `core/executable.py` uses this to book a dispatch exactly
    once: an inner site that finds itself nested skips opening a second
    phase (the enclosing one already owns the wall time)."""
    from .timeline import thread_phase_depth
    return thread_phase_depth() > 0


def add_phase(name: str, dur: float, t0=None, t1=None) -> None:
    tl = _TIMELINE
    if tl is not None and _TL_ENABLED:
        tl.add_phase(name, dur, t0, t1)


def add_async_phase(name: str, dur: float, t0=None, t1=None) -> None:
    """Book concurrent (hidden) work — always into the between-steps
    bucket, never the open step record (see StepTimeline.add_async_phase)."""
    tl = _TIMELINE
    if tl is not None and _TL_ENABLED:
        tl.add_async_phase(name, dur, t0, t1)


def mark(name: str) -> None:
    tl = _TIMELINE
    if tl is not None and _ENABLED:
        tl.mark(name)


def record_event(kind: str, **payload) -> None:
    fr = _RECORDER
    if fr is not None and _FR_ENABLED:
        fr.record_event(kind, **payload)


def dump(path: Optional[str] = None, reason: str = "manual",
         extra: Optional[Dict[str, Any]] = None,
         incident_id: Optional[str] = None,
         source: Optional[str] = None) -> Optional[str]:
    """Dump the flight recorder (even if the flag is off — an explicit call
    is an explicit request; the rings are just emptier)."""
    return recorder().dump(path=path, reason=reason, extra=extra,
                           incident_id=incident_id, source=source)


# ---- automatic dump triggers ------------------------------------------------
# Failure types that must produce a black-box artifact register here
# (serving/engine.py registers ServerOverloadedError).

_DUMP_TRIGGERS: Dict[Type[BaseException], str] = {}


def register_dump_trigger(exc_cls: Type[BaseException], reason: str) -> None:
    _DUMP_TRIGGERS[exc_cls] = reason


def dump_triggers() -> Dict[Type[BaseException], str]:
    return dict(_DUMP_TRIGGERS)


def trigger_reason(exc_cls: Type[BaseException]) -> Optional[str]:
    """Registered dump reason for an error type, walking its MRO (so a
    subclass of a registered error inherits the trigger)."""
    for klass in exc_cls.__mro__:
        if klass in _DUMP_TRIGGERS:
            return _DUMP_TRIGGERS[klass]
    return None


def dump_on_error(exc: BaseException,
                  extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Automatic-dump path for raise sites: when the flight recorder is
    armed and exc's type has a registered trigger, dump (rate-limited per
    reason), stamp `exc.dump_path`, and append the path to the error
    message so the operator's traceback names the artifact."""
    fr = _RECORDER
    if fr is None or not _FR_ENABLED:
        return None
    reason = trigger_reason(type(exc))
    if reason is None:
        return None
    path = fr.dump(reason=reason, extra=extra)
    if path:
        exc.dump_path = path  # type: ignore[attr-defined]
        if exc.args and isinstance(exc.args[0], str):
            exc.args = (exc.args[0] + f" [flight recorder: {path}]",) \
                + exc.args[1:]
    return path
