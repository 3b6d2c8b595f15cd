"""Device memory attribution plane — the *space* analog of the step timeline.

Counterpart of `paddle_tpu/obs/memory.py`. `torch.cuda.memory_allocated`
answers "how many bytes are live"; this module answers "whose bytes are
they" — params, optimizer slots, activations, the serving bucket pool or
the LLM KV pool — three ways:

  1. **Tagged census** — `tag(name, tensors, origin=...)` registers
     tensors in a weakref side-table at their creation seams
     (`jit/train_step.py`, `optimizer/`, `serving/engine.py`,
     `serving/llm.py`). The table is keyed by STORAGE
     (`(device, untyped_storage().data_ptr())`), so views of one storage
     count once and a view at an offset still finds its storage.
     `census()` buckets the tagged bytes per tag per device, publishing
     `mem.<tag>.bytes` gauges and feeding a bounded ring
     (`FLAGS_mem_census_ring`). On a CUDA device the untagged remainder is
     "other": `torch.cuda.memory_allocated(dev)` minus the tagged bytes.
     The reference walks `jax.live_arrays()`; torch has no such walk, so
     on the CPU untagged bytes are unknown and the record says so
     (`untagged_unknown`).
  2. **Per-executable breakdown** — `executable_memory(obj)` normalizes
     `obj.memory_analysis()` (argument/output/temp/alias/generated-code
     bytes). A captured CUDA graph (`jit.TranslatedLayer`'s replays)
     reports the growth of `torch.cuda.memory_reserved()` across its
     capture beside the artifact's parameter bytes. Peak memory per
     timeline phase is read from `torch.cuda.max_memory_allocated` at
     each phase exit (`StepTimeline.on_phase`), which then resets the
     peak for the next phase.
  3. **OOM forensics + leak watch** — `maybe_dump_oom(exc, ...)` turns a
     `torch.cuda.OutOfMemoryError` (or a fault injected at the
     `mem.alloc` site) into ONE rate-limited flight-recorder dump
     embedding the census ring, the top-K tagged storages with tag +
     origin, and the owning executable's breakdown; the leak watch flags
     any tag whose census bytes grow strictly for `FLAGS_mem_leak_window`
     consecutive censuses (`mem.leak_suspects` counter + one warning per
     tag).

Hot-path contract: every tag seam checks ONE module attribute
(`_mem._ENABLED`) and calls nothing else on the disabled path.
"""
from __future__ import annotations

import threading
import time
import warnings
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

import torch

from ..core import flags as _flags

__all__ = [
    "tag", "tag_of", "census", "census_ring", "top_buffers",
    "executable_memory", "phase_peaks", "phase_peak_ring",
    "is_oom", "maybe_dump_oom", "render_census", "reset",
]

# Hot-path gate: tag seams read this module attribute.
_ENABLED: bool = False

# (device, storage data_ptr) -> [tag, origin, storage nbytes, [weakrefs]]:
# one entry per storage; the entry lives while any tagged tensor over the
# storage does (the weakref callbacks reap it), so a recycled address can
# never inherit a dead storage's tag.
_TAGS: Dict[tuple, list] = {}

_LOCK = threading.RLock()
_CENSUS_RING: deque = deque(maxlen=16)
_PHASE_RING: deque = deque(maxlen=64)      # {"phase","ts","bytes"} samples
_PHASE_PEAKS: Dict[str, int] = {}          # phase -> max sampled bytes
_LEAK_HISTORY: Dict[str, deque] = {}       # tag -> trailing census bytes
_LEAK_WARNED: set = set()

_OOM_MARKERS = ("CUDA out of memory", "out of memory",
                "fault injected at mem.alloc")


def _rewire(_v=None) -> None:
    global _ENABLED, _CENSUS_RING
    _ENABLED = bool(_flags.flag("mem_census"))
    ring = max(1, int(_flags.flag("mem_census_ring")))
    if ring != _CENSUS_RING.maxlen:
        with _LOCK:
            _CENSUS_RING = deque(list(_CENSUS_RING)[-ring:], maxlen=ring)


for _name in ("mem_census", "mem_census_ring"):
    _flags.watch_flag(_name, _rewire)
_rewire()


# ---- tagging ----------------------------------------------------------------

def _iter_tensors(values):
    """Tensors in any nest of tensors, lists, tuples and dicts."""
    if isinstance(values, torch.Tensor):
        yield values
    elif isinstance(values, dict):
        for v in values.values():
            yield from _iter_tensors(v)
    elif isinstance(values, (list, tuple)):
        for v in values:
            yield from _iter_tensors(v)


def _key(t: torch.Tensor) -> tuple:
    return str(t.device), t.untyped_storage().data_ptr()


def _reaper(key: tuple):
    def _cb(ref):
        with _LOCK:
            entry = _TAGS.get(key)
            if entry is None:
                return
            entry[3] = [r for r in entry[3] if r is not ref and
                        r() is not None]
            if not entry[3]:
                del _TAGS[key]
    return _cb


def tag(name: str, values: Any, origin: Optional[str] = None) -> int:
    """Tag the storage of every tensor in `values` (a tensor or a nest of
    them) as belonging to plane `name`; a later tag of the same storage
    replaces the earlier one. Returns the number of tensors tagged."""
    if not _ENABLED:
        return 0
    n = 0
    name = str(name)
    with _LOCK:
        for t in _iter_tensors(values):
            storage = t.untyped_storage()
            key = (str(t.device), storage.data_ptr())
            if key[1] == 0:
                continue            # an empty tensor owns no memory
            entry = _TAGS.get(key)
            if entry is None:
                entry = _TAGS[key] = [name, origin, storage.nbytes(), []]
            else:
                entry[0], entry[1] = name, origin
                entry[2] = max(entry[2], storage.nbytes())
            if not any(r() is t for r in entry[3]):
                entry[3].append(weakref.ref(t, _reaper(key)))
            n += 1
    return n


def tag_of(t: torch.Tensor) -> Optional[tuple]:
    """(tag, origin) of the storage under `t`, else None."""
    with _LOCK:
        entry = _TAGS.get(_key(t))
        return (entry[0], entry[1]) if entry is not None else None


def _live_entries() -> List[tuple]:
    """[(device, tag, origin, nbytes)] for every tagged storage."""
    with _LOCK:
        return [(key[0], e[0], e[1], e[2]) for key, e in _TAGS.items()
                if any(r() is not None for r in e[3])]


# ---- census -----------------------------------------------------------------

def census(publish: bool = True, store: bool = True) -> Dict[str, Any]:
    """Bucket the tagged bytes per tag per device. On a CUDA device the
    untagged rest of `torch.cuda.memory_allocated` is "other"; on the CPU
    the untagged bytes are unknown (listed in `untagged_unknown`).
    Publishes `mem.<tag>.bytes` gauges (FLAGS_monitor), appends to the
    census ring, and feeds the leak watch unless told otherwise."""
    tags: Dict[str, Dict[str, Any]] = {}
    per_dev: Dict[str, int] = {}
    for dev, name, _origin, nb in _live_entries():
        bucket = tags.setdefault(name, {"bytes": 0, "count": 0,
                                        "devices": {}})
        bucket["bytes"] += nb
        bucket["count"] += 1
        bucket["devices"][dev] = bucket["devices"].get(dev, 0) + nb
        per_dev[dev] = per_dev.get(dev, 0) + nb
    tagged = sum(per_dev.values())
    total = tagged
    allocated: Dict[str, int] = {}
    unknown: List[str] = []
    cuda_devs = set(d for d in per_dev if d.startswith("cuda"))
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        cuda_devs.add(f"cuda:{torch.cuda.current_device()}")
    for dev in sorted(cuda_devs):
        alloc = int(torch.cuda.memory_allocated(torch.device(dev)))
        allocated[dev] = alloc
        rest = max(0, alloc - per_dev.get(dev, 0))
        if rest:
            bucket = tags.setdefault("other", {"bytes": 0, "count": 0,
                                               "devices": {}})
            bucket["bytes"] += rest
            bucket["devices"][dev] = rest
            total += rest
    unknown = sorted(d for d in per_dev if not d.startswith("cuda"))
    rec = {"ts": time.time(), "total_bytes": total, "tagged_bytes": tagged,
           "allocated_bytes": allocated, "untagged_unknown": unknown,
           "tags": tags}
    if publish:
        from .. import monitor as _monitor
        if _monitor._ENABLED:
            for name, bucket in tags.items():
                _monitor.gauge_set(f"mem.{name}.bytes", bucket["bytes"])
            _monitor.gauge_set("mem.total.bytes", total)
    if store:
        with _LOCK:
            _CENSUS_RING.append(rec)
        _leak_check({n: b["bytes"] for n, b in tags.items()})
    return rec


def census_ring() -> List[Dict[str, Any]]:
    with _LOCK:
        return list(_CENSUS_RING)


def top_buffers(k: Optional[int] = None) -> List[Dict[str, Any]]:
    """The K largest tagged storages, each with its tag + origin — the
    'who owns the bytes' table of an OOM dump (untagged storages are not
    visible to the port)."""
    if k is None:
        k = int(_flags.flag("mem_top_k"))
    rows = []
    with _LOCK:
        for key, e in _TAGS.items():
            t = next((r() for r in e[3] if r() is not None), None)
            if t is None:
                continue
            rows.append({"bytes": int(e[2]), "shape": list(t.shape),
                         "dtype": str(t.dtype).replace("torch.", ""),
                         "device": key[0], "tag": e[0], "origin": e[1]})
    rows.sort(key=lambda r: -r["bytes"])
    return rows[:max(0, int(k))]


# ---- leak watch -------------------------------------------------------------

def _leak_check(per_tag: Dict[str, int]) -> None:
    window = int(_flags.flag("mem_leak_window"))
    if window <= 0:
        return
    from .. import monitor as _monitor
    with _LOCK:
        for name, nbytes in per_tag.items():
            hist = _LEAK_HISTORY.get(name)
            if hist is None or hist.maxlen != window + 1:
                hist = _LEAK_HISTORY[name] = deque(
                    list(hist or ()), maxlen=window + 1)
            hist.append(int(nbytes))
            if len(hist) < hist.maxlen:
                continue
            samples = list(hist)
            if all(a < b for a, b in zip(samples, samples[1:])):
                if _monitor._ENABLED:
                    _monitor.count("mem.leak_suspects")
                if name not in _LEAK_WARNED:
                    _LEAK_WARNED.add(name)
                    warnings.warn(
                        f"mem leak watch: tag '{name}' grew on {window} "
                        f"consecutive censuses ({samples[0]} -> "
                        f"{samples[-1]} bytes) — a held reference is "
                        "pinning device memory (FLAGS_mem_leak_window)",
                        ResourceWarning, stacklevel=2)


# ---- per-executable breakdown ----------------------------------------------

_MEM_ATTRS = (
    ("argument_size_in_bytes", "argument_bytes"),
    ("output_size_in_bytes", "output_bytes"),
    ("temp_size_in_bytes", "temp_bytes"),
    ("alias_size_in_bytes", "alias_bytes"),
    ("generated_code_size_in_bytes", "generated_code_bytes"),
)


def executable_memory(compiled) -> Dict[str, int]:
    """Normalized {argument_bytes, output_bytes, temp_bytes, alias_bytes,
    generated_code_bytes, peak_bytes} from `compiled.memory_analysis()`
    (an object with those `*_size_in_bytes` attributes, or a dict of
    them); absent/failed analysis -> {}. A captured CUDA graph of the port
    (`jit.save_load._Replay`) reports its parameters and static inputs as
    arguments, its static outputs as outputs, and the rest of the
    `memory_reserved()` growth across its capture as temps. `peak_bytes`
    = arguments (minus aliases) + outputs + temps + program text."""
    try:
        ma = compiled.memory_analysis()
    except Exception:
        return {}
    if isinstance(ma, (list, tuple)):
        ma = ma[0] if ma else None
    if ma is None:
        return {}
    out: Dict[str, int] = {}
    for attr, norm in _MEM_ATTRS:
        v = ma.get(attr) if isinstance(ma, dict) else getattr(ma, attr, None)
        if isinstance(v, (int, float)):
            out[norm] = int(v)
    if out:
        out["peak_bytes"] = (out.get("argument_bytes", 0)
                             - out.get("alias_bytes", 0)
                             + out.get("output_bytes", 0)
                             + out.get("temp_bytes", 0)
                             + out.get("generated_code_bytes", 0))
    return out


# ---- peak memory per timeline phase ----------------------------------------

def on_phase(name: str, t0: float, t1: float) -> None:
    """StepTimeline phase-boundary hook (wired by obs._rewire when both the
    timeline and FLAGS_mem_census are on): the phase's peak is
    `torch.cuda.max_memory_allocated` since the previous phase exit, which
    is then reset; on the CPU, the tagged bytes at the exit."""
    if not _ENABLED:
        return
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        nbytes = int(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
    else:
        nbytes = sum(e[3] for e in _live_entries())
    with _LOCK:
        _PHASE_RING.append({"phase": name, "ts": t1, "bytes": nbytes})
        if nbytes > _PHASE_PEAKS.get(name, -1):
            _PHASE_PEAKS[name] = nbytes


def phase_peaks() -> Dict[str, int]:
    """phase -> max bytes sampled at that phase's exits."""
    with _LOCK:
        return dict(_PHASE_PEAKS)


def phase_peak_ring() -> List[Dict[str, Any]]:
    with _LOCK:
        return list(_PHASE_RING)


# ---- OOM forensics ----------------------------------------------------------

def is_oom(exc: BaseException) -> bool:
    """A `torch.cuda.OutOfMemoryError` (or any error whose message says
    the device ran out of memory), or the fault-injected `mem.alloc`
    stand-in used to rehearse the path off the card."""
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    msg = str(exc)
    return any(m in msg for m in _OOM_MARKERS)


def forensics(executables: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The memory section of an OOM dump: a fresh census (the last act
    before the artifact is written), the ring of prior censuses, the top-K
    tagged storages with tag + origin, per-phase peaks, and the
    per-executable breakdown the call site supplied."""
    try:
        current = census(publish=False, store=False)
    except Exception:
        current = {}
    return {
        "census": census_ring(),
        "census_at_dump": current,
        "top_buffers": top_buffers(),
        "phase_peaks": phase_peaks(),
        "executables": executables or {},
    }


def maybe_dump_oom(exc: BaseException, executable: Optional[str] = None,
                   report=None) -> Optional[str]:
    """Dispatch-site except-path: when `exc` is an OOM and the flight
    recorder is armed, write ONE rate-limited dump (reason "oom") whose
    extra.memory names the top storages (tag + origin) and the owning
    executable's breakdown. Stamps `exc.dump_path` like
    obs.dump_on_error. Returns the dump path or None."""
    if not is_oom(exc):
        return None
    from . import _FR_ENABLED, _RECORDER
    fr = _RECORDER
    if fr is None or not _FR_ENABLED:
        return None
    execs: Dict[str, Any] = {}
    if executable is not None and report is not None:
        try:
            execs[executable] = report() if callable(report) else dict(report)
        except Exception:
            execs[executable] = {}
    path = fr.dump(reason="oom", extra={"memory": forensics(execs)})
    if path:
        exc.dump_path = path  # type: ignore[attr-defined]
        if exc.args and isinstance(exc.args[0], str):
            exc.args = (exc.args[0] + f" [flight recorder: {path}]",) \
                + exc.args[1:]
    return path


# ---- rendering (monitor CLI `mem` subcommand) ------------------------------

def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024.0 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024.0
    return f"{n:.1f}GiB"


def render_census(rec: Dict[str, Any],
                  top: Optional[List[Dict[str, Any]]] = None) -> str:
    """Pretty-print one census record (+ optional top-buffer table)."""
    lines = ["-" * 72,
             f"memory census — total {_fmt_bytes(rec.get('total_bytes', 0))}",
             "-" * 72,
             f"{'Tag':<22}{'Bytes':>12}{'Share':>8}{'Buffers':>9}  Devices"]
    total = max(1, int(rec.get("total_bytes", 0)))
    tags = rec.get("tags", {})
    for name in sorted(tags, key=lambda n: -tags[n]["bytes"]):
        b = tags[name]
        devs = ",".join(sorted(b.get("devices", {})))
        lines.append(f"{name[:21]:<22}{_fmt_bytes(b['bytes']):>12}"
                     f"{b['bytes'] / total:>8.1%}{b.get('count', 0):>9}"
                     f"  [{devs}]")
    if rec.get("untagged_unknown"):
        lines.append(f"untagged bytes unknown on: "
                     f"{', '.join(rec['untagged_unknown'])}")
    if top:
        lines.append("-" * 72)
        lines.append("top buffers:")
        for row in top:
            origin = f"  ({row['origin']})" if row.get("origin") else ""
            lines.append(f"  {_fmt_bytes(row['bytes']):>10}  "
                         f"{row['dtype']}{row['shape']}  "
                         f"tag={row['tag']}{origin}")
    lines.append("-" * 72)
    return "\n".join(lines)


# ---- test hygiene -----------------------------------------------------------

def reset() -> None:
    """Drop the side tables (tests): tags, rings, leak history."""
    with _LOCK:
        _TAGS.clear()
        _CENSUS_RING.clear()
        _PHASE_RING.clear()
        _PHASE_PEAKS.clear()
        _LEAK_HISTORY.clear()
        _LEAK_WARNED.clear()
