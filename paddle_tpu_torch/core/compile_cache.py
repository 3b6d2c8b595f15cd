"""Persistent on-disk program cache — fleet warm start in seconds.

Counterpart of `paddle_tpu/core/compile_cache.py`. A process never
re-exports a program it already built (`core/executable.py`'s ledger), but
at fleet scale the same waste happens ACROSS processes: every serving
replica re-warms its bucket ladder and every restarted trainer re-exports
its to_static step. This module is the cross-process half of that
substrate: a novel to_static signature's `torch.export` program is saved
with `jit.save_load.program_bytes` (the serializer `jit.save` writes its
`.pdmodel` with; the weights stay out, they are the program's arguments)
and persisted crash-atomically (`framework/io.atomic_write`, CRC
manifests, tmp + rename with per-writer tmp names, so lock-free concurrent
writers are last-writer-wins). A second process with the same program and
topology loads it instead of exporting; a corrupt, torn, stale-version or
wrong-topology entry falls back to a fresh export (`fallbacks` counter,
never an error) and is pruned. The disk footprint is a size-capped LRU
(`FLAGS_compile_cache_mb`), ranked by each entry's last-use stamp.

Key anatomy. The reference hashes the canonical StableHLO of the program
it is about to compile. In torch the export is the expensive step and
comes before any such text, so the port keys on what it knows before
exporting: the caller's key material (to_static: its whole in-process
signature — input, parameter and buffer shapes, dtypes and device kinds,
the `training` flags, the AMP state, the kwargs — plus the parameter and
buffer names, the function's qualname and dy2static-rewritten source with
its closure and defaults, the non-tensor attributes and hooks of every
sublayer, and the source text of every file that defines a class in
`layer.modules()`; a value without a description that holds across
processes makes the program unpersistable, an `export_skip`), and here

    sha256(key material
           + one digest of the port's own .py sources (once per process)
           + topology fingerprint (device name x count, mesh axes)
           + torch and CUDA versions
           + every flag's value except the observability and cache gates)

Devices enter the key by kind only: to_static moves a loaded program onto
the call's device index. What this key cannot see: a helper changed in a
user file that defines no module class (or a global it reads). Clearing the directory, or
`python -m paddle_tpu_torch.monitor cache DIR --gc --cap-mb 0`, is the
remedy.

Hot-path contract (monitor/faults regime): every build site checks ONE
module attribute (`_DIR`) and pays nothing else while the flag is unset.
Counters are plain module ints (`stats()`), mirrored to
`paddle_tpu_torch.monitor` counters `compile_cache.*` when the monitor is
on. `exports` counts every `torch.export` of the process
(`jit.save_load.export_program`), which `warm_start_report` reads: the
port's `trace_compile` also counts CUDA-graph captures, which no process
can load.

Fault drill site: `compile_cache.write` (torn blob bytes — the manifest
CRC is of the INTENDED bytes, so a mangled write fails lookup
verification and falls back).
"""
from __future__ import annotations

import hashlib
import json
import os
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from .. import faults as _faults
from .. import monitor as _monitor
from . import flags as _flags

__all__ = [
    "enabled", "cache_dir", "cache_key", "topology_fingerprint",
    "lookup", "store", "entries", "gc", "verify", "stats", "reset_stats",
    "warm_start_report",
]

_SCHEMA = 1

# ---- gate (one module attribute on the disabled path) ----------------------
_DIR: str = str(_flags.flag("compile_cache_dir") or "")

# process-lifetime counters (monitor may be off; serving stats() and tests
# read these regardless)
hits: int = 0
misses: int = 0
fallbacks: int = 0
stores: int = 0
evictions: int = 0
export_skips: int = 0   # programs the cache does not persist
exports: int = 0        # torch.export calls of this process


def _on_dir(value) -> None:
    global _DIR
    _DIR = str(value or "")


_flags.watch_flag("compile_cache_dir", _on_dir)


def enabled() -> bool:
    return bool(_DIR)


def cache_dir() -> str:
    return _DIR


def _count(name: str, delta: int = 1) -> None:
    if _monitor._ENABLED:
        _monitor.count(f"compile_cache.{name}", delta)


# ---- key anatomy -----------------------------------------------------------

_TOPOLOGY: Optional[str] = None
_PORT_DIGEST: Optional[str] = None

# flags that change no program: observability, fault drills, the wire's
# secrets, and the cache's own gates. Every other flag is keyed, so a flag
# added later is keyed by default.
_UNKEYED = frozenset({
    "compile_cache_dir", "compile_cache_mb", "lint", "monitor",
    "fault_inject", "obs_timeline", "obs_flight_recorder", "obs_ring_steps",
    "obs_ring_snapshots", "obs_dump_dir", "obs_dump_min_interval_s",
    "mem_census", "mem_census_ring", "mem_top_k", "mem_leak_window",
    "trace", "trace_ring", "slo_latency_ms", "slo_target", "slo_windows",
    "slo_shed_burn", "sync_watch", "sync_hold_warn_ms", "sync_order_fatal",
    "net_auth_token", "net_tls_cert", "net_tls_key", "net_tls_ca",
})
# the serving fleet's planes (membership, routing, telemetry, the online
# tables, the autoscaler) steer requests, never a program: a replica
# started under them loads what a plain process stored
_UNKEYED_PREFIXES = ("telemetry", "fleet_", "online_", "autoscaler_")


def topology_fingerprint(mesh_shape=None) -> str:
    """Device name × count (+ mesh axes) — an entry exported for one
    topology must never be offered to another."""
    global _TOPOLOGY
    if _TOPOLOGY is None:
        import torch
        if torch.cuda.is_available():
            _TOPOLOGY = (f"{torch.cuda.get_device_name(0)}"
                         f"x{torch.cuda.device_count()}")
        else:
            _TOPOLOGY = "cpux1"
    fp = _TOPOLOGY
    if mesh_shape:
        fp += ";mesh=" + ",".join(f"{a}={n}" for a, n in
                                  (mesh_shape.items()
                                   if isinstance(mesh_shape, dict)
                                   else mesh_shape))
    return fp


def torch_version() -> str:
    """The torch build an entry was written by: its version and CUDA's."""
    import torch
    return f"{torch.__version__};cuda={torch.version.cuda}"


def port_digest() -> str:
    """sha256 of every .py file of `paddle_tpu_torch` (paths and bytes),
    computed once per process: an edited port never loads a program the
    old code exported."""
    global _PORT_DIGEST
    if _PORT_DIGEST is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        h = hashlib.sha256()
        for base, dirs, names in os.walk(root):
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            for name in sorted(names):
                if name.endswith(".py"):
                    path = os.path.join(base, name)
                    h.update(os.path.relpath(path, root).encode() + b"\x00")
                    with open(path, "rb") as f:
                        h.update(f.read())
        _PORT_DIGEST = h.hexdigest()
    return _PORT_DIGEST


def _canonicalize(text: str) -> str:
    """Trailing whitespace never changes a program."""
    return "\n".join(ln.rstrip() for ln in text.splitlines())


def _relevant_flags() -> str:
    return ";".join(f"{name}={value!r}" for name, value in
                    sorted(_flags._REGISTRY.items())
                    if name not in _UNKEYED
                    and not name.startswith(_UNKEYED_PREFIXES))


def cache_key(material: str, mesh_shape=None,
              extra: Tuple[str, ...] = ()) -> str:
    h = hashlib.sha256()
    h.update(_canonicalize(material).encode())
    h.update(b"\x00" + port_digest().encode())
    h.update(b"\x00" + topology_fingerprint(mesh_shape).encode())
    h.update(b"\x00" + torch_version().encode())
    h.update(b"\x00" + _relevant_flags().encode())
    for item in extra:
        h.update(b"\x00" + str(item).encode())
    return h.hexdigest()[:40]


# ---- storage layout: <dir>/<key>.bin + <dir>/<key>.json --------------------

def _paths(key: str, dirname: Optional[str] = None) -> Tuple[str, str]:
    d = dirname or _DIR
    return os.path.join(d, key + ".bin"), os.path.join(d, key + ".json")


def _read_manifest(mpath: str) -> Optional[dict]:
    try:
        with open(mpath) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _write_manifest(mpath: str, manifest: dict) -> None:
    from ..framework.io import atomic_write
    atomic_write(mpath, json.dumps(manifest).encode())


def _prune(key: str, dirname: Optional[str] = None) -> None:
    for path in _paths(key, dirname):
        try:
            os.remove(path)
        except OSError:
            pass


def _fallback(key: str, why: str, dirname: Optional[str] = None,
              prune: bool = True) -> None:
    global fallbacks
    fallbacks += 1
    _count("fallbacks")
    if _monitor._ENABLED:
        _monitor.log_event("compile_cache.fallback", key=key, why=why)
    if prune:
        _prune(key, dirname)


def lookup(key: str, mesh_shape=None) -> Optional[bytes]:
    """Serialized program bytes for `key`, or None (miss OR fallback).
    Verifies the manifest CRC and re-validates the recorded torch version
    / topology against the current process (defense in depth — they are
    in the key, but a copied or forged entry must still never load). A
    bad entry is pruned and counted as a fallback, never raised."""
    global hits
    bpath, mpath = _paths(key)
    manifest = _read_manifest(mpath)
    if manifest is None:
        if os.path.exists(bpath):           # blob without commit record
            _fallback(key, "missing_manifest")
        return None
    try:
        with open(bpath, "rb") as f:
            blob = f.read()
    except OSError:
        _fallback(key, "missing_blob")
        return None
    if zlib.crc32(blob) & 0xFFFFFFFF != manifest.get("crc"):
        _fallback(key, "crc_mismatch")
        return None
    if manifest.get("torch_version") != torch_version():
        _fallback(key, "stale_torch_version")
        return None
    if manifest.get("topology") != topology_fingerprint(mesh_shape):
        _fallback(key, "wrong_topology")
        return None
    hits += 1
    _count("hits")
    # LRU stamp + hit count: lock-free last-writer-wins manifest rewrite
    manifest["hits"] = int(manifest.get("hits", 0)) + 1
    manifest["last_used"] = time.time()
    try:
        _write_manifest(mpath, manifest)
    except OSError:
        pass
    return blob


def store(key: str, blob: bytes, kind: str = "", label: str = "",
          mesh_shape=None) -> bool:
    """Persist one entry crash-atomically. The manifest CRC is computed
    over the INTENDED bytes before the `compile_cache.write` fault site
    can mangle them, so a torn write is caught by the next lookup. Never
    raises; a failed store just means the next process exports fresh."""
    global stores
    if not _DIR:
        return False
    bpath, mpath = _paths(key)
    manifest = {
        "schema": _SCHEMA,
        "key": key,
        "kind": kind,
        "label": label,
        "bytes": len(blob),
        "crc": zlib.crc32(blob) & 0xFFFFFFFF,
        "torch_version": torch_version(),
        "topology": topology_fingerprint(mesh_shape),
        "created": time.time(),
        "last_used": time.time(),
        "hits": 0,
    }
    if _faults._ENABLED:
        blob = _faults.mangle("compile_cache.write", blob)
    try:
        from ..framework.io import atomic_write
        os.makedirs(_DIR, exist_ok=True)
        atomic_write(bpath, blob)
        _write_manifest(mpath, manifest)
    except OSError:
        return False
    stores += 1
    _count("stores")
    _enforce_cap()
    return True


def note_miss() -> None:
    global misses
    misses += 1
    _count("misses")


def note_export_skip(why: str = "") -> None:
    global export_skips
    export_skips += 1
    _count("export_skips")
    if _monitor._ENABLED and why:
        _monitor.log_event("compile_cache.export_skip", why=why[:200])


def note_export() -> None:
    """One `torch.export` ran in this process (cache on or off)."""
    global exports
    exports += 1
    _count("exports")


# ---- listing / gc / verify (the monitor CLI's `cache` subcommand) ----------

def entries(dirname: Optional[str] = None) -> List[Dict[str, Any]]:
    """Manifest-backed listing of every committed entry, LRU first."""
    d = dirname or _DIR
    out: List[Dict[str, Any]] = []
    if not d or not os.path.isdir(d):
        return out
    for name in sorted(os.listdir(d)):
        if not name.endswith(".json"):
            continue
        manifest = _read_manifest(os.path.join(d, name))
        if not manifest or "key" not in manifest:
            continue
        bpath = os.path.join(d, manifest["key"] + ".bin")
        try:
            nbytes = os.path.getsize(bpath)
        except OSError:
            nbytes = -1   # torn entry: manifest without blob
        row = dict(manifest)
        row["disk_bytes"] = nbytes
        row["age_s"] = max(0.0, time.time() - float(
            manifest.get("created", 0.0)))
        out.append(row)
    out.sort(key=lambda r: float(r.get("last_used", 0.0)))
    return out


def total_bytes(dirname: Optional[str] = None) -> int:
    return sum(max(0, e["disk_bytes"]) + len(json.dumps(e))
               for e in entries(dirname))


def gc(dirname: Optional[str] = None,
       cap_mb: Optional[float] = None) -> List[str]:
    """Evict least-recently-used entries until the directory fits the cap
    (`FLAGS_compile_cache_mb`). Returns evicted keys."""
    global evictions
    d = dirname or _DIR
    cap = float(_flags.flag("compile_cache_mb")) if cap_mb is None \
        else float(cap_mb)
    cap_bytes = int(cap * 1024 * 1024)
    rows = entries(d)
    used = sum(max(0, r["disk_bytes"]) for r in rows)
    evicted: List[str] = []
    for row in rows:                       # LRU first
        if used <= cap_bytes:
            break
        _prune(row["key"], d)
        used -= max(0, row["disk_bytes"])
        evicted.append(row["key"])
    if evicted:
        evictions += len(evicted)
        _count("evictions", len(evicted))
    return evicted


def _enforce_cap() -> None:
    try:
        gc()
    except OSError:
        pass


def verify(dirname: Optional[str] = None,
           prune: bool = True) -> Tuple[int, List[str]]:
    """CRC-check every entry; optionally prune corrupt/torn ones.
    Returns (ok_count, bad_keys)."""
    d = dirname or _DIR
    ok, bad = 0, []
    for row in entries(d):
        bpath, _ = _paths(row["key"], d)
        try:
            with open(bpath, "rb") as f:
                blob = f.read()
            good = zlib.crc32(blob) & 0xFFFFFFFF == row.get("crc")
        except OSError:
            good = False
        if good:
            ok += 1
        else:
            bad.append(row["key"])
            if prune:
                _prune(row["key"], d)
    return ok, bad


# ---- stats -----------------------------------------------------------------

def stats() -> Dict[str, int]:
    """Process-lifetime cache activity (plain ints — valid with the
    monitor off; `ServingEngine.stats()` embeds this dict)."""
    return {"hits": hits, "misses": misses, "fallbacks": fallbacks,
            "stores": stores, "evictions": evictions,
            "export_skips": export_skips}


def reset_stats() -> None:
    global hits, misses, fallbacks, stores, evictions, export_skips, exports
    hits = misses = fallbacks = stores = evictions = export_skips = 0
    exports = 0


def warm_start_report() -> Dict[str, Any]:
    """One-call warm-start verdict for a freshly spawned process: cache
    activity, the `trace_compile` ledger counter (core/executable.py's
    booking counts every build there, CUDA-graph captures included) and
    `exports`, the process's `torch.export` calls. `warm` is the
    autoscaler's acceptance bit: the cache is on, the process exported
    NOTHING and loaded at least one program from disk. The reference's
    bit reads `trace_compile == 0`; in the port a loaded program still
    captures its CUDA graph, which no process can persist, so the bit
    reads `exports` instead."""
    compiles = 0
    if _monitor._ENABLED:
        compiles = int(
            _monitor.snapshot()["counters"].get("trace_compile", 0))
    s = stats()
    return {"enabled": enabled(), "dir": cache_dir(),
            "trace_compile": compiles, "exports": exports,
            "warm": bool(enabled() and exports == 0 and s["hits"] > 0),
            **s}
