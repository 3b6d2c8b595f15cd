"""Runtime concurrency sanitizer + central thread registry.

Counterpart of `paddle_tpu/utils/syncwatch.py`:

  - `ThreadRegistry` (always on): every thread the port spawns (the
    serving engine's workers, the LLM scheduler, the wire's accept and
    connection threads) is a `syncwatch.Thread(..., owner=__name__)`,
    which records name, owner module, daemonhood and the SPAWN STACK.
    `live_threads()` lists the live ones (the tests' leak fixtures read
    it) and `python -m paddle_tpu_torch.monitor threads` renders them.

  - lock-order sanitizer (`FLAGS_sync_watch`): `syncwatch.lock(name)` /
    `rlock(name)` hand out watched wrappers recording per-thread
    held-sets + acquisition stacks and maintaining the observed
    lock-order graph (edge A->B = "B acquired while holding A"). An
    acquisition that would close a cycle raises `SyncOrderError` naming
    BOTH stacks BEFORE blocking on the real lock, so a seeded deadlock
    reports instead of wedging (`FLAGS_sync_order_fatal=False` downgrades
    to a warning + `sync.order_violations` counter). Hold times land in
    the `sync.lock_hold_ms` histogram; holds over
    `FLAGS_sync_hold_warn_ms` warn with the acquisition stack. Disabled
    (default) the factories return PLAIN threading locks: one
    module-attribute check at construction, zero per-acquire cost.

Same-name edges are never recorded: instances sharing one name are an
ordered same-class acquisition whose protocol is the caller's, and a
self-loop would be a guaranteed false cycle.
"""
from __future__ import annotations

import sys
import threading
import time
import traceback
import warnings
import weakref
from typing import Any, Dict, List, Optional

from ..core import flags as _flags

__all__ = ["SyncOrderError", "Thread", "lock", "rlock", "live_threads",
           "dump_sync", "render_threads", "order_edges", "violations"]

# hot-path gate (faults/monitor/analysis pattern): factories read this
# module attribute; watch_flag keeps it in sync with set_flags
_ENABLED: bool = bool(_flags.flag("sync_watch"))


def _on_flag(value) -> None:
    global _ENABLED
    _ENABLED = bool(value)


_flags.watch_flag("sync_watch", _on_flag)


def enabled() -> bool:
    return _ENABLED


class SyncOrderError(RuntimeError):
    """A lock acquisition would close a cycle in the observed lock-order
    graph — the canonical ingredients of a deadlock. `.cycle` is the
    node path; the message carries both acquisition stacks."""

    def __init__(self, message: str, cycle: List[str]):
        super().__init__(message)
        self.cycle = cycle


# ---------------------------------------------------------------------------
# thread registry (always on)
# ---------------------------------------------------------------------------

_REG_LOCK = threading.Lock()
# id(thread) -> {"ref": weakref, "owner": str, "spawned": str, "t0": float}
_REGISTRY: Dict[int, Dict[str, Any]] = {}


class Thread(threading.Thread):
    """`threading.Thread` that self-registers in the central registry.

    `owner` names the spawning module; when omitted it is inferred from
    the caller's frame, so a leak report names the module that spawned
    the thread, not a bare thread name. The spawn stack is
    captured at CONSTRUCTION — that is the site a leak report must
    point at, not the run() frame."""

    def __init__(self, *args, owner: Optional[str] = None, **kwargs):
        super().__init__(*args, **kwargs)
        if owner is None:
            import sys
            owner = sys._getframe(1).f_globals.get("__name__", "?")
        self.owner = owner
        spawned = "".join(traceback.format_stack(limit=8)[:-1])
        with _REG_LOCK:
            _REGISTRY[id(self)] = {
                "ref": weakref.ref(self), "owner": owner,
                "spawned": spawned, "t0": time.time()}
            if len(_REGISTRY) > 512:
                _prune_registry_locked()


def _prune_registry_locked() -> None:
    dead = [k for k, row in _REGISTRY.items()
            if (t := row["ref"]()) is None or
            (t._started.is_set() and not t.is_alive())]
    for k in dead:
        _REGISTRY.pop(k, None)


def live_threads() -> List[Dict[str, Any]]:
    """Rows for every ALIVE registered thread: name, owner module, age,
    daemonhood, spawn stack, and (sanitizer on) currently-held locks
    with their hold ages and acquisition stacks."""
    now = time.time()
    with _REG_LOCK:
        _prune_registry_locked()
        rows = []
        for row in _REGISTRY.values():
            t = row["ref"]()
            if t is None or not t.is_alive():
                continue
            rows.append({"name": t.name, "owner": row["owner"],
                         "daemon": t.daemon, "ident": t.ident,
                         "age_s": round(now - row["t0"], 3),
                         "spawned": row["spawned"]})
    with _STATE_LOCK:
        held = {ident: [{"lock": h[0],
                         "held_ms": round((now - h[1]) * 1e3, 3),
                         "stack": _format_stack(h[2])}
                        for h in holds]
                for ident, holds in _HELD.items() if holds}
    for r in rows:
        r["held"] = held.get(r["ident"], [])
    return sorted(rows, key=lambda r: (r["owner"], r["name"]))


# ---------------------------------------------------------------------------
# lock-order sanitizer (FLAGS_sync_watch)
# ---------------------------------------------------------------------------

_STATE_LOCK = threading.Lock()          # plain: guards the books below
# thread ident -> [(lock name, t_acquire, acquisition stack), ...]
_HELD: Dict[int, List[tuple]] = {}
# src name -> {dst name -> {"stack_src","stack_dst","thread","count"}}:
# edge src->dst = "dst acquired while holding src", first-observed stacks
_EDGES: Dict[str, Dict[str, Dict[str, Any]]] = {}
_VIOLATIONS: int = 0


def violations() -> int:
    return _VIOLATIONS


def order_edges() -> Dict[str, List[str]]:
    """Adjacency snapshot of the observed lock-order graph."""
    with _STATE_LOCK:
        return {src: sorted(dsts) for src, dsts in _EDGES.items()}


def _find_path_locked(src: str, dst: str) -> Optional[List[str]]:
    """DFS: a path src ~> dst in the edge graph (callers hold
    _STATE_LOCK)."""
    stack, seen = [(src, [src])], {src}
    while stack:
        node, path = stack.pop()
        for nxt in _EDGES.get(node, ()):
            if nxt == dst:
                return path + [dst]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _stack_here(skip: int = 3, limit: int = 10):
    """Cheap per-acquire stack capture: (file, line, func) tuples from a
    raw frame walk — NO source-line reads, those happen lazily in
    `_format_stack` only when a violation/warning/render needs the text.
    `traceback.format_stack` here costs ~100x more."""
    try:
        f = sys._getframe(skip)
    except ValueError:
        return ()
    frames = []
    while f is not None and len(frames) < limit:
        frames.append((f.f_code.co_filename, f.f_lineno,
                       f.f_code.co_name))
        f = f.f_back
    return tuple(reversed(frames))


def _format_stack(frames) -> str:
    """Render a `_stack_here` capture in traceback style (cold path)."""
    if isinstance(frames, str):     # dump round-trip: already text
        return frames
    import linecache
    lines = []
    for fname, lineno, func in frames:
        lines.append(f'  File "{fname}", line {lineno}, in {func}\n')
        src = linecache.getline(fname, lineno).strip()
        if src:
            lines.append(f"    {src}\n")
    return "".join(lines)


class _WatchedLock:
    """Wrapper over a real threading lock. On acquire: cycle-check the
    would-be edges BEFORE blocking, then record edges + the hold; on
    release: pop the hold and feed the hold-time histogram/warning.
    RLock re-entry only does the bookkeeping on the OUTERMOST
    acquire/release."""

    __slots__ = ("_real", "name", "_reentrant", "_depth")

    def __init__(self, real, name: str, reentrant: bool = False):
        self._real = real
        self.name = name
        self._reentrant = reentrant
        self._depth = threading.local()

    # -- bookkeeping --
    def _check_and_record(self) -> None:
        global _VIOLATIONS
        ident = threading.get_ident()
        stack = _stack_here()
        cycle = None
        with _STATE_LOCK:
            holds = _HELD.setdefault(ident, [])
            for hname, _t0, hstack in holds:
                if hname == self.name:
                    continue        # same-name class: caller's protocol
                # acquiring self while holding hname adds hname->self;
                # a path self ~> hname means that edge closes a cycle
                path = _find_path_locked(self.name, hname)
                if path is not None:
                    first = _EDGES[path[0]][path[1]]
                    cycle = (path, hname, hstack, stack, first)
                    break
            if cycle is None:
                for hname, _t0, hstack in holds:
                    if hname == self.name:
                        continue
                    e = _EDGES.setdefault(hname, {}).get(self.name)
                    if e is None:
                        _EDGES[hname][self.name] = {
                            "stack_src": hstack, "stack_dst": stack,
                            "thread": threading.current_thread().name,
                            "count": 1}
                    else:
                        e["count"] += 1
                holds.append((self.name, time.monotonic(), stack))
                return
            _VIOLATIONS += 1
        path, hname, hstack, stack, first = cycle
        loop = " -> ".join(path + ["(held)"])
        msg = (f"lock-order cycle: acquiring '{self.name}' while holding "
               f"'{hname}' inverts the established order {loop}\n"
               f"--- this acquisition (thread "
               f"{threading.current_thread().name!r}, already holding "
               f"'{hname}'):\n{_format_stack(stack)}"
               f"--- established '{path[0]}' -> '{path[1]}' first "
               f"observed (thread {first['thread']!r}):\n"
               f"{_format_stack(first['stack_dst'])}")
        from .. import monitor as _monitor
        if _monitor._ENABLED:
            _monitor.count("sync.order_violations")
        if bool(_flags.flag("sync_order_fatal")):
            raise SyncOrderError(msg, path)
        warnings.warn(f"syncwatch: {msg}", stacklevel=3)
        with _STATE_LOCK:
            _HELD.setdefault(ident, []).append(
                (self.name, time.monotonic(), stack))

    def _pop_hold(self) -> None:
        ident = threading.get_ident()
        with _STATE_LOCK:
            holds = _HELD.get(ident, [])
            for i in range(len(holds) - 1, -1, -1):
                if holds[i][0] == self.name:
                    _name, t0, stack = holds.pop(i)
                    break
            else:
                return
        held_ms = (time.monotonic() - t0) * 1e3
        from .. import monitor as _monitor
        if _monitor._ENABLED:
            _monitor.observe("sync.lock_hold_ms", held_ms)
        warn_ms = float(_flags.flag("sync_hold_warn_ms"))
        if warn_ms > 0 and held_ms > warn_ms:
            if _monitor._ENABLED:
                _monitor.count("sync.hold_warns")
            warnings.warn(
                f"syncwatch: '{self.name}' held {held_ms:.1f}ms "
                f"(> FLAGS_sync_hold_warn_ms={warn_ms:g}) by thread "
                f"{threading.current_thread().name!r}; acquired at:\n"
                f"{_format_stack(stack)}", stacklevel=3)

    def _enter_depth(self) -> int:
        d = getattr(self._depth, "n", 0)
        self._depth.n = d + 1
        return d

    def _exit_depth(self) -> int:
        d = getattr(self._depth, "n", 1) - 1
        self._depth.n = d
        return d

    # -- lock protocol --
    def acquire(self, blocking: bool = True, timeout: float = -1):
        outermost = not self._reentrant or self._enter_depth() == 0
        if outermost:
            try:
                self._check_and_record()
            except SyncOrderError:
                if self._reentrant:
                    self._exit_depth()
                raise
        got = self._real.acquire(blocking, timeout)
        if outermost and not got:
            self._pop_hold()
        return got

    def release(self):
        self._real.release()
        if not self._reentrant or self._exit_depth() == 0:
            self._pop_hold()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._real.locked()

    def __repr__(self):
        return f"<syncwatch.{'RLock' if self._reentrant else 'Lock'} " \
               f"{self.name!r}>"


def lock(name: str):
    """Factory adopted by the threaded modules: a watched Lock under
    FLAGS_sync_watch, a plain `threading.Lock()` otherwise (zero
    per-acquire cost on the disabled path)."""
    if _ENABLED:
        return _WatchedLock(threading.Lock(), name)
    return threading.Lock()


def rlock(name: str):
    if _ENABLED:
        return _WatchedLock(threading.RLock(), name, reentrant=True)
    return threading.RLock()


# ---------------------------------------------------------------------------
# dump / render (flight-recorder `sync` section, `monitor threads` CLI)
# ---------------------------------------------------------------------------

def dump_sync() -> Dict[str, Any]:
    """The flight-recorder `sync` section (schema /5): the live thread
    table, the observed lock-order graph, and the violation count."""
    with _STATE_LOCK:
        edges = [{"src": src, "dst": dst, "count": e["count"],
                  "thread": e["thread"]}
                 for src, dsts in _EDGES.items()
                 for dst, e in dsts.items()]
        nviol = _VIOLATIONS
    threads = [{k: r[k] for k in
                ("name", "owner", "daemon", "age_s")} |
               {"held": [{"lock": h["lock"], "held_ms": h["held_ms"]}
                         for h in r["held"]]}
               for r in live_threads()]
    return {"enabled": _ENABLED, "threads": threads,
            "lock_order": sorted(edges,
                                 key=lambda e: (e["src"], e["dst"])),
            "violations": nviol}


def render_threads(doc: Optional[Dict[str, Any]] = None,
                   hold_warn_ms: Optional[float] = None) -> str:
    """Text table for `python -m paddle_tpu_torch.monitor threads`: live
    registry (doc=None) or a dump's `sync` section. Threads holding a
    lock longer than `hold_warn_ms` get their acquisition stack dumped
    under the table."""
    live = doc is None
    rows = live_threads() if live else (doc.get("threads") or [])
    if hold_warn_ms is None:
        hold_warn_ms = float(_flags.flag("sync_hold_warn_ms")) or 1e12
    lines = ["-" * 78,
             f"{'thread':<24}{'owner':<28}{'age':>8}{'daemon':>7}  held",
             "-" * 78]
    stuck = []
    for r in rows:
        held = ", ".join(f"{h['lock']}({h['held_ms']:.0f}ms)"
                         for h in (r.get("held") or [])) or "-"
        age = r.get("age_s", 0.0)
        age_s = f"{age / 3600:.1f}h" if age >= 3600 else f"{age:.1f}s"
        lines.append(f"{r['name'][:23]:<24}{r['owner'][:27]:<28}"
                     f"{age_s:>8}{'yes' if r.get('daemon') else 'no':>7}"
                     f"  {held}")
        for h in (r.get("held") or []):
            if h["held_ms"] > hold_warn_ms and h.get("stack"):
                stuck.append((r["name"], h))
    if not rows:
        lines.append("(no registered threads alive)")
    edges = None if live else (doc.get("lock_order") or [])
    if edges is None:
        edges = [{"src": s, "dst": d, "count": None}
                 for s, ds in order_edges().items() for d in ds]
    if edges:
        lines.append("observed lock order (held -> acquired):")
        for e in edges:
            n = f" x{e['count']}" if e.get("count") else ""
            lines.append(f"  {e['src']} -> {e['dst']}{n}")
    if doc is not None and doc.get("violations"):
        lines.append(f"ORDER VIOLATIONS: {doc['violations']}")
    for name, h in stuck:
        lines.append(f"thread {name!r} holding '{h['lock']}' for "
                     f"{h['held_ms']:.0f}ms (> {hold_warn_ms:g}ms), "
                     f"acquired at:")
        lines.extend("  " + ln for ln in h["stack"].splitlines())
    lines.append("-" * 78)
    return "\n".join(lines)


def _reset() -> None:
    """Test hook: forget the observed order graph, held-sets, and the
    violation count (the thread registry survives — it is state about
    real threads, not about the sanitizer)."""
    global _VIOLATIONS
    with _STATE_LOCK:
        _HELD.clear()
        _EDGES.clear()
        _VIOLATIONS = 0
