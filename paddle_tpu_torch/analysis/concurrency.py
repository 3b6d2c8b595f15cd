"""tpu-lint level 4: concurrency analysis (whole-package AST pass).

Counterpart of `paddle_tpu/analysis/concurrency.py`, pure AST and ported
close to verbatim. Levels 1-3 guard the source -> export -> CUDA-graph
path; this level guards the THREADS the serving engines, the wire and the
robustness planes run on. A pure-AST pass (no imports of
the scanned code) builds the static lock-acquisition graph — which locks
are taken while holding which others, tracked through `with self._lock:`
blocks, bare `.acquire()`/`.release()` calls, and `self.method(...)`
calls ONE level deep — and reports three rules:

  lock-order            two code paths acquire the same pair of locks in
                        opposite orders: the canonical deadlock. The
                        finding names BOTH sites.
  blocking-under-lock   unbounded blocking reachable inside a held-lock
                        region: socket recv/accept, zero-arg
                        `queue.get()` / `.join()` / `.wait()` (no
                        timeout), `time.sleep(>= SLEEP_THRESHOLD_S)`, or
                        an RPC `call_with_retry` — any of these wedges
                        every other thread contending the lock for the
                        full blocking duration.
  unregistered-thread   a raw `threading.Thread(...)` spawn outside the
                        `utils/syncwatch.py` ThreadRegistry — invisible
                        to the leak fixtures and the
                        `monitor threads` live table.

Lock identity is name-based: `self._lock` in class C is `C._lock`,
module-level `_LOCK` keeps its name, `self._locks[i]` collapses to
`C._locks[]` (a same-name CLASS — ordered same-class acquisition, such
as locks taken in ascending shard order, is the caller's protocol and
never forms an edge). A `with`/`acquire()` target counts as a lock when
it was assigned from `threading.Lock/RLock` / `syncwatch.lock/rlock` in
the same module, or when its terminal name looks like one
(`*lock*`/`*mutex*`/`_mu`).

Suppressions are the standard `# tpu-lint: disable=rule` comments; a
`lock-order` finding is dropped when EITHER of its two sites is
suppressed. The runtime half of this plane is `utils/syncwatch.py`,
which observes the same graph live under FLAGS_sync_watch.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Tuple

from .base import Finding, Suppressions

__all__ = ["SLEEP_THRESHOLD_S", "analyze_source", "analyze_paths",
           "lock_graph", "find_cycles"]

# a `time.sleep(c)` with constant c at/above this, under a held lock,
# is a real stall for every contending thread
SLEEP_THRESHOLD_S = 0.05

_LOCK_NAME_RE = re.compile(r"(^|_)(lock|locks|mu|mutex)\d*$", re.I)
# `.get()` is only a QUEUE get when the receiver is queue-shaped —
# Counter.get()/dict.get(k) must not fire
_QUEUE_NAME_RE = re.compile(
    r"(^|_)(q|queue|queues|jobs|tasks|inbox|mailbox|work)\d*$", re.I)
_BLOCKING_SOCKET = ("recv", "recv_into", "recvfrom", "accept")


def _dotted(node) -> Tuple[str, ...]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return ()


def _looks_like_lock(name: str) -> bool:
    return bool(_LOCK_NAME_RE.search(name))


# ---------------------------------------------------------------------------
# per-module scan
# ---------------------------------------------------------------------------

class _Module:
    """One parsed file: class->method map, known lock attrs, imports."""

    def __init__(self, tree: ast.Module, path: str):
        self.path = path
        self.classes: Dict[str, Dict[str, ast.FunctionDef]] = {}
        self.known_locks: set = set()
        self.thread_from_threading = False   # `from threading import Thread`
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and \
                    node.module == "threading":
                if any(a.name == "Thread" for a in node.names):
                    self.thread_from_threading = True
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                self.classes[node.name] = {
                    n.name: n for n in node.body
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))}
        # known lock assignments: `x = threading.Lock()` /
        # `self._lock = syncwatch.lock(...)` anywhere in the module
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign) or \
                    not isinstance(node.value, ast.Call):
                continue
            ctor = _dotted(node.value.func)
            if not ctor:
                continue
            is_lock = ctor[-1] in ("Lock", "RLock") or \
                (len(ctor) >= 2 and ctor[-2] in ("syncwatch", "_syncwatch")
                 and ctor[-1] in ("lock", "rlock"))
            if not is_lock:
                continue
            for tgt in node.targets:
                parts = _dotted(tgt)
                if parts:
                    self.known_locks.add(parts[-1])

    def lock_id(self, node, cls: Optional[str]) -> Optional[str]:
        """Resolve a with-item / acquire() target to a lock name, or
        None when it does not look like a lock."""
        suffix = ""
        if isinstance(node, ast.Subscript):
            node, suffix = node.value, "[]"
        parts = _dotted(node)
        if not parts:
            return None
        name = parts[-1]
        if name not in self.known_locks and not _looks_like_lock(name):
            return None
        if parts[0] == "self" and cls:
            parts = (cls,) + parts[1:]
        return ".".join(parts) + suffix


class _Edges:
    """The static lock graph: (src, dst) -> first site, where src->dst
    means "dst acquired while src held"."""

    def __init__(self):
        self.sites: Dict[Tuple[str, str],
                         Tuple[str, int, str]] = {}

    def add(self, src: str, dst: str, path: str, line: int,
            func: str) -> None:
        if src != dst:
            self.sites.setdefault((src, dst), (path, line, func))


class _FuncScan:
    """Walk one function's statements in order, tracking the held-lock
    stack structurally through `with` blocks and linearly through
    `.acquire()`/`.release()`; recurse one level into `self.method()`
    calls made while holding a lock."""

    def __init__(self, mod: _Module, cls: Optional[str],
                 fn, findings: List[Finding], edges: _Edges,
                 depth: int = 0, held: Optional[List[str]] = None,
                 via: str = ""):
        self.mod, self.cls, self.fn = mod, cls, fn
        self.findings, self.edges = findings, edges
        self.depth = depth
        self.held: List[str] = list(held or [])
        self.qual = (f"{cls}.{fn.name}" if cls else fn.name) + via

    def _add(self, rule: str, node, message: str) -> None:
        self.findings.append(Finding(
            rule, message, path=self.mod.path, line=node.lineno,
            col=node.col_offset, func=self.qual))

    def run(self) -> None:
        self._block(self.fn.body)

    # -- statement walking --
    def _block(self, stmts) -> None:
        for stmt in stmts:
            self._stmt(stmt)

    def _stmt(self, stmt) -> None:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in stmt.items:
                self._expr(item.context_expr)
                lid = self.mod.lock_id(item.context_expr, self.cls)
                if lid is not None:
                    self._acquire(lid, item.context_expr)
                    acquired.append(lid)
            self._block(stmt.body)
            for lid in reversed(acquired):
                self._release(lid)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return          # nested defs run later, not in this region
        if isinstance(stmt, (ast.If, ast.For, ast.AsyncFor, ast.While,
                             ast.Try)):
            for expr in ast.iter_child_nodes(stmt):
                if isinstance(expr, ast.expr):
                    self._expr(expr)
            before = list(self.held)
            for attr in ("body", "orelse", "finalbody"):
                self.held = list(before)
                self._block(getattr(stmt, attr, []) or [])
            for h in getattr(stmt, "handlers", []) or []:
                self.held = list(before)
                self._block(h.body)
            self.held = before
            return
        # linear statement: scan every call; toggle bare acquire/release
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                self._call(node)

    # -- lock bookkeeping --
    def _acquire(self, lid: str, node) -> None:
        for h in self.held:
            self.edges.add(h, lid, self.mod.path, node.lineno, self.qual)
        self.held.append(lid)

    def _release(self, lid: str) -> None:
        for i in range(len(self.held) - 1, -1, -1):
            if self.held[i] == lid:
                del self.held[i]
                return

    # -- calls --
    def _expr(self, expr) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._call(node)

    def _call(self, call: ast.Call) -> None:
        f = call.func
        parts = _dotted(f)
        # unregistered-thread fires held or not
        if parts and parts[-1] == "Thread":
            registered = len(parts) >= 2 and \
                parts[-2] in ("syncwatch", "_syncwatch")
            raw = (len(parts) >= 2 and parts[-2] == "threading") or \
                (len(parts) == 1 and self.mod.thread_from_threading)
            if raw and not registered:
                self._add("unregistered-thread", call,
                          "raw threading.Thread() outside the "
                          "ThreadRegistry — spawn via syncwatch.Thread("
                          "..., owner=__name__) so leak fixtures and "
                          "`monitor threads` can see it")
        if isinstance(f, ast.Attribute):
            # bare acquire()/release() on a lock-looking target
            lid = self.mod.lock_id(f.value, self.cls)
            if lid is not None and f.attr == "acquire":
                self._acquire(lid, call)
            elif lid is not None and f.attr == "release":
                self._release(lid)
        if self.held:
            reason = self._blocking_reason(call, parts)
            if reason is not None:
                self._add("blocking-under-lock", call,
                          f"{reason} while holding "
                          f"{', '.join(repr(h) for h in self.held)} — "
                          "every contending thread stalls for the full "
                          "blocking duration; move it outside the "
                          "critical section or bound it with a timeout")
            # one level deep: self.method() called under a held lock
            if self.depth == 0 and isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Name) and \
                    f.value.id == "self" and self.cls:
                m = self.mod.classes.get(self.cls, {}).get(f.attr)
                if m is not None and m is not self.fn:
                    _FuncScan(self.mod, self.cls, m, self.findings,
                              self.edges, depth=1, held=self.held,
                              via=f" (called holding "
                                  f"{', '.join(self.held)})").run()

    def _blocking_reason(self, call: ast.Call,
                         parts: Tuple[str, ...]) -> Optional[str]:
        if not parts:
            return None
        name = parts[-1]
        if isinstance(call.func, ast.Attribute):
            if name in _BLOCKING_SOCKET:
                return f"socket .{name}()"
            has_kw = {kw.arg for kw in call.keywords}
            if name == "get" and not call.args and not call.keywords \
                    and len(parts) >= 2 \
                    and _QUEUE_NAME_RE.search(parts[-2]):
                return "queue .get() with no timeout"
            if name in ("join", "wait") and not call.args and \
                    "timeout" not in has_kw:
                return f".{name}() with no timeout"
        if name == "call_with_retry":
            return "RPC call_with_retry()"
        if name == "sleep" and (len(parts) == 1 or parts[-2] == "time"):
            if call.args and isinstance(call.args[0], ast.Constant):
                try:
                    secs = float(call.args[0].value)
                except (TypeError, ValueError):
                    return None
                if secs >= SLEEP_THRESHOLD_S:
                    return f"time.sleep({secs:g})"
        return None


def _scan_module(src: str, path: str
                 ) -> Tuple[List[Finding], _Edges, Suppressions]:
    tree = ast.parse(src, filename=path)
    mod = _Module(tree, path)
    findings: List[Finding] = []
    edges = _Edges()
    for cls, methods in mod.classes.items():
        for m in methods.values():
            _FuncScan(mod, cls, m, findings, edges).run()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _FuncScan(mod, None, node, findings, edges).run()
    # module-level statements (thread spawns in script blocks)
    top = _FuncScan(mod, None,
                    ast.FunctionDef(name="<module>", args=None,
                                    body=[], decorator_list=[]),
                    findings, edges)
    for stmt in tree.body:
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
            top._stmt(stmt)
    return findings, edges, Suppressions(src)


# ---------------------------------------------------------------------------
# whole-run aggregation: inversions + cycles over the merged graph
# ---------------------------------------------------------------------------

def find_cycles(sites: Dict[Tuple[str, str], Tuple[str, int, str]]
                ) -> List[List[str]]:
    """Cycles in the merged lock graph (node path, last edge closes the
    loop), deduplicated by node set. Pairwise inversions come out as
    2-cycles."""
    adj: Dict[str, List[str]] = {}
    for (a, b) in sites:
        adj.setdefault(a, []).append(b)
    cycles, seen = [], set()

    def dfs(node, path, on_path):
        for nxt in adj.get(node, ()):
            if nxt in on_path:
                cyc = path[path.index(nxt):]
                key = frozenset(cyc)
                if key not in seen:
                    seen.add(key)
                    cycles.append(cyc + [nxt])
            elif (node, nxt) not in visited_edges:
                visited_edges.add((node, nxt))
                on_path.add(nxt)
                dfs(nxt, path + [nxt], on_path)
                on_path.discard(nxt)

    visited_edges: set = set()
    for start in sorted(adj):
        dfs(start, [start], {start})
    return cycles


def _order_findings(sites: Dict[Tuple[str, str], Tuple[str, int, str]],
                    supp: Dict[str, Suppressions]) -> List[Finding]:
    out = []
    for cyc in find_cycles(sites):
        edge_sites = []
        suppressed = False
        for a, b in zip(cyc, cyc[1:]):
            path, line, func = sites[(a, b)]
            edge_sites.append((a, b, path, line, func))
            s = supp.get(path)
            if s is not None and s.suppressed("lock-order", line):
                suppressed = True
        if suppressed:
            continue
        a, b, path, line, func = edge_sites[-1]
        others = "; ".join(
            f"'{x}' -> '{y}' at {p}:{ln} (in {fn})"
            for x, y, p, ln, fn in edge_sites[:-1])
        out.append(Finding(
            "lock-order",
            f"inconsistent lock order: acquiring '{b}' while holding "
            f"'{a}' closes the cycle {' -> '.join(cyc)} — established "
            f"by {others}; two threads running these paths "
            "concurrently deadlock", path=path, line=line, func=func))
    return out


def analyze_source(src: str, path: str = "<src>") -> List[Finding]:
    """Single-file entry (tests, apply_pass): blocking/thread findings
    plus any intra-file lock-order inversions, suppression-applied."""
    findings, edges, supp = _scan_module(src, path)
    findings = supp.apply(findings)
    findings += _order_findings(edges.sites, {path: supp})
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def analyze_paths(paths: List[str]
                  ) -> Tuple[List[Finding], int,
                             Dict[Tuple[str, str], Tuple[str, int, str]]]:
    """Whole-package entry: per-file findings plus lock-order findings
    over the MERGED cross-file graph. Returns (findings, n_files,
    edge-site map) — the site map is the checked-in-gate's proof that
    the repo's own lock graph is cycle-free."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = [d for d in dirs if d != "__pycache__"]
                files.extend(os.path.join(root, n)
                             for n in sorted(names) if n.endswith(".py"))
        elif os.path.isfile(p):
            files.append(p)
        else:
            raise FileNotFoundError(p)
    findings: List[Finding] = []
    merged: Dict[Tuple[str, str], Tuple[str, int, str]] = {}
    supp: Dict[str, Suppressions] = {}
    for path in files:
        with open(path, "r", encoding="utf-8") as f:
            src = f.read()
        try:
            fs, edges, s = _scan_module(src, path)
        except SyntaxError:
            continue
        findings.extend(s.apply(fs))
        supp[path] = s
        for k, v in edges.sites.items():
            merged.setdefault(k, v)
    findings += _order_findings(merged, supp)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, len(files), merged


def lock_graph(paths: List[str]
               ) -> Dict[Tuple[str, str], Tuple[str, int, str]]:
    """The merged static lock graph of `paths` (edge -> first site)."""
    return analyze_paths(paths)[2]
