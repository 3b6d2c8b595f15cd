"""paddle_tpu_torch.faults — deterministic fault injection.

Counterpart of `paddle_tpu/faults.py`, with the same spec grammar, the same
seeded hit sequence and the same counters. Every seam that must survive a
failure carries a *named injection site*, and a flag-gated registry
decides, deterministically, whether a given hit turns into a connection
reset, a timeout, a delay, an error or a torn payload. The ported sites:
`serving.dispatch` (ServingEngine), `llm.decode` (LLMEngine),
`mem.alloc` (`core.executable.dispatch_guard`) and the wire's
`net.<plane>.send` / `net.<plane>.recv` (utils/net.py).

Spec grammar (`FLAGS_fault_inject`, also `register()`/`inject()`):

    site:kind[:p=PROB][:seed=N][:times=K][:after=N][:delay=SECS]

  - `site`   — the injection-site name; a spec site matches a hit site
               exactly OR as a dotted prefix (`net.serving` matches
               `net.serving.send` and `net.serving.recv`).
  - `kind`   — `conn_reset` (ConnectionResetError), `timeout`
               (TimeoutError), `error` (InjectedFault/RuntimeError),
               `delay` (sleep `delay` seconds then continue), `torn`
               (truncate a payload — fires only via `mangle()`).
  - `p`      — fire probability per eligible hit (default 1.0), drawn
               from a per-spec `random.Random(seed)` so a seeded spec
               produces the SAME hit sequence on every run.
  - `times`  — total fires allowed (0 = unlimited).
  - `after`  — eligible only after this many hits at matching sites.

Multiple specs are separated by `;` (or `,`).

Hot-path contract (same as `FLAGS_monitor`): instrumented seams guard
with `if _faults._ENABLED: _faults.check("site")` — the disabled path is
one module-attribute load. With faults on, every `check()` counts the hit,
and every fire increments `faults.injected` / `faults.injected.<site>` in
`paddle_tpu_torch.monitor` (when the monitor plane is enabled).
"""
from __future__ import annotations

import functools
import random
import re
import threading
import time
from typing import Dict, List, Optional

from .core import flags as _flags
from . import monitor as _monitor

__all__ = [
    "InjectedFault", "InjectedConnectionReset", "InjectedTimeout",
    "FaultSpecError",
    "enabled", "check", "site", "mangle",
    "register", "unregister", "inject", "clear", "active", "stats",
]


class InjectedFault(RuntimeError):
    """Generic injected failure (kind `error`)."""


class InjectedConnectionReset(ConnectionResetError):
    """Injected transport reset (kind `conn_reset`) — an OSError subclass,
    so retry/reconnect paths treat it exactly like a real peer reset."""


class InjectedTimeout(TimeoutError):
    """Injected deadline expiry (kind `timeout`)."""


class FaultSpecError(ValueError):
    """Malformed `FLAGS_fault_inject` spec string."""


_KINDS = ("conn_reset", "timeout", "error", "delay", "torn")


class _FaultSpec:
    __slots__ = ("site", "kind", "p", "seed", "times", "after", "delay",
                 "_rng", "_hits", "_fired")

    def __init__(self, site: str, kind: str, p: float = 1.0, seed: int = 0,
                 times: int = 0, after: int = 0, delay: float = 0.01):
        if kind not in _KINDS:
            raise FaultSpecError(
                f"fault kind {kind!r} not in {_KINDS} (site {site!r})")
        if not site:
            raise FaultSpecError("fault spec needs a site name")
        self.site, self.kind = site, kind
        self.p, self.seed = float(p), int(seed)
        self.times, self.after = int(times), int(after)
        self.delay = float(delay)
        self._rng = random.Random(self.seed)
        self._hits = 0
        self._fired = 0

    def matches(self, site: str) -> bool:
        return site == self.site or site.startswith(self.site + ".")

    def should_fire(self) -> bool:
        """One eligible hit; caller holds the registry lock."""
        self._hits += 1
        if self._hits <= self.after:
            return False
        if self.times and self._fired >= self.times:
            return False
        if self.p < 1.0 and self._rng.random() >= self.p:
            return False
        self._fired += 1
        return True

    def describe(self) -> str:
        return (f"{self.site}:{self.kind}:p={self.p}:seed={self.seed}"
                f":times={self.times}:after={self.after}"
                + (f":delay={self.delay}" if self.kind == "delay" else ""))


def _parse(spec: str) -> List[_FaultSpec]:
    out = []
    for part in re.split(r"[;,]", spec):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise FaultSpecError(
                f"fault spec {part!r} needs at least site:kind")
        site_name, kind = fields[0].strip(), fields[1].strip()
        kw: Dict[str, float] = {}
        for opt in fields[2:]:
            if "=" not in opt:
                raise FaultSpecError(f"fault option {opt!r} is not k=v "
                                     f"(in {part!r})")
            k, v = opt.split("=", 1)
            k = k.strip()
            if k not in ("p", "seed", "times", "after", "delay"):
                raise FaultSpecError(f"unknown fault option {k!r} "
                                     f"(in {part!r})")
            kw[k] = float(v)
        out.append(_FaultSpec(site_name, kind, **kw))
    return out


# ---- registry ---------------------------------------------------------------
# Flag-sourced specs (replaced wholesale on every FLAGS_fault_inject set)
# and programmatic specs (register()/inject()) are tracked separately so
# the conftest leak guard can restore each origin independently.

_LOCK = threading.Lock()
_FLAG_SPECS: List[_FaultSpec] = []
_PROG_SPECS: List[_FaultSpec] = []
_SITE_HITS: Dict[str, int] = {}
_SITE_INJECTED: Dict[str, int] = {}

_ENABLED: bool = False


def _recompute_enabled() -> None:
    global _ENABLED
    _ENABLED = bool(_FLAG_SPECS or _PROG_SPECS)


def _on_flag(value) -> None:
    specs = _parse(str(value)) if value else []
    with _LOCK:
        _FLAG_SPECS[:] = specs
        _recompute_enabled()


_flags.watch_flag("fault_inject", _on_flag)
if _flags.flag("fault_inject"):  # seeded from the environment at import
    _on_flag(_flags.flag("fault_inject"))


def enabled() -> bool:
    return _ENABLED


def register(spec: str) -> List[_FaultSpec]:
    """Programmatically arm fault spec(s); returns handles for
    `unregister`. Prefer the `inject()` context manager in tests."""
    specs = _parse(spec)
    with _LOCK:
        _PROG_SPECS.extend(specs)
        _recompute_enabled()
    return specs


def unregister(specs: List[_FaultSpec]) -> None:
    with _LOCK:
        for s in specs:
            if s in _PROG_SPECS:
                _PROG_SPECS.remove(s)
        _recompute_enabled()


class _InjectContext:
    """`with faults.inject("serving.dispatch:error:times=1"): ...` — arms the
    spec(s) for the block and disarms them on exit, even on error."""

    def __init__(self, spec: str):
        self._spec = spec
        self._handles: Optional[List[_FaultSpec]] = None

    def __enter__(self):
        self._handles = register(self._spec)
        return self

    def __exit__(self, *exc):
        if self._handles is not None:
            unregister(self._handles)
            self._handles = None
        return False


def inject(spec: str) -> _InjectContext:
    return _InjectContext(spec)


def clear(flag_specs: bool = True, programmatic: bool = True) -> None:
    """Disarm everything (counters included)."""
    with _LOCK:
        if flag_specs:
            _FLAG_SPECS.clear()
        if programmatic:
            _PROG_SPECS.clear()
        _SITE_HITS.clear()
        _SITE_INJECTED.clear()
        _recompute_enabled()


def active() -> List[str]:
    with _LOCK:
        return [s.describe() for s in _FLAG_SPECS + _PROG_SPECS]


def stats() -> Dict[str, Dict[str, int]]:
    """Per-site {hits, injected} counts (empty when faults never armed —
    the disabled path records nothing)."""
    with _LOCK:
        sites = set(_SITE_HITS) | set(_SITE_INJECTED)
        return {s: {"hits": _SITE_HITS.get(s, 0),
                    "injected": _SITE_INJECTED.get(s, 0)}
                for s in sorted(sites)}


# ---- the injection points ---------------------------------------------------

def _fire_lookup(site_name: str, torn_only: bool) -> Optional[_FaultSpec]:
    with _LOCK:
        _SITE_HITS[site_name] = _SITE_HITS.get(site_name, 0) + 1
        for spec in _FLAG_SPECS + _PROG_SPECS:
            if (spec.kind == "torn") is not torn_only:
                continue
            if spec.matches(site_name) and spec.should_fire():
                _SITE_INJECTED[site_name] = \
                    _SITE_INJECTED.get(site_name, 0) + 1
                return spec
    return None


def _account(site_name: str) -> None:
    if _monitor._ENABLED:
        _monitor.count("faults.injected")
        _monitor.count(f"faults.injected.{site_name}")


def check(site_name: str) -> None:
    """One hit at a named site. No-op unless an armed spec matches AND
    fires; then raises (conn_reset/timeout/error) or sleeps (delay).
    Callers gate with `if _faults._ENABLED:` so the disabled path never
    reaches here."""
    if not _ENABLED:
        return
    spec = _fire_lookup(site_name, torn_only=False)
    if spec is None:
        return
    _account(site_name)
    if spec.kind == "delay":
        time.sleep(spec.delay)
        return
    if spec.kind == "conn_reset":
        raise InjectedConnectionReset(
            f"fault injected at {site_name}: connection reset")
    if spec.kind == "timeout":
        raise InjectedTimeout(
            f"fault injected at {site_name}: timeout")
    raise InjectedFault(f"fault injected at {site_name}")


def mangle(site_name: str, data: bytes) -> bytes:
    """Payload-corruption hook (kind `torn`): a firing spec truncates the
    bytes to half length — the write path persists the torn payload and
    the READ path must detect it (checksums) and fall back."""
    if not _ENABLED:
        return data
    spec = _fire_lookup(site_name, torn_only=True)
    if spec is None:
        return data
    _account(site_name)
    return data[: len(data) // 2]


class _Site:
    """Context manager + decorator form of `check()`:

        with faults.site("ckpt.write"):
            ...
        @faults.site("serving.dispatch")
        def rpc(...): ...
    """

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        check(self.name)
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _ENABLED:
                check(self.name)
            return fn(*args, **kwargs)
        return wrapper


def site(name: str) -> _Site:
    return _Site(name)
