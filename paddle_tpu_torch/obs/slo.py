"""SLO objects — error-budget burn rate for the serving plane.

Counterpart of `paddle_tpu/obs/slo.py`. An SLO is the pair
(`FLAGS_slo_latency_ms`, `FLAGS_slo_target`): "`target` of requests
complete within `latency_ms`". Every finished request is GOOD (status ok
and fast enough) or BAD (over the latency objective, rejected by
admission, deadline-expired, or errored). The error budget is the
tolerated bad fraction, `1 - target`; the burn rate over a window is

    burn(w) = bad_fraction(w) / (1 - target)

so burn 1.0 = consuming the budget exactly as provisioned. Multiple
windows (`FLAGS_slo_windows`, default 60/300/3600s) are kept at once from
one ring of per-second good/bad buckets.

Outputs:

  - `stats()` — the `"slo"` section of `ServingEngine.stats()` and hence
    the `'PDHQ'` wire probe: objective, per-window burn rates, good/bad
    totals, and latency quantiles from the `serving.e2e_latency` sketch.
  - `slo.*` monitor gauges (`slo.burn.<w>s`, `slo.good`, `slo.bad`) —
    republished at most once a second from the record path.
  - `should_shed()` — optional admission hook: when the SHORTEST
    window's burn exceeds `FLAGS_slo_shed_burn`, `ServingEngine.submit`
    and `LLMEngine.submit` shed new work as overloaded.

Hot-path contract: `FLAGS_slo_latency_ms == 0` disables the plane —
`record_request()` is one module-attribute check, nothing else.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ..core import flags as _flags

__all__ = [
    "SloPlane", "enabled", "record_request", "burn_rates", "should_shed",
    "stats", "reset", "render_slo", "doc_from_snapshot",
    "OUTCOME_OK", "OUTCOME_SLOW", "OUTCOME_REJECTED", "OUTCOME_DEADLINE",
    "OUTCOME_ERROR",
]

OUTCOME_OK = "ok"
OUTCOME_SLOW = "slow"            # completed, but over the latency objective
OUTCOME_REJECTED = "rejected"    # queue-full admission rejection (status 2)
OUTCOME_DEADLINE = "deadline"    # expired before completion (status 3)
OUTCOME_ERROR = "error"          # model/transport failure (status 1)

_BAD_OUTCOMES = (OUTCOME_SLOW, OUTCOME_REJECTED, OUTCOME_DEADLINE,
                 OUTCOME_ERROR)


def _parse_windows(spec: str) -> List[int]:
    out = []
    for part in str(spec).split(","):
        part = part.strip()
        if part:
            try:
                w = int(float(part))
            except ValueError:
                continue    # malformed flag value: fall back, don't raise
            if w > 0:
                out.append(w)
    return sorted(set(out)) or [60, 300, 3600]


class SloPlane:
    """One latency SLO + its burn-rate accounting: a ring of per-second
    (good, bad) buckets spanning the longest window, read at any window
    length. O(1) record, O(window) read."""

    def __init__(self, latency_ms: float, target: float,
                 windows: Optional[List[int]] = None,
                 shed_burn: float = 0.0):
        self.latency_ms = float(latency_ms)
        self.target = min(max(float(target), 0.0), 0.999999)
        self.windows = list(windows or [60, 300, 3600])
        self.shed_burn = float(shed_burn)
        self._budget = 1.0 - self.target
        self._horizon = max(self.windows)
        self._lock = threading.Lock()
        self._buckets: Dict[int, List[int]] = {}   # epoch-sec -> [good, bad]
        self._good_total = 0
        self._bad_total = 0
        self._bad_by_outcome: Dict[str, int] = {}
        self._last_publish = 0.0

    # -- write side --
    def record(self, latency_s: Optional[float],
               outcome: str = OUTCOME_OK,
               now: Optional[float] = None) -> bool:
        """Account one finished request. Returns True when it was BAD
        (callers use this to promote the request's trace to the
        protected ring). `now` is injectable for tests."""
        bad = outcome != OUTCOME_OK or (
            latency_s is not None and latency_s * 1e3 > self.latency_ms)
        if bad and outcome == OUTCOME_OK:
            outcome = OUTCOME_SLOW
        if now is None:
            now = time.time()
        sec = int(now)
        with self._lock:
            b = self._buckets.get(sec)
            if b is None:
                b = self._buckets[sec] = [0, 0]
                self._prune_locked(sec)
            b[1 if bad else 0] += 1
            if bad:
                self._bad_total += 1
                self._bad_by_outcome[outcome] = \
                    self._bad_by_outcome.get(outcome, 0) + 1
            else:
                self._good_total += 1
            publish = now - self._last_publish >= 1.0
            if publish:
                self._last_publish = now
        if publish:
            self._publish(now)
        return bad

    def _prune_locked(self, now_sec: int) -> None:
        floor = now_sec - self._horizon
        for sec in [s for s in self._buckets if s < floor]:
            del self._buckets[sec]

    # -- read side --
    def window_counts(self, window_s: int,
                      now: Optional[float] = None) -> Dict[str, int]:
        sec = int(now if now is not None else time.time())
        good = bad = 0
        with self._lock:
            for s, (g, b) in self._buckets.items():
                if sec - window_s < s <= sec:
                    good += g
                    bad += b
        return {"good": good, "bad": bad}

    def burn_rate(self, window_s: int,
                  now: Optional[float] = None) -> float:
        """bad_fraction / error_budget over the window; 0.0 when the
        window saw no traffic (no news is not a page)."""
        c = self.window_counts(window_s, now)
        total = c["good"] + c["bad"]
        if total == 0:
            return 0.0
        return (c["bad"] / total) / self._budget

    def burn_rates(self, now: Optional[float] = None) -> Dict[int, float]:
        return {w: self.burn_rate(w, now) for w in self.windows}

    def should_shed(self, now: Optional[float] = None) -> bool:
        """Admission hook: True when the shortest window burns faster
        than FLAGS_slo_shed_burn allows (0 = never shed)."""
        if self.shed_burn <= 0.0:
            return False
        return self.burn_rate(min(self.windows), now) > self.shed_burn

    def _publish(self, now: float) -> None:
        from .. import monitor as _monitor
        if not _monitor._ENABLED:
            return
        for w, rate in self.burn_rates(now).items():
            _monitor.gauge_set(f"slo.burn.{w}s", rate)
        _monitor.gauge_set("slo.good", self._good_total)
        _monitor.gauge_set("slo.bad", self._bad_total)
        # objective gauges make a snapshot export self-describing — the
        # monitor CLI `slo` subcommand rebuilds the doc from gauges alone
        _monitor.gauge_set("slo.objective.latency_ms", self.latency_ms)
        _monitor.gauge_set("slo.objective.target", self.target)

    def stats(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The 'slo' section of engine stats / the 'PDHQ' probe."""
        from .. import monitor as _monitor
        qs = _monitor.histogram("serving.e2e_latency").quantiles()
        with self._lock:
            good, bad = self._good_total, self._bad_total
            by_outcome = dict(self._bad_by_outcome)
        return {
            "objective": {"latency_ms": self.latency_ms,
                          "target": self.target},
            "burn": {str(w): round(r, 4)
                     for w, r in self.burn_rates(now).items()},
            "good": good,
            "bad": bad,
            "bad_by_outcome": by_outcome,
            "shedding": self.should_shed(now),
            "latency_ms": {f"p{int(q * 100)}": v * 1e3
                           for q, v in qs.items()},
        }

    def reset(self) -> None:
        with self._lock:
            self._buckets.clear()
            self._good_total = 0
            self._bad_total = 0
            self._bad_by_outcome.clear()
            self._last_publish = 0.0


# ---- module plane (flag-wired singleton) ------------------------------------

_ENABLED: bool = False
_PLANE: Optional[SloPlane] = None


def _rewire(_v=None) -> None:
    global _ENABLED, _PLANE
    latency_ms = float(_flags.flag("slo_latency_ms"))
    if latency_ms <= 0.0:
        _ENABLED = False
        _PLANE = None
        return
    _PLANE = SloPlane(latency_ms, float(_flags.flag("slo_target")),
                      _parse_windows(_flags.flag("slo_windows")),
                      float(_flags.flag("slo_shed_burn")))
    _ENABLED = True


for _name in ("slo_latency_ms", "slo_target", "slo_windows",
              "slo_shed_burn"):
    _flags.watch_flag(_name, _rewire)
_rewire()


def enabled() -> bool:
    return _ENABLED


def plane() -> Optional[SloPlane]:
    return _PLANE


def record_request(latency_s: Optional[float],
                   outcome: str = OUTCOME_OK) -> bool:
    """Account one finished serving request (engine hot path — callers
    guard on `_slo._ENABLED` so the disabled plane costs one attribute
    check). Returns True when the request was BAD for the SLO."""
    p = _PLANE
    if p is None:
        return False
    return p.record(latency_s, outcome)


def burn_rates() -> Dict[int, float]:
    p = _PLANE
    return p.burn_rates() if p is not None else {}


def should_shed() -> bool:
    p = _PLANE
    return p.should_shed() if p is not None else False


def stats() -> Optional[Dict[str, Any]]:
    p = _PLANE
    return p.stats() if p is not None else None


def reset() -> None:
    if _PLANE is not None:
        _PLANE.reset()


# ---- rendering (monitor CLI `slo` subcommand) -------------------------------

def doc_from_snapshot(snap: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Rebuild an slo stats doc from a monitor snapshot export's `slo.*`
    gauges + the serving.e2e_latency histogram quantiles. Returns None
    when the snapshot carries no SLO gauges (plane never configured)."""
    gauges = snap.get("gauges", {})
    burn = {}
    for name, val in gauges.items():
        if name.startswith("slo.burn.") and name.endswith("s"):
            try:
                burn[name[len("slo.burn."):-1]] = float(val)
            except ValueError:
                continue
    if not burn and "slo.good" not in gauges:
        return None
    hist = (snap.get("histograms") or {}).get("serving.e2e_latency", {})
    lat = {k: hist[k] * 1e3 for k in ("p50", "p95", "p99") if k in hist}
    return {
        "objective": {
            "latency_ms": gauges.get("slo.objective.latency_ms", 0.0),
            "target": gauges.get("slo.objective.target", 0.0),
        },
        "burn": burn,
        "good": gauges.get("slo.good", 0),
        "bad": gauges.get("slo.bad", 0),
        "bad_by_outcome": {},
        "shedding": False,
        "latency_ms": lat,
    }


def render_slo(doc: Optional[Dict[str, Any]]) -> str:
    if not doc:
        return ("(no SLO configured — set FLAGS_slo_latency_ms / "
                "FLAGS_slo_target)")
    obj = doc.get("objective", {})
    lines = ["-" * 78,
             f"SLO: {obj.get('target', 0.0) * 100:.3f}% of requests within "
             f"{obj.get('latency_ms', 0.0):.1f}ms"
             + ("   [SHEDDING]" if doc.get("shedding") else ""),
             "-" * 78]
    burn = doc.get("burn", {})
    if burn:
        lines.append("burn rate (1.0 = consuming budget exactly):")
        for w in sorted(burn, key=lambda x: int(x)):
            rate = float(burn[w])
            flag = "  <-- fast burn" if rate > 10.0 else \
                ("  <-- over budget" if rate > 1.0 else "")
            lines.append(f"  {int(w):>6}s window: {rate:8.3f}{flag}")
    good, bad = doc.get("good", 0), doc.get("bad", 0)
    total = good + bad
    frac = (bad / total * 100.0) if total else 0.0
    lines.append(f"requests: {total} total, {bad} bad ({frac:.3f}%)")
    by = doc.get("bad_by_outcome", {})
    if by:
        lines.append("  bad by outcome: " + ", ".join(
            f"{k}={v}" for k, v in sorted(by.items(), key=lambda kv: -kv[1])))
    lat = doc.get("latency_ms", {})
    if lat:
        lines.append("e2e latency (sketch, <=1% rel err): " + "  ".join(
            f"{k}={lat[k]:.2f}ms" for k in ("p50", "p95", "p99")
            if k in lat))
    lines.append("-" * 78)
    return "\n".join(lines)
