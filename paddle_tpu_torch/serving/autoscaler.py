"""SLO-driven elastic autoscaler — the fleet control plane's actuator.

Counterpart of `paddle_tpu/serving/autoscaler.py`: the same policy, the
same decisions from the same signals, the same ledger entries.

The telemetry plane (obs/telemetry.py) is the SENSOR side (fleet-wide
burn/queue gauges, death/drain events, true fleet quantiles at one
collector); this module closes the sense→decide→act loop:

    TelemetryCollector ──sense──> Autoscaler ──decide──> ScalePolicy
                                      │
                                      └──act──> ReplicaPool
                                                  ├─ scale OUT: spawn a
                                                  │  ReplicaAgent (warm-
                                                  │  started in seconds
                                                  │  with ZERO compiles
                                                  │  via the persistent
                                                  │  compile cache)
                                                  ├─ scale IN: graceful
                                                  │  'PDDR' drain + lease
                                                  │  reclaim
                                                  └─ scale-to-zero: idle
                                                     tenants evicted via
                                                     the HBM-budget LRU

Three pieces, deliberately separable:

  - `ScalePolicy` — PURE decision math, no I/O and injectable clock, so
    hysteresis/cooldown/scale-to-zero are table-testable from traces
    alone. Scale out when the worst replica's shortest-window burn or
    the fleet queue fraction crosses the high thresholds; the idle clock
    only runs while BOTH signals sit below the low thresholds (the gap
    between is the hysteresis band where nothing happens); per-direction
    cooldowns bound the actuation rate; a blind policy (collector dead,
    zero alive sources) holds steady.
  - `ReplicaPool` — the actuator over FleetRouter + a `spawn` callable.
    A spawned replica must answer its first 'PDHQ' within
    `FLAGS_autoscaler_spawn_timeout_s` or it is reaped — handle killed,
    store record + elastic lease reclaimed via `FleetRouter.forget` —
    and counted `autoscaler.spawn_failures`; it is never routed to
    forever. Scale-in drains gracefully; a SIGKILL landing mid-drain
    still converges (the connection error is the verdict, the corpse's
    lease is reclaimed, the ledger records `died_during_drain`).
  - `DecisionLedger` — every scale action with its triggering evidence,
    in a bounded ring: dumped into the flight recorder
    (`Autoscaler.dump`) and rendered by `monitor top` (the collector's
    pool row). When scale-out cannot be satisfied (spawn retry budget
    exhausted, HBM refused) the collector's built-in `scale_blocked`
    alert fires once per transition.

Failure → behavior: collector dead → hold steady; spawn fails → alert +
retry budget (one retry per cooldown after exhaustion); drain
interrupted by SIGKILL → pool consistent, lease reclaimed, ledger audit
clean.
"""
from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .. import monitor as _monitor
from .. import obs as _obs
from ..core import flags as _flags
from .fleet import FleetError
from ..utils import syncwatch as _syncwatch

__all__ = ["Autoscaler", "ScalePolicy", "ScaleDecision", "ReplicaPool",
           "DecisionLedger"]

# unclosed autoscalers, so the test-suite leak fixture can reap them (a
# leaked control loop would keep scaling a dead fleet under later tests)
_LIVE: "weakref.WeakSet" = weakref.WeakSet()


# ---- decisions --------------------------------------------------------------

HOLD = "hold"
OUT = "out"
IN = "in"


class ScaleDecision:
    """One policy verdict: `action` in {hold, out, in}, `delta` replicas,
    the `reason` that triggered it, and the evidence it was made on."""

    __slots__ = ("action", "delta", "reason", "evidence")

    def __init__(self, action: str, delta: int = 0, reason: str = "",
                 evidence: Optional[Dict[str, Any]] = None):
        self.action = action
        self.delta = int(delta)
        self.reason = reason
        self.evidence = dict(evidence or {})

    def __repr__(self):
        return (f"ScaleDecision({self.action}{self.delta:+d} "
                f"reason={self.reason})")


class ScalePolicy:
    """Pure scale-decision math. `decide()` consumes one fleet signal
    sample — worst shortest-window burn, queue fraction, actual/alive
    counts, pending front-door work — and returns a ScaleDecision.
    Stateful only in its clocks (calm-since, per-direction cooldowns);
    the injectable `now` makes traces deterministic."""

    def __init__(self, burn_high: Optional[float] = None,
                 burn_low: Optional[float] = None,
                 queue_high: Optional[float] = None,
                 queue_low: Optional[float] = None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 idle_after_s: Optional[float] = None,
                 zero_after_s: Optional[float] = None,
                 step: Optional[int] = None):
        def _f(v, flag):
            return float(_flags.flag(flag)) if v is None else float(v)

        self.burn_high = _f(burn_high, "autoscaler_burn_high")
        self.burn_low = _f(burn_low, "autoscaler_burn_low")
        self.queue_high = _f(queue_high, "autoscaler_queue_high")
        self.queue_low = _f(queue_low, "autoscaler_queue_low")
        self.min_replicas = int(_f(min_replicas,
                                   "autoscaler_min_replicas"))
        mx = int(_f(max_replicas, "autoscaler_max_replicas"))
        self.max_replicas = mx if mx > 0 else int(
            _flags.flag("fleet_max_replicas"))
        self.cooldown_s = _f(cooldown_s, "autoscaler_cooldown_s")
        self.idle_after_s = _f(idle_after_s, "autoscaler_idle_after_s")
        self.zero_after_s = _f(zero_after_s, "autoscaler_zero_after_s")
        self.step = max(1, int(_f(step, "autoscaler_step")))
        # clocks: None == never / not running
        self._calm_since: Optional[float] = None
        self._last_out: Optional[float] = None
        self._last_in: Optional[float] = None

    # -- clock helpers --
    def _cooled(self, last: Optional[float], now: float) -> bool:
        return last is None or now - last >= self.cooldown_s

    def _out(self, now: float, delta: int, reason: str,
             ev: Dict[str, Any]) -> ScaleDecision:
        self._last_out = now
        self._calm_since = None
        return ScaleDecision(OUT, delta, reason, ev)

    def _in(self, now: float, delta: int, reason: str,
            ev: Dict[str, Any]) -> ScaleDecision:
        self._last_in = now
        # the idle clock restarts: ONE scale-in per sustained-calm
        # window, the next needs a fresh window (plus the cooldown)
        self._calm_since = now
        return ScaleDecision(IN, delta, reason, ev)

    def decide(self, signal: Dict[str, Any],
               now: Optional[float] = None) -> ScaleDecision:
        """One verdict from one signal sample. `signal` keys: `burn`
        (worst per-source shortest-window burn), `queue_frac` (fleet
        queued work / aggregate capacity), `actual` (healthy replicas),
        `alive_sources` (telemetry sources feeding the burn signal),
        `pending` (front-door work with no replica to run it, optional)."""
        if now is None:
            now = time.monotonic()
        burn = float(signal.get("burn") or 0.0)
        queue = float(signal.get("queue_frac") or 0.0)
        actual = int(signal.get("actual") or 0)
        alive = int(signal.get("alive_sources") or 0)
        pending = int(signal.get("pending") or 0)
        ev = {"burn": burn, "queue_frac": queue, "actual": actual,
              "alive_sources": alive, "pending": pending}
        # 1. bootstrap / floor repair — not gated on a telemetry signal
        #    (a pool below its floor has nothing to report burn with)
        if actual < self.min_replicas:
            if not self._cooled(self._last_out, now):
                return ScaleDecision(HOLD, 0, "cooldown", ev)
            return self._out(now, self.min_replicas - actual,
                             "below_min", ev)
        # 2. scale-out from zero on front-door demand (a scaled-to-zero
        #    fleet has no replica sources to burn)
        if actual == 0 and pending > 0:
            if not self._cooled(self._last_out, now):
                return ScaleDecision(HOLD, 0, "cooldown", ev)
            return self._out(now, self.step, "cold_start", ev)
        # 3. blind — collector dead or nothing reporting: hold steady
        #    and freeze the idle clock (never scale in on missing data)
        if alive == 0 and actual > 0:
            self._calm_since = None
            return ScaleDecision(HOLD, 0, "no_signal", ev)
        hot = burn >= self.burn_high or queue >= self.queue_high
        calm = burn <= self.burn_low and queue <= self.queue_low
        if hot:
            self._calm_since = None
            if not self._cooled(self._last_out, now):
                return ScaleDecision(HOLD, 0, "cooldown", ev)
            if actual >= self.max_replicas:
                return ScaleDecision(HOLD, 0, "at_max", ev)
            delta = min(self.step, self.max_replicas - actual)
            reason = "burn_high" if burn >= self.burn_high \
                else "queue_high"
            return self._out(now, delta, reason, ev)
        if not calm:
            # the hysteresis band: neither threshold crossed — the idle
            # clock does not run here, so flapping near the low
            # thresholds cannot accumulate toward a scale-in
            self._calm_since = None
            return ScaleDecision(HOLD, 0, "steady", ev)
        if self._calm_since is None:
            self._calm_since = now
        idle_for = now - self._calm_since
        ev["idle_s"] = round(idle_for, 3)
        # surplus replicas drain one at a time at the idle threshold;
        # the LAST one (min_replicas=0 only) waits for the longer
        # zero_after_s — going dark costs a cold start on the next
        # request, so it takes more conviction
        if actual > max(self.min_replicas, 1):
            if idle_for >= self.idle_after_s \
                    and self._cooled(self._last_in, now):
                return self._in(now, 1, "sustained_idle", ev)
        elif actual == 1 and self.min_replicas == 0:
            if idle_for >= self.zero_after_s \
                    and self._cooled(self._last_in, now):
                return self._in(now, 1, "scale_to_zero", ev)
        return ScaleDecision(HOLD, 0, "calm", ev)


# ---- decision ledger --------------------------------------------------------

class DecisionLedger:
    """Bounded ring of scale actions with their triggering evidence —
    the audit trail the flight recorder dumps and `monitor top`
    renders. Sequence numbers make post-mortem ordering unambiguous."""

    def __init__(self, ring: Optional[int] = None):
        self._ring: deque = deque(maxlen=max(
            4, int(ring if ring is not None
                   else _flags.flag("autoscaler_ledger_ring"))))
        self._lock = _syncwatch.lock("autoscaler.DecisionLedger._lock")
        self._seq = 0
        self._counts: Dict[str, int] = {}

    def record(self, action: str, delta: int, reason: str,
               evidence: Dict[str, Any], outcome: str,
               target: int, actual: int) -> Dict[str, Any]:
        entry = {"seq": None, "ts": time.time(), "action": action,
                 "delta": int(delta), "reason": reason,
                 "evidence": dict(evidence), "outcome": outcome,
                 "target": target, "actual": actual}
        with self._lock:
            entry["seq"] = self._seq
            self._seq += 1
            self._ring.append(entry)
            self._counts[action] = self._counts.get(action, 0) + 1
        if _monitor._ENABLED:
            _monitor.count(f"autoscaler.decisions.{action}")
        return entry

    def last(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return dict(self._ring[-1]) if self._ring else None

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"decisions": [dict(e) for e in self._ring],
                    "counts": dict(self._counts),
                    "recorded": self._seq}


# ---- actuator ---------------------------------------------------------------

class ReplicaPool:
    """The actuator: spawns/activates replicas through a caller-supplied
    `spawn()` (returning anything with a `replica_id` attribute and a
    `stop`/`kill`; an in-process `ReplicaAgent` or a subprocess wrapper
    both fit) and retires them through the router's graceful drain.
    Membership truth is the ROUTER's — `actual()` is its healthy count,
    so externally-joined replicas are scaled the same as spawned ones."""

    def __init__(self, router, spawn: Callable[[], Any],
                 spawn_timeout_s: Optional[float] = None):
        self.router = router
        self._spawn = spawn
        self._timeout = float(
            spawn_timeout_s if spawn_timeout_s is not None
            else _flags.flag("autoscaler_spawn_timeout_s"))
        self.handles: Dict[int, Any] = {}
        self.spawned = 0
        self.spawn_failures = 0
        self.drained = 0

    def actual(self) -> int:
        return len(self.router.healthy_replicas())

    # -- scale out --
    def scale_out(self, n: int = 1) -> Dict[str, Any]:
        """Spawn `n` replicas; each must answer its first 'PDHQ' within
        the spawn timeout or it is reaped (never routed to forever).
        Returns {"ok": [rids], "failed": int, "why": [reasons]}."""
        ok: List[int] = []
        why: List[str] = []
        for _ in range(max(1, int(n))):
            rid = self._spawn_one(why)
            if rid is not None:
                ok.append(rid)
        return {"ok": ok, "failed": len(why), "why": why}

    def _spawn_one(self, why: List[str]) -> Optional[int]:
        t0 = time.monotonic()
        try:
            handle = self._spawn()
        except Exception as e:
            self._spawn_failed(None, None, f"{type(e).__name__}: {e}",
                               why)
            return None
        rid = getattr(handle, "replica_id", None)
        while time.monotonic() - t0 < self._timeout:
            if rid is None:
                rid = getattr(handle, "replica_id", None)
            if rid is not None and any(
                    h.replica_id == rid
                    for h in self.router.healthy_replicas()):
                self.handles[int(rid)] = handle
                self.spawned += 1
                if _monitor._ENABLED:
                    _monitor.count("autoscaler.spawned")
                _obs.record_event("autoscaler.replica_spawned",
                                  replica=int(rid),
                                  took_s=round(time.monotonic() - t0, 3))
                return int(rid)
            poll = getattr(handle, "poll", None)
            if poll is not None and poll() is not None:
                break  # subprocess died before its first 'PDHQ' answer
            try:
                self.router.refresh()
            except Exception:
                pass  # store blip: the loop retries until the timeout
            time.sleep(min(0.05, self._timeout / 10.0))
        self._spawn_failed(handle, rid, "never_healthy", why)
        return None

    def _spawn_failed(self, handle, rid, reason: str,
                      why: List[str]) -> None:
        self.spawn_failures += 1
        why.append(reason)
        if _monitor._ENABLED:
            _monitor.count("autoscaler.spawn_failures")
        if handle is not None:
            _stop_handle(handle)
        if rid is not None:
            # reap the corpse: record + lease reclaimed so no router
            # probes it forever
            self.router.forget(int(rid))
        _obs.record_event("autoscaler.spawn_failed", replica=rid,
                          reason=reason)

    # -- scale in --
    def scale_in(self, n: int = 1) -> List[Dict[str, Any]]:
        """Drain the `n` least-loaded replicas gracefully ('PDDR': every
        accepted request completes or rejects) and reclaim their leases.
        A victim SIGKILLed mid-drain still converges: the connection
        error is recorded as `died_during_drain` and `forget()` reclaims
        its record + lease anyway."""
        results: List[Dict[str, Any]] = []
        for _ in range(max(1, int(n))):
            victims = self.router.healthy_replicas()
            if not victims:
                break
            victim = min(victims, key=lambda h: (
                float(h.stats.get("queue_depth", 0) or 0)
                + float(h.stats.get("inflight", 0) or 0)))
            rid = victim.replica_id
            outcome = "drained"
            try:
                self.router.drain(rid)
            except (ConnectionError, TimeoutError, OSError):
                outcome = "died_during_drain"
            except FleetError:
                outcome = "already_gone"
            except Exception:
                # a victim SIGKILLed mid-handshake can fail the drain
                # RPC with a protocol error rather than a clean
                # ConnectionError; the decision must still be recorded
                # and the lease still reclaimed or the pool wedges
                outcome = "drain_error"
            handle = self.handles.pop(rid, None)
            if handle is not None:
                _stop_handle(handle)
            self.router.forget(rid)
            self.drained += 1
            if _monitor._ENABLED:
                _monitor.count("autoscaler.drained")
            _obs.record_event("autoscaler.replica_drained", replica=rid,
                              outcome=outcome)
            results.append({"replica": rid, "outcome": outcome})
        return results

    def stop_all(self) -> None:
        """Teardown: stop every handle this pool spawned (no drain)."""
        handles, self.handles = dict(self.handles), {}
        for rid, handle in handles.items():
            _stop_handle(handle)
            try:
                self.router.forget(rid)
            except Exception:
                pass


def _stop_handle(handle) -> None:
    """Best-effort stop across handle shapes: ReplicaAgent.stop(drain=),
    a subprocess wrapper's kill(), or a bare stop()/close()."""
    for call in (lambda: handle.stop(drain=False),
                 lambda: handle.stop(),
                 lambda: handle.kill(),
                 lambda: handle.close()):
        try:
            call()
            return
        except TypeError:
            continue
        except AttributeError:
            continue
        except Exception:
            return  # it tried; a dead process raising is fine


# ---- the control loop -------------------------------------------------------

class Autoscaler:
    """The sense→decide→act loop. Each `FLAGS_autoscaler_interval_s`
    tick: read the fleet signal off the co-located TelemetryCollector
    (worst per-source shortest-window burn — NEVER the merged-gauge sum,
    which inflates with the source count — plus the aggregate queue
    fraction), ask the ScalePolicy for a verdict, actuate it through the
    ReplicaPool, record it in the DecisionLedger, and publish the pool
    doc back to the collector for `monitor top` + the `scale_blocked`
    alert. `tick()` is public so tests drive the loop deterministically."""

    def __init__(self, collector, pool: ReplicaPool,
                 policy: Optional[ScalePolicy] = None,
                 interval_s: Optional[float] = None,
                 queue_capacity: Optional[int] = None):
        self.collector = collector
        self.pool = pool
        self.policy = policy or ScalePolicy()
        self.ledger = DecisionLedger()
        self.interval_s = float(
            interval_s if interval_s is not None
            else _flags.flag("autoscaler_interval_s"))
        self._queue_capacity = max(1, int(
            queue_capacity if queue_capacity is not None
            else _flags.flag("serving_queue_depth")))
        self._spawn_retries = max(1, int(
            _flags.flag("autoscaler_spawn_retries")))
        self._spawn_budget = self._spawn_retries
        self._last_spawn_attempt: Optional[float] = None
        self._blocked_reason: Optional[str] = None
        self.target = pool.actual()
        self.ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        _LIVE.add(self)

    # -- lifecycle --
    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self.target = max(self.target, self.pool.actual())
        self._thread = _syncwatch.Thread(
            target=self._run, name="autoscaler-loop", daemon=True)
        self._thread.start()
        return self

    def close(self, stop_pool: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None
        if stop_pool:
            self.pool.stop_all()

    stop = close

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                continue  # a store/collector blip must not kill the loop

    # -- one loop iteration (public: tests drive it deterministically) --
    def tick(self, now: Optional[float] = None) -> ScaleDecision:
        if now is None:
            now = time.monotonic()
        signal = self._sense()
        decision = self.policy.decide(signal, now)
        self._act(decision, now)
        self._sweep_tenants(now)
        self._publish()
        self.ticks += 1
        return decision

    # -- sense --
    def _sense(self) -> Dict[str, Any]:
        burn = 0.0
        queued = 0.0
        alive = 0
        if self.collector is not None:
            for row in self.collector.fleet_table():
                if not row.get("alive") or row.get("role") != "replica":
                    continue
                alive += 1
                burn = max(burn, float(row.get("burn") or 0.0))
                queued += float(row.get("queue") or 0)
        frac = queued / (alive * self._queue_capacity) if alive else 0.0
        try:
            pending = int(self.pool.router.ledger.audit()["open"])
        except Exception:
            pending = 0
        return {"burn": burn, "queue_frac": frac,
                "actual": self.pool.actual(), "alive_sources": alive,
                "pending": pending}

    # -- act --
    def _act(self, decision: ScaleDecision, now: float) -> None:
        if decision.action == OUT:
            self._scale_out(decision, now)
        elif decision.action == IN:
            results = self.pool.scale_in(decision.delta)
            self.target = max(self.policy.min_replicas,
                              self.pool.actual())
            outcome = ",".join(r["outcome"] for r in results) or "no_victim"
            self.ledger.record(IN, -len(results), decision.reason,
                               decision.evidence, outcome,
                               self.target, self.pool.actual())

    def _scale_out(self, decision: ScaleDecision, now: float) -> None:
        # retry budget: consecutive spawn failures exhaust it and block
        # scale-out (the collector's scale_blocked alert fires); after a
        # cooldown one probe spawn is allowed — a recovered substrate
        # unblocks without operator action, a still-broken one re-arms
        if self._spawn_budget <= 0:
            cooled = (self._last_spawn_attempt is None
                      or now - self._last_spawn_attempt
                      >= self.policy.cooldown_s)
            if not cooled:
                self.ledger.record(OUT, 0, decision.reason,
                                   decision.evidence, "blocked",
                                   self.target, self.pool.actual())
                return
            self._spawn_budget = 1
        self._last_spawn_attempt = now
        self.target = min(self.policy.max_replicas,
                          max(self.target, self.pool.actual())
                          + decision.delta)
        res = self.pool.scale_out(decision.delta)
        if res["ok"]:
            self._spawn_budget = self._spawn_retries
            self._blocked_reason = None
            outcome = "spawned:" + ",".join(map(str, res["ok"]))
        else:
            self._spawn_budget -= res["failed"]
            if self._spawn_budget <= 0:
                self._spawn_budget = 0
                self._blocked_reason = (
                    "hbm_refused" if any("HBMBudget" in w
                                         for w in res["why"])
                    else "spawn_budget_exhausted")
                outcome = "blocked"
            else:
                outcome = "spawn_failed"
            self.target = self.pool.actual()
        self.ledger.record(
            OUT, len(res["ok"]), decision.reason,
            dict(decision.evidence, spawn_why=res["why"]), outcome,
            self.target, self.pool.actual())

    def _sweep_tenants(self, now: float) -> None:
        """Scale-to-zero for hosted tenants: one idle past the threshold
        with an empty queue is evicted through the replica's HBM-budget
        LRU path (model_ctl op 'evict'); a later host_model/rollout
        re-admits it, warm-started by the compile cache."""
        thr = float(_flags.flag("autoscaler_tenant_idle_s"))
        if thr < 0:
            return
        if thr == 0:
            thr = self.policy.zero_after_s
        for h in self.pool.router.healthy_replicas():
            tenants = h.stats.get("tenants") or {}
            for name, t in list(tenants.items()):
                if not isinstance(t, dict):
                    continue
                if float(t.get("idle_s") or 0.0) < thr \
                        or int(t.get("queue_depth") or 0) > 0:
                    continue
                try:
                    self.pool.router._model_ctl(h, "evict", name)
                except Exception:
                    continue  # busy/raced tenant: next sweep retries
                if _monitor._ENABLED:
                    _monitor.count("autoscaler.tenants_evicted")
                self.ledger.record(
                    "evict_tenant", 0, "tenant_idle",
                    {"model": name, "replica": h.replica_id,
                     "idle_s": t.get("idle_s")}, "evicted",
                    self.target, self.pool.actual())

    # -- publish / observability --
    def pool_doc(self) -> Dict[str, Any]:
        return {"target": self.target, "actual": self.pool.actual(),
                "blocked": self._blocked_reason is not None,
                "blocked_reason": self._blocked_reason,
                "spawn_failures": self.pool.spawn_failures,
                "last": self.ledger.last()}

    def _publish(self) -> None:
        c = self.collector
        if c is not None and hasattr(c, "pool_update"):
            try:
                c.pool_update(self.pool_doc())
            except Exception:
                pass  # a dying collector must not kill the control loop

    def snapshot(self) -> Dict[str, Any]:
        return {"target": self.target, "actual": self.pool.actual(),
                "ticks": self.ticks,
                "blocked_reason": self._blocked_reason,
                "spawn_budget": self._spawn_budget,
                "pool": {"spawned": self.pool.spawned,
                         "spawn_failures": self.pool.spawn_failures,
                         "drained": self.pool.drained},
                "policy": {"burn_high": self.policy.burn_high,
                           "burn_low": self.policy.burn_low,
                           "queue_high": self.policy.queue_high,
                           "queue_low": self.policy.queue_low,
                           "min": self.policy.min_replicas,
                           "max": self.policy.max_replicas,
                           "cooldown_s": self.policy.cooldown_s,
                           "idle_after_s": self.policy.idle_after_s,
                           "zero_after_s": self.policy.zero_after_s},
                "ledger": self.ledger.snapshot()}

    def dump(self, path: Optional[str] = None) -> Optional[str]:
        """Write the decision ledger into a flight-recorder dump."""
        return _obs.dump(path, reason="autoscaler",
                         extra={"autoscaler": self.snapshot()})
