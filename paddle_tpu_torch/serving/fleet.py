"""Fleet-of-replicas serving tier: a health-routed replica pool.

Counterpart of `paddle_tpu/serving/fleet.py`: the same store keys and
records, the same wire verbs, the same ledger. Membership runs on a
`torch.distributed.TCPStore`, whose `get` waits on a missing key until
the store's timeout, so every read of a record that may be missing goes
through `collective.store_peek` (`check` first) and a dead replica never
stalls the health thread. A replica serves where its predictor lives
(`Predictor.device`); one whose card stops answering fails the 'PDHQ'
probe instead of serving from the CPU. The HBM budget
keeps the reference's accounting (the bytes of the weight generation);
the probe reports `torch.cuda.memory_allocated` beside it.

Reference parity: the cluster role of Paddle Serving (`Serving/python/
pipeline/` — DAG of op servers behind a gRPC gateway with channel-full
backpressure) re-based on this repo's own primitives instead of a
sidecar stack: replicas are `PredictorServer` processes wrapped in a
`ReplicaAgent`, membership is the TCPStore + `ElasticManager` lease
plane (`parallel/elastic.py`), health is the `'PDHQ'` wire probe, and
routing is load-aware off each replica's own engine stats.

Topology — one `FleetRouter`, N `ReplicaAgent`s, one TCPStore:

    client -> FleetRouter.run()
                |  score replicas: queue_frac + w * slo_burn
                |  (stats from the 'PDHQ' probe, refreshed by the
                |   fleet-health thread every FLAGS_fleet_health_interval_s)
                v
              replica agent  -- PredictorServer -- ServingEngine(s)
                ^   heartbeats `lease:{id}` through ElasticManager;
                |   a missed lease OR a dispatch connection error marks
                |   the replica dead and its traffic re-routes within
                |   the ORIGINAL request deadline (failover loop)

Exactly-once: the router gives every request a sequence number in a
`SequenceLedger`; a failover retry re-dispatches the SAME sequence, and
the ledger refuses a second settle — a duplicate response (replica
answered but the connection died before the router saw it) is dropped
and counted (`fleet.duplicates_dropped`), never returned twice. The
chaos test audits the ledger: every sequence settles exactly once or is
accounted as abandoned/rejected.

Lifecycle verbs:
  - graceful drain ('PDDR'): every accepted request completes or is
    rejected overloaded — never silently dropped; the port closes.
  - versioned rollout: `FleetRouter.rollout()` pushes a new generation
    into the tenant's guard-checkpoint weight store, reloads ONE canary
    replica, watches the canary tenant's SLO burn over live probes, then
    promotes to the rest or instantly rolls back via the `.bak`
    generation (`guard.rollback_guard_state`).
  - multi-model hosting: `ReplicaAgent.host_model()` admits a
    `ModelTenant` (own engine + own `SloPlane`, so one tenant's burn
    cannot hide in another's average) under an explicit HBM budget —
    over-budget pushes evict idle tenants or fail with
    `HBMBudgetExceededError`, never over-subscribe.

Fault sites (chaos drills): `router.dispatch` (conn resets on the
dispatch path), `replica.register` (rendezvous failures),
`replica.drain` (drain-path faults).
"""
from __future__ import annotations

import json
import os
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import faults as _faults
from .. import monitor as _monitor
from .. import obs as _obs
from ..core import flags as _flags
from ..guard import (guard_state_version, load_guard_state,
                     rollback_guard_state, save_guard_state)
from ..obs import slo as _slo
from ..parallel.collective import store_peek
from ..parallel.elastic import ElasticManager
from .engine import EngineConfig, ServingEngine

__all__ = [
    "FleetRouter", "ReplicaAgent", "ModelTenant", "SequenceLedger",
    "RolloutResult", "FleetError", "NoHealthyReplicaError",
    "HBMBudgetExceededError", "render_fleet",
]

# unclosed routers/agents, so the test-suite leak fixture can both detect
# and reap them (a leaked health thread would poison every later test)
_LIVE: "weakref.WeakSet" = weakref.WeakSet()


class FleetError(RuntimeError):
    pass


class NoHealthyReplicaError(FleetError):
    """Every replica was dead, draining, or refused within the deadline."""


class HBMBudgetExceededError(FleetError):
    """Admitting the model would exceed the replica's HBM budget and no
    idle tenant could be evicted to make room."""


def _server_mod():
    # runtime import: inference/server.py imports the serving package at
    # module load, so a top-level import here would be circular
    from ..inference import server as _server
    return _server


# ---- exactly-once sequence ledger -------------------------------------------

class SequenceLedger:
    """Router-side exactly-once accounting. Every request gets one
    sequence number; failover re-dispatches the SAME sequence; the FIRST
    settle wins and any later one is refused (the caller drops the
    duplicate response). `audit()` is the chaos-test contract: sequences
    partition into settled / rejected / abandoned / open, and
    `duplicates` counts refused second settles."""

    def __init__(self):
        self._lock = _syncwatch.lock("fleet.SequenceLedger._lock")
        self._next = 0
        self._open: Dict[int, List[int]] = {}      # seq -> replicas tried
        self._settled: Dict[int, int] = {}         # seq -> replica that won
        self._rejected: Dict[int, str] = {}        # seq -> terminal status
        self._duplicates = 0

    def next_seq(self) -> int:
        with self._lock:
            seq = self._next
            self._next += 1
            self._open[seq] = []
            return seq

    def dispatch(self, seq: int, replica_id: int) -> None:
        with self._lock:
            self._open.setdefault(seq, []).append(replica_id)

    def settle(self, seq: int, replica_id: int) -> bool:
        """First settle returns True; a later one is a DUPLICATE: refused,
        counted, and the caller must drop the response."""
        # the monitor count stays OUTSIDE the critical section: it takes
        # the registry lock, and nesting that under the ledger lock puts
        # a foreign lock inside the request hot path (syncwatch dogfood)
        with self._lock:
            if seq in self._settled:
                self._duplicates += 1
                dup = True
            else:
                self._settled[seq] = replica_id
                self._open.pop(seq, None)
                dup = False
        if dup and _monitor._ENABLED:
            _monitor.count("fleet.duplicates_dropped")
        return not dup

    def reject(self, seq: int, why: str) -> None:
        """Terminal non-answer (deadline, no healthy replica): the caller
        surfaced an error for this sequence — it is accounted, not lost."""
        with self._lock:
            if seq not in self._settled:
                self._rejected[seq] = why
                self._open.pop(seq, None)

    def audit(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "issued": self._next,
                "settled": len(self._settled),
                "rejected": len(self._rejected),
                "open": len(self._open),
                "duplicates": self._duplicates,
                "lost": self._next - len(self._settled)
                - len(self._rejected) - len(self._open),
            }


# ---- model tenancy ----------------------------------------------------------

class ModelTenant:
    """One hosted model on a replica: a guard-checkpoint versioned weight
    store, a handler factory, its OWN ServingEngine (queue isolation) and
    its OWN SloPlane (per-tenant error budget — one tenant's burn must
    not hide in the replica average).

    `handler_factory(arrays, meta) -> callable` builds the predictor
    callable from a weight generation; `reload()` re-reads the NEWEST
    committed generation and swaps the handler in place (the engine and
    its warmed buckets survive a version swap)."""

    def __init__(self, name: str, dirname: str,
                 handler_factory: Callable[[Dict[str, np.ndarray], dict],
                                           Callable],
                 engine_config: Optional[EngineConfig] = None,
                 slo: Optional[_slo.SloPlane] = None,
                 bytes_hint: Optional[int] = None):
        self.name = name
        self.dirname = dirname
        self.handler_factory = handler_factory
        self._handler: Optional[Callable] = None
        self._lock = _syncwatch.lock("fleet.ModelTenant._lock")
        self.version = 0
        self.bytes = 0
        self._bytes_hint = bytes_hint
        self.last_used = time.monotonic()
        self.slo = slo
        # a stable closure: reload() swaps self._handler, the engine keeps
        # the same callable (and its compiled buckets)
        tenant = self

        def _call(*arrays):
            tenant.last_used = time.monotonic()
            h = tenant._handler
            if h is None:
                raise FleetError(f"model {tenant.name!r} has no loaded "
                                 "generation")
            return h(*arrays)

        self.engine = ServingEngine(_call, engine_config)
        if slo is not None:
            self.engine.slo_plane = slo

    def reload(self) -> int:
        """Load the newest committed weight generation; returns its
        version. Raises (and keeps the PREVIOUS handler serving) when the
        store has no intact generation."""
        arrays, meta = load_guard_state(self.dirname)
        with self._lock:
            self._handler = self.handler_factory(arrays, meta)
            self.version = guard_state_version(self.dirname)
            self.bytes = self._bytes_hint if self._bytes_hint is not None \
                else sum(int(np.asarray(a).nbytes) for a in arrays.values())
        if _monitor._ENABLED:
            _monitor.gauge_set(f"mem.model.{self.name}.bytes", self.bytes)
        return self.version

    def stats(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "bytes": self.bytes,
            "slo": self.slo.stats() if self.slo is not None else None,
            "queue_depth": self.engine.stats()["queue_depth"],
            "idle_s": round(time.monotonic() - self.last_used, 3),
        }


# ---- replica side -----------------------------------------------------------

class ReplicaAgent:
    """One fleet member: wraps a `PredictorServer`, registers with the
    fleet's TCPStore, heartbeats through `ElasticManager`, answers the
    fleet control verbs (drain, model reload/rollback), and hosts extra
    models under an explicit HBM budget. A replica whose predictor lives
    on a card that stops answering fails its 'PDHQ' probe, so the router
    routes around it."""

    def __init__(self, predictor, store, fleet: str = "fleet",
                 host: str = "127.0.0.1", port: int = 0,
                 engine_config: Optional[EngineConfig] = None,
                 replica_id: Optional[int] = None,
                 hbm_budget_bytes: Optional[int] = None,
                 slo: Optional[_slo.SloPlane] = None):
        # the predictor's own device: a plain callable has none to probe
        self.device = getattr(predictor, "device", None)
        self.store = store
        self.fleet = fleet
        self.replica_id = replica_id
        budget_mb = float(_flags.flag("fleet_hbm_budget_mb"))
        self.hbm_budget_bytes = hbm_budget_bytes if hbm_budget_bytes \
            is not None else int(budget_mb * (1 << 20))
        self.tenants: Dict[str, ModelTenant] = {}
        self._elastic: Optional[ElasticManager] = None
        self._exporter = None   # TelemetryExporter under FLAGS_telemetry
        self._closed = False
        srv = _server_mod()
        self.server = srv.PredictorServer(
            predictor, host=host, port=port, engine_config=engine_config,
            on_drain=self._on_drain, on_model_ctl=self._on_model_ctl,
            stats_extra=self._stats_extra, health_check=self._device_check)
        if slo is not None:
            self.server.engine.slo_plane = slo
        self.slo = slo
        _LIVE.add(self)

    # -- store keys --
    def _key(self, suffix: str) -> str:
        return f"fleet:{self.fleet}:{suffix}"

    # -- lifecycle --
    def start(self) -> "ReplicaAgent":
        if _faults._ENABLED:
            _faults.check("replica.register")
        if self.replica_id is None:
            # rendezvous: claim the next id (the store's add-counters are
            # atomic across processes)
            self.replica_id = int(
                self.store.add(self._key("next_id"), 1)) - 1
        max_replicas = int(_flags.flag("fleet_max_replicas"))
        if self.replica_id >= max_replicas:
            raise FleetError(
                f"replica id {self.replica_id} >= FLAGS_fleet_max_replicas="
                f"{max_replicas}")
        self.server.start()
        self.server.drain_info = {"replica_id": self.replica_id}
        record = {"host": self.server.host, "port": self.server.port,
                  "pid": os.getpid(), "ts": time.time()}
        self.store.set(self._key(f"replica:{self.replica_id}"),
                       json.dumps(record))
        self._elastic = ElasticManager(
            _PrefixStore(self.store, self._key("")), rank=self.replica_id,
            world_size=max_replicas,
            lease_ttl=float(_flags.flag("fleet_lease_ttl_s")),
            heartbeat_interval=float(_flags.flag("fleet_heartbeat_s")))
        self._elastic.register()
        if _flags.flag("telemetry"):
            from ..obs import telemetry as _telemetry
            self._exporter = _telemetry.TelemetryExporter(
                self.store, source=f"replica-{self.replica_id}",
                role="replica", fleet=self.fleet,
                meta={"replica_id": self.replica_id}).start()
        _obs.record_event("fleet.replica_register",
                          replica=self.replica_id, port=self.server.port)
        return self

    def _deregister(self) -> None:
        if self._elastic is not None:
            self._elastic.stop()
            self._elastic = None
        if self.replica_id is not None:
            try:  # the store has no delete: empty value == deregistered
                self.store.set(self._key(f"replica:{self.replica_id}"), b"")
                self.store.set(self._key(f"lease:{self.replica_id}"), b"")
            except Exception:
                pass  # store may already be gone on teardown

    def _on_drain(self) -> None:
        # runs between the port closing and the engines draining: stop
        # advertising FIRST so the router routes around us while queued
        # work completes
        if _faults._ENABLED:
            _faults.check("replica.drain")
        self._deregister()
        if self._exporter is not None:
            # push-fed fast path: the router learns of the drain from the
            # collector relay, not the next poll sweep
            self._exporter.event("drain", replica_id=self.replica_id)
        _obs.record_event("fleet.replica_drain", replica=self.replica_id)

    def drain(self) -> dict:
        report = self.server.drain()
        report["replica_id"] = self.replica_id
        return report

    def stop(self, drain: bool = True) -> None:
        if self._closed:
            return
        self._closed = True
        if drain:
            self.drain()
        else:
            self._deregister()
            self.server.stop(drain=False)
        if self._exporter is not None:
            self._exporter.stop()   # final flush ships the drain event
            self._exporter = None
        for t in self.tenants.values():
            t.engine.stop(drain=drain)

    close = stop

    # -- multi-model hosting under an HBM budget --
    def host_model(self, tenant: ModelTenant) -> ModelTenant:
        """Admit a tenant: load its newest generation, then check the
        budget — evicting IDLE tenants (no queued work, least recently
        used first) if needed; refuse with `HBMBudgetExceededError` when
        the model cannot fit even after evictions."""
        tenant.reload()
        if self.hbm_budget_bytes > 0:
            need = tenant.bytes
            used = sum(t.bytes for t in self.tenants.values())
            if used + need > self.hbm_budget_bytes:
                # plan the evictions FIRST (idle tenants, least recently
                # used): a doomed admission must refuse without having
                # torn anything down
                plan: List[str] = []
                would_free = 0
                for name, cand in sorted(
                        self.tenants.items(),
                        key=lambda kv: kv[1].last_used):
                    if used - would_free + need <= self.hbm_budget_bytes:
                        break
                    if cand.engine.stats()["queue_depth"] > 0:
                        continue  # busy tenants are not evictable
                    plan.append(name)
                    would_free += cand.bytes
                if used - would_free + need > self.hbm_budget_bytes:
                    raise HBMBudgetExceededError(
                        f"model {tenant.name!r} needs {need}B; "
                        f"{used}B of {self.hbm_budget_bytes}B in use and "
                        "no idle tenant to evict")
                for name in plan:
                    self.evict_model(name)
        self.tenants[tenant.name] = tenant
        self.server.register_model(tenant.name, tenant.engine)
        if _monitor._ENABLED:
            _monitor.count("fleet.models_hosted")
        _obs.record_event("fleet.model_hosted", replica=self.replica_id,
                          model=tenant.name, bytes=tenant.bytes,
                          version=tenant.version)
        return tenant

    def evict_model(self, name: str) -> None:
        tenant = self.tenants.pop(name, None)
        if tenant is None:
            return
        self.server.unregister_model(name, drain=True)
        if _monitor._ENABLED:
            _monitor.count("fleet.models_evicted")
            _monitor.gauge_set(f"mem.model.{name}.bytes", 0)
        _obs.record_event("fleet.model_evicted", replica=self.replica_id,
                          model=name)

    # -- control-plane hooks wired into PredictorServer --
    def _on_model_ctl(self, req: dict) -> dict:
        op = req.get("op")
        name = req.get("model", "")
        tenant = self.tenants.get(name)
        if tenant is None:
            raise FleetError(f"unknown model {name!r}")
        if op == "reload":
            version = tenant.reload()
        elif op == "rollback":
            version = rollback_guard_state(tenant.dirname)
            tenant.reload()
            if _monitor._ENABLED:
                _monitor.count("fleet.model_rollbacks")
        elif op == "evict":
            # scale-to-zero for an idle tenant: the autoscaler rides the
            # same LRU eviction path the HBM budget uses, so a later
            # host_model() re-admits the tenant cold (weights reload from
            # the guard store, the compile cache warm-starts the engine)
            version = tenant.version
            if tenant.engine.stats()["queue_depth"] > 0:
                raise FleetError(f"model {name!r} is busy; not evictable")
            self.evict_model(name)
        else:
            raise FleetError(f"unknown model-ctl op {op!r}")
        _obs.record_event("fleet.model_ctl", replica=self.replica_id,
                          model=name, op=op, version=version)
        return {"ok": True, "model": name, "op": op, "version": version}

    def _device_check(self) -> None:
        """The 'PDHQ' probe's device leg: a card that no longer answers
        fails the probe (the server answers an error status)."""
        if getattr(self.device, "type", None) == "cuda":
            torch.cuda.mem_get_info(self.device)

    def _stats_extra(self) -> dict:
        extra: Dict[str, Any] = {"replica_id": self.replica_id}
        if self.tenants:
            extra["tenants"] = {n: t.stats()
                                for n, t in self.tenants.items()}
        if self.hbm_budget_bytes > 0:
            extra["hbm"] = {
                "budget_bytes": self.hbm_budget_bytes,
                "used_bytes": sum(t.bytes
                                  for t in self.tenants.values()),
            }
            if getattr(self.device, "type", None) == "cuda":
                # reported beside the budget, not part of its policy
                extra["hbm"]["device_allocated_bytes"] = int(
                    torch.cuda.memory_allocated(self.device))
        return extra

    @property
    def host(self):
        return self.server.host

    @property
    def port(self):
        return self.server.port


# promoted to parallel/elastic.py (the PS HA plane shares it); the
# underscore alias keeps this module's call sites and pickles stable
from ..parallel.elastic import PrefixStore as _PrefixStore  # noqa: E402
from ..utils import syncwatch as _syncwatch


# ---- router side ------------------------------------------------------------

class _ReplicaHandle:
    """Router-side view of one replica: its record, freshest probe stats,
    health verdict, and a small pool of persistent connections."""

    def __init__(self, replica_id: int, host: str, port: int):
        self.replica_id = replica_id
        self.host = host
        self.port = port
        self.healthy = True
        self.draining = False
        self.stats: Dict[str, Any] = {}
        self.served = 0
        self.failures = 0
        self.died_at: Optional[float] = None
        self.detected_dead_at: Optional[float] = None
        self._pool: List[Any] = []
        self._pool_lock = _syncwatch.lock("fleet._ReplicaHandle._pool_lock")

    def acquire(self, connect_timeout: float):
        with self._pool_lock:
            if self._pool:
                return self._pool.pop()
        srv = _server_mod()
        return srv.PredictorClient(
            self.host, self.port, failover=False, max_retries=0,
            connect_timeout=connect_timeout)

    def release(self, client) -> None:
        with self._pool_lock:
            if len(self._pool) < 8:
                self._pool.append(client)
                return
        client.close()

    def close_pool(self) -> None:
        with self._pool_lock:
            pool, self._pool = self._pool, []
        for c in pool:
            c.close()

    def mark_dead(self) -> None:
        self.healthy = False
        if self.detected_dead_at is None:
            self.detected_dead_at = time.monotonic()
        self.close_pool()

    def score(self, burn_weight: float) -> float:
        """Load score, lower routes first: queue fraction + weighted SLO
        burn (shortest window) off the last 'PDHQ' probe."""
        s = self.stats
        cap = max(1, int(s.get("queue_capacity", 1) or 1))
        q = (float(s.get("queue_depth", 0)) +
             float(s.get("inflight", 0))) / cap
        return q + burn_weight * _slo.shortest_window_burn(s.get("slo"))


class RolloutResult:
    def __init__(self, model: str, version: int, canary: int,
                 promoted: bool, rolled_back: bool, canary_burn: float,
                 probed: int):
        self.model = model
        self.version = version
        self.canary = canary
        self.promoted = promoted
        self.rolled_back = rolled_back
        self.canary_burn = canary_burn
        self.probed = probed

    def __repr__(self):
        verdict = "promoted" if self.promoted else (
            "rolled_back" if self.rolled_back else "undecided")
        return (f"RolloutResult({self.model}@v{self.version} "
                f"canary={self.canary} {verdict} "
                f"burn={self.canary_burn:.3f})")


class FleetRouter:
    """Load-aware front-end over the replica pool. Discovers replicas
    from the fleet's TCPStore records, probes them on the fleet-health
    thread, scores each by `queue_frac + FLAGS_fleet_route_burn_weight *
    slo_burn`, and dispatches with exactly-once failover (see module
    docstring)."""

    def __init__(self, store, fleet: str = "fleet",
                 slo: Optional[_slo.SloPlane] = None):
        self.store = store
        self.fleet = fleet
        self.replicas: Dict[int, _ReplicaHandle] = {}
        self.ledger = SequenceLedger()
        self.slo = slo
        self._lock = _syncwatch.lock("fleet.FleetRouter._lock")
        self._stop = threading.Event()
        self._burn_weight = float(_flags.flag("fleet_route_burn_weight"))
        self._connect_timeout = float(
            _flags.flag("serving_client_connect_timeout_s"))
        self._health_interval = float(
            _flags.flag("fleet_health_interval_s"))
        self._max_replicas = int(_flags.flag("fleet_max_replicas"))
        lease_ttl = float(_flags.flag("fleet_lease_ttl_s"))
        # a handle dead this long with NO live lease is a corpse: reaped
        # from membership (and its stale record cleared) instead of being
        # probed forever — long enough that a live-but-slow replica's
        # lease always outruns it
        self._reap_after = max(2.0 * lease_ttl,
                               4.0 * self._health_interval)
        # prompt death detection: the elastic watcher fires on a missed
        # lease without waiting for the next health sweep
        self._elastic = ElasticManager(
            _PrefixStore(store, f"fleet:{self.fleet}:"), rank=-1,
            world_size=self._max_replicas,
            lease_ttl=lease_ttl,
            heartbeat_interval=float(_flags.flag("fleet_heartbeat_s")))
        self._health_thread: Optional[threading.Thread] = None
        self._closed = False
        _LIVE.add(self)

    def start(self) -> "FleetRouter":
        self.refresh()
        self._elastic.on_rank_dead(
            self._on_rank_dead,
            interval=min(self._health_interval,
                         self._elastic.heartbeat_interval))
        self._health_thread = _syncwatch.Thread(
            target=self._health_loop, daemon=True, name="fleet-health")
        self._health_thread.start()
        return self

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._elastic.stop()
        if self._health_thread is not None:
            self._health_thread.join(timeout=2)
            self._health_thread = None
        with self._lock:
            handles = list(self.replicas.values())
        for h in handles:
            h.close_pool()

    stop = close

    # -- membership + health --
    def _on_rank_dead(self, rank: int) -> None:
        with self._lock:
            h = self.replicas.get(rank)
        if h is not None and h.healthy:
            h.mark_dead()
            if _monitor._ENABLED:
                _monitor.count("fleet.replicas_lost")
            _obs.record_event("fleet.replica_dead", replica=rank,
                              via="lease")
            from ..obs import telemetry as _telemetry
            _telemetry.emit("lease_expiry", replica_id=rank)

    # -- telemetry fast path --
    def attach_telemetry(self, collector) -> "FleetRouter":
        """Subscribe to a TelemetryCollector's event relay: a pushed
        death/drain marks the replica dead the moment the collector's
        connection reader sees EOF (<1s after a SIGKILL), instead of
        waiting out the lease TTL or the next 'PDHQ' poll sweep — both
        of which keep running as fallback."""
        collector.subscribe(self._on_telemetry_event)
        return self

    def _on_telemetry_event(self, ev: Dict[str, Any]) -> None:
        kind = ev.get("kind")
        if kind not in ("death", "drain"):
            return
        detail = ev.get("detail") or {}
        rid = detail.get("replica_id")
        if rid is None:
            return
        with self._lock:
            h = self.replicas.get(int(rid))
        if h is None:
            return
        if kind == "drain":
            if not h.draining:
                h.draining = True
                h.close_pool()
            return
        if h.healthy:
            h.mark_dead()
            if _monitor._ENABLED:
                _monitor.count("fleet.replicas_lost")
            _obs.record_event("fleet.replica_dead", replica=int(rid),
                              via="telemetry")

    def forget(self, replica_id: int, reclaim: bool = True) -> bool:
        """Remove a replica from membership entirely. With `reclaim`,
        also clear its store record and lease (the store has no delete;
        empty == gone) so neither this router nor any other ever probes
        the corpse again. The autoscaler's pool calls this for a spawn
        that never answered its first 'PDHQ'; `refresh` calls it for any
        handle dead past the reap window with no live lease."""
        with self._lock:
            h = self.replicas.pop(replica_id, None)
        if h is not None:
            h.close_pool()
        if reclaim:
            try:
                self.store.set(
                    f"fleet:{self.fleet}:replica:{replica_id}", b"")
                self._elastic.reclaim(replica_id)
            except Exception:
                pass  # store gone on teardown: nothing left to reclaim
        if h is not None:
            _obs.record_event("fleet.replica_reaped", replica=replica_id)
        return h is not None

    def _reap_if_corpse(self, h: _ReplicaHandle) -> bool:
        """A handle that has been dead past the reap window AND holds no
        live lease is a corpse — a replica that died between spawn and
        its first 'PDHQ' answer would otherwise keep a stale record that
        every sweep probes forever."""
        if h.healthy or h.detected_dead_at is None:
            return False
        if time.monotonic() - h.detected_dead_at < self._reap_after:
            return False
        try:
            alive = set(self._elastic.alive_ranks())
        except Exception:
            return False  # store blip: reap on a later sweep
        if h.replica_id in alive:
            return False
        self.forget(h.replica_id)
        if _monitor._ENABLED:
            _monitor.count("fleet.replicas_reaped")
        return True

    def refresh(self) -> None:
        """One membership + health sweep (the fleet-health thread calls
        this every FLAGS_fleet_health_interval_s; tests call it directly
        for determinism)."""
        for rid in range(self._max_replicas):
            raw = store_peek(self.store, f"fleet:{self.fleet}:replica:{rid}")
            if raw is None:
                continue
            if not raw:  # empty record == deregistered (drained)
                with self._lock:
                    h = self.replicas.get(rid)
                if h is not None and not h.draining:
                    h.draining = True
                    h.close_pool()
                continue
            try:
                rec = json.loads(raw.decode() if isinstance(raw, bytes)
                                 else raw)
            except ValueError:
                continue
            joined = False
            with self._lock:
                h = self.replicas.get(rid)
                rejoin = (h is not None
                          and (h.host, h.port) != (rec["host"],
                                                   rec["port"]))
                if h is None or rejoin:
                    h = _ReplicaHandle(rid, rec["host"], rec["port"])
                    self.replicas[rid] = h
                    joined = True
            # counter + event ride OUTSIDE the membership lock: both take
            # foreign (monitor/obs ring) locks of their own, and nothing
            # here needs the membership view (syncwatch dogfood)
            if joined:
                if _monitor._ENABLED:
                    _monitor.count("fleet.replicas_joined")
                _obs.record_event("fleet.replica_joined", replica=rid,
                                  port=rec["port"], rejoin=rejoin)
            self._probe(h)
            self._reap_if_corpse(h)

    def _probe(self, h: _ReplicaHandle) -> None:
        try:
            client = h.acquire(self._connect_timeout)
        except Exception:
            h.mark_dead()
            return
        try:
            h.stats = client.health(deadline_ms=max(
                1000.0, self._health_interval * 2000.0))
        except Exception:
            client.close()
            h.mark_dead()
            return
        h.release(client)
        h.draining = bool(h.stats.get("draining"))
        if not h.healthy:
            h.detected_dead_at = None
            h.died_at = None
            _obs.record_event("fleet.replica_recovered",
                              replica=h.replica_id)
        h.healthy = True

    def _health_loop(self) -> None:
        while not self._stop.wait(self._health_interval):
            try:
                self.refresh()
            except Exception:
                continue  # a store blip must not kill the health plane

    def healthy_replicas(self) -> List[_ReplicaHandle]:
        with self._lock:
            hs = list(self.replicas.values())
        return [h for h in hs if h.healthy and not h.draining]

    # -- dispatch --
    def _pick(self, exclude) -> Optional[_ReplicaHandle]:
        best, best_score = None, None
        for h in self.healthy_replicas():
            if h.replica_id in exclude:
                continue
            s = h.score(self._burn_weight)
            if best_score is None or s < best_score:
                best, best_score = h, s
        return best

    def run(self, arrays: Sequence[np.ndarray],
            deadline_ms: Optional[float] = None,
            model: Optional[str] = None) -> Tuple[int, Any]:
        """Route one request. Returns (wire_status, payload) like
        `PredictorClient.run`. A replica that dies mid-request fails over
        to the next-best replica within the ORIGINAL deadline; overload
        answers also fail over (another replica may have room). A
        momentarily all-dead pool is ridden out within the deadline
        (refresh + short waits) rather than failed fast. Raises
        `NoHealthyReplicaError` when the pool is exhausted and
        `TimeoutError` when the deadline expires first."""
        seq = self.ledger.next_seq()
        deadline = (time.monotonic() + deadline_ms / 1000.0
                    if deadline_ms is not None else None)
        attempts = max(1, int(_flags.flag("fleet_failover_attempts")))
        tried: set = set()
        dispatches = 0
        t0 = time.monotonic()
        last_err: Optional[Exception] = None
        overloaded: Optional[Tuple[int, Any]] = None
        while dispatches < attempts:
            if deadline is not None and time.monotonic() >= deadline:
                break
            h = self._pick(tried)
            if h is None and tried:
                # every UNTRIED replica is out; a failover retry may
                # revisit a tried one (the ledger still dedups, and a
                # reset victim is often healthy again by now)
                tried = set()
                h = self._pick(tried)
            if h is None:
                # transient all-dead blip (a burst of resets can mark
                # replicas dead faster than the health loop revives
                # them): refresh membership and ride it out WITHIN the
                # deadline instead of failing fast
                try:
                    self.refresh()
                except Exception:
                    pass
                h = self._pick(tried)
                if h is None:
                    if deadline is None:
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    time.sleep(min(0.05, remaining))
                    continue
            tried.add(h.replica_id)
            dispatches += 1
            self.ledger.dispatch(seq, h.replica_id)
            remaining_ms = None
            if deadline is not None:
                remaining_ms = max(1.0,
                                   (deadline - time.monotonic()) * 1e3)
            try:
                if _faults._ENABLED:
                    _faults.check("router.dispatch")
                client = h.acquire(self._connect_timeout)
                try:
                    status, payload = client.run(
                        arrays, deadline_ms=remaining_ms, model=model)
                except BaseException:
                    client.close()
                    raise
                h.release(client)
            except (ConnectionError, TimeoutError, OSError) as e:
                last_err = e
                h.mark_dead()
                h.failures += 1
                if _monitor._ENABLED:
                    _monitor.count("fleet.failovers")
                _obs.record_event("fleet.failover", replica=h.replica_id,
                                  seq=seq, error=type(e).__name__)
                continue
            srv = _server_mod()
            if status == srv.STATUS_OVERLOADED:
                # healthy backpressure: remember it, try a replica with
                # room (the pool may absorb what one member shed)
                overloaded = (status, payload)
                h.failures += 1
                continue
            if not self.ledger.settle(seq, h.replica_id):
                # a failover retry already answered this sequence: this
                # response is the duplicate — drop it
                continue
            h.served += 1
            self._slo_record(t0, status)
            return status, payload
        # terminal: no answer within the budget
        if overloaded is not None:
            self.ledger.reject(seq, "overloaded")
            self._slo_record(t0, _server_mod().STATUS_OVERLOADED)
            return overloaded
        if deadline is not None and time.monotonic() >= deadline:
            self.ledger.reject(seq, "deadline")
            self._slo_record(t0, _server_mod().STATUS_DEADLINE)
            raise TimeoutError(
                f"fleet deadline exceeded after {len(tried)} attempts"
            ) from last_err
        self.ledger.reject(seq, "no_healthy_replica")
        self._slo_record(t0, _server_mod().STATUS_ERROR)
        raise NoHealthyReplicaError(
            f"no healthy replica (tried {sorted(tried)})") from last_err

    def _slo_record(self, t0: float, status: int) -> None:
        p = self.slo
        if p is None:
            return
        srv = _server_mod()
        outcome = {srv.STATUS_OK: _slo.OUTCOME_OK,
                   srv.STATUS_OVERLOADED: _slo.OUTCOME_REJECTED,
                   srv.STATUS_DEADLINE: _slo.OUTCOME_DEADLINE}.get(
                       status, _slo.OUTCOME_ERROR)
        p.record(time.monotonic() - t0, outcome)

    # -- lifecycle verbs --
    def drain(self, replica_id: int) -> dict:
        """Gracefully drain one replica ('PDDR'): its accepted work
        completes, its port closes, its lease deregisters; the health
        plane routes around it immediately."""
        with self._lock:
            h = self.replicas.get(replica_id)
        if h is None:
            raise FleetError(f"unknown replica {replica_id}")
        srv = _server_mod()
        client = srv.PredictorClient(h.host, h.port, failover=False,
                                     connect_timeout=self._connect_timeout)
        try:
            report = client.drain()
        finally:
            client.close()
        h.draining = True
        h.healthy = False
        h.close_pool()
        if _monitor._ENABLED:
            _monitor.count("fleet.drains")
        _obs.record_event("fleet.replica_drained", replica=replica_id)
        return report

    def _model_ctl(self, h: _ReplicaHandle, op: str, model: str) -> dict:
        srv = _server_mod()
        client = srv.PredictorClient(h.host, h.port, failover=False,
                                     connect_timeout=self._connect_timeout)
        try:
            return client.model_ctl(op, model)
        finally:
            client.close()

    def rollout(self, model: str, dirname: str,
                arrays: Dict[str, np.ndarray], meta: dict,
                probes: Sequence[Sequence[np.ndarray]],
                canary: Optional[int] = None,
                probe_deadline_ms: float = 2000.0) -> RolloutResult:
        """Versioned canary rollout. Commits the new generation into the
        tenant's shared weight store, reloads ONE canary replica, drives
        the probe requests at the canary's tenant, reads the canary's
        per-tenant SLO burn off a fresh 'PDHQ' probe, then either
        promotes (reload everywhere else) or instantly rolls back via the
        guard `.bak` generation. The aggregate error budget stays
        bounded: only the canary ever served the bad version."""
        candidates = self.healthy_replicas()
        if not candidates:
            raise NoHealthyReplicaError("no replica to canary on")
        if canary is None:
            canary_h = candidates[0]
        else:
            canary_h = next((h for h in candidates
                             if h.replica_id == canary), None)
            if canary_h is None:
                raise FleetError(f"canary replica {canary} not healthy")
        save_guard_state(dirname, arrays, meta)
        ctl = self._model_ctl(canary_h, "reload", model)
        version = int(ctl.get("version", 0))
        _obs.record_event("fleet.rollout_canary", model=model,
                          version=version, canary=canary_h.replica_id)
        # drive the probes at the CANARY specifically (routing would
        # spread them and dilute the signal)
        srv = _server_mod()
        client = srv.PredictorClient(canary_h.host, canary_h.port,
                                     failover=False,
                                     connect_timeout=self._connect_timeout)
        probed = 0
        try:
            for p in probes:
                try:
                    client.run(list(p), deadline_ms=probe_deadline_ms,
                               model=model)
                except (ConnectionError, TimeoutError, OSError):
                    pass  # the burn accounting below is the verdict
                probed += 1
            stats = client.health(deadline_ms=probe_deadline_ms)
        finally:
            client.close()
        tenant = (stats.get("tenants") or {}).get(model) or {}
        burn = _slo.shortest_window_burn(tenant.get("slo"))
        threshold = float(_flags.flag("fleet_canary_burn"))
        if burn > threshold:
            self._model_ctl(canary_h, "rollback", model)
            if _monitor._ENABLED:
                _monitor.count("fleet.rollbacks")
            _obs.record_event("fleet.rollout_rollback", model=model,
                              version=version, burn=burn)
            from ..obs import telemetry as _telemetry
            _telemetry.emit("rollout", model=model, version=version,
                            burn=burn, promoted=False)
            return RolloutResult(model, version, canary_h.replica_id,
                                 promoted=False, rolled_back=True,
                                 canary_burn=burn, probed=probed)
        for h in self.healthy_replicas():
            if h.replica_id == canary_h.replica_id:
                continue
            try:
                self._model_ctl(h, "reload", model)
            except (ConnectionError, TimeoutError, OSError):
                h.mark_dead()
        if _monitor._ENABLED:
            _monitor.count("fleet.promotions")
        _obs.record_event("fleet.rollout_promote", model=model,
                          version=version, burn=burn)
        from ..obs import telemetry as _telemetry
        _telemetry.emit("rollout", model=model, version=version,
                        burn=burn, promoted=True)
        return RolloutResult(model, version, canary_h.replica_id,
                             promoted=True, rolled_back=False,
                             canary_burn=burn, probed=probed)

    def rollback_model(self, model: str) -> Dict[int, int]:
        """Instant fleet-wide rollback of `model` to its guard `.bak`
        generation ('PDMV' model-ctl on every healthy replica). Returns
        replica id -> restored version. The online rollback guard drives
        this when a poisoned table generation reaches serving."""
        restored: Dict[int, int] = {}
        for h in self.healthy_replicas():
            try:
                ctl = self._model_ctl(h, "rollback", model)
                restored[h.replica_id] = int(ctl.get("version", 0))
            except (ConnectionError, TimeoutError, OSError):
                h.mark_dead()
        if _monitor._ENABLED:
            _monitor.count("fleet.rollbacks")
        _obs.record_event("fleet.model_rollback", model=model,
                          replicas=sorted(restored))
        from ..obs import telemetry as _telemetry
        _telemetry.emit("model_rollback", model=model,
                        replicas=sorted(restored))
        return restored

    # -- observability --
    def snapshot(self) -> Dict[str, Any]:
        """The `fleet` section of an obs dump / the monitor CLI table."""
        with self._lock:
            hs = list(self.replicas.items())
        out: Dict[str, Any] = {"fleet": self.fleet, "replicas": {}}
        for rid, h in hs:
            s = h.stats
            out["replicas"][str(rid)] = {
                "host": h.host, "port": h.port,
                "healthy": h.healthy, "draining": h.draining,
                "score": round(h.score(self._burn_weight), 4),
                "served": h.served, "failures": h.failures,
                "queue_depth": s.get("queue_depth", 0),
                "warm_start_ms": s.get("warm_start_ms"),
                "tenants": sorted((s.get("tenants") or {}).keys()),
            }
        out["ledger"] = self.ledger.audit()
        if self.slo is not None:
            out["slo"] = self.slo.stats()
        return out

    def dump(self, path: Optional[str] = None,
             reason: str = "fleet") -> Optional[str]:
        return _obs.dump(path, reason=reason,
                         extra={"fleet": self.snapshot()})


# ---- rendering (monitor CLI `fleet` subcommand) -----------------------------

def render_fleet(doc: Optional[Dict[str, Any]]) -> str:
    if not doc or not doc.get("replicas"):
        return "(no fleet replicas found)"
    lines = ["-" * 78,
             f"fleet {doc.get('fleet', '?')!r}: "
             f"{len(doc['replicas'])} replica(s)",
             "-" * 78,
             f"{'id':>3} {'endpoint':<21} {'state':<9} {'score':>7} "
             f"{'queue':>5} {'served':>7} {'fail':>5}  models"]
    for rid in sorted(doc["replicas"], key=int):
        r = doc["replicas"][rid]
        state = "draining" if r.get("draining") else (
            "up" if r.get("healthy") else "DEAD")
        lines.append(
            f"{rid:>3} {r['host'] + ':' + str(r['port']):<21} {state:<9} "
            f"{r.get('score', 0.0):>7.3f} {r.get('queue_depth', 0):>5} "
            f"{r.get('served', 0):>7} {r.get('failures', 0):>5}  "
            + (",".join(r.get("tenants", [])) or "-"))
    led = doc.get("ledger")
    if led:
        lines.append(
            f"ledger: issued={led['issued']} settled={led['settled']} "
            f"rejected={led['rejected']} open={led['open']} "
            f"duplicates={led['duplicates']} lost={led['lost']}")
    slo = doc.get("slo")
    if slo:
        burn = slo.get("burn", {})
        if burn:
            worst = max(burn.values())
            lines.append("router SLO burn: " + "  ".join(
                f"{w}s={burn[w]:.3f}"
                for w in sorted(burn, key=int)) +
                ("   <-- over budget" if worst > 1.0 else ""))
    lines.append("-" * 78)
    return "\n".join(lines)
