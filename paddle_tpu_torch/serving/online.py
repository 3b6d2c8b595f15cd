"""Online-learning serving plane: staleness-bounded embedding tables.

Counterpart of `paddle_tpu/serving/online.py`. The rows stay host numpy
and `lookup` returns numpy, as in the reference; a handler that serves
on the card moves the looked-up rows there in one host-to-device copy.

`OnlineServingTable` answers embedding lookups inside the Predictor
path from rows streamed off the trainer-side PS by the delta-push plane
(`distributed/ps/delta.py`). It tracks how stale it is — the time since
the last SUCCESSFUL delta sync, where "no rows changed" counts as a
sync — and refuses (or loudly degrades) lookups past
`FLAGS_online_max_staleness_s`: serving silently-stale recommendations
is the failure mode this plane exists to prevent.

Versioned cutover rides the guard checkpoint machinery
(`guard/checkpoint.py`): `save_serving_generation` writes the table
rows as a guard-state generation, so a `ModelTenant` hosting the CTR
model reloads ('PDMV' reload) and instantly rolls back ('PDMV'
rollback -> guard `.bak`) through the exact paths the fleet already
chaos-tests. `OnlineRollbackGuard` closes that loop: a probe batch is
validated every interval and a poisoned generation (non-finite or
out-of-range predictions) triggers the fleet-wide rollback within one
interval, recorded in a DecisionLedger-style entry plus a telemetry
event.

Gauges (the telemetry plane picks these up from the monitor
registry): `online.<table>.staleness_s`, `online.<table>.applied_version`,
`online.<table>.rows`. Counters: `online.stale_serves`,
`online.stale_rejects`, `online.poison_rows`, `online.rollbacks`.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, Optional

import numpy as np

from .. import monitor as _monitor
from ..core import flags as _flags
from ..guard.checkpoint import save_guard_state
from ..utils import syncwatch as _syncwatch

__all__ = ["StalenessExceededError", "OnlineServingTable",
           "save_serving_generation", "load_serving_tables",
           "OnlineRollbackGuard"]

# live rollback guards, for the conftest leak fixture
_LIVE = weakref.WeakSet()


class StalenessExceededError(RuntimeError):
    """Lookup refused: the table is staler than the configured bound
    and `FLAGS_online_staleness_degrade` is 'reject'."""


class OnlineServingTable:
    """Serving-side mirror of one PS sparse table: embedding VALUES
    only (optimizer slots never leave the trainer plane), installed by
    a `DeltaSubscriber`, read by the prediction handler.

    Unknown/cold keys read as zeros — a key the trainer has pulled but
    never pushed carries no trained signal yet, and a fixed answer
    beats an unbounded wait. Installs are idempotent value writes, so
    a re-pulled delta after a torn response changes nothing.
    """

    def __init__(self, name: str, dim: int,
                 max_staleness_s: Optional[float] = None,
                 degrade: Optional[str] = None):
        self.name = name
        self.dim = int(dim)
        self._lock = threading.Lock()
        self._rows: Dict[int, np.ndarray] = {}
        self.applied_version = -1
        self._fresh_t: Optional[float] = None   # monotonic of last sync
        self._max_staleness_s = max_staleness_s
        self._degrade = degrade
        self._stale_episode = False   # one telemetry event per episode
        self._installs = 0
        self._poison_rows = 0

    # ---- install side (DeltaSubscriber contract) ----
    def install_delta(self, batch) -> None:
        """Apply one `delta.DeltaBatch`: merge live rows + drop
        tombstoned keys, or replace the whole table when the batch is a
        full resync. Non-finite rows are installed but counted — the
        rollback guard, not the install path, owns the poison verdict
        (a half-installed table would be a worse failure mode than a
        loudly-poisoned one)."""
        rows = np.asarray(batch.rows, np.float32)
        bad = int(np.sum(~np.isfinite(rows).all(axis=1))) if len(rows) else 0
        with self._lock:
            if batch.full:
                self._rows = {}
            for i, k in enumerate(batch.live_keys):
                self._rows[int(k)] = rows[i].copy()
            for k in batch.dead_keys:
                self._rows.pop(int(k), None)
            self.applied_version = int(batch.version)
            self._installs += 1
            self._poison_rows += bad
        if _monitor._ENABLED:
            if bad:
                _monitor.count("online.poison_rows", bad)
            _monitor.gauge_set(f"online.{self.name}.applied_version",
                               self.applied_version)
            _monitor.gauge_set(f"online.{self.name}.rows", len(self._rows))

    def mark_fresh(self) -> None:
        """Record a successful sync (even an empty delta: 'nothing
        changed' is freshness, not staleness)."""
        self._fresh_t = time.monotonic()
        self._stale_episode = False
        if _monitor._ENABLED:
            _monitor.gauge_set(f"online.{self.name}.staleness_s", 0.0)

    # ---- read side (prediction handler contract) ----
    def staleness_s(self) -> float:
        if self._fresh_t is None:
            return float("inf")
        return time.monotonic() - self._fresh_t

    def _staleness_bound(self) -> float:
        if self._max_staleness_s is not None:
            return float(self._max_staleness_s)
        return float(_flags.flag("online_max_staleness_s"))

    def lookup(self, ids) -> np.ndarray:
        """[n] ids -> [n, dim] f32 rows (zeros for cold keys). Past the
        staleness bound the configured degrade applies — NEVER a silent
        stale answer: 'serve_stale' serves but counts + emits one
        telemetry event per stale episode, 'reject' raises."""
        stale = self.staleness_s()
        if stale > self._staleness_bound():
            degrade = (self._degrade if self._degrade is not None
                       else str(_flags.flag("online_staleness_degrade")))
            if _monitor._ENABLED:
                _monitor.gauge_set(f"online.{self.name}.staleness_s", stale)
            if degrade == "reject":
                if _monitor._ENABLED:
                    _monitor.count("online.stale_rejects")
                raise StalenessExceededError(
                    f"online table {self.name!r} is {stale:.3f}s stale "
                    f"(bound {self._staleness_bound()}s)")
            if _monitor._ENABLED:
                _monitor.count("online.stale_serves")
            if not self._stale_episode:
                self._stale_episode = True
                from ..obs import telemetry as _telemetry
                _telemetry.emit("online_stale_serve", table=self.name,
                                staleness_s=round(stale, 3),
                                version=self.applied_version)
        ids = np.asarray(ids, np.int64).reshape(-1)
        out = np.zeros((len(ids), self.dim), np.float32)
        with self._lock:
            for r, i in enumerate(ids):
                row = self._rows.get(int(i))
                if row is not None:
                    out[r] = row
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def stats(self) -> dict:
        with self._lock:
            n = len(self._rows)
        s = self.staleness_s()
        return {"table": self.name, "dim": self.dim, "rows": n,
                "applied_version": self.applied_version,
                "staleness_s": None if s == float("inf") else round(s, 4),
                "installs": self._installs,
                "poison_rows": self._poison_rows}

    # ---- guard-generation cutover ----
    def export_arrays(self) -> Dict[str, np.ndarray]:
        with self._lock:
            keys = np.fromiter(self._rows.keys(), np.int64,
                               len(self._rows))
            order = np.argsort(keys, kind="stable")
            keys = keys[order]
            vals = (np.stack([self._rows[int(k)] for k in keys])
                    if len(keys) else np.zeros((0, self.dim), np.float32))
        return {f"{self.name}::keys": keys,
                f"{self.name}::rows": vals.astype(np.float32)}

    def load_arrays(self, keys: np.ndarray, rows: np.ndarray,
                    version: int) -> None:
        """Replace content from a guard generation (tenant reload and
        'PDMV' rollback both land here)."""
        rows = np.asarray(rows, np.float32)
        with self._lock:
            self._rows = {int(k): rows[i].copy()
                          for i, k in enumerate(np.asarray(keys).reshape(-1))}
            self.applied_version = int(version)
        self.mark_fresh()


def save_serving_generation(dirname: str,
                            tables: Dict[str, OnlineServingTable],
                            meta_extra: Optional[dict] = None) -> str:
    """Persist the tables as ONE guard-state generation (atomic_write +
    CRC manifest + `.bak` of the previous generation), so tenant
    reload/rollback flows through `guard/checkpoint.py` untouched."""
    arrays: Dict[str, np.ndarray] = {}
    meta_tables: Dict[str, dict] = {}
    for name, t in tables.items():
        arrays.update(t.export_arrays())
        meta_tables[name] = {"dim": t.dim,
                             "version": int(t.applied_version)}
    meta = dict(meta_extra or {}, online_tables=meta_tables)
    return save_guard_state(dirname, arrays, meta)


def load_serving_tables(arrays: Dict[str, np.ndarray],
                        meta: dict, **table_kw
                        ) -> Dict[str, OnlineServingTable]:
    """Rebuild the tables from a guard generation — the piece a
    `ModelTenant.handler_factory` calls so reload AND rollback rebuild
    the serving state from whatever generation the guard files hold."""
    out: Dict[str, OnlineServingTable] = {}
    for name, tm in (meta.get("online_tables") or {}).items():
        t = OnlineServingTable(name, int(tm["dim"]), **table_kw)
        t.load_arrays(arrays.get(f"{name}::keys", np.zeros(0, np.int64)),
                      arrays.get(f"{name}::rows",
                                 np.zeros((0, int(tm["dim"])), np.float32)),
                      int(tm.get("version", 0)))
        out[name] = t
    return out


class OnlineRollbackGuard:
    """Poisoned-generation watchdog: every `interval_s` it runs
    `probe_fn()` (a validation prediction batch) and, when the output
    is non-finite or leaves `bounds`, fires `rollback_fn()` — e.g.
    `FleetRouter.rollback_model` — so the bad generation is off the
    serving path within ONE probe interval. Every decision lands in a
    DecisionLedger-style record (action / reason / evidence / outcome)
    and a telemetry event, mirroring the autoscaler's discipline."""

    def __init__(self, probe_fn: Callable[[], np.ndarray],
                 rollback_fn: Callable[[], object],
                 interval_s: float = 0.5,
                 bounds: tuple = (0.0, 1.0),
                 max_ledger: int = 256):
        self.probe_fn = probe_fn
        self.rollback_fn = rollback_fn
        self.interval_s = float(interval_s)
        self.bounds = bounds
        import collections
        self.ledger: "collections.deque" = collections.deque(
            maxlen=max_ledger)
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.rollbacks = 0
        _LIVE.add(self)

    def _record(self, action: str, reason: str, evidence: dict,
                outcome: str) -> dict:
        self._seq += 1
        entry = {"seq": self._seq, "ts": time.time(), "action": action,
                 "reason": reason, "evidence": evidence, "outcome": outcome}
        self.ledger.append(entry)
        return entry

    def check_once(self) -> bool:
        """One probe -> verdict; returns True when a rollback fired."""
        try:
            preds = np.asarray(self.probe_fn(), np.float64).reshape(-1)
        except Exception as e:  # a dead probe is a verdict, not a crash
            self._record("probe", f"probe failed: {type(e).__name__}",
                         {"error": str(e)}, "skipped")
            return False
        lo, hi = self.bounds
        finite = bool(np.isfinite(preds).all()) if len(preds) else True
        in_range = bool(((preds >= lo) & (preds <= hi)).all()) \
            if finite and len(preds) else finite
        if finite and in_range:
            return False
        fin = preds[np.isfinite(preds)]
        evidence = {"n": int(len(preds)),
                    "non_finite": int((~np.isfinite(preds)).sum()),
                    "min": float(fin.min()) if len(fin) else None,
                    "max": float(fin.max()) if len(fin) else None}
        reason = ("non-finite predictions" if not finite
                  else f"predictions outside [{lo}, {hi}]")
        try:
            result = self.rollback_fn()
            outcome = f"rolled_back:{result}"
        except Exception as e:
            outcome = f"rollback_failed:{type(e).__name__}"
        self.rollbacks += 1
        self._record("rollback", reason, evidence, outcome)
        if _monitor._ENABLED:
            _monitor.count("online.rollbacks")
        from ..obs import telemetry as _telemetry
        _telemetry.emit("online_rollback", reason=reason, **evidence)
        return True

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            self.check_once()

    def start(self) -> "OnlineRollbackGuard":
        self._thread = _syncwatch.Thread(target=self._loop, daemon=True,
                                        name="online-guard")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    close = stop   # the conftest reaper speaks close()
