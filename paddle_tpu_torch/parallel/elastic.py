"""Elastic training: lease-based membership and the gang relauncher.

Counterpart of `paddle_tpu/parallel/elastic.py` (the reference Paddle's
`fleet/elastic/manager.py:130`, ElasticManager over etcd leases, and
`elastic/__init__.py:48`, launch_elastic's restart loop), over a
`torch.distributed.TCPStore` (or any store with `set`, `get`, `add` and,
for a TCPStore, `check`):

  - each member heartbeats `lease:<rank>` = its wall time; a lease older
    than the TTL, missing, empty (`reclaim`) or unreadable is expired;
  - a new node announces itself with a join ticket (`elastic:join_seq`,
    `elastic:join:<n>`); the launcher absorbs pending tickets by
    relaunching the gang at a larger world size;
  - a member that exits non-zero stops the gang, which is relaunched as a
    unit (collective jobs cannot run degraded), up to `max_restarts`
    times; scale events cost no restart.

A TCPStore's `get` waits for a missing key until the store's timeout, so
every read of a key that may be missing goes through
`collective.store_peek` (`check` first).

Environment of each rank (the reference's contract): `PADDLE_TRAINER_ID`,
`PADDLE_TRAINERS_NUM`, `PADDLE_ELASTIC_RESTART_COUNT` (the launch's
index), `PADDLE_ELASTIC_NP`, and, new with the port, the launcher's
rendezvous of each launch (`launch.rank_envs`: a fresh endpoint per
launch, the backend, device and cards), so a script's
`init_parallel_env` brings up the gang's process world.
"""
from __future__ import annotations

import datetime
import os
import subprocess
import sys
import threading
import time
from typing import List, Optional, Sequence

from .. import faults as _faults
from .. import monitor as _monitor
from ..utils import syncwatch as _syncwatch
from .collective import store_peek


class PrefixStore:
    """One store, many planes: every key a consumer writes lands under
    its prefix."""

    def __init__(self, store, prefix: str):
        self._store = store
        self._prefix = prefix

    def set(self, key, value):
        return self._store.set(self._prefix + key, value)

    def get(self, key):
        return self._store.get(self._prefix + key)

    def add(self, key, amount):
        return self._store.add(self._prefix + key, amount)

    def check(self, keys):
        return self._store.check([self._prefix + k for k in keys])

    def wait(self, keys, timeout=None):
        keys = [self._prefix + k for k in keys]
        if timeout is None:
            return self._store.wait(keys)
        if not isinstance(timeout, datetime.timedelta):
            timeout = datetime.timedelta(seconds=float(timeout))
        return self._store.wait(keys, timeout)


def _lease_time(raw) -> Optional[float]:
    try:
        return float(raw.decode() if isinstance(raw, (bytes, bytearray))
                     else raw)
    except ValueError:
        return None


class ElasticManager:
    """Lease-based membership over a store (manager.py:130)."""

    def __init__(self, store, rank: int, world_size: int,
                 lease_ttl: float = 10.0, heartbeat_interval: float = 2.0):
        self.store = store
        self.rank = rank
        self.world_size = world_size
        self.lease_ttl = lease_ttl
        self.heartbeat_interval = heartbeat_interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # on_rank_dead: callbacks fired once per lease-expiry transition
        # (a rank that heartbeats again re-arms), from a watcher thread
        self._dead_cbs: List = []
        self._known_dead: set = set()
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None

    # ---- member side ----
    def register(self):
        self._beat()
        self._thread = _syncwatch.Thread(target=self._run, daemon=True,
                                        name="elastic-heartbeat")
        self._thread.start()
        return self

    def _beat(self):
        if _faults._ENABLED:
            _faults.check("elastic.heartbeat")
        self.store.set(f"lease:{self.rank}", repr(time.time()))

    def _run(self):
        # a transient store error must not end the heartbeats: retry at the
        # next interval, and give up only when the misses alone would have
        # expired the lease three times over
        misses = 0
        while not self._stop.wait(self.heartbeat_interval):
            try:
                self._beat()
                misses = 0
            except Exception:
                misses += 1
                if _monitor._ENABLED:
                    _monitor.count("elastic.heartbeat_errors")
                if misses * self.heartbeat_interval > self.lease_ttl * 3:
                    return

    def reclaim(self, rank: int) -> None:
        """Expire `rank`'s lease now (an empty value reads as expired), so
        membership converges without waiting out the TTL."""
        self.store.set(f"lease:{rank}", b"")

    def stop(self):
        self._stop.set()
        self._watch_stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=2)
            self._watch_thread = None

    # ---- watcher side ----
    def on_rank_dead(self, callback, interval: Optional[float] = None):
        """Register `callback(rank)`, fired once per lease-expiry
        transition of a rank that was seen alive (each counting
        `elastic.lease_expired`); the first registration starts the
        `elastic-watcher` thread, `stop()` ends it."""
        self._dead_cbs.append(callback)
        if self._watch_thread is None:
            iv = interval if interval is not None else \
                min(1.0, self.heartbeat_interval)
            self._watch_stop.clear()
            self._watch_thread = _syncwatch.Thread(
                target=self._watch_loop, args=(iv,), daemon=True,
                name="elastic-watcher")
            self._watch_thread.start()
        return self

    def _watch_loop(self, interval: float) -> None:
        ever_alive: set = set()
        while not self._watch_stop.wait(interval):
            try:
                alive = set(self.alive_ranks())
            except Exception:
                continue  # a store blip: look again at the next interval
            ever_alive |= alive
            dead = ever_alive - alive
            fresh = dead - self._known_dead
            self._known_dead = dead  # a recovered rank re-arms
            for r in sorted(fresh):
                if _monitor._ENABLED:
                    _monitor.count("elastic.lease_expired")
                for cb in list(self._dead_cbs):
                    try:
                        cb(r)
                    except Exception:
                        pass  # one bad callback must not end the watcher

    def alive_ranks(self) -> List[int]:
        now = time.time()
        alive = []
        for r in range(self.world_size):
            raw = store_peek(self.store, f"lease:{r}")
            ts = None if raw is None else _lease_time(raw)
            if ts is not None and now - ts <= self.lease_ttl:
                alive.append(r)
        return alive

    def dead_ranks(self) -> List[int]:
        alive = set(self.alive_ranks())
        return [r for r in range(self.world_size) if r not in alive]

    def watch(self, interval: float = 1.0, max_wait: Optional[float] = None):
        """Block until membership shrinks; returns the dead ranks ([] when
        `max_wait` passes first)."""
        start = time.time()
        while True:
            dead = self.dead_ranks()
            if dead:
                return dead
            if max_wait is not None and time.time() - start > max_wait:
                return []
            time.sleep(interval)

    # ---- scale-out (manager.py:215-266) ----
    def announce_join(self, node_id: str = "") -> int:
        """A new node announces itself; returns its join ticket."""
        seq = self.store.add("elastic:join_seq", 1)
        self.store.set(f"elastic:join:{seq}", f"{time.time()!r}:{node_id}")
        return seq

    def pending_joins(self, absorbed: int = 0) -> List[int]:
        """Join tickets newer than `absorbed` whose announcement is still
        fresh (within 6 lease TTLs: joiners wait for the gang)."""
        try:
            seq = int(self.store.add("elastic:join_seq", 0))  # a read
        except Exception:
            return []
        now = time.time()
        out = []
        for i in range(absorbed + 1, seq + 1):
            raw = store_peek(self.store, f"elastic:join:{i}")
            if raw is None:
                continue
            text = raw.decode() if isinstance(raw, (bytes, bytearray)) \
                else raw
            ts = _lease_time(text.split(":", 1)[0])
            if ts is not None and now - ts <= self.lease_ttl * 6:
                out.append(i)
        return out

    def watch_membership(self, interval: float = 1.0,
                         max_wait: Optional[float] = None,
                         absorbed: int = 0):
        """Block until membership changes: ('scale_in', dead_ranks),
        ('scale_out', join_tickets), or ('steady', []) after
        `max_wait`."""
        start = time.time()
        while True:
            dead = self.dead_ranks()
            if dead:
                return ("scale_in", dead)
            joins = self.pending_joins(absorbed)
            if joins:
                return ("scale_out", joins)
            if max_wait is not None and time.time() - start > max_wait:
                return ("steady", [])
            time.sleep(interval)


class ElasticResult:
    def __init__(self, restarts: int, returncodes: Sequence[int]):
        self.restarts = restarts
        self.returncodes = list(returncodes)

    @property
    def success(self) -> bool:
        return all(rc == 0 for rc in self.returncodes)


def _stop_gang(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch_elastic(training_script: str, script_args: Sequence[str] = (),
                   nprocs: int = 2, max_restarts: int = 3,
                   poll_interval: float = 0.2, env: Optional[dict] = None,
                   timeout: Optional[float] = 300.0, store=None,
                   max_np: Optional[int] = None, backend: Optional[str] = None,
                   device: Optional[str] = None, gpus=None,
                   log_dir: Optional[str] = None) -> ElasticResult:
    """Gang launcher with relaunch and scale-out (elastic/__init__.py:48,
    manager.py:215-266).

    Starts `nprocs` ranks of `training_script`, then per launch:
      - a rank exiting non-zero, or `timeout` seconds passing (None: no
        limit), stops the gang and relaunches it, up to `max_restarts`
        times;
      - with a `store`, a pending join ticket (`announce_join`) stops the
        gang and relaunches it at the world size grown by the tickets
        (capped at `max_np`), costing no restart.
    `backend`, `device` and `gpus` are the launcher's (`launch.rank_envs`:
    `gpus` must name a card for every rank up to `max_np`); with
    `log_dir` each rank appends to `workerlog.<rank>` there. Returns the
    restarts used and the last gang's exit codes."""
    from .launch import rank_envs
    base_env = dict(os.environ if env is None else env)
    watcher = ElasticManager(store, rank=-1, world_size=0) if store else None
    absorbed = 0
    attempt = 0      # failures (scale events do not count)
    launches = 0
    np_now = nprocs
    procs: List[subprocess.Popen] = []
    while attempt <= max_restarts:
        procs, logs = [], []
        for renv in rank_envs(np_now, gpus=gpus, backend=backend,
                              device=device):
            e = dict(base_env, **renv)
            e.update({"PADDLE_ELASTIC_RESTART_COUNT": str(launches),
                      "PADDLE_ELASTIC_NP": str(np_now)})
            out = None
            if log_dir:
                os.makedirs(log_dir, exist_ok=True)
                out = open(os.path.join(
                    log_dir, f"workerlog.{renv['PADDLE_TRAINER_ID']}"), "a")
                logs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, training_script, *map(str, script_args)],
                env=e, stdout=out, stderr=subprocess.STDOUT if out else None))
        launches += 1
        deadline = None if timeout is None else time.time() + timeout
        outcome = None   # the gang is stopped unless it finished
        try:
            while True:
                rcs = [p.poll() for p in procs]
                if any(rc is not None and rc != 0 for rc in rcs):
                    outcome = "failed"
                    break
                if all(rc == 0 for rc in rcs):
                    outcome = "done"
                    break
                if watcher is not None:
                    joins = watcher.pending_joins(absorbed)
                    if joins and (max_np is None or np_now < max_np):
                        outcome = "scale_out"
                        break
                if deadline is not None and time.time() > deadline:
                    outcome = "failed"
                    break
                time.sleep(poll_interval)
        finally:
            if outcome != "done":
                _stop_gang(procs)
            for f in logs:
                f.close()
        if outcome == "done":
            return ElasticResult(attempt, [p.returncode for p in procs])
        if outcome == "scale_out":
            joins = watcher.pending_joins(absorbed)
            take = joins if max_np is None else \
                joins[:max(0, max_np - np_now)]
            absorbed = max(take or [absorbed])
            np_now += len(take)
        else:
            attempt += 1
    return ElasticResult(max_restarts, [p.returncode for p in procs])


__all__ = ["PrefixStore", "ElasticManager", "ElasticResult",
           "launch_elastic"]
