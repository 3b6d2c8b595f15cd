"""PS high availability: warm-standby replication + lease failover.

Counterpart of `paddle_tpu/distributed/ps/ha.py`, over the port's store
(`torch.distributed.TCPStore`, namespaced by `parallel.elastic.
PrefixStore`; a missing key is peeked, never waited on). Industrial PS deployments pair each brpc PS shard
group with warm standbys that tail the primary's delta stream and take
over on failure. Here the same roles are built from the repo's own
primitives: the rendezvous TCPStore (namespaced via
`elastic.PrefixStore`) holds the primary record and the lease plane
(`ElasticManager`), the delta stream is the server's WAL served over
CMD_REPLICATE, and promotion is an epoch-numbered claim — the highest
epoch in the store wins, so a promotion race converges without a
consensus protocol.

Topology: one `HaPsNode` per process wraps one `PsServer`. The primary
serves trainers; each standby tails the primary's WAL (acking its
applied watermark), and promotes itself when the primary's lease
expires. `PsClient(resolver=ha.resolver(store))` re-reads the primary
record inside its retry loop, so a trainer fails over within its
original per-call deadline; in-flight pushes replay idempotently off
the replicated seq ledger. A recovered ex-primary REJOINS as the new
standby: it replays its own WAL, hands the new primary any records the
replication tail missed (CMD_HANDBACK, ledger-dedup'd), then re-anchors
on the new primary's state (CMD_FETCH_STATE) and starts tailing.
"""
from __future__ import annotations

import json
import os
import threading
import time
import weakref
from typing import List, Optional

from . import wal as _wal
from .service import (PsClient, PsError, PsServer, ha_connect,
                      rpc_fetch_state, rpc_ha_status, rpc_handback,
                      rpc_replicate)
from ... import monitor as _monitor
from ...core import flags as _flags
from ...framework.sharded_io import atomic_write
from ...parallel.collective import store_peek
from ...parallel.elastic import ElasticManager, PrefixStore
from ...utils import syncwatch as _syncwatch

__all__ = ["HaPsNode", "resolver", "connect"]

# ranks an HA group's lease watcher scans (one PS group never has more
# nodes than this; alive_ranks iterates the range)
_MAX_NODES = 16

# live HaPsNode instances, for the tests' leak checks
_LIVE = weakref.WeakSet()


def _read_json(store, key) -> Optional[dict]:
    # a TCPStore's get waits for a missing key: peek
    raw = store_peek(store, key)
    if raw is None:
        return None
    try:
        return json.loads(raw.decode() if isinstance(raw, (bytes, bytearray))
                          else raw)
    except ValueError:
        return None


def resolver(store, name: str = "ps"):
    """Endpoint resolver for `PsClient`: re-reads the current primary
    record from the rendezvous store on every call."""
    ns = PrefixStore(store, f"ps:{name}:")

    def _resolve() -> List[str]:
        rec = _read_json(ns, "primary")
        if not rec:
            return []
        return [f"{rec['host']}:{rec['port']}"]

    return _resolve


def connect(store, name: str = "ps", **kw) -> PsClient:
    """A PsClient bound to the HA group's CURRENT primary, failing over
    through the store on transport errors."""
    return PsClient(resolver=resolver(store, name), **kw)


class HaPsNode:
    """One member of an HA parameter-server group (primary or standby).

    `start()` claims the primary role if the record is absent or its
    lease is dead, otherwise bootstraps as a standby (handback + state
    fetch + replication tail). The node heartbeats its lease either way;
    a standby promotes itself on the primary's lease-expiry transition.
    """

    def __init__(self, store, name: str = "ps",
                 wal_dir: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 lease_ttl: Optional[float] = None,
                 heartbeat: Optional[float] = None):
        self._ns = PrefixStore(store, f"ps:{name}:")
        self.name = name
        self.node_id = int(self._ns.add("next_id", 1)) - 1
        self.server = PsServer(host, port, wal_dir=wal_dir)
        self.lease_ttl = float(_flags.flag("ps_ha_lease_ttl_s")
                               if lease_ttl is None else lease_ttl)
        self.heartbeat = float(_flags.flag("ps_ha_heartbeat_s")
                               if heartbeat is None else heartbeat)
        self.role: Optional[str] = None
        self.epoch = 0
        self._primary_rec: Optional[dict] = None
        self._es = ElasticManager(self._ns, rank=self.node_id,
                                  world_size=_MAX_NODES,
                                  lease_ttl=self.lease_ttl,
                                  heartbeat_interval=self.heartbeat)
        self._loop_stop = threading.Event()
        self._loop_thread: Optional[threading.Thread] = None
        self._repl_sock = None
        self._status_written = 0.0
        self._promote_lock = threading.Lock()
        self._closed = False
        _LIVE.add(self)

    # ---- lifecycle ----

    def start(self) -> "HaPsNode":
        self.server.run()
        self._ns.set(f"node:{self.node_id}",
                     json.dumps({"host": self.server.host,
                                 "port": self.server.port}))
        self._es.register()
        rec = _read_json(self._ns, "primary")
        alive = (rec is not None
                 and rec.get("rank") in self._es.alive_ranks())
        if alive:
            self._become_standby(rec)
        else:
            self._claim_primary()
        # one maintenance thread for both roles: a standby tails the
        # primary's delta stream; both roles keep ha-status.json fresh
        self._loop_thread = _syncwatch.Thread(
            target=self._loop, daemon=True, name="ps-repl-tail")
        self._loop_thread.start()
        return self

    def stop(self):
        self._loop_stop.set()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=5)
            self._loop_thread = None
        if self._repl_sock is not None:
            try:
                self._repl_sock.close()
            except OSError:
                pass
            self._repl_sock = None
        self._es.stop()
        self._write_status(force=True)
        self.server.stop()
        self._closed = True

    @property
    def endpoint(self) -> str:
        return f"{self.server.host}:{self.server.port}"

    # ---- role management ----

    def _claim_primary(self):
        """Epoch-numbered claim: take the next epoch and publish the
        record; if a concurrent claimant published a HIGHER epoch, yield
        to it (converges without consensus)."""
        self.epoch = int(self._ns.add("primary_epoch", 1))
        self._ns.set("primary", json.dumps({
            "rank": self.node_id, "host": self.server.host,
            "port": self.server.port, "epoch": self.epoch}))
        cur = _read_json(self._ns, "primary") or {}
        if int(cur.get("epoch", 0)) > self.epoch:
            return self._become_standby(cur)
        self.role = self.server.ha_role = "primary"
        self._primary_rec = None
        from ...obs import telemetry as _telemetry
        _telemetry.emit("role_change", role="primary", node=self.node_id,
                        epoch=self.epoch)
        self._write_status(force=True)

    def _become_standby(self, rec: dict):
        self.role = self.server.ha_role = "standby"
        self._primary_rec = rec
        from ...obs import telemetry as _telemetry
        _telemetry.emit("role_change", role="standby", node=self.node_id,
                        primary=rec.get("rank"))
        endpoint = f"{rec['host']}:{rec['port']}"
        sk = ha_connect(endpoint)
        try:
            if self.server.applied_lsn > 0 and self.server.wal_dir:
                # rejoining ex-primary: hand over WAL records the new
                # primary's replication tail never saw (ledger dedups)
                st = rpc_ha_status(sk)
                floor = int(st.get("handback_floor", 0))
                recs = _wal.replay(self.server.wal_dir, after_lsn=floor,
                                   count_fallback=False)
                if recs:
                    rpc_handback(sk, recs)
            # re-anchor the local durability chain on the primary's state
            self.server.reset_state()
            meta, blob = rpc_fetch_state(sk)
            self.server.install_state(meta, blob)
        finally:
            sk.close()
        # promote on the primary's lease-expiry transition (fires once;
        # re-registration for later epochs re-arms in ElasticManager)
        self._es.on_rank_dead(self._on_rank_dead,
                              interval=min(0.2, self.heartbeat))
        self._write_status(force=True)

    def _on_rank_dead(self, rank: int):
        rec = self._primary_rec
        if self.role == "standby" and rec and rank == rec.get("rank"):
            self.promote()

    def promote(self):
        """Standby -> primary: freeze the handback floor at what the
        replication tail applied, then claim the next epoch."""
        with self._promote_lock:
            if self.role != "standby":
                return
            self.server._handback_floor = self.server.applied_lsn
            self._claim_primary()
            if _monitor._ENABLED:
                _monitor.count("ps.promotions")

    # ---- maintenance loop ----

    def _loop(self):
        interval = float(_flags.flag("ps_replication_interval_ms")) / 1e3
        while not self._loop_stop.wait(interval):
            if self.role == "standby":
                self._tail_once()
            self._write_status()

    def _tail_once(self):
        rec = self._primary_rec
        if rec is None:
            return
        try:
            if self._repl_sock is None:
                self._repl_sock = ha_connect(f"{rec['host']}:{rec['port']}")
            recs = rpc_replicate(self._repl_sock,
                                 after_lsn=self.server.applied_lsn,
                                 standby_id=str(self.node_id))
            for r in recs:
                self.server.apply_replicated(r)
        except (OSError, PsError, ValueError):
            # primary unreachable: drop the socket and let the lease
            # watcher decide about promotion
            if self._repl_sock is not None:
                try:
                    self._repl_sock.close()
                except OSError:
                    pass
                self._repl_sock = None

    def _write_status(self, force: bool = False):
        """Side-file for `python -m paddle_tpu_torch.monitor ps <wal-dir>`:
        the offline renderer's view of role + replication watermark."""
        if self.server.wal_dir is None:
            return
        now = time.monotonic()
        if not force and now - self._status_written < 0.2:
            return
        self._status_written = now
        doc = {"role": self.role, "node_id": self.node_id,
               "epoch": self.epoch, "applied_lsn": self.server.applied_lsn,
               "acks": dict(self.server._repl_acks),
               "endpoint": self.endpoint}
        try:
            atomic_write(os.path.join(self.server.wal_dir, "ha-status.json"),
                         json.dumps(doc).encode())
        except OSError:
            pass
