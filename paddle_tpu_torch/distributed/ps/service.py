"""PS RPC plane: threaded socket server + sharded client + async Communicator.

Counterpart of `paddle_tpu/distributed/ps/service.py`: the same `_HDR`
header, `CMD_*` codes and frames, so the port's client talks to the
reference's servers (python and native) and back; the transport is the
port's `utils/net.py` substrate.

Reference parity: `ps/service/brpc_ps_client.h` / `brpc_ps_server.cc`
(pull/push dense+sparse RPCs), `ps/service/communicator/communicator.cc:1`
(async grad send batching), proto `sendrecv.proto`.

Redesign: brpc is replaced by a length-prefixed binary protocol over raw
sockets (the C++ TCPStore's wire style) — request header `cmd table n dim`
+ raw little-endian buffers, no pickle on the hot path. Every response
starts with a one-byte status; errors carry a message frame so server-side
failures (unknown table, barrier timeout) surface to the caller instead of
tearing the connection down. Sparse tables shard across servers by
`id % n_servers`; dense tables are row-range sharded across all
servers. Shard RPCs are issued
send-first-then-receive so a pull touches all servers in ~one RTT (the
brpc client's concurrent-request role).
"""
from __future__ import annotations

import json
import os
import random
import socket
import struct
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from . import wal as _wal
from .table import DenseTable, SparseTable
from ... import faults as _faults
from ... import monitor as _monitor
from ...core import flags as _flags
from ...obs import trace as _trace

# The PS codec reads/writes CMD_* frames on connections the substrate
# (utils/net.py RpcChannel / secure_server / dial) owns and hands out —
# those raw send/recv calls are the plane's wire format, not a bypass.
# tpu-lint: disable=raw-socket

_HDR = struct.Struct("<B16sqq")  # cmd, table name (padded), n, dim
# payload plausibility caps (the header fields are client-controlled)
_MAX_PAYLOAD_ROWS = 1 << 24      # 16M ids per request
_MAX_PAYLOAD_DIM = 1 << 16       # 64K embedding width
_MAX_PAYLOAD_ELEMS = 1 << 28     # 256M f32 elems ≈ 1 GiB
_LEN = struct.Struct("<q")
CMD_PULL_SPARSE = 1
CMD_PUSH_SPARSE = 2
CMD_PULL_DENSE = 3
CMD_PUSH_DENSE = 4
CMD_STOP = 5
CMD_BARRIER = 6
CMD_PUSH_SHOW_CLICK = 7
CMD_DECAY = 8
CMD_SHRINK = 9
CMD_ADD_SPARSE = 10      # table-config negotiation (optimizer + accessor)
CMD_ADD_DENSE = 11
CMD_SAMPLE_NEIGHBORS = 12   # graph table: ids[n] -> [n, k] ids + weights
CMD_NODE_FEAT = 13          # graph table: ids[n] -> [n, feat_dim] f32
# Resilience extension (python plane). HELLO registers the client id for
# this connection — the id rides the header's NAME field (no payload), so
# a server that predates it (the native csrc/ps_server.cpp plane) answers
# with a plain unknown-cmd error frame and the stream stays in sync; the
# client then marks the endpoint legacy and keeps using unsequenced
# pushes. Sequenced pushes prefix their payload with an i64 request seq;
# the server applies each (client, seq) AT MOST ONCE, so a push retried
# after a lost ACK cannot double-apply the gradient.
CMD_HELLO = 14              # client id in the name field, no payload
CMD_PUSH_SPARSE_SEQ = 15    # i64 seq + CMD_PUSH_SPARSE payload
CMD_PUSH_DENSE_SEQ = 16     # i64 seq + CMD_PUSH_DENSE payload
# Durability/HA extension. REPLICATE streams the WAL delta
# records after a watermark to a tailing standby (and doubles as the
# standby's ack: the watermark it sends IS its applied lsn). HA_STATUS
# returns a JSON role/watermark document; HANDBACK lets a recovered
# ex-primary hand the new primary any WAL records the replication tail
# missed (dedup'd by the seq ledger); FETCH_STATE is the full-state
# bootstrap a rejoining standby anchors its own WAL on.
CMD_PUSH_SHOW_CLICK_SEQ = 17  # i64 seq + CMD_PUSH_SHOW_CLICK payload
CMD_REPLICATE = 18            # i64 after_lsn + i64 max_records
CMD_HA_STATUS = 19            # no payload -> JSON frame
CMD_HANDBACK = 20             # i64 blob_len + concatenated records
CMD_FETCH_STATE = 21          # no payload -> meta JSON + npz blob
# delta-push plane (delta.py): a serving replica tails a sparse table's
# embedding ROWS (values, not optimizer slots) watermarked by commit lsn
CMD_DELTA = 22                # i64 after_lsn + i64 max_rows + subscriber id

from .table import OPT_WIRE_IDS as _OPT_IDS  # single source, both planes
_SPARSE_CFG = struct.Struct("<ffqBBfffffff")   # lr,std,seed,opt,ctr,b1,b2,eps,sdec,ccoef,dth,ttl
_DENSE_CFG = struct.Struct("<fqqBfff")          # lr,shard_lo,total,opt,b1,b2,eps
_ST_OK = b"\x01"
_ST_ERR = b"\x00"

_BARRIER_TIMEOUT = 60.0


class PsError(RuntimeError):
    """Server-reported request failure (carried in an error frame)."""


class CommunicatorFlushTimeout(TimeoutError):
    """`Communicator.flush` deadline expired with work still queued.
    The undelivered batches are NOT dropped: they stay parked with
    their original seqs and the next flush()/stop() delivers them."""

    def __init__(self, msg: str, pending: int = 0):
        super().__init__(msg)
        self.pending = pending


from ...utils import net as _net  # noqa: E402
from ...utils.net import recv_exact as _recv_exact  # noqa: E402
from ...utils import syncwatch as _syncwatch


def _tname(name: str) -> bytes:
    b = name.encode()
    if len(b) > 16:
        raise ValueError(
            f"ps table name {name!r} exceeds the 16-byte wire limit")
    return b.ljust(16, b"\0")


def _send_err(conn, msg: str):
    m = msg.encode()
    conn.sendall(_ST_ERR + _LEN.pack(len(m)) + m)


def _check_status(sock, deadline: Optional[float] = None):
    """Read the response status byte; raise PsError on an error frame.
    `deadline` (absolute monotonic) bounds the wait on a stalled peer."""
    st = _recv_exact(sock, 1, deadline)
    if st == _ST_OK:
        return
    (ln,) = _LEN.unpack(_recv_exact(sock, 8, deadline))
    raise PsError(_recv_exact(sock, ln, deadline).decode())


# live PsServer instances, for the tests' leak checks
_LIVE = weakref.WeakSet()


class PsServer:
    """One parameter-server process/thread (brpc_ps_server role).

    With `wal_dir` (or `FLAGS_ps_wal_dir`) set, every mutating request is
    committed to a CRC-framed write-ahead log BEFORE it touches a table,
    and `snapshot()` compacts the log into a crash-atomic generation (see
    `wal.py`). Construction over an existing wal_dir RECOVERS: newest
    intact snapshot + WAL replay, dedup'd by the persisted seq ledger, so
    a trainer retry replayed across the crash is still exactly-once.
    """

    def __init__(self, host="127.0.0.1", port=0, wal_dir: Optional[str] = None):
        self._tables: Dict[str, object] = {}
        # table name -> (kind, constructor cfg): rides the snapshot
        # manifest so recovery can rebuild tables before loading arrays
        self._cfgs: Dict[str, tuple] = {}
        self._sock = _net.make_listener(host, port, backlog=64)
        self.host, self.port = self._sock.getsockname()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # open handler connections, so stop() can close them out from
        # under blocked recv_exact calls instead of leaking the threads
        self._conns: "weakref.WeakSet[socket.socket]" = weakref.WeakSet()
        # generation-counted barrier: CMD_BARRIER carries n participants;
        # the ACK is held until all n arrive (gloo-barrier role)
        self._barrier_cond = threading.Condition()
        self._barrier_arrived = 0
        self._barrier_gen = 0
        # at-most-once push ledger: (client id, request seq) applied set.
        # Floor+extras (wal.SeqLedger), NOT a monotonic high-water mark:
        # after a failover, a handed-back seq can arrive BELOW seqs the
        # new primary already applied and must still apply exactly once.
        self._ledger = _wal.SeqLedger()
        self._seq_lock = _syncwatch.lock("ps.PsServer._seq_lock")
        # ---- durability plane ----
        if wal_dir is None:
            wal_dir = str(_flags.flag("ps_wal_dir")) or None
        self.wal_dir = wal_dir
        self._wal: Optional[_wal.WalWriter] = None
        self._wal_lock = _syncwatch.lock("ps.PsServer._wal_lock")
        self._snap_lock = _syncwatch.lock("ps.PsServer._snap_lock")
        self._commits_since_snap = 0
        self._snap_every = int(_flags.flag("ps_snapshot_every_records"))
        self._snap_skip_warned = False
        # ---- HA plane (driven by ha.HaPsNode; inert otherwise) ----
        self.ha_role: Optional[str] = None
        self._repl_acks: Dict[str, int] = {}   # standby id -> acked lsn
        self._handback_floor = 0
        self.applied_lsn = 0
        # ---- delta-push plane (serving subscribers; see delta.py) ----
        # table -> key -> version of the commit that last touched the
        # row (value-shipping: the delta response reads the CURRENT row,
        # so a conservative extra mark is harmless, never wrong)
        self._delta_dirty: Dict[str, Dict[int, int]] = {}
        self._delta_acks: Dict[str, int] = {}  # subscriber id -> acked ver
        # subscribers at/below this watermark get a full-table resync:
        # mutations up to here predate the dirty map (recovery, install)
        self._delta_floor = 0
        self._delta_seq = 0   # version counter for WAL-less servers
        if wal_dir is not None:
            self._recover()
        self._closed = False
        _LIVE.add(self)

    # ---- durable state: recovery, commit, snapshot ----

    def _recover(self):
        """snapshot + WAL replay -> tables/ledger; then open the writer
        right after the last intact record (`wal.repair` truncates a torn
        tail so the next recovery can read past this session's appends)."""
        snap = _wal.load_snapshot(self.wal_dir)
        after = 0
        if snap is not None:
            for name, (kind, cfg) in snap.tables.items():
                self._install_table(name, kind, cfg)
            per_table: Dict[str, dict] = {}
            for key, arr in snap.arrays.items():
                tname, field = key.split("::", 1)
                per_table.setdefault(tname, {})[field] = arr
            for tname, arrs in per_table.items():
                self._tables[tname].load_arrays(arrs)
            self._ledger.load_state(snap.ledger)
            after = snap.lsn
        last = max(after, _wal.repair(self.wal_dir))
        for rec in _wal.replay(self.wal_dir, after_lsn=after):
            self._apply_record(rec)
            if _monitor._ENABLED:
                _monitor.count("ps.wal.records_replayed")
        self._wal = _wal.WalWriter(self.wal_dir, start_lsn=last + 1)
        self.applied_lsn = last
        # replayed mutations are not in the dirty map: any subscriber
        # whose watermark predates recovery needs a full resync
        self._delta_floor = last

    def _apply_record(self, rec: "_wal.Record"):
        """Apply one WAL record to the in-memory tables (recovery replay
        AND the standby's replication tail). Seq-stamped records go
        through the ledger: a delta that both reached the snapshot and
        survived in the log applies exactly once. A record whose apply
        raised live (e.g. decay on a dense table) raised BEFORE it was
        acked, so apply errors here are skipped, deterministically on
        every replica."""
        if rec.seq >= 0 and rec.client:
            with self._seq_lock:
                if not self._ledger.record(rec.client, rec.seq):
                    return False
        return self._apply_payload(rec)

    def _apply_payload(self, rec: "_wal.Record") -> bool:
        """Decode + apply one record's payload, WITHOUT the ledger check
        (callers own dedup). Exception-tolerant by contract — see
        `_apply_record`. True = applied."""
        try:
            if rec.rtype in (_wal.R_ADD_SPARSE, _wal.R_ADD_DENSE,
                             _wal.R_ADD_GRAPH):
                # idempotent on replay/handback: re-registering must NOT
                # clobber a live table with a fresh one
                if rec.table not in self._tables:
                    kind = {_wal.R_ADD_SPARSE: "sparse",
                            _wal.R_ADD_DENSE: "dense",
                            _wal.R_ADD_GRAPH: "graph"}[rec.rtype]
                    self._install_table(rec.table, kind,
                                        json.loads(rec.payload.decode()))
            elif rec.rtype == _wal.R_PUSH_SPARSE:
                ids, grads = _wal.unpack_push_sparse(rec.payload)
                self._tables[rec.table].push(ids, grads)
            elif rec.rtype == _wal.R_PUSH_DENSE:
                tbl = self._tables[rec.table]
                self._tables[rec.table].push(
                    _wal.unpack_push_dense(rec.payload).reshape(tbl.w.shape))
            elif rec.rtype == _wal.R_SHOW_CLICK:
                ids, shows, clicks = _wal.unpack_show_click(rec.payload)
                self._tables[rec.table].push_show_click(ids, shows, clicks)
            elif rec.rtype == _wal.R_DECAY:
                self._tables[rec.table].decay()
            elif rec.rtype == _wal.R_SHRINK:
                self._tables[rec.table].shrink()
        except (KeyError, ValueError, AttributeError, TypeError) as e:
            import warnings
            warnings.warn(f"ps wal replay: skipping lsn {rec.lsn} "
                          f"({type(e).__name__}: {e})")
            return False
        return True

    def _commit(self, rtype: int, name: str, client: Optional[str],
                seq: Optional[int], payload_fn: Callable[[], bytes],
                apply_fn: Callable[[], object], delta_ids=None):
        """The one mutating-request path: dedup -> WAL append -> apply,
        atomically w.r.t. snapshot collection (`_wal_lock`). Returns the
        apply result, or None for a deduplicated retry. Without a WAL the
        dedup + apply semantics are those of the plain server.

        `delta_ids` names the sparse keys whose ROWS this commit may
        change (an id array, or a callable evaluated AFTER the apply —
        shrink only knows its evictions afterwards); they are stamped
        with the commit's version so delta subscribers pick them up."""
        if self._wal is None:
            if seq is not None and client:
                with self._seq_lock:
                    if not self._ledger.record(client, seq):
                        return None
            out = apply_fn()
            if delta_ids is not None:
                with self._wal_lock:
                    self._delta_seq += 1
                    self._mark_delta(name, delta_ids, self._delta_seq)
            return out
        with self._wal_lock:
            if seq is not None and client:
                with self._seq_lock:
                    if not self._ledger.record(client, seq):
                        return None
            lsn = self._wal.append(rtype, name, client or "",
                                   -1 if seq is None else seq, payload_fn())
            out = apply_fn()
            self.applied_lsn = lsn
            if delta_ids is not None:
                self._mark_delta(name, delta_ids, lsn)
            self._commits_since_snap += 1
        self._maybe_autosnapshot()
        return out

    def _mark_delta(self, name: str, ids, version: int) -> None:
        """Stamp keys dirty at `version` (caller holds `_wal_lock`)."""
        if callable(ids):
            ids = ids()
        if len(ids) == 0:
            return
        dirty = self._delta_dirty.setdefault(name, {})
        for k in ids:
            dirty[int(k)] = version

    def _delta_version(self) -> int:
        """Head of the delta stream: the WAL lsn when durable, a local
        commit counter otherwise (both monotonic per server lifetime)."""
        return self.applied_lsn if self._wal is not None else self._delta_seq

    def _maybe_autosnapshot(self):
        if not self._snap_every or self._commits_since_snap < self._snap_every:
            return
        try:
            self.snapshot()
        except _wal.PsSnapshotUnsupportedError:
            # a table type without a snapshot representation is
            # registered: auto-compaction cannot cover it, and a
            # serving-path push must never error for that
            if not self._snap_skip_warned:
                self._snap_skip_warned = True
                import warnings
                warnings.warn("ps: auto-snapshot skipped — a registered "
                              "table has no snapshot representation")
            self._commits_since_snap = 0
        except Exception:
            # a failed compaction (crashed mid-commit, disk error) must
            # not fail the push that tripped it: the WAL already holds
            # the commit, recovery falls back past an orphaned payload,
            # and the NEXT snapshot interval retries the compaction
            if _monitor._ENABLED:
                _monitor.count("ps.snapshot.failures")
            self._commits_since_snap = 0

    def collect_state(self):
        """Frozen (lsn, ledger, cfgs, arrays) under the commit lock —
        the payload for snapshot() and CMD_FETCH_STATE."""
        with self._wal_lock:
            for name, tbl in self._tables.items():
                if name not in self._cfgs:
                    raise _wal.PsSnapshotUnsupportedError(
                        f"ps: table {name!r} ({type(tbl).__name__}) has no "
                        "snapshot representation")
            with self._seq_lock:
                ledger = self._ledger.state()
            arrays = {}
            for name, tbl in self._tables.items():
                for field, arr in tbl.snapshot_arrays().items():
                    arrays[f"{name}::{field}"] = arr
            lsn = self.applied_lsn if self._wal is not None else 0
            self._commits_since_snap = 0
            return lsn, ledger, dict(self._cfgs), arrays

    def snapshot(self) -> int:
        """Compact the WAL into one crash-atomic generation; returns the
        new version. Graph tables ride along via `snapshot_arrays` (their
        content never hits the per-edge WAL — registration does, so a
        pre-snapshot crash recovers an empty-but-present graph). Raises
        PsSnapshotUnsupportedError when a registered table has no
        snapshot representation — never silent loss."""
        if self.wal_dir is None:
            raise ValueError("ps: snapshot() needs a wal_dir")
        with self._snap_lock:
            lsn, ledger, cfgs, arrays = self.collect_state()
            version = _wal.save_snapshot(self.wal_dir, lsn, ledger,
                                         cfgs, arrays)
            self._wal.sync()
            # drop segments every durable consumer is past: the FALLBACK
            # generation (previous manifest lsn) and every standby ack
            floor = min([lsn] + list(self._repl_acks.values()))
            prev = _wal._read_json(
                os.path.join(self.wal_dir, _wal._MANIFEST) + ".bak")
            if prev:
                floor = min(floor, int(prev.get("lsn", 0)))
            _wal.gc_segments(self.wal_dir, floor + 1)
            return version

    # ---- table registration ----

    def _install_table(self, name, kind, cfg):
        _tname(name)  # validate against the wire limit at registration
        if kind == "sparse":
            self._tables[name] = SparseTable(**cfg)
        elif kind == "dense":
            cfg = dict(cfg)
            shape = tuple(cfg.pop("shape"))
            self._tables[name] = DenseTable(shape, **cfg)
        elif kind == "graph":
            from .graph_table import GraphTable
            self._tables[name] = GraphTable(**cfg)
        else:
            raise ValueError(f"ps: unknown table kind {kind!r}")
        self._cfgs[name] = (kind, dict(cfg, shape=list(shape))
                            if kind == "dense" else cfg)
        return self._tables[name]

    def _log_add(self, rtype, name, cfg):
        if self._wal is not None:
            payload = json.dumps(cfg).encode()
            with self._wal_lock:
                self.applied_lsn = self._wal.append(rtype, name, "", -1,
                                                    payload)

    def add_sparse_table(self, name, dim, **kw):
        cfg = dict(kw, dim=dim)
        tbl = self._install_table(name, "sparse", cfg)
        self._log_add(_wal.R_ADD_SPARSE, name, cfg)
        return tbl

    def add_dense_table(self, name, shape, **kw):
        cfg = dict(kw, shape=list(np.atleast_1d(np.asarray(shape)).tolist())
                   if not np.isscalar(shape) else [int(shape)])
        tbl = self._install_table(name, "dense", cfg)
        self._log_add(_wal.R_ADD_DENSE, name, self._cfgs[name][1])
        return tbl

    def add_graph_table(self, name, **kw):
        # graph edges/features stay OUTSIDE the WAL record stream
        # (load-once read-only state, no per-edge commits) but ride the
        # snapshot/fetch-state plane via GraphTable.snapshot_arrays, so
        # recovery and standby bootstrap carry the feature source too
        tbl = self._install_table(name, "graph", kw)
        self._log_add(_wal.R_ADD_GRAPH, name, kw)
        return tbl

    def table(self, name):
        return self._tables[name]

    def run(self, block=False):
        self._thread = _syncwatch.Thread(target=self._serve, daemon=True,
                                        name="ps-serve")
        self._thread.start()
        if block:
            self._thread.join()
        return self

    def _serve(self):
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                # one flag flip secures the PS plane: TLS + 'PDAH' auth,
                # unauthenticated peers rejected + counted
                conn = _net.secure_server(conn, "ps")
            except (_net.AuthError, OSError, ValueError):
                continue
            _syncwatch.Thread(target=self._handle, args=(conn,),
                             daemon=True, name="ps-handler").start()

    def _barrier(self, n_participants: int):
        with self._barrier_cond:
            gen = self._barrier_gen
            self._barrier_arrived += 1
            if self._barrier_arrived >= max(n_participants, 1):
                self._barrier_arrived = 0
                self._barrier_gen += 1
                self._barrier_cond.notify_all()
                return
            if not self._barrier_cond.wait_for(
                    lambda: self._barrier_gen != gen,
                    timeout=_BARRIER_TIMEOUT):
                # roll back our arrival so later generations aren't corrupted
                if self._barrier_gen == gen:
                    self._barrier_arrived -= 1
                raise PsError(
                    f"barrier timed out after {_BARRIER_TIMEOUT}s "
                    f"({n_participants} participants expected)")

    def _handle(self, conn):
        client_id: Optional[str] = None   # set by CMD_HELLO, per connection
        self._conns.add(conn)
        try:
            while True:
                # recv_head strips an optional 'PDDL' deadline prefix and
                # DROPS already-expired work (DeadlineExpiredError lands
                # in the outer except: connection closed, nothing computed)
                hdr, _req_deadline = _net.recv_head(conn, _HDR.size,
                                                    plane="ps")
                cmd, name, n, dim = _HDR.unpack(hdr)
                name = name.rstrip(b"\0").decode()
                if _faults._ENABLED:
                    # injected conn_reset lands in the outer except and
                    # drops this handler's connection — the server stays
                    # up, the client reconnects and retries
                    _faults.check("ps.server")
                # bound the (client-controlled) payload size before any
                # allocation: a corrupt/hostile header must produce an
                # error frame + connection drop, not a multi-GB buffer or
                # a dead handler thread
                if not (0 <= n <= _MAX_PAYLOAD_ROWS
                        and 0 <= dim <= _MAX_PAYLOAD_DIM
                        and n * max(dim, 1) <= _MAX_PAYLOAD_ELEMS):
                    _send_err(conn, f"ps: implausible header n={n} "
                                    f"dim={dim}")
                    return
                # read the FULL request payload before processing so an
                # error reply leaves the stream in sync for the next request
                ids = grads = None
                req_seq = None
                repl_args = blob = None
                if cmd == CMD_PUSH_SPARSE_SEQ:
                    (req_seq,) = _LEN.unpack(_recv_exact(conn, 8))
                    cmd = CMD_PUSH_SPARSE
                elif cmd == CMD_PUSH_DENSE_SEQ:
                    (req_seq,) = _LEN.unpack(_recv_exact(conn, 8))
                    cmd = CMD_PUSH_DENSE
                elif cmd == CMD_PUSH_SHOW_CLICK_SEQ:
                    (req_seq,) = _LEN.unpack(_recv_exact(conn, 8))
                    cmd = CMD_PUSH_SHOW_CLICK
                if cmd == CMD_REPLICATE:
                    repl_args = _LEN.unpack(_recv_exact(conn, 8)) \
                        + _LEN.unpack(_recv_exact(conn, 8))
                elif cmd == CMD_DELTA:
                    after_v = _LEN.unpack(_recv_exact(conn, 8))[0]
                    max_rows = _LEN.unpack(_recv_exact(conn, 8))[0]
                    (slen,) = _LEN.unpack(_recv_exact(conn, 8))
                    if not 0 <= slen <= 256:
                        _send_err(conn, f"ps: implausible subscriber id "
                                        f"length {slen}")
                        return
                    repl_args = (after_v, max_rows,
                                 _recv_exact(conn, slen).decode())
                elif cmd == CMD_HANDBACK:
                    (blen,) = _LEN.unpack(_recv_exact(conn, 8))
                    if not 0 <= blen <= 4 * _MAX_PAYLOAD_ELEMS:
                        _send_err(conn, f"ps: implausible handback {blen}")
                        return
                    blob = _recv_exact(conn, blen)
                if cmd == CMD_PULL_SPARSE:
                    ids = np.frombuffer(_recv_exact(conn, 8 * n), np.int64)
                elif cmd == CMD_PUSH_SPARSE:
                    ids = np.frombuffer(_recv_exact(conn, 8 * n), np.int64)
                    grads = np.frombuffer(
                        _recv_exact(conn, 4 * n * dim), np.float32
                    ).reshape(n, dim)
                elif cmd == CMD_PUSH_DENSE:
                    grads = np.frombuffer(_recv_exact(conn, 4 * n), np.float32)
                elif cmd == CMD_PUSH_SHOW_CLICK:
                    ids = np.frombuffer(_recv_exact(conn, 8 * n), np.int64)
                    grads = np.frombuffer(
                        _recv_exact(conn, 4 * n * 2), np.float32)
                elif cmd == CMD_ADD_SPARSE:
                    cfg_raw = _recv_exact(conn, _SPARSE_CFG.size)
                elif cmd == CMD_ADD_DENSE:
                    cfg_raw = _recv_exact(conn, _DENSE_CFG.size)
                elif cmd in (CMD_SAMPLE_NEIGHBORS, CMD_NODE_FEAT):
                    ids = np.frombuffer(_recv_exact(conn, 8 * n), np.int64)
                try:
                    if cmd == CMD_STOP:
                        conn.sendall(_ST_OK)
                        self._stop.set()
                        return
                    if cmd == CMD_BARRIER:
                        self._barrier(int(n))
                        conn.sendall(_ST_OK)
                        continue
                    if cmd == CMD_HELLO:
                        client_id = name
                        conn.sendall(_ST_OK)
                        continue
                    if req_seq is not None and client_id is None:
                        raise PsError("ps: sequenced push before CMD_HELLO")
                    if cmd == CMD_REPLICATE:
                        self._serve_replicate(conn, name, *repl_args)
                        continue
                    if cmd == CMD_DELTA:
                        from . import delta as _delta
                        _delta.serve_delta(self, conn, name, *repl_args)
                        continue
                    if cmd == CMD_HA_STATUS:
                        doc = json.dumps(self.ha_status()).encode()
                        conn.sendall(_ST_OK + _LEN.pack(len(doc)) + doc)
                        continue
                    if cmd == CMD_HANDBACK:
                        applied = self._serve_handback(blob)
                        conn.sendall(_ST_OK + _LEN.pack(applied))
                        continue
                    if cmd == CMD_FETCH_STATE:
                        self._serve_fetch_state(conn)
                        continue
                    if cmd == CMD_ADD_SPARSE:
                        (lr, istd, seed, opt, ctr, b1, b2, eps, sdec, ccoef,
                         dth, ttl) = _SPARSE_CFG.unpack(cfg_raw)
                        if name in self._tables:
                            raise ValueError(
                                f"ps: table {name!r} already registered")
                        opt_name = {0: "sgd", 1: "adagrad", 2: "adam"}[opt]
                        kw = {}
                        if ctr:
                            kw = dict(accessor="ctr", show_decay_rate=sdec,
                                      click_coeff=ccoef,
                                      delete_threshold=dth, ttl_days=ttl)
                        self.add_sparse_table(
                            name, int(dim), optimizer=opt_name, lr=lr,
                            init_std=istd, seed=int(seed), beta1=b1,
                            beta2=b2, eps=eps, **kw)
                        conn.sendall(_ST_OK)
                        continue
                    if cmd == CMD_ADD_DENSE:
                        lr, lo, total, opt, b1, b2, eps = \
                            _DENSE_CFG.unpack(cfg_raw)
                        if name in self._tables:
                            raise ValueError(
                                f"ps: table {name!r} already registered")
                        opt_name = {0: "sgd", 1: "adagrad", 2: "adam"}[opt]
                        self.add_dense_table(name, (int(n),),
                                             optimizer=opt_name, lr=lr,
                                             beta1=b1, beta2=b2, eps=eps,
                                             shard_lo=int(lo),
                                             total_size=int(total) if
                                             total > 0 else int(n))
                        conn.sendall(_ST_OK)
                        continue
                    tbl = self._tables.get(name)
                    if tbl is None:
                        raise KeyError(f"ps: unknown table {name!r}")
                    if cmd == CMD_PULL_SPARSE:
                        rows = tbl.pull(ids)
                        conn.sendall(_ST_OK + rows.astype(np.float32).tobytes())
                    elif cmd == CMD_PUSH_SPARSE:
                        self._commit(
                            _wal.R_PUSH_SPARSE, name, client_id, req_seq,
                            lambda: _wal.pack_push_sparse(ids, grads),
                            lambda: tbl.push(ids, grads), delta_ids=ids)
                        conn.sendall(_ST_OK)
                    elif cmd == CMD_PULL_DENSE:
                        w = tbl.pull().astype(np.float32)
                        lo, _hi = getattr(tbl, "shard_range", (0, w.size))
                        total = getattr(tbl, "total_size", w.size)
                        # slice + (offset, total) so the client can verify
                        # the shards tile exactly one table
                        conn.sendall(_ST_OK + _LEN.pack(w.size)
                                     + _LEN.pack(lo) + _LEN.pack(total)
                                     + w.tobytes())
                    elif cmd == CMD_PUSH_DENSE:
                        self._commit(
                            _wal.R_PUSH_DENSE, name, client_id, req_seq,
                            lambda: _wal.pack_push_dense(grads),
                            lambda: tbl.push(grads.reshape(tbl.w.shape)))
                        conn.sendall(_ST_OK)
                    elif cmd == CMD_PUSH_SHOW_CLICK:
                        self._commit(
                            _wal.R_SHOW_CLICK, name, client_id, req_seq,
                            lambda: _wal.pack_show_click(
                                ids, grads[:n], grads[n:]),
                            lambda: tbl.push_show_click(
                                ids, grads[:n], grads[n:]))
                        conn.sendall(_ST_OK)
                    elif cmd == CMD_DECAY:
                        # decay/shrink carry no client seq: durable but
                        # at-least-once across a handback (documented)
                        self._commit(_wal.R_DECAY, name, None, None,
                                     lambda: b"", tbl.decay)
                        conn.sendall(_ST_OK)
                    elif cmd == CMD_SHRINK:
                        # tombstones are only known after the apply, so
                        # the mark is a callable over the table's record
                        evicted = self._commit(
                            _wal.R_SHRINK, name, None, None, lambda: b"",
                            tbl.shrink,
                            delta_ids=lambda: getattr(
                                tbl, "last_shrink_evicted", ()))
                        conn.sendall(_ST_OK + _LEN.pack(int(evicted)))
                    elif cmd == CMD_SAMPLE_NEIGHBORS:
                        nb, w = tbl.sample_neighbors(ids, int(dim))
                        conn.sendall(_ST_OK + nb.astype(np.int64).tobytes()
                                     + w.astype(np.float32).tobytes())
                    elif cmd == CMD_NODE_FEAT:
                        f = tbl.get_node_feat(ids).astype(np.float32)
                        conn.sendall(_ST_OK + _LEN.pack(f.shape[1])
                                     + f.tobytes())
                    else:
                        raise ValueError(f"ps: unknown command {cmd}")
                except (KeyError, ValueError, PsError, AttributeError,
                        TypeError) as e:
                    # AttributeError/TypeError: a table-op aimed at a table
                    # type without that surface (e.g. DECAY on a dense
                    # table) must produce a protocol error frame — the C++
                    # server answers the same request with one
                    _send_err(conn, str(e))
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    # ---- HA verbs (server side; driven by ha.HaPsNode + PsClient) ----

    def _serve_replicate(self, conn, standby_id: str, after_lsn: int,
                         max_records: int):
        """Stream WAL records with lsn > after_lsn to a tailing standby.
        The request watermark doubles as the standby's ack — segment GC
        and the bounded-staleness guarantee key off it. Reads happen
        under the commit lock so a record mid-append is never torn."""
        if self._wal is None:
            raise PsError("ps: replication needs a wal_dir")
        if standby_id:
            self._repl_acks[standby_id] = int(after_lsn)
        with self._wal_lock:
            recs = _wal.replay(self.wal_dir, after_lsn=int(after_lsn),
                               max_records=int(max_records) or None,
                               count_fallback=False)
            frames = [_wal.encode_record(r) for r in recs]
        blen = sum(len(f) for f in frames)
        # scatter-gather: the already-encoded records go to the kernel
        # as-is instead of being re-joined into one blob copy
        _net.send_frames(conn, [_ST_OK + _LEN.pack(len(recs))
                                + _LEN.pack(blen)] + frames)

    def ha_status(self) -> dict:
        return {"role": self.ha_role, "applied_lsn": self.applied_lsn,
                "handback_floor": self._handback_floor,
                "acks": dict(self._repl_acks),
                "wal": self.wal_dir is not None}

    def _serve_handback(self, blob: bytes) -> int:
        """A recovered ex-primary hands over WAL records the replication
        tail never saw (lsn > our handback floor). Each is committed as a
        FRESH record in our own stream; the seq ledger drops anything the
        client base already re-pushed after failover — exactly-once
        either way the race lands."""
        applied = 0
        for rec in _wal.decode_stream(blob):
            if rec.lsn <= self._handback_floor:
                continue
            if (rec.rtype in (_wal.R_ADD_SPARSE, _wal.R_ADD_DENSE,
                              _wal.R_ADD_GRAPH)
                    and rec.table in self._tables):
                continue   # already registered: no duplicate WAL record
            out = self._commit(rec.rtype, rec.table, rec.client or None,
                               rec.seq if rec.seq >= 0 else None,
                               lambda: rec.payload,
                               lambda: self._apply_payload(rec),
                               delta_ids=lambda rec=rec:
                                   self._delta_ids_for(rec))
            if out:
                applied += 1
        if applied and _monitor._ENABLED:
            _monitor.count("ps.handback.records", applied)
        return applied

    def _serve_fetch_state(self, conn):
        """Full-state bootstrap for a rejoining standby: frozen meta
        (lsn + ledger + table configs) and an npz blob of every array."""
        import io
        lsn, ledger, cfgs, arrays = self.collect_state()
        meta = json.dumps({"lsn": lsn, "ledger": ledger,
                           "tables": cfgs}).encode()
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        blob = buf.getbuffer()
        _net.send_frames(conn, [_ST_OK + _LEN.pack(len(meta)) + meta
                                + _LEN.pack(blob.nbytes), blob])

    def delta_since(self, name: str, after_version: int, max_rows: int = 0,
                    subscriber: str = ""):
        """The delta-push plane's read side (CMD_DELTA; see delta.py).

        Returns `(version, dim, full, live_keys, rows, dead_keys)` —
        every sparse ROW touched by a commit after `after_version`
        (values only, never optimizer slots), plus tombstones for
        evicted keys. `full=True` (watermark below the resync floor —
        a fresh subscriber, or this server recovered/installed state)
        means the payload is the WHOLE table and the subscriber must
        replace, not merge. `max_rows` cuts the incremental path on a
        version boundary only — the returned watermark is always safe
        to resume from. The request watermark doubles as the
        subscriber's ack: tombstones every subscriber has passed are
        dropped. Runs under the commit lock, so a row mid-push is
        never shipped torn."""
        tbl = self._tables.get(name)
        if not isinstance(tbl, SparseTable):
            raise PsError(f"ps: delta stream needs a sparse table, "
                          f"{name!r} is {type(tbl).__name__}")
        after = int(after_version)
        with self._wal_lock:
            if subscriber:
                self._delta_acks[subscriber] = after
            version = self._delta_version()
            if after < self._delta_floor:
                with tbl._lock:
                    live = list(tbl._rows.keys())
                    block = self._stack_rows(
                        [tbl._rows[k] for k in live], tbl.dim)
                return version, tbl.dim, True, live, block, []
            dirty = self._delta_dirty.get(name, {})
            items = sorted((ver, k) for k, ver in dirty.items()
                           if ver > after)
            if max_rows and len(items) > max_rows:
                cut = int(max_rows)
                edge = items[cut - 1][0]
                while cut < len(items) and items[cut][0] == edge:
                    cut += 1   # never split one commit across pulls
                items = items[:cut]
                version = items[-1][0]
            live, dead, rows = [], [], []
            with tbl._lock:
                for _ver, k in items:
                    r = tbl._rows.get(k)
                    if r is None:
                        dead.append(k)
                    else:
                        live.append(k)
                        rows.append(r)
                block = self._stack_rows(rows, tbl.dim)
            if self._delta_acks:
                floor = min(self._delta_acks.values())
                stale = [k for k, ver in dirty.items()
                         if ver <= floor and k not in tbl._rows]
                for k in stale:
                    del dirty[k]
            return version, tbl.dim, False, live, block, dead

    @staticmethod
    def _stack_rows(rows, dim) -> np.ndarray:
        if not rows:
            return np.zeros((0, dim), np.float32)
        return np.stack(rows).astype(np.float32, copy=False)

    def _delta_ids_for(self, rec: "_wal.Record"):
        """Sparse keys whose rows a replicated/handed-back record may
        have changed (evaluated AFTER the record applied). Stats-only
        records (show/click, decay) leave embedding rows untouched."""
        if rec.rtype == _wal.R_PUSH_SPARSE:
            ids, _ = _wal.unpack_push_sparse(rec.payload)
            return ids
        if rec.rtype == _wal.R_SHRINK:
            tbl = self._tables.get(rec.table)
            return getattr(tbl, "last_shrink_evicted", ()) if tbl else ()
        return ()

    def apply_replicated(self, rec: "_wal.Record"):
        """Standby-side: persist one replicated record under its ORIGINAL
        lsn (both WALs carry the identical stream), then apply through
        the same ledger/dedup discipline as the primary."""
        with self._wal_lock:
            if self._wal is not None:
                self._wal.append_record(rec)
            self._apply_record(rec)
            self.applied_lsn = rec.lsn
            self._mark_delta(rec.table, self._delta_ids_for(rec), rec.lsn)
            self._commits_since_snap += 1
        if _monitor._ENABLED:
            _monitor.count("ps.replication.records")
        self._maybe_autosnapshot()

    def reset_state(self):
        """Drop every table, the ledger, and the local WAL directory —
        the rejoin flow calls this after handback, right before anchoring
        on the new primary's `install_state` payload."""
        with self._wal_lock:
            if self._wal is not None:
                self._wal.close()
                self._wal = None
            self._tables.clear()
            self._cfgs.clear()
            with self._seq_lock:
                self._ledger = _wal.SeqLedger()
            self.applied_lsn = 0
            self._delta_dirty.clear()
            self._delta_floor = 0
            self._delta_seq = 0
            if self.wal_dir is not None:
                _wal.wipe(self.wal_dir)

    def install_state(self, meta: dict, blob: bytes):
        """Install a `_serve_fetch_state` payload and anchor the local
        durability chain on it: the state becomes snapshot generation 1
        at the primary's lsn, and the WAL writer opens at lsn + 1."""
        import io
        npz = np.load(io.BytesIO(blob))
        arrays = {k: npz[k] for k in npz.files}
        with self._wal_lock:
            for name, kc in meta["tables"].items():
                self._install_table(name, kc[0], kc[1])
            per_table: Dict[str, dict] = {}
            for key, arr in arrays.items():
                tname, field = key.split("::", 1)
                per_table.setdefault(tname, {})[field] = arr
            for tname, arrs in per_table.items():
                self._tables[tname].load_arrays(arrs)
            with self._seq_lock:
                self._ledger.load_state(meta["ledger"])
            lsn = int(meta["lsn"])
            if self.wal_dir is not None:
                _wal.save_snapshot(self.wal_dir, lsn, meta["ledger"],
                                   {n: (kc[0], kc[1]) for n, kc in
                                    meta["tables"].items()}, arrays)
                self._wal = _wal.WalWriter(self.wal_dir, start_lsn=lsn + 1)
            self.applied_lsn = lsn
            # installed arrays are not in the dirty map: delta
            # subscribers at or below this point need a full resync
            self._delta_floor = lsn
            self._delta_seq = lsn

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        # unblock handler threads parked in recv_exact — their sockets
        # are owned here so tests can assert nothing leaks
        for c in list(self._conns):
            try:
                c.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2)
        with self._wal_lock:
            if self._wal is not None:
                self._wal.close()
        self._closed = True


_CLIENT_SEQ = [0]
_CLIENT_SEQ_LOCK = threading.Lock()


def _new_client_id() -> bytes:
    """16-byte wire client id, unique across processes and instances
    (pid + in-process counter, hex — fits the header's name field)."""
    with _CLIENT_SEQ_LOCK:
        _CLIENT_SEQ[0] += 1
        n = _CLIENT_SEQ[0]
    return f"{os.getpid() % 0xFFFF:04x}{n % 0xFFFF:04x}" \
        f"{random.getrandbits(32):08x}".encode()


class PsClient:
    """Sharded client (brpc_ps_client role): sparse ids route to server
    `id % n_servers`; dense tables are row-range sharded across all
    servers (pull concatenates, push scatters).

    Self-healing transport: a transport error invalidates the cached
    connection, and every data-plane RPC is retried with exponential
    backoff + jitter up to `max_retries` times, reconnecting
    transparently (`ps.retries` / `ps.reconnects` monitor counters).
    Pulls are idempotent and retried freely; pushes carry a per-client
    request sequence (CMD_HELLO capability handshake per connection) so a
    push retried after a lost ACK is applied AT MOST ONCE server-side.
    Endpoints that reject CMD_HELLO (the native C++ plane) are marked
    legacy and keep plain at-least-once pushes. `call_timeout` bounds
    connect and each response read, so a stalled-but-open server raises
    TimeoutError (feeding the retry loop) instead of hanging the caller.
    """

    def __init__(self, endpoints: Optional[Sequence[str]] = None,
                 max_retries: Optional[int] = None,
                 backoff_ms: Optional[float] = None,
                 call_timeout: Optional[float] = None,
                 resolver: Optional[Callable[[], Sequence[str]]] = None):
        # `resolver` re-reads the current endpoint set (HA: the
        # rendezvous store's primary records) — consulted once up front
        # when `endpoints` is omitted, and again inside the retry loop
        # after every transport failure, so a failed-over primary is
        # picked up WITHIN the original per-call deadline
        self._resolver = resolver
        if endpoints is None:
            if resolver is None:
                raise ValueError("PsClient needs endpoints or a resolver")
            endpoints = resolver()
        self.endpoints = list(endpoints)
        self.max_retries = int(_flags.flag("ps_rpc_max_retries")
                               if max_retries is None else max_retries)
        self.backoff_s = float(_flags.flag("ps_rpc_backoff_ms")
                               if backoff_ms is None else backoff_ms) / 1e3
        ct = float(_flags.flag("ps_rpc_call_timeout_s")
                   if call_timeout is None else call_timeout)
        self.call_timeout = ct if ct > 0 else None
        # one RpcChannel per shard: the substrate owns connect/reconnect,
        # the security stack, and the plane's fault sites; this client
        # keeps only the sharding + verb framing
        self._chans: List[_net.RpcChannel] = [
            self._make_chan(ep) for ep in endpoints]
        # one shared syncwatch name: shard locks are acquired in ascending
        # shard order by protocol, so order edges between them are noise
        self._locks = [_syncwatch.lock("ps.PsClient._locks[]")
                       for _ in endpoints]
        self._dims: Dict[str, int] = {}  # table -> row dim (accessor config)
        self._dense_sizes: Dict[str, list] = {}  # table -> per-server sizes
        self._client_id = _new_client_id()
        self._push_seq = [0] * len(endpoints)   # per-server request seq
        # per-CONNECTION hello state (None = not negotiated yet) and the
        # per-ENDPOINT legacy verdict (sticky: a native server stays one)
        self._hello_ok: List[Optional[bool]] = [None] * len(endpoints)
        self._legacy = [False] * len(endpoints)

    def _make_chan(self, ep: str) -> "_net.RpcChannel":
        return _net.RpcChannel(
            "ps", endpoint=ep, connect_timeout=self.call_timeout or 120,
            legacy_sites=("ps.rpc.send", "ps.rpc.recv"),
            legacy_reconnect_counter="ps.reconnects")

    def _sock(self, i):
        return self._chans[i].sock

    def _drop(self, i):
        # a transport error leaves the stream byte-desynced: close and
        # forget the connection so the next request starts clean
        self._chans[i].drop()
        self._hello_ok[i] = None   # renegotiate on the next connection

    def _deadline(self) -> Optional[float]:
        return (time.monotonic() + self.call_timeout
                if self.call_timeout else None)

    def _refresh_endpoints(self) -> bool:
        """Re-resolve the endpoint set after a transport failure. The
        shard count must be stable (ids route by `id % n_servers`);
        per-server push seqs are KEPT — the standby replicated the
        primary's ledger, so in-flight retries stay exactly-once."""
        if self._resolver is None:
            return False
        try:
            new = list(self._resolver())
        except Exception:
            return False
        if not new or new == self.endpoints or len(new) != len(self.endpoints):
            return False
        for i in range(len(self._chans)):
            self._drop(i)
            self._chans[i].endpoint = new[i]
        self.endpoints = new
        self._legacy = [False] * len(new)
        if _monitor._ENABLED:
            _monitor.count("ps.failovers")
        return True

    def _retry_rpc(self, attempt_fn, op: str = "call"):
        """Run one RPC attempt; on a transport failure (OSError family —
        includes injected resets and recv deadlines) back off and retry.
        Server-reported PsErrors are application failures: never retried.
        Caller must already hold the involved per-server locks so a
        retried push reuses its sequence numbers without interleaving.

        Under `FLAGS_trace` the WHOLE call (retries included) is one
        `ps.rpc.<op>` span — parented on the calling thread's open span
        when there is one — that closes with error status when the RPC
        ultimately fails (injected `ps.rpc.send` conn-resets/timeouts
        land here: no leaked open spans)."""
        # with a resolver the retry budget is the CALL DEADLINE, not a
        # fixed count: failover (lease expiry + standby promotion) can
        # take several backoff rounds, and the contract is reaching the
        # new primary within the original per-call deadline
        return _net.call_with_retry(
            attempt_fn, plane="ps", op=op,
            max_retries=self.max_retries, backoff_s=self.backoff_s,
            deadline=(self._deadline() if self._resolver is not None
                      else None),
            retry_on=(OSError,), no_retry=(PsError,),
            on_transport_error=self._refresh_endpoints,
            span_name=f"ps.rpc.{op}", legacy_retry_counter="ps.retries")

    def _ensure_seq(self, s: int) -> bool:
        """True when the CURRENT connection to server s has a registered
        client id (sequenced pushes allowed). One HELLO per connection;
        an error frame marks the endpoint legacy for good."""
        if self._legacy[s]:
            return False
        sk = self._sock(s)
        if self._hello_ok[s] is not None:
            return self._hello_ok[s]
        try:
            sk.sendall(_HDR.pack(CMD_HELLO, self._client_id, 0, 0))
            _check_status(sk, self._deadline())
            self._hello_ok[s] = True
        except PsError:
            self._legacy[s] = True
            self._hello_ok[s] = False
        except OSError:
            self._drop(s)
            raise
        return self._hello_ok[s]

    def _next_push_seq(self, s: int) -> int:
        self._push_seq[s] += 1
        return self._push_seq[s]

    def _shard_sel(self, ids):
        n_srv = len(self.endpoints)
        m = ids % n_srv  # one modulo pass over the id vector
        out = []
        for s in range(n_srv):
            sel = np.where(m == s)[0]
            if len(sel):
                out.append((s, sel))
        return out

    def _send_all(self, shards, make_payload):
        """Send one request per shard; on a transport error every involved
        socket is dropped (earlier sends may have unread responses that
        would byte-desync a reused connection)."""
        wire_dl = (self._deadline()
                   if _net.deadline_wire_enabled() else None)
        try:
            for s, sel in shards:
                self._chans[s].sendall(make_payload(s, sel), wire_dl)
        except OSError:
            for s, _ in shards:
                self._drop(s)
            raise

    def _recv_all(self, shards, recv_one, deadline: Optional[float] = None):
        """Read every shard's response even if one errors (keeps the other
        sockets in sync); re-raise the first failure afterwards."""
        first: Optional[BaseException] = None
        for s, sel in shards:
            ch = self._chans[s]
            if not ch.connected:
                continue
            try:
                ch.check_recv_faults()
                sk = ch.sock
                _check_status(sk, deadline)
                if recv_one is not None:
                    recv_one(s, sel, sk)
            except OSError as e:
                self._drop(s)
                first = first or e
            except PsError as e:
                first = first or e
        if first is not None:
            raise first

    # -- sparse --
    def register_sparse_dim(self, table: str, dim: int):
        """Client-side table metadata (the reference ships this in the
        TableAccessor config)."""
        self._dims[table] = dim

    def pull_sparse(self, table: str, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64).reshape(-1)
        dim = self._dims[table]
        shards = self._shard_sel(ids)
        out = np.empty((len(ids), dim), np.float32)
        # acquire in ascending shard order (deadlock-free), send all
        # requests, then collect all responses: ~one RTT total
        for s, sel in shards:
            self._locks[s].acquire()
        try:
            def attempt():
                deadline = self._deadline()
                self._send_all(shards, lambda s, sel: (
                    _HDR.pack(CMD_PULL_SPARSE, _tname(table), len(sel), 0)
                    + ids[sel].tobytes()))

                def recv_rows(s, sel, sk):
                    out[sel] = np.frombuffer(
                        _recv_exact(sk, 4 * len(sel) * dim, deadline),
                        np.float32).reshape(len(sel), dim)

                self._recv_all(shards, recv_rows, deadline)

            self._retry_rpc(attempt, op="pull_sparse")
        finally:
            for s, _ in shards:
                self._locks[s].release()
        return out

    def _call_seqs(self, shards, _seqs):
        """One seq per involved server for the WHOLE call: every retry
        resends the same seq, so the server applies it at most once. The
        optional `_seqs` box lets a caller that re-issues the call later
        (Communicator requeue after failover) REUSE the original seqs —
        the ledger then drops whatever the dead primary already shipped."""
        seqs = _seqs if _seqs is not None else {}
        for s, _ in shards:
            if s not in seqs:
                seqs[s] = self._next_push_seq(s)
        return seqs

    def push_sparse(self, table: str, ids, grads, _seqs=None):
        ids = np.asarray(ids, np.int64).reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(len(ids), -1)
        shards = self._shard_sel(ids)
        for s, sel in shards:
            self._locks[s].acquire()
        try:
            seqs = self._call_seqs(shards, _seqs)

            def attempt():
                deadline = self._deadline()

                def payload(s, sel):
                    g = grads[sel]  # one fancy-index copy per shard
                    if self._ensure_seq(s):
                        return (_HDR.pack(CMD_PUSH_SPARSE_SEQ, _tname(table),
                                          len(sel), g.shape[1])
                                + _LEN.pack(seqs[s])
                                + ids[sel].tobytes() + g.tobytes())
                    return (_HDR.pack(CMD_PUSH_SPARSE, _tname(table),
                                      len(sel), g.shape[1])
                            + ids[sel].tobytes() + g.tobytes())

                self._send_all(shards, payload)
                self._recv_all(shards, None, deadline)

            self._retry_rpc(attempt, op="push_sparse")
        finally:
            for s, _ in shards:
                self._locks[s].release()

    # -- dense --
    # Dense tables are row-range sharded across ALL servers (reference
    # `common_dense_table.cc`): pull fans one request per server and
    # concatenates the slices; push scatters the grad by the same ranges.
    # Slice sizes are learned on the first pull (each response carries its
    # size) and cached for pushes.

    def pull_dense(self, table: str) -> np.ndarray:
        n_srv = len(self.endpoints)
        shards = [(s, None) for s in range(n_srv)]
        parts: list = [None] * n_srv
        metas: list = [None] * n_srv
        for s, _ in shards:
            self._locks[s].acquire()
        try:
            def attempt():
                deadline = self._deadline()
                self._send_all(shards, lambda s, sel: _HDR.pack(
                    CMD_PULL_DENSE, _tname(table), 0, 0))

                def recv_slice(s, sel, sk):
                    (size,) = _LEN.unpack(_recv_exact(sk, 8, deadline))
                    (lo,) = _LEN.unpack(_recv_exact(sk, 8, deadline))
                    (total,) = _LEN.unpack(_recv_exact(sk, 8, deadline))
                    metas[s] = (lo, size, total)
                    parts[s] = np.frombuffer(
                        _recv_exact(sk, 4 * size, deadline),
                        np.float32).copy()

                self._recv_all(shards, recv_slice, deadline)

            self._retry_rpc(attempt, op="pull_dense")
        finally:
            for s, _ in shards:
                self._locks[s].release()
        # the per-server slices must tile [0, total) exactly — this catches
        # tables registered unsharded on several servers (duplicate full
        # copies) or with inconsistent shard specs
        total = metas[0][2]
        ordered = sorted(range(n_srv), key=lambda s: metas[s][0])
        cursor = 0
        for s in ordered:
            lo, size, tot = metas[s]
            if tot != total or lo != cursor:
                raise PsError(
                    f"pull_dense('{table}'): server shards do not tile the "
                    f"table (server {s} reports offset {lo} size {size} "
                    f"total {tot}; expected offset {cursor} total {total}) "
                    "— register with shard=(i, n_servers) on every server")
            cursor += size
        if cursor != total:
            raise PsError(
                f"pull_dense('{table}'): shards cover {cursor} of {total} "
                "elements")
        self._dense_sizes[table] = [(metas[s][0], metas[s][1])
                                    for s in range(n_srv)]
        return np.concatenate([parts[s] for s in ordered])

    def push_dense(self, table: str, grad, _seqs=None):
        g = np.asarray(grad, np.float32).reshape(-1)
        ranges = self._dense_sizes.get(table)
        if ranges is None:
            self.pull_dense(table)  # learn (and validate) the shard split
            ranges = self._dense_sizes[table]
        total = sum(size for _, size in ranges)
        if total != g.size:
            raise PsError(
                f"push_dense('{table}'): grad size {g.size} != table size "
                f"{total}")
        shards = [(s, (lo, lo + size))
                  for s, (lo, size) in enumerate(ranges) if size]
        for s, _ in shards:
            self._locks[s].acquire()
        try:
            seqs = self._call_seqs(shards, _seqs)

            def attempt():
                deadline = self._deadline()

                def payload(s, sel):
                    body = g[sel[0]:sel[1]].tobytes()
                    if self._ensure_seq(s):
                        return (_HDR.pack(CMD_PUSH_DENSE_SEQ, _tname(table),
                                          sel[1] - sel[0], 0)
                                + _LEN.pack(seqs[s]) + body)
                    return (_HDR.pack(CMD_PUSH_DENSE, _tname(table),
                                      sel[1] - sel[0], 0) + body)

                self._send_all(shards, payload)
                self._recv_all(shards, None, deadline)

            self._retry_rpc(attempt, op="push_dense")
        finally:
            for s, _ in shards:
                self._locks[s].release()

    # -- CTR accessor ops (ctr_accessor.cc role over the wire) --
    def push_show_click(self, table: str, ids, shows, clicks, _seqs=None):
        """Bump per-row show/click statistics on the owning servers.
        Sequenced like the gradient pushes (CMD_PUSH_SHOW_CLICK_SEQ): a
        counter bump retried across a failover lands exactly once."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        shows = np.asarray(shows, np.float32).reshape(-1)
        clicks = np.asarray(clicks, np.float32).reshape(-1)
        shards = self._shard_sel(ids)
        for s, sel in shards:
            self._locks[s].acquire()
        try:
            seqs = self._call_seqs(shards, _seqs)

            def attempt():
                deadline = self._deadline()

                def payload(s, sel):
                    body = (ids[sel].tobytes() + shows[sel].tobytes()
                            + clicks[sel].tobytes())
                    if self._ensure_seq(s):
                        return (_HDR.pack(CMD_PUSH_SHOW_CLICK_SEQ,
                                          _tname(table), len(sel), 0)
                                + _LEN.pack(seqs[s]) + body)
                    return (_HDR.pack(CMD_PUSH_SHOW_CLICK, _tname(table),
                                      len(sel), 0) + body)

                self._send_all(shards, payload)
                self._recv_all(shards, None, deadline)

            self._retry_rpc(attempt, op="push_show_click")
        finally:
            for s, _ in shards:
                self._locks[s].release()

    def _simple_cmd_all(self, cmd, table, recv_extra=None):
        """Fire `cmd` at every server; returns the per-server extras."""
        shards = [(i, None) for i in range(len(self.endpoints))]
        outs = [None] * len(self.endpoints)
        for s, _ in shards:
            self._locks[s].acquire()
        try:
            def attempt():
                deadline = self._deadline()
                self._send_all(shards, lambda s, sel: _HDR.pack(
                    cmd, _tname(table), 0, 0))

                def recv_one(s, sel, sk):
                    if recv_extra is not None:
                        outs[s] = recv_extra(sk)

                self._recv_all(shards, recv_one, deadline)

            self._retry_rpc(attempt, op="cmd")
        finally:
            for s, _ in shards:
                self._locks[s].release()
        return outs

    def decay(self, table: str):
        """One show/click time-decay cycle on every server."""
        self._simple_cmd_all(CMD_DECAY, table)

    def shrink(self, table: str) -> int:
        """Evict low-score/expired rows everywhere; total evicted."""
        outs = self._simple_cmd_all(
            CMD_SHRINK, table,
            recv_extra=lambda sk: _LEN.unpack(_recv_exact(sk, 8))[0])
        return int(np.sum([o or 0 for o in outs]))

    # -- table-config negotiation (the reference ships TableAccessor
    #    configs to every server at fleet init; these do it per table) --
    def create_sparse_table(self, table: str, dim: int, optimizer="sgd",
                            lr=0.01, init_std=0.01, seed=0, accessor=None,
                            show_decay_rate=0.98, click_coeff=8.0,
                            delete_threshold=0.8, ttl_days=30.0,
                            beta1=0.9, beta2=0.999, eps=1e-8):
        cfg = _SPARSE_CFG.pack(
            lr, init_std, int(seed), _OPT_IDS[optimizer],
            1 if accessor == "ctr" else 0, beta1, beta2, eps,
            show_decay_rate, click_coeff, delete_threshold, float(ttl_days))
        shards = [(i, None) for i in range(len(self.endpoints))]
        for s, _ in shards:
            self._locks[s].acquire()
        try:
            self._send_all(shards, lambda s, sel: _HDR.pack(
                CMD_ADD_SPARSE, _tname(table), 0, dim) + cfg)
            self._recv_all(shards, None)
        finally:
            for s, _ in shards:
                self._locks[s].release()
        self.register_sparse_dim(table, dim)

    def create_dense_table(self, table: str, total: int, optimizer="sgd",
                           lr=0.01, beta1=0.9, beta2=0.999, eps=1e-8):
        from .table import dense_shard_range
        n_srv = len(self.endpoints)
        for i in range(n_srv):
            lo, hi = dense_shard_range(int(total), i, n_srv)
            cfg = _DENSE_CFG.pack(lr, lo, int(total), _OPT_IDS[optimizer],
                                  beta1, beta2, eps)
            with self._locks[i]:
                sk = self._sock(i)
                sk.sendall(_HDR.pack(CMD_ADD_DENSE, _tname(table), hi - lo, 0)
                           + cfg)
                _check_status(sk)

    # -- graph table (common_graph_table.h role) --
    def sample_neighbors(self, table: str, ids, k: int):
        """[n] node ids -> ([n, k] neighbor ids, [n, k] weights); nodes
        route to their owning server (id % n_servers, like sparse rows)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        shards = self._shard_sel(ids)
        nb = np.full((len(ids), k), -1, np.int64)
        w = np.zeros((len(ids), k), np.float32)
        for s, sel in shards:
            self._locks[s].acquire()
        try:
            self._send_all(shards, lambda s, sel: (
                _HDR.pack(CMD_SAMPLE_NEIGHBORS, _tname(table), len(sel), k)
                + ids[sel].tobytes()))

            def recv_one(s, sel, sk):
                nb[sel] = np.frombuffer(
                    _recv_exact(sk, 8 * len(sel) * k), np.int64
                ).reshape(len(sel), k)
                w[sel] = np.frombuffer(
                    _recv_exact(sk, 4 * len(sel) * k), np.float32
                ).reshape(len(sel), k)

            self._recv_all(shards, recv_one)
        finally:
            for s, _ in shards:
                self._locks[s].release()
        return nb, w

    def node_feat(self, table: str, ids):
        ids = np.asarray(ids, np.int64).reshape(-1)
        shards = self._shard_sel(ids)
        parts = {}
        for s, sel in shards:
            self._locks[s].acquire()
        try:
            self._send_all(shards, lambda s, sel: (
                _HDR.pack(CMD_NODE_FEAT, _tname(table), len(sel), 0)
                + ids[sel].tobytes()))

            def recv_one(s, sel, sk):
                (d,) = _LEN.unpack(_recv_exact(sk, 8))
                parts[s] = (sel, np.frombuffer(
                    _recv_exact(sk, 4 * len(sel) * d), np.float32
                ).reshape(len(sel), d))

            self._recv_all(shards, recv_one)
        finally:
            for s, _ in shards:
                self._locks[s].release()
        d = max(p.shape[1] for _, p in parts.values())
        out = np.zeros((len(ids), d), np.float32)
        for sel, p in parts.values():
            out[sel, :p.shape[1]] = p
        return out

    def barrier(self, n_trainers: int = 1):
        """Block until `n_trainers` clients reach this point (coordinated by
        server 0 — the gloo-barrier role in the reference's PS bring-up)."""
        with self._locks[0]:
            try:
                sk = self._sock(0)
                sk.sendall(_HDR.pack(CMD_BARRIER, _tname(""), n_trainers, 0))
                # the ACK is legitimately held until all trainers arrive;
                # bound the wait by the server's own barrier timeout
                _check_status(sk, time.monotonic() + _BARRIER_TIMEOUT + 30)
            except OSError:
                self._drop(0)
                raise

    def stop_server(self):
        for s in range(len(self.endpoints)):
            try:
                with self._locks[s]:
                    sk = self._sock(s)
                    sk.sendall(_HDR.pack(CMD_STOP, _tname(""), 0, 0))
                    _check_status(sk)
            except (ConnectionError, OSError, PsError):
                pass

    def close(self):
        for i in range(len(self._chans)):
            self._drop(i)


# ---- single-endpoint HA RPCs (driven by ha.HaPsNode over its own
#      socket; service.py owns the wire structs) ----

def ha_connect(endpoint: str, timeout: Optional[float] = None):
    return _net.dial(endpoint, timeout=timeout or 120, plane="ps")


def rpc_replicate(sock, after_lsn: int, max_records: int = 0,
                  standby_id: str = "", deadline=None):
    """Fetch WAL records with lsn > after_lsn; `after_lsn` is also the
    caller's ack watermark. Returns a list of wal.Record."""
    sock.sendall(_HDR.pack(CMD_REPLICATE, _tname(standby_id), 0, 0)
                 + _LEN.pack(int(after_lsn)) + _LEN.pack(int(max_records)))
    _check_status(sock, deadline)
    (_n,) = _LEN.unpack(_recv_exact(sock, 8, deadline))
    (blen,) = _LEN.unpack(_recv_exact(sock, 8, deadline))
    return _wal.decode_stream(_recv_exact(sock, blen, deadline))


def rpc_ha_status(sock, deadline=None) -> dict:
    sock.sendall(_HDR.pack(CMD_HA_STATUS, _tname(""), 0, 0))
    _check_status(sock, deadline)
    (ln,) = _LEN.unpack(_recv_exact(sock, 8, deadline))
    return json.loads(_recv_exact(sock, ln, deadline).decode())


def rpc_handback(sock, records, deadline=None) -> int:
    blob = b"".join(_wal.encode_record(r) for r in records)
    sock.sendall(_HDR.pack(CMD_HANDBACK, _tname(""), 0, 0)
                 + _LEN.pack(len(blob)) + blob)
    _check_status(sock, deadline)
    (applied,) = _LEN.unpack(_recv_exact(sock, 8, deadline))
    return applied


def rpc_fetch_state(sock, deadline=None):
    sock.sendall(_HDR.pack(CMD_FETCH_STATE, _tname(""), 0, 0))
    _check_status(sock, deadline)
    (mlen,) = _LEN.unpack(_recv_exact(sock, 8, deadline))
    meta = json.loads(_recv_exact(sock, mlen, deadline).decode())
    (blen,) = _LEN.unpack(_recv_exact(sock, 8, deadline))
    return meta, _recv_exact(sock, blen, deadline)


class Communicator:
    """Async grad sender (communicator.cc role): push_sparse calls are
    queued and flushed by a background thread, overlapping server updates
    with the trainer's next step; `flush()`/`barrier()` give the sync
    points the reference exposes.

    Failover behavior: a TRANSPORT failure no longer poisons the worker —
    the in-flight batch is re-enqueued (bounded by
    `FLAGS_ps_communicator_max_requeues`) and retried with its ORIGINAL
    per-server seqs, so whatever the dying primary already applied and
    replicated is dropped by the survivor's ledger, not double-applied.
    Server-reported PsErrors (application failures) still fail the
    worker permanently."""

    def __init__(self, client: PsClient, max_queue=64):
        self.client = client
        import collections
        import queue as q
        self._q = q.Queue(maxsize=max_queue)
        # pending counts enqueued-but-not-yet-applied items; a Condition
        # (not q.empty + idle flag) closes the pop-before-clear race where
        # flush() could return while the last push was still in flight
        self._pending = 0
        self._cond = threading.Condition()
        self._error: Optional[BaseException] = None
        self._max_requeues = int(_flags.flag("ps_communicator_max_requeues"))
        # requeued batches live in a worker-local deque, NOT back in the
        # bounded queue: the worker blocking on its own full queue would
        # deadlock against the producers it is supposed to drain
        self._retry = collections.deque()
        self._thread = _syncwatch.Thread(target=self._run, daemon=True,
                                        name="ps-communicator")
        self._thread.start()

    def _run(self):
        while True:
            item = self._retry.popleft() if self._retry else self._q.get()
            if item is None:
                return
            kind, table, a, b, seqs, tries = item
            try:
                if self._error is None:
                    if kind == "sparse":
                        self.client.push_sparse(table, a, b, _seqs=seqs)
                    else:
                        self.client.push_dense(table, a, _seqs=seqs)
            except PsError as e:  # application failure: permanent
                self._error = e
            except BaseException as e:
                if tries < self._max_requeues:
                    # count the requeue into pending BEFORE the finally
                    # block decrements this attempt, so a concurrent
                    # flush() can never observe a false zero
                    with self._cond:
                        self._pending += 1
                    self._retry.append((kind, table, a, b, seqs, tries + 1))
                    if _monitor._ENABLED:
                        _monitor.count("ps.communicator.requeues")
                    time.sleep(self.client.backoff_s)
                else:
                    self._error = e
            finally:
                with self._cond:
                    self._pending -= 1
                    if self._pending == 0:
                        self._cond.notify_all()

    def _raise_if_failed(self):
        if self._error is not None:
            raise RuntimeError(
                "Communicator push failed; queued gradients were dropped"
            ) from self._error

    def _put(self, item):
        self._raise_if_failed()
        with self._cond:
            self._pending += 1
        self._q.put(item)

    def push_sparse_async(self, table, ids, grads):
        self._put(("sparse", table, np.asarray(ids), np.asarray(grads),
                   {}, 0))

    def push_dense_async(self, table, grad):
        self._put(("dense", table, np.asarray(grad), None, {}, 0))

    def pending(self) -> int:
        """Batches enqueued or in flight but not yet applied."""
        with self._cond:
            return self._pending

    def flush(self, timeout=30.0, on_timeout="requeue"):
        """Block until every queued push applied (or permanently failed).

        On timeout the behavior is DETERMINISTIC, never
        silently-dropped work (`ps.communicator.flush_timeouts` counts
        either way):

        - ``on_timeout="requeue"`` (default): raise
          `CommunicatorFlushTimeout` carrying the pending batch count.
          Every undelivered batch stays parked in the worker with its
          ORIGINAL per-server seqs — the ledger keeps the retries
          exactly-once — so a later flush()/stop() delivers exactly
          what this one could not.
        - ``on_timeout="drain"``: keep waiting past the deadline until
          the queue drains or a permanent error is recorded. The
          elapsed timeout is reported via the counter only.
        """
        if on_timeout not in ("requeue", "drain"):
            raise ValueError(f"flush: unknown on_timeout={on_timeout!r}")
        with self._cond:
            if not self._cond.wait_for(lambda: self._pending == 0,
                                       timeout=timeout):
                if _monitor._ENABLED:
                    _monitor.count("ps.communicator.flush_timeouts")
                if on_timeout == "requeue":
                    raise CommunicatorFlushTimeout(
                        f"Communicator flush timed out after {timeout}s "
                        f"with {self._pending} batch(es) pending; they "
                        "remain queued with their original seqs",
                        pending=self._pending)
                # drain: a permanent error also releases the wait —
                # the worker stops applying and pending hits zero as
                # remaining items fall through the error check
                self._cond.wait_for(lambda: self._pending == 0)
        self._raise_if_failed()

    def stop(self):
        """Drain and shut down the worker; the thread is always joined and
        any recorded push error re-raised AFTER cleanup."""
        err: Optional[BaseException] = None
        try:
            self.flush()
        except BaseException as e:
            err = e
        self._q.put(None)
        self._thread.join(timeout=5)
        if err is not None:
            raise err
