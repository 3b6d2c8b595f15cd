"""Delta-push plane: trainer-side PS -> serving replicas, value-shipped.

Counterpart of `paddle_tpu/distributed/ps/delta.py`, on the same wire.

A serving replica subscribes to a sparse table like a standby tails the
WAL (same watermark discipline as CMD_REPLICATE), but the payload is
embedding ROWS, not log records: the server ships the CURRENT value of
every row touched since the subscriber's watermark, plus tombstones for
TTL-shrink evictions. Value-shipping makes installs idempotent — a
retried pull after a torn response re-installs the same values, so the
plane is exactly-once-EFFECTIVE without a serving-side ledger — and
keeps optimizer slots (which serving never reads) off the wire.

Watermarks are commit versions: the WAL lsn on durable servers (the one
monotonic version that survives restart and failover), a local commit
counter otherwise. A subscriber below the server's resync floor (fresh
subscriber, or the server just recovered / installed a fetched state)
gets a full-table replace instead of a merge.

Wire (CMD_DELTA, service.py header conventions):
  request:  HDR(CMD_DELTA, table, 0, 0) + i64 after_version
            + i64 max_rows + i64 id_len + subscriber id
  response: 0x01 + i64 version + i64 dim + i64 flags(bit0=full)
            + i64 n_live + i64 n_dead
            + live_keys i64[n_live] + rows f32[n_live, dim]
            + dead_keys i64[n_dead]

Fault site: `ps.delta.push` fires on the server's send (check + torn
mangle), exercised alongside the other PS-plane seams in the online
soak.
"""
# tpu-lint: disable=raw-socket
from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np

from .service import (CMD_DELTA, PsError, _HDR, _LEN, _check_status,
                      _recv_exact, _tname, ha_connect)
from ... import faults as _faults
from ... import monitor as _monitor
from ...core import flags as _flags
from ...utils import net as _net
from ...utils import syncwatch as _syncwatch

__all__ = ["DeltaBatch", "DeltaSubscriber", "rpc_delta", "serve_delta"]

# live subscribers, for the tests' leak checks
_LIVE = weakref.WeakSet()

_MAX_DELTA_ROWS = 100_000_000
_MAX_DELTA_DIM = 1_000_000


@dataclass
class DeltaBatch:
    """One CMD_DELTA response, decoded."""
    version: int
    dim: int
    full: bool              # True: replace the whole table, don't merge
    live_keys: np.ndarray   # i64 [n_live]
    rows: np.ndarray        # f32 [n_live, dim]
    dead_keys: np.ndarray   # i64 [n_dead]


def serve_delta(server, conn, name: str, after_version: int,
                max_rows: int, subscriber: str) -> None:
    """Server side of CMD_DELTA (called from PsServer._handle; errors
    propagate to the handler's error-frame path). The response frames
    go out scatter-gather — the stacked row block is handed to the
    kernel as-is, never re-joined with the key arrays."""
    version, dim, full, live, rows, dead = server.delta_since(
        name, after_version, max_rows, subscriber)
    head = (b"\x01" + _LEN.pack(int(version)) + _LEN.pack(int(dim))
            + _LEN.pack(1 if full else 0) + _LEN.pack(len(live))
            + _LEN.pack(len(dead)))
    frames = [head,
              np.asarray(live, np.int64).tobytes(),
              np.ascontiguousarray(rows, np.float32).tobytes(),
              np.asarray(dead, np.int64).tobytes()]
    if _faults._ENABLED:
        payload = b"".join(frames)
        _faults.check("ps.delta.push")
        payload = _faults.mangle("ps.delta.push", payload)
        conn.sendall(payload)
    else:
        _net.send_frames(conn, frames)
    if _monitor._ENABLED:
        _monitor.count("ps.delta.pushes")
        if len(live) or len(dead):
            _monitor.count("ps.delta.rows_shipped", len(live) + len(dead))


def rpc_delta(sock, table: str, after_version: int = -1, max_rows: int = 0,
              subscriber_id: str = "", deadline=None) -> DeltaBatch:
    """Pull one delta batch. `after_version` doubles as the caller's ack
    watermark (-1 = nothing installed yet -> full bootstrap). Callers
    polling an unreliable wire should pass a `deadline`: a torn response
    then raises instead of blocking forever."""
    sid = subscriber_id.encode()
    sock.sendall(_HDR.pack(CMD_DELTA, _tname(table), 0, 0)
                 + _LEN.pack(int(after_version)) + _LEN.pack(int(max_rows))
                 + _LEN.pack(len(sid)) + sid)
    _check_status(sock, deadline)
    version, dim, flags, n_live, n_dead = (
        _LEN.unpack(_recv_exact(sock, 8, deadline))[0] for _ in range(5))
    if not (0 < dim <= _MAX_DELTA_DIM
            and 0 <= n_live <= _MAX_DELTA_ROWS
            and 0 <= n_dead <= _MAX_DELTA_ROWS):
        raise PsError(f"delta: implausible response header dim={dim} "
                      f"n_live={n_live} n_dead={n_dead}")
    live = np.frombuffer(_recv_exact(sock, 8 * n_live, deadline), np.int64)
    rows = np.frombuffer(_recv_exact(sock, 4 * n_live * dim, deadline),
                         np.float32).reshape(n_live, dim)
    dead = np.frombuffer(_recv_exact(sock, 8 * n_dead, deadline), np.int64)
    return DeltaBatch(int(version), int(dim), bool(flags & 1),
                      live, rows, dead)


class DeltaSubscriber:
    """Background tail of one PS's delta stream into serving tables.

    `tables` maps PS table name -> install target (an
    `serving.online.OnlineServingTable`, or anything with
    `install_delta(batch)` + `mark_fresh()`). The endpoint comes from a
    static `endpoint` or a `resolver()` callable (use `ha.resolver(store)`
    so the tail follows a failover to the promoted standby).

    Loss/duplication contract: the watermark advances ONLY after a
    batch installed successfully (zero loss — a crash between pull and
    install re-pulls the same rows), and installs are idempotent value
    writes (zero double-apply effects). An empty delta still marks the
    table fresh: "nothing changed" is a successful sync, not staleness.
    Transport errors drop the connection, count
    `ps.delta.pull_errors`, and the next tick re-resolves — the
    subscriber never dies with the primary.
    """

    def __init__(self, tables: Dict[str, object], endpoint: str = None,
                 resolver: Optional[Callable] = None,
                 subscriber_id: str = "serving",
                 interval_ms: Optional[float] = None,
                 max_rows: Optional[int] = None,
                 pull_timeout_s: float = 10.0):
        if endpoint is None and resolver is None:
            raise ValueError("DeltaSubscriber needs an endpoint or resolver")
        self.tables = dict(tables)
        self._endpoint = endpoint
        self._resolver = resolver
        self.subscriber_id = subscriber_id
        self._interval_s = (float(_flags.flag("online_delta_interval_ms"))
                            if interval_ms is None else interval_ms) / 1e3
        self._max_rows = (int(_flags.flag("online_delta_max_rows"))
                          if max_rows is None else int(max_rows))
        self._pull_timeout_s = pull_timeout_s
        self._marks: Dict[str, int] = {t: -1 for t in self.tables}
        self._sock = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        _LIVE.add(self)

    def watermark(self, table: str) -> int:
        return self._marks[table]

    def _connect(self):
        if self._sock is not None:
            return self._sock
        ep = self._endpoint
        if self._resolver is not None:
            eps = self._resolver()
            ep = eps[0] if eps else None
        if ep is None:
            raise ConnectionError("delta: no endpoint resolved")
        self._sock = ha_connect(ep)
        return self._sock

    def _drop(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def poll_once(self) -> int:
        """One pull+install pass over every table; returns rows applied.
        Raises on transport failure (the loop counts and retries; direct
        callers — tests, the bench — see the real error)."""
        applied = 0
        for name, target in self.tables.items():
            deadline = time.monotonic() + self._pull_timeout_s
            # keep pulling while a max_rows cap leaves us behind the head
            while True:
                sock = self._connect()
                try:
                    batch = rpc_delta(
                        sock, name, after_version=self._marks[name],
                        max_rows=self._max_rows,
                        subscriber_id=self.subscriber_id, deadline=deadline)
                except BaseException:
                    self._drop()
                    raise
                target.install_delta(batch)
                self._marks[name] = batch.version  # install-then-advance
                target.mark_fresh()
                applied += len(batch.live_keys) + len(batch.dead_keys)
                if not (len(batch.live_keys) or len(batch.dead_keys)) \
                        or not self._max_rows:
                    break
        return applied

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.poll_once()
            except (OSError, PsError, ValueError, TimeoutError):
                if _monitor._ENABLED:
                    _monitor.count("ps.delta.pull_errors")
                self._drop()
            self._wake.wait(self._interval_s)
            self._wake.clear()

    def start(self) -> "DeltaSubscriber":
        self._thread = _syncwatch.Thread(target=self._loop, daemon=True,
                                        name="ps-delta-tail")
        self._thread.start()
        return self

    def kick(self) -> None:
        """Wake the tail immediately (tests and cutover probes)."""
        self._wake.set()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._drop()
