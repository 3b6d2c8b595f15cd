"""PS durability plane: write-ahead delta log + crash-atomic snapshots.

Counterpart of `paddle_tpu/distributed/ps/wal.py`: the same record
framing, segment names, snapshot manifests and ledger, byte for byte, so
either package recovers a directory the other wrote.

Reference parity: the reference's PS persists sparse tables through
`ps/table/` save/load plus an incremental "delta" path for online
learning; brpc PS deployments pair that with warm standbys. Here the
same roles are built from the repo's own primitives: the delta log is a
segmented, CRC-framed record stream (one record per mutating RPC,
stamped with the client's existing push seq), and compaction reuses the
`sharded_io.atomic_write` + CRC-manifest + `.bak`-generation commit
protocol the guard plane already trusts (`guard/checkpoint.py`).

Recovery contract: restart = load the newest INTACT snapshot generation
(manifest -> payload, falling back to the `.bak` generation on a CRC
mismatch, counting `ps.wal.fallbacks`), then replay WAL records with
lsn > snapshot lsn, dedup'd by the persisted `SeqLedger` — so the
at-most-once server ledger itself survives restart and a trainer retry
replayed across the crash is still exactly-once. A torn tail record
(SIGKILL mid-append, or the `ps.wal.write` fault site) ends replay at
the last intact record; it is never an error, because a torn record was
by construction never applied nor ACKed.

Fault sites: `ps.wal.write` (torn/short append, via `faults.mangle`)
and `ps.snapshot.commit` (crash point between the snapshot payload and
its manifest — the manifest keeps referencing the previous generation).
"""
from __future__ import annotations

import glob
import io
import json
import os
import struct
import threading
import weakref
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np

from ... import faults as _faults
from ... import monitor as _monitor
from ...framework.sharded_io import atomic_write, _crc

__all__ = [
    "PsSnapshotUnsupportedError", "Record", "SeqLedger", "WalWriter",
    "encode_record", "decode_record", "replay", "save_snapshot",
    "load_snapshot", "gc_segments", "wal_status",
    "pack_push_sparse", "unpack_push_sparse", "pack_push_dense",
    "unpack_push_dense", "pack_show_click", "unpack_show_click",
]


class PsSnapshotUnsupportedError(TypeError):
    """A registered table kind has no snapshot representation (graph
    tables) — raised instead of silently dropping its state."""


# record types (one per mutating RPC verb + table registration)
R_PUSH_SPARSE = 1
R_PUSH_DENSE = 2
R_SHOW_CLICK = 3
R_DECAY = 4
R_SHRINK = 5
R_ADD_SPARSE = 6     # payload: JSON table config
R_ADD_DENSE = 7
R_ADD_GRAPH = 8      # registration only: graph CONTENT rides snapshots

# lsn, rtype, table name (padded), client id (padded), seq, payload len
_REC_HDR = struct.Struct("<qB16s16sqq")
_CRC32 = struct.Struct("<I")
_LEN = struct.Struct("<q")

_SEG_GLOB = "wal-*.log"
_MANIFEST = "ps-manifest.json"

# open WalWriters, for the tests' leak checks
_LIVE_WRITERS: "weakref.WeakSet[WalWriter]" = weakref.WeakSet()


class Record(NamedTuple):
    lsn: int
    rtype: int
    table: str
    client: str       # "" for unsequenced records
    seq: int          # -1 for unsequenced records
    payload: bytes


def _pad16(s: str) -> bytes:
    b = s.encode()
    if len(b) > 16:
        raise ValueError(f"wal name {s!r} exceeds the 16-byte wire limit")
    return b.ljust(16, b"\0")


def encode_record(rec: Record) -> bytes:
    body = _REC_HDR.pack(rec.lsn, rec.rtype, _pad16(rec.table),
                         _pad16(rec.client), rec.seq, len(rec.payload)) \
        + rec.payload
    return body + _CRC32.pack(_crc(body))


def decode_record(raw: bytes) -> Record:
    """Decode one framed record; raises ValueError on any damage."""
    if len(raw) < _REC_HDR.size + _CRC32.size:
        raise ValueError("wal record too short")
    body, (crc,) = raw[:-_CRC32.size], _CRC32.unpack(raw[-_CRC32.size:])
    if _crc(body) != crc:
        raise ValueError("wal record failed its checksum")
    lsn, rtype, table, client, seq, plen = _REC_HDR.unpack(
        body[:_REC_HDR.size])
    payload = body[_REC_HDR.size:]
    if len(payload) != plen:
        raise ValueError("wal record payload length mismatch")
    return Record(lsn, rtype, table.rstrip(b"\0").decode(),
                  client.rstrip(b"\0").decode(), seq, payload)


def decode_stream(blob: bytes) -> List[Record]:
    """Decode a concatenation of framed records (the REPLICATE/HANDBACK
    wire form). Raises ValueError on damage — this blob crossed a
    checksummed RPC, so damage is a bug, not a torn tail."""
    out: List[Record] = []
    off = 0
    while off < len(blob):
        if off + _REC_HDR.size > len(blob):
            raise ValueError("ps record stream truncated")
        _, _, _, _, _, plen = _REC_HDR.unpack_from(blob, off)
        end = off + _REC_HDR.size + plen + _CRC32.size
        if plen < 0 or end > len(blob):
            raise ValueError("ps record stream truncated")
        out.append(decode_record(blob[off:end]))
        off = end
    return out


def wipe(dirname: str) -> None:
    """Remove every WAL segment, snapshot payload, and manifest — the
    rejoin flow resets a superseded durability chain before re-anchoring
    on the new primary's state."""
    for pat in (_SEG_GLOB, "ps-snap-v*.npz", _MANIFEST, _MANIFEST + ".bak",
                "ha-status.json"):
        for p in glob.glob(os.path.join(dirname, pat)):
            try:
                os.remove(p)
            except OSError:
                pass


# ---- delta payload codecs (shared by the RPC handler, replay, and the
#      replication/handback wire) -----------------------------------------

def pack_push_sparse(ids: np.ndarray, grads: np.ndarray) -> bytes:
    return (_LEN.pack(len(ids)) + _LEN.pack(grads.shape[1])
            + np.ascontiguousarray(ids, np.int64).tobytes()
            + np.ascontiguousarray(grads, np.float32).tobytes())


def unpack_push_sparse(payload: bytes) -> Tuple[np.ndarray, np.ndarray]:
    (n,) = _LEN.unpack_from(payload, 0)
    (dim,) = _LEN.unpack_from(payload, 8)
    ids = np.frombuffer(payload, np.int64, n, 16)
    grads = np.frombuffer(payload, np.float32, n * dim,
                          16 + 8 * n).reshape(n, dim)
    return ids, grads


def pack_push_dense(grads: np.ndarray) -> bytes:
    return np.ascontiguousarray(grads, np.float32).tobytes()


def unpack_push_dense(payload: bytes) -> np.ndarray:
    return np.frombuffer(payload, np.float32)


def pack_show_click(ids, shows, clicks) -> bytes:
    return (_LEN.pack(len(ids))
            + np.ascontiguousarray(ids, np.int64).tobytes()
            + np.ascontiguousarray(shows, np.float32).tobytes()
            + np.ascontiguousarray(clicks, np.float32).tobytes())


def unpack_show_click(payload: bytes):
    (n,) = _LEN.unpack_from(payload, 0)
    ids = np.frombuffer(payload, np.int64, n, 8)
    shows = np.frombuffer(payload, np.float32, n, 8 + 8 * n)
    clicks = np.frombuffer(payload, np.float32, n, 8 + 12 * n)
    return ids, shows, clicks


# ---- at-most-once seq ledger ---------------------------------------------

class SeqLedger:
    """Per-client applied-seq set = contiguous floor + sparse extras.

    The pre-durability ledger was a monotonic "last applied seq" per
    client, which silently drops a LOWER seq arriving later — wrong once
    failover exists: seq 35 can be acked by a dying primary (reaching
    the survivor only via WAL handback) while the client has already
    pushed seq 36 to the new primary. The floor+set form applies every
    seq exactly once regardless of arrival order, and compacts back to
    a bare floor as gaps fill. Callers serialize access (`_seq_lock`).
    """

    def __init__(self):
        self._floor: Dict[str, int] = {}
        self._extra: Dict[str, set] = {}

    def seen(self, client: str, seq: int) -> bool:
        return (seq <= self._floor.get(client, 0)
                or seq in self._extra.get(client, ()))

    def record(self, client: str, seq: int) -> bool:
        """Mark (client, seq) applied; False when it already was."""
        floor = self._floor.get(client, 0)
        if seq <= floor:
            return False
        extra = self._extra.setdefault(client, set())
        if seq in extra:
            return False
        extra.add(seq)
        while floor + 1 in extra:       # compact the contiguous prefix
            floor += 1
            extra.discard(floor)
        self._floor[client] = floor
        return True

    def state(self) -> Dict[str, dict]:
        return {c: {"floor": f, "extra": sorted(self._extra.get(c, ()))}
                for c, f in self._floor.items()}

    def load_state(self, state: Dict[str, dict]) -> None:
        self._floor = {c: int(v["floor"]) for c, v in state.items()}
        self._extra = {c: set(int(s) for s in v.get("extra", ()))
                       for c, v in state.items() if v.get("extra")}


# ---- segmented writer ----------------------------------------------------

def _seg_path(dirname: str, start_lsn: int) -> str:
    return os.path.join(dirname, f"wal-{start_lsn:012d}.log")


def _seg_files(dirname: str) -> List[Tuple[int, str]]:
    out = []
    for p in glob.glob(os.path.join(dirname, _SEG_GLOB)):
        try:
            out.append((int(os.path.basename(p)[4:-4]), p))
        except ValueError:
            continue
    return sorted(out)


class WalWriter:
    """Appends CRC-framed records to segment files named by their first
    lsn; rolls to a new segment past `segment_bytes`. Every append is
    flushed so a reader (replication, the monitor CLI) sees it
    immediately; fsync happens on rollover and `sync()` (snapshot),
    trading per-record fsync latency for the snapshot-anchored
    durability window the recovery contract needs."""

    def __init__(self, dirname: str, start_lsn: int = 1,
                 segment_bytes: Optional[int] = None):
        from ...core import flags as _flags
        os.makedirs(dirname, exist_ok=True)
        self.dirname = dirname
        self._next_lsn = int(start_lsn)
        self.segment_bytes = int(segment_bytes if segment_bytes is not None
                                 else float(_flags.flag("ps_wal_segment_mb"))
                                 * (1 << 20))
        self._f = None
        self._f_bytes = 0
        self._open_segment()
        _LIVE_WRITERS.add(self)

    def _open_segment(self):
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
        path = _seg_path(self.dirname, self._next_lsn)
        self._f = open(path, "ab")
        self._f_bytes = self._f.tell()

    @property
    def closed(self) -> bool:
        return self._f is None

    @property
    def last_lsn(self) -> int:
        return self._next_lsn - 1

    def append(self, rtype: int, table: str, client: str, seq: int,
               payload: bytes) -> int:
        rec = Record(self._next_lsn, rtype, table, client, seq, payload)
        self.append_record(rec)
        return rec.lsn

    def append_record(self, rec: Record) -> None:
        """Append a pre-built record. A replica tailing the primary uses
        this to persist replicated records under their ORIGINAL lsn, so
        both WALs carry the identical stream."""
        if rec.lsn != self._next_lsn:
            raise ValueError(
                f"wal append out of order: lsn {rec.lsn} != next "
                f"{self._next_lsn}")
        data = encode_record(rec)
        if _faults._ENABLED:
            # a firing `torn` spec persists a truncated record — the
            # replay path must stop at it, never error
            data = _faults.mangle("ps.wal.write", data)
        self._f.write(data)
        self._f.flush()
        self._f_bytes += len(data)
        self._next_lsn = rec.lsn + 1
        if _monitor._ENABLED:
            _monitor.count("ps.wal.appends")
        if self._f_bytes >= self.segment_bytes:
            self._open_segment()

    def sync(self) -> None:
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self) -> None:
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None


def _read_segment(path: str) -> Tuple[List[Record], bool]:
    """All intact records of one segment file; intact=False when the file
    ends in a torn/short/corrupt record (replay stops there)."""
    recs: List[Record] = []
    with open(path, "rb") as f:
        raw = f.read()
    off = 0
    while off < len(raw):
        if off + _REC_HDR.size > len(raw):
            return recs, False
        _, _, _, _, _, plen = _REC_HDR.unpack_from(raw, off)
        end = off + _REC_HDR.size + plen + _CRC32.size
        if plen < 0 or end > len(raw):
            return recs, False
        try:
            recs.append(decode_record(raw[off:end]))
        except ValueError:
            return recs, False
        off = end
    return recs, True


def replay(dirname: str, after_lsn: int = 0,
           max_records: Optional[int] = None,
           count_fallback: bool = True) -> List[Record]:
    """Records with lsn > after_lsn, in lsn order. A torn tail ends the
    stream at the last intact record (counting `ps.wal.fallbacks` when
    `count_fallback` — replication polls pass False, because a reader
    racing a live appender is not a fallback)."""
    out: List[Record] = []
    for _, path in _seg_files(dirname):
        recs, intact = _read_segment(path)
        for r in recs:
            if r.lsn > after_lsn:
                out.append(r)
                if max_records is not None and len(out) >= max_records:
                    return out
        if not intact:
            if count_fallback and _monitor._ENABLED:
                _monitor.count("ps.wal.fallbacks")
            break
    return out


def repair(dirname: str) -> int:
    """Recovery-time WAL repair: truncate every segment ending in a torn
    record back to its intact prefix (a torn record was never applied nor
    ACKed, so dropping it loses nothing durable) — otherwise replay would
    stop at the tear forever and records appended AFTER recovery, in later
    segments, would be unreachable. Returns the highest intact lsn."""
    last = 0
    for _, path in _seg_files(dirname):
        recs, intact = _read_segment(path)
        if recs:
            last = max(last, recs[-1].lsn)
        if not intact:
            good = sum(len(encode_record(r)) for r in recs)
            with open(path, "r+b") as f:
                f.truncate(good)
            # a truncation IS the recovery falling back to the last
            # intact record — same counter as a snapshot-generation
            # fallback, by the acceptance contract
            if _monitor._ENABLED:
                _monitor.count("ps.wal.fallbacks")
            import warnings
            warnings.warn(f"ps wal: torn tail in {os.path.basename(path)}; "
                          f"truncated to the last intact record")
    return last


def oldest_lsn(dirname: str) -> int:
    """First lsn still covered by the retained segment chain (0 = none)."""
    segs = _seg_files(dirname)
    return segs[0][0] if segs else 0


def gc_segments(dirname: str, below_lsn: int) -> List[str]:
    """Drop segments whose EVERY record is < below_lsn (covered by both
    the fallback snapshot generation and every standby's ack)."""
    segs = _seg_files(dirname)
    removed = []
    for i, (start, path) in enumerate(segs):
        nxt = segs[i + 1][0] if i + 1 < len(segs) else None
        if nxt is not None and nxt <= below_lsn:
            try:
                os.remove(path)
                removed.append(path)
            except OSError:
                pass
    return removed


# ---- crash-atomic snapshots (guard/checkpoint.py commit protocol) --------

class Snapshot(NamedTuple):
    version: int
    lsn: int
    ledger: Dict[str, dict]
    tables: Dict[str, tuple]          # name -> (kind, cfg dict)
    arrays: Dict[str, np.ndarray]     # "<table>::<key>" -> array


def _snap_path(dirname: str, version: int) -> str:
    return os.path.join(dirname, f"ps-snap-v{version}.npz")


def save_snapshot(dirname: str, lsn: int, ledger_state: Dict[str, dict],
                  tables: Dict[str, tuple],
                  arrays: Dict[str, np.ndarray]) -> int:
    """Commit one snapshot generation: versioned npz payload via
    `atomic_write`, then the JSON manifest as the commit record (file
    CRC + lsn watermark + ledger + table configs). The previous manifest
    survives as `.bak` and its payload is retained — the corruption
    fallback generation. Returns the new version."""
    os.makedirs(dirname, exist_ok=True)
    mpath = os.path.join(dirname, _MANIFEST)
    prev = _read_json(mpath)
    version = int(prev.get("version", 0)) + 1 if prev else 1
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    data = buf.getvalue()
    manifest = {
        "version": version, "lsn": int(lsn), "ledger": ledger_state,
        "tables": {n: [k, cfg] for n, (k, cfg) in tables.items()},
        "snap_file": os.path.basename(_snap_path(dirname, version)),
        "file_crc": _crc(data),
    }
    atomic_write(_snap_path(dirname, version), data)
    if _faults._ENABLED:
        # deterministic crash point BETWEEN payload and commit: the
        # manifest still references the previous generation
        _faults.check("ps.snapshot.commit")
    if os.path.exists(mpath):
        import shutil
        shutil.copyfile(mpath, mpath + ".bak")
    atomic_write(mpath, json.dumps(manifest).encode())
    # keep current + fallback payloads, GC older generations
    keep = {manifest["snap_file"], prev.get("snap_file", "")}
    for p in glob.glob(os.path.join(dirname, "ps-snap-v*.npz")):
        if os.path.basename(p) not in keep:
            try:
                os.remove(p)
            except OSError:
                pass
    if _monitor._ENABLED:
        _monitor.count("ps.snapshots")
    return version


def _read_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _load_one(dirname: str, manifest: dict) -> Snapshot:
    path = os.path.join(dirname, manifest["snap_file"])
    with open(path, "rb") as f:
        raw = f.read()
    if _crc(raw) != manifest["file_crc"]:
        raise ValueError(f"snapshot {path} failed its checksum")
    npz = np.load(io.BytesIO(raw))
    arrays = {k: npz[k] for k in npz.files}
    return Snapshot(int(manifest["version"]), int(manifest["lsn"]),
                    manifest.get("ledger", {}),
                    {n: (kc[0], kc[1])
                     for n, kc in manifest.get("tables", {}).items()},
                    arrays)


def load_snapshot(dirname: str) -> Optional[Snapshot]:
    """Newest intact snapshot generation, or None when no generation is
    loadable (recovery then replays the full WAL from lsn 0). On a
    corrupt current generation, falls back to `.bak`; an orphaned NEWER
    payload than the manifest references (crash between payload and
    commit) also counts `ps.wal.fallbacks` — the durable state fell back
    to the previous committed generation, exactly as designed."""
    mpath = os.path.join(dirname, _MANIFEST)
    manifest = _read_json(mpath)
    if not manifest:
        return None
    version = int(manifest.get("version", 0))
    orphans = [p for p in glob.glob(os.path.join(dirname, "ps-snap-v*.npz"))
               if _snap_version(p) > version]
    if orphans and _monitor._ENABLED:
        _monitor.count("ps.wal.fallbacks")
    try:
        return _load_one(dirname, manifest)
    except (OSError, ValueError, KeyError, Exception) as e:  # noqa: B014
        bak = _read_json(mpath + ".bak")
        if not bak:
            return None
        if _monitor._ENABLED:
            _monitor.count("ps.wal.fallbacks")
        import warnings
        warnings.warn(f"ps snapshot: {e}; falling back to the previous "
                      f"committed generation (v{bak.get('version')})")
        try:
            return _load_one(dirname, bak)
        except (OSError, ValueError, KeyError):
            return None


def _snap_version(path: str) -> int:
    try:
        return int(os.path.basename(path)[len("ps-snap-v"):-len(".npz")])
    except ValueError:
        return -1


# ---- introspection (python -m paddle_tpu_torch.monitor ps <wal-dir>) -----------

def wal_status(dirname: str) -> dict:
    """Offline view of a PS durability directory: snapshot generations,
    the WAL segment chain (with per-segment intactness), and the HA
    side-file (role + replication watermark) when present."""
    mpath = os.path.join(dirname, _MANIFEST)
    manifest = _read_json(mpath)
    bak = _read_json(mpath + ".bak")
    segments = []
    last = 0
    for start, path in _seg_files(dirname):
        recs, intact = _read_segment(path)
        if recs:
            last = max(last, recs[-1].lsn)
        segments.append({
            "file": os.path.basename(path), "start_lsn": start,
            "bytes": os.path.getsize(path), "records": len(recs),
            "last_lsn": recs[-1].lsn if recs else None, "intact": intact,
        })
    doc = {
        "dir": dirname,
        "snapshot": {
            "version": manifest.get("version"),
            "lsn": manifest.get("lsn"),
            "tables": sorted(manifest.get("tables", {})),
            "bak_version": bak.get("version"),
            "bak_lsn": bak.get("lsn"),
        } if manifest else None,
        "segments": segments,
        "last_lsn": last or manifest.get("lsn", 0),
        "ha": _read_json(os.path.join(dirname, "ha-status.json")) or None,
    }
    return doc
