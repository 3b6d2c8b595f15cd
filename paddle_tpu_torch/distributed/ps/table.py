"""Parameter-server tables: dense + sparse (hash) with server-side optimizers.

Counterpart of `paddle_tpu/distributed/ps/table.py`, the same numpy code,
so a table's rows are bit-equal to the reference's for the same seed and
pushes and either package loads the other's save files (Paddle's
`paddle/fluid/distributed/ps/table/common_dense_table.cc:1`
and `common_sparse_table.cc:1` (dense blocks / id->row hash tables with
per-row optimizer state, lazy row creation, save/load).

Tables are HOST-side (numpy) — the sparse embedding tier stays on CPU
hosts exactly as in Paddle; only pulled rows ever reach the card. The update rules run vectorized numpy (the server's C++
math role).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np


class _SGDRule:
    def __init__(self, lr=0.01, **_unused_hyper):
        self.lr = lr

    def slots(self, dim):
        return {}

    def apply(self, w, g, slots):
        w -= self.lr * g
        return w


class _AdagradRule:
    def __init__(self, lr=0.01, eps=1e-8, **_unused_hyper):
        self.lr = lr
        self.eps = eps

    def slots(self, dim):
        return {"g2": np.zeros(dim, np.float32)}

    def apply(self, w, g, slots):
        slots["g2"] += g * g
        w -= self.lr * g / (np.sqrt(slots["g2"]) + self.eps)
        return w


class _AdamRule:
    """Dense/sparse adam with per-row moments and per-row step counter
    (adam_op.h dense path / common_sparse_table adam accessor)."""

    def __init__(self, lr=0.01, beta1=0.9, beta2=0.999, eps=1e-8,
                 **_unused_hyper):
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps

    def slots(self, dim):
        return {"m": np.zeros(dim, np.float32),
                "v": np.zeros(dim, np.float32),
                "t": np.zeros((), np.float32)}

    def apply(self, w, g, slots):
        slots["t"] += 1.0
        t = float(slots["t"])
        slots["m"][...] = self.b1 * slots["m"] + (1 - self.b1) * g
        slots["v"][...] = self.b2 * slots["v"] + (1 - self.b2) * g * g
        mhat = slots["m"] / (1 - self.b1 ** t)
        vhat = slots["v"] / (1 - self.b2 ** t)
        w -= self.lr * mhat / (np.sqrt(vhat) + self.eps)
        return w


# lazy adam IS per-row adam on a sparse table: moments advance only when a
# row receives a gradient (reference lazy_mode; common_sparse_table.cc:1) —
# the SparseTable's per-key slot storage gives that behavior for free
_RULES = {"sgd": _SGDRule, "adagrad": _AdagradRule, "adam": _AdamRule,
          "lazy_adam": _AdamRule}

# wire ids for the table-config negotiation frames (service.py cmds 10/11
# and the native plane's config structs) — the ONE mapping both planes and
# both table kinds share
OPT_WIRE_IDS = {"sgd": 0, "adagrad": 1, "adam": 2, "lazy_adam": 2}


class CtrAccessor:
    """Show/click statistics + eviction scoring per sparse row.

    Reference parity: `paddle/fluid/distributed/ps/table/ctr_accessor.cc`
    (CtrCommonAccessor): every row carries decayed show/click counters; the
    shrink pass evicts rows whose score falls below a threshold or that
    have not been seen for `ttl_days` decay cycles.
    """

    def __init__(self, show_decay_rate=0.98, click_coeff=8.0,
                 delete_threshold=0.8, ttl_days=30):
        self.show_decay_rate = show_decay_rate
        self.click_coeff = click_coeff
        self.delete_threshold = delete_threshold
        self.ttl_days = ttl_days

    def fresh(self):
        return {"show": 0.0, "click": 0.0, "unseen_days": 0.0}

    def on_show_click(self, stat, show, click):
        stat["show"] += float(show)
        stat["click"] += float(click)
        stat["unseen_days"] = 0.0

    def decay(self, stat):
        """One decay cycle (reference UpdateTimeDecay, daily)."""
        stat["show"] *= self.show_decay_rate
        stat["click"] *= self.show_decay_rate
        stat["unseen_days"] += 1.0

    def score(self, stat):
        return stat["show"] + self.click_coeff * stat["click"]

    def should_evict(self, stat):
        return (self.score(stat) < self.delete_threshold
                or stat["unseen_days"] > self.ttl_days)


def dense_shard_range(total: int, shard: int, n_shards: int):
    """Contiguous row-range partition of a flat dense block (reference
    `ps/table/common_dense_table.cc` fixed_len split): shard s holds
    [start, end) with the remainder spread over the leading shards."""
    base, rem = divmod(int(total), int(n_shards))
    start = shard * base + min(shard, rem)
    return start, start + base + (1 if shard < rem else 0)


class DenseTable:
    """Fixed-shape dense parameter block (common_dense_table role). With
    `shard=(i, n)` the table holds only its contiguous row-range slice of
    the flattened block — the reference distributes dense params across
    servers the same way (`common_dense_table.cc`), removing the
    server-0 bandwidth/memory pinch point."""

    def __init__(self, shape, optimizer="sgd", lr=0.01, initializer=None,
                 shard=None, beta1=0.9, beta2=0.999, eps=1e-8,
                 shard_lo=None, total_size=None):
        self._lock = threading.Lock()
        total = int(np.prod(shape))
        self.total_size = total
        if shard_lo is not None:
            # explicit range (wire-negotiated tables): must be set BEFORE
            # the initializer so per-shard RNG streams decorrelate by the
            # TRUE global offset, not a post-construction patch
            self.total_size = int(total_size) if total_size else total
            self.shard_range = (int(shard_lo), int(shard_lo) + total)
            myshape = tuple(shape)
        elif shard is not None:
            i, n = shard
            if not 0 <= i < n:
                raise ValueError(f"dense shard index {i} out of range for "
                                 f"{n} shards")
            lo, hi = dense_shard_range(total, i, n)
            myshape: tuple = (hi - lo,)
            self.shard_range = (lo, hi)
        else:
            myshape = tuple(shape)
            self.shard_range = (0, total)
        if initializer == "zeros" or initializer is None:
            self.w = np.zeros(myshape, np.float32)
        else:
            # seed by the global offset so different shards draw
            # decorrelated streams
            rng = np.random.default_rng(self.shard_range[0])
            self.w = rng.normal(0, 0.01, myshape).astype(np.float32)
        self._rule = _RULES[optimizer](lr=lr, beta1=beta1, beta2=beta2,
                                       eps=eps)
        self._slots = self._rule.slots(self.w.shape)

    def pull(self):
        with self._lock:
            return self.w.copy()

    def push(self, grad):
        with self._lock:
            self._rule.apply(self.w, np.asarray(grad, np.float32), self._slots)

    def set(self, value):
        with self._lock:
            self.w[...] = value

    def state(self):
        return {"w": self.w, "slots": self._slots}

    def snapshot_arrays(self):
        """Durable state as flat arrays (see SparseTable.snapshot_arrays)."""
        with self._lock:
            out = {"w": self.w.copy()}
            for sname, arr in self._slots.items():
                out["slot_" + sname] = np.array(arr)
        return out

    def load_arrays(self, data):
        names = getattr(data, "files", None)
        if names is None:
            names = list(data.keys())
        with self._lock:
            self.w[...] = data["w"]
            for f in names:
                if f.startswith("slot_"):
                    # keep 0-d slots 0-d (adam's step counter "t")
                    self._slots[f[5:]] = np.array(data[f], np.float32)


class SparseTable:
    """id -> embedding-row hash table with lazy row init and per-row
    optimizer slots (common_sparse_table role)."""

    def __init__(self, dim, optimizer="sgd", lr=0.01, init_std=0.01, seed=0,
                 accessor=None, beta1=0.9, beta2=0.999, eps=1e-8,
                 **accessor_kw):
        self.dim = dim
        self._lock = threading.Lock()
        self._rows: Dict[int, np.ndarray] = {}
        self._slots: Dict[int, dict] = {}
        self._rule = _RULES[optimizer](lr=lr, beta1=beta1, beta2=beta2,
                                       eps=eps)
        self._init_std = init_std
        self._seed = seed
        # accessor="ctr": per-row show/click stats + decay/shrink eviction
        if accessor not in (None, "ctr"):
            raise TypeError(f"unknown accessor {accessor!r}")
        if accessor is None and accessor_kw:
            raise TypeError(
                f"unexpected keyword arguments {sorted(accessor_kw)} "
                "(accessor options need accessor='ctr')")
        self._accessor = CtrAccessor(**accessor_kw) if accessor == "ctr" else None
        self._stats: Dict[int, dict] = {}
        # keys evicted by the most recent shrink() — the delta-push plane
        # reads this to ship tombstones to serving subscribers
        self.last_shrink_evicted: list = []

    def _row(self, key: int) -> np.ndarray:
        r = self._rows.get(key)
        if r is None:
            # keyed (seed, id) stream, NOT a shared table RNG: lazy init
            # must not depend on first-touch ORDER, or a replica replaying
            # the same deltas in a different interleaving (WAL replay,
            # standby tail) would diverge from the primary
            rng = np.random.default_rng((self._seed, key & 0x7FFFFFFFFFFFFFFF))
            r = rng.normal(0, self._init_std, self.dim).astype(np.float32)
            self._rows[key] = r
            self._slots[key] = self._rule.slots(self.dim)
            if self._accessor is not None:
                self._stats[key] = self._accessor.fresh()
        return r

    # ---- CTR accessor surface (ctr_accessor.cc role) ----
    def push_show_click(self, ids, shows, clicks):
        if self._accessor is None:
            raise ValueError("table has no ctr accessor")
        ids = np.asarray(ids).reshape(-1)
        shows = np.asarray(shows).reshape(-1)
        clicks = np.asarray(clicks).reshape(-1)
        with self._lock:
            for i, s, c in zip(ids, shows, clicks):
                self._row(int(i))
                self._accessor.on_show_click(self._stats[int(i)], s, c)

    def decay(self):
        """One show/click decay cycle over every row (daily shrink prep)."""
        if self._accessor is None:
            raise ValueError("table has no ctr accessor")
        with self._lock:
            for st in self._stats.values():
                self._accessor.decay(st)

    def _on_evict(self, key):
        """Hook for subclasses tracking rows outside _rows (SSD tier)."""

    def shrink(self):
        """Evict rows below the score threshold or past their TTL
        (reference Table::Shrink). Returns number of evicted rows."""
        if self._accessor is None:
            raise ValueError("table has no ctr accessor")
        with self._lock:
            dead = [k for k, st in self._stats.items()
                    if self._accessor.should_evict(st)]
            for k in dead:
                self._rows.pop(k, None)
                self._slots.pop(k, None)
                self._stats.pop(k, None)
                self._on_evict(k)
            # evicted keys from the LAST shrink, for consumers that must
            # propagate tombstones (the PS delta-push plane)
            self.last_shrink_evicted = list(dead)
            return len(dead)

    def row_stat(self, key: int) -> Optional[dict]:
        with self._lock:
            st = self._stats.get(int(key))
            return dict(st) if st is not None else None

    def pull(self, ids) -> np.ndarray:
        ids = np.asarray(ids).reshape(-1)
        with self._lock:
            return np.stack([self._row(int(i)) for i in ids])

    def push(self, ids, grads):
        ids = np.asarray(ids).reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(len(ids), self.dim)
        with self._lock:
            # accumulate duplicate ids before applying (one update per key)
            acc: Dict[int, np.ndarray] = {}
            for i, g in zip(ids, grads):
                k = int(i)
                if k in acc:
                    acc[k] = acc[k] + g
                else:
                    acc[k] = g.copy()
            for k, g in acc.items():
                self._rule.apply(self._row(k), g, self._slots[k])

    def __len__(self):
        return len(self._rows)

    def state(self):
        return {"rows": self._rows, "slots": self._slots}

    _STAT_FIELDS = ("show", "click", "unseen_days")

    def _iter_all_rows(self):
        """(key, row, slots, stat) for every row the table owns — the SSD
        tier overrides this to include spilled rows."""
        for k in self._rows:
            yield k, self._rows[k], self._slots[k], self._stats.get(k)

    def snapshot_arrays(self):
        """Complete durable state as flat arrays — rows, per-row optimizer
        slots AND accessor stats round-trip (reference sparse tables
        persist accessor state with embeddings). Shared by `save` and the
        PS snapshot plane (`wal.save_snapshot`)."""
        with self._lock:
            items = list(self._iter_all_rows())
            keys = np.asarray([k for k, *_ in items], np.int64)
            vals = np.stack([r for _, r, _, _ in items]) if items \
                else np.zeros((0, self.dim), np.float32)
            slot_arrays = {}
            for sname in self._rule.slots(self.dim):
                slot_arrays["slot_" + sname] = np.stack(
                    [s[sname] for _, _, s, _ in items]) if items \
                    else np.zeros((0, self.dim), np.float32)
            if self._accessor is not None:
                for f in self._STAT_FIELDS:
                    # float64: stats are Python floats in memory, and the
                    # durability contract is a BIT-EXACT round-trip
                    slot_arrays["stat_" + f] = np.asarray(
                        [(st or self._accessor.fresh())[f]
                         for _, _, _, st in items], np.float64)
        return dict(keys=keys, vals=vals, **slot_arrays)

    def save(self, path):
        np.savez(path, **self.snapshot_arrays())

    def load_arrays(self, data):
        """Install state from a `snapshot_arrays`-shaped mapping (a dict
        of arrays or an open npz)."""
        names = getattr(data, "files", None)
        if names is None:
            names = list(data.keys())
        snames = [f[5:] for f in names if f.startswith("slot_")]
        has_stats = "stat_show" in names
        # decompress each npz member ONCE; store per-row copies so a row
        # update can't pin the whole backing array
        keys, vals = data["keys"], data["vals"]
        slot_data = {s: data["slot_" + s] for s in snames}
        stat_data = {f: data["stat_" + f] for f in self._STAT_FIELDS} \
            if has_stats else None
        with self._lock:
            for i, k in enumerate(keys):
                k = int(k)
                self._rows[k] = np.array(vals[i], np.float32)
                self._slots[k] = {s: np.array(slot_data[s][i])
                                  for s in snames} or self._rule.slots(self.dim)
                if self._accessor is not None:
                    self._stats[k] = (
                        {f: float(stat_data[f][i]) for f in self._STAT_FIELDS}
                        if stat_data is not None else self._accessor.fresh())
                self._on_load_row(k)

    def load(self, path):
        self.load_arrays(
            np.load(path if path.endswith(".npz") else path + ".npz"))

    def _on_load_row(self, key):
        """Hook: SSD tier registers loaded rows in its LRU and spills."""


class SSDSparseTable(SparseTable):
    """Sparse table with a bounded in-memory working set; cold rows spill
    to an on-disk key-value store and reload transparently on access.

    Reference parity: `paddle/fluid/distributed/ps/table/ssd_sparse_table.h`
    (RocksDB-backed sparse tier for embedding tables larger than RAM). The
    disk store here is a stdlib dbm database holding pickled (row, slots,
    stat) triples; eviction is LRU over the in-memory dict.
    """

    def __init__(self, dim, path, cache_rows=100000, **kw):
        super().__init__(dim, **kw)
        import dbm
        import os as _os
        _os.makedirs(_os.path.dirname(_os.path.abspath(path)) or ".",
                     exist_ok=True)
        self._db = dbm.open(path, "c")
        self._cache_rows = int(cache_rows)
        self._lru: Dict[int, None] = {}  # insertion-ordered LRU

    def _touch(self, key):
        self._lru.pop(key, None)
        self._lru[key] = None

    def _spill_if_needed(self):
        import pickle
        while len(self._rows) > self._cache_rows and self._lru:
            cold = next(iter(self._lru))
            self._lru.pop(cold)
            if cold not in self._rows:  # evicted by shrink since touched
                continue
            blob = pickle.dumps((self._rows.pop(cold),
                                 self._slots.pop(cold),
                                 self._stats.pop(cold, None)))
            self._db[str(cold).encode()] = blob

    def _row(self, key: int) -> np.ndarray:
        r = self._rows.get(key)
        if r is None:
            import pickle
            blob = self._db.get(str(key).encode())
            if blob is not None:
                row, slots, stat = pickle.loads(blob)
                self._rows[key] = row
                self._slots[key] = slots
                if stat is not None:
                    self._stats[key] = stat
                del self._db[str(key).encode()]
                r = row
            else:
                r = super()._row(key)
        self._touch(key)
        self._spill_if_needed()
        return r

    def __len__(self):
        # resident + spilled
        with self._lock:
            return len(self._rows) + len(self._db)

    @property
    def resident_rows(self):
        with self._lock:
            return len(self._rows)

    # ---- hooks keeping the LRU/disk tiers consistent with the base ----
    def _on_evict(self, key):
        self._lru.pop(key, None)
        k = str(key).encode()
        if k in self._db:
            del self._db[k]

    def _on_load_row(self, key):
        # A load() into a reused spill db must supersede any stale disk
        # copy, or _iter_all_rows would yield the key twice and the stale
        # row would win on the next load.
        self._on_evict(key)
        self._touch(key)
        self._spill_if_needed()

    def _iter_all_rows(self):
        import pickle
        yield from super()._iter_all_rows()
        for kb in self._db.keys():
            if int(kb.decode()) in self._rows:
                continue  # resident copy is authoritative
            row, slots, stat = pickle.loads(self._db[kb])
            yield int(kb.decode()), row, slots, stat

    def decay(self):
        """Decay covers SPILLED rows too (rewrites their stat on disk)."""
        super().decay()
        if self._accessor is None:
            return
        import pickle
        with self._lock:
            for kb in list(self._db.keys()):
                row, slots, stat = pickle.loads(self._db[kb])
                if stat is not None:
                    self._accessor.decay(stat)
                    self._db[kb] = pickle.dumps((row, slots, stat))

    def shrink(self):
        """Shrink walks the disk tier as well — the coldest rows are
        exactly the ones most likely to be spilled."""
        n = super().shrink()
        if self._accessor is None:
            return n
        import pickle
        with self._lock:
            for kb in list(self._db.keys()):
                _, _, stat = pickle.loads(self._db[kb])
                if stat is not None and self._accessor.should_evict(stat):
                    del self._db[kb]
                    self.last_shrink_evicted.append(int(kb))
                    n += 1
        return n

    def close(self):
        self._db.close()
