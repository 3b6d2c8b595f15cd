"""GraphTable — node/edge store + neighbor sampling on the PS plane.

Counterpart of `paddle_tpu/distributed/ps/graph_table.py`, the same numpy
store (Paddle's `paddle/fluid/distributed/ps/table/common_graph_table.h:355`
(GraphTable: edge lists per node with optional weights, node features,
`random_sample_neighbors`, `random_sample_nodes`, `get_node_feat`) — the
GNN-sampling backend PGL drives through the PS service.

Fixed-shape contract: `sample_neighbors` returns [n, k] id/weight arrays
(pad id -1), sampling with replacement — downstream GNN minibatch
programs keep static shapes without data-dependent padding logic.
The store itself is host-side (the reference's is too — graph sampling is
a CPU-side service feeding the accelerator).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

import numpy as np


class GraphTable:
    def __init__(self, weighted: bool = True, feat_dim: int = 0, seed: int = 0):
        self._lock = threading.Lock()
        self.weighted = weighted
        self.feat_dim = int(feat_dim)
        self._adj: Dict[int, List[int]] = {}
        self._w: Dict[int, List[float]] = {}
        self._feat: Dict[int, np.ndarray] = {}
        self._rng = np.random.default_rng(seed)

    # ---- construction (load_edges / load_nodes roles) ----
    def add_edges(self, src, dst, weight=None):
        src = np.asarray(src, np.int64).reshape(-1)
        dst = np.asarray(dst, np.int64).reshape(-1)
        w = (np.asarray(weight, np.float32).reshape(-1) if weight is not None
             else np.ones(len(src), np.float32))
        if not (len(src) == len(dst) == len(w)):
            raise ValueError("add_edges: src/dst/weight length mismatch")
        with self._lock:
            for s, d, wt in zip(src, dst, w):
                self._adj.setdefault(int(s), []).append(int(d))
                self._w.setdefault(int(s), []).append(float(wt))
                self._adj.setdefault(int(d), self._adj.get(int(d), []))

    def set_node_feat(self, ids, feats):
        ids = np.asarray(ids, np.int64).reshape(-1)
        feats = np.asarray(feats, np.float32).reshape(len(ids), -1)
        if self.feat_dim and feats.shape[1] != self.feat_dim:
            raise ValueError(
                f"feat dim {feats.shape[1]} != table feat_dim {self.feat_dim}")
        with self._lock:
            for i, f in zip(ids, feats):
                self._feat[int(i)] = f.copy()

    # ---- queries ----
    def n_nodes(self) -> int:
        with self._lock:
            return len(self._adj)

    def neighbors(self, node: int):
        with self._lock:
            return (list(self._adj.get(int(node), [])),
                    list(self._w.get(int(node), [])))

    def sample_neighbors(self, ids, k: int):
        """[n] ids -> ([n, k] neighbor ids, [n, k] weights); pad -1/0.
        Weighted tables sample proportionally to edge weight (reference
        WeightedSampler); unweighted uniformly; always with replacement."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        out = np.full((len(ids), k), -1, np.int64)
        ow = np.zeros((len(ids), k), np.float32)
        with self._lock:
            for r, i in enumerate(ids):
                nbrs = self._adj.get(int(i))
                if not nbrs:
                    continue
                w = np.asarray(self._w[int(i)], np.float64)
                p = w / w.sum() if self.weighted and w.sum() > 0 else None
                sel = self._rng.choice(len(nbrs), size=k, replace=True, p=p)
                out[r] = np.asarray(nbrs, np.int64)[sel]
                ow[r] = np.asarray(self._w[int(i)], np.float32)[sel]
        return out, ow

    def random_sample_nodes(self, k: int):
        with self._lock:
            pool = np.fromiter(self._adj.keys(), np.int64, len(self._adj))
        if len(pool) == 0:
            return np.empty(0, np.int64)
        return self._rng.choice(pool, size=min(k, len(pool)), replace=False)

    def get_node_feat(self, ids):
        ids = np.asarray(ids, np.int64).reshape(-1)
        d = self.feat_dim or (next(iter(self._feat.values())).shape[0]
                              if self._feat else 0)
        out = np.zeros((len(ids), d), np.float32)
        with self._lock:
            for r, i in enumerate(ids):
                f = self._feat.get(int(i))
                if f is not None:
                    out[r, :len(f)] = f
        return out

    def state(self):
        return {"adj": self._adj, "w": self._w, "feat": self._feat}

    # ---- durability (rides the PS snapshot/fetch-state plane) ----
    def snapshot_arrays(self) -> Dict[str, np.ndarray]:
        """Deterministic flat-array form for atomic_write+CRC snapshots:
        edges as (src, dst, weight) triples iterated over SORTED source
        nodes with per-node insertion order preserved (the order
        `sample_neighbors` indexes by), isolated nodes separately, and
        features sorted by key. Same table content -> same bytes, so a
        restart restore is bit-identical."""
        with self._lock:
            src: List[int] = []
            dst: List[int] = []
            w: List[float] = []
            iso: List[int] = []
            for s in sorted(self._adj.keys()):
                nbrs = self._adj[s]
                if not nbrs:
                    iso.append(s)
                    continue
                src.extend([s] * len(nbrs))
                dst.extend(nbrs)
                w.extend(self._w.get(s, [1.0] * len(nbrs)))
            fkeys = sorted(self._feat.keys())
            fdim = (self._feat[fkeys[0]].shape[0] if fkeys
                    else max(self.feat_dim, 1))
            fvals = (np.stack([self._feat[k] for k in fkeys])
                     if fkeys else np.zeros((0, fdim), np.float32))
            return {
                "edge_src": np.asarray(src, np.int64),
                "edge_dst": np.asarray(dst, np.int64),
                "edge_w": np.asarray(w, np.float32),
                "iso_nodes": np.asarray(iso, np.int64),
                "feat_keys": np.asarray(fkeys, np.int64),
                "feat_vals": fvals.astype(np.float32),
            }

    def load_arrays(self, arrays: Dict[str, np.ndarray]) -> None:
        """Restore from `snapshot_arrays` output (replaces content)."""
        with self._lock:
            self._adj.clear()
            self._w.clear()
            self._feat.clear()
            for s, d, wt in zip(arrays["edge_src"], arrays["edge_dst"],
                                arrays["edge_w"]):
                self._adj.setdefault(int(s), []).append(int(d))
                self._w.setdefault(int(s), []).append(float(wt))
                self._adj.setdefault(int(d), self._adj.get(int(d), []))
            for n in arrays.get("iso_nodes", ()):
                self._adj.setdefault(int(n), [])
            feat_vals = np.asarray(arrays.get(
                "feat_vals", np.zeros((0, 1), np.float32)), np.float32)
            for i, k in enumerate(arrays.get("feat_keys", ())):
                self._feat[int(k)] = feat_vals[i].copy()
