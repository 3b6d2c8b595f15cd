"""Multiprocess DataLoader workers with shared-memory numpy transport.

Counterpart of `paddle_tpu/io/worker.py` (worker processes, shared-memory
numpy transport, out-of-order results re-sequenced, dead workers
respawned), copied without the reference's fault-injection, monitor and
syncwatch hooks. Workers never touch torch tensors or a device: they
produce numpy, and the parent makes the tensors. Batches cross the
process boundary as `multiprocessing.shared_memory` blocks (pickle ships
only names and shapes).
"""
from __future__ import annotations

import multiprocessing as mp
import queue as pyqueue
import threading
import time
from multiprocessing import shared_memory

import numpy as np

from ..core import flags as _flags

_SENTINEL = None
_DONE = "__worker_done__"   # clean worker exit marker: (_DONE, worker_id)


def _untrack(name):
    """Detach a segment from this process's resource_tracker. The CHILD
    creates segments but the PARENT owns their lifetime (copy-then-unlink);
    without this, the tracker unlinks them when the worker exits — a race
    that manifests as FileNotFoundError on slow consumers (3.12 has no
    track=False yet)."""
    try:
        from multiprocessing import resource_tracker
        resource_tracker.unregister("/" + name.lstrip("/"), "shared_memory")
    except Exception:
        pass


def _np_collate(batch):
    """Worker-side collate to NUMPY structures only."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int32)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, (list, tuple)):
        return tuple(_np_collate(list(s)) for s in zip(*batch))
    if isinstance(sample, dict):
        return {k: _np_collate([b[k] for b in batch]) for k in sample}
    raise TypeError(f"multiprocess DataLoader cannot collate {type(sample)}; "
                    "provide a collate_fn returning numpy")


def _to_shm(obj, shms):
    """Replace ndarrays in a nested structure with shm descriptors."""
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        blk = shared_memory.SharedMemory(create=True, size=max(arr.nbytes, 1))
        _untrack(blk.name)  # parent owns lifetime, not this process
        view = np.ndarray(arr.shape, arr.dtype, buffer=blk.buf)
        view[...] = arr
        shms.append(blk)
        return ("__shm__", blk.name, arr.shape, arr.dtype.str)
    if isinstance(obj, tuple):
        return tuple(_to_shm(o, shms) for o in obj)
    if isinstance(obj, list):
        return [_to_shm(o, shms) for o in obj]
    if isinstance(obj, dict):
        return {k: _to_shm(v, shms) for k, v in obj.items()}
    return obj


def _from_shm(obj, opened):
    if isinstance(obj, tuple) and len(obj) == 4 and obj[0] == "__shm__":
        _, name, shape, dtype = obj
        blk = shared_memory.SharedMemory(name=name)  # attach (no tracker
        opened.append(blk)                           # registration on 3.12)
        # copy out so the block can be unlinked immediately
        return np.ndarray(shape, np.dtype(dtype), buffer=blk.buf).copy()
    if isinstance(obj, tuple):
        return tuple(_from_shm(o, opened) for o in obj)
    if isinstance(obj, list):
        return [_from_shm(o, opened) for o in obj]
    if isinstance(obj, dict):
        return {k: _from_shm(v, opened) for k, v in obj.items()}
    return obj


def _worker_loop(dataset, index_queue, result_queue, collate_fn,
                 use_shared_memory, worker_id, worker_init_fn,
                 num_workers=1):
    """Runs in the child process. numpy only: the parent makes tensors."""
    # publish worker metadata for get_worker_info (IterableDataset shards)
    try:
        from . import WorkerInfo, _WORKER_INFO
        _WORKER_INFO[0] = WorkerInfo(worker_id, num_workers,
                                     1234 + worker_id, dataset)
    except Exception:
        pass
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    collate = collate_fn or _np_collate
    while True:
        item = index_queue.get()
        if item is _SENTINEL:
            result_queue.put((_DONE, worker_id, None))
            return
        seq, indices = item
        try:
            batch = collate([dataset[i] for i in indices])
            if use_shared_memory:
                shms = []
                desc = _to_shm(batch, shms)
                result_queue.put((seq, desc, None))
                for blk in shms:  # parent copies out; child just closes
                    blk.close()
            else:
                result_queue.put((seq, batch, None))
        except Exception as e:  # noqa: BLE001 — ship to parent
            import traceback
            result_queue.put((seq, None, f"{e}\n{traceback.format_exc()}"))
            return


class MultiprocessIter:
    """Ordered multiprocess prefetch iterator (dataloader_iter.py role).

    Self-healing: each worker owns a PRIVATE index queue and the parent
    records every (seq, indices) assignment until its batch arrives. A
    worker that dies mid-epoch (OOM-kill, segfault) is
    detected by exitcode polling, respawned into a FRESH queue, and its
    outstanding assignments are re-enqueued — the epoch completes with
    every batch exactly once (duplicates a dying worker already shipped
    are dropped by seq), instead of the parent hanging on the result
    queue. Respawns per worker slot are bounded by
    FLAGS_dataloader_max_worker_restarts; past that the death is a hard
    error.

    Workers start with the `spawn` method (a process with CUDA and
    threads must not fork), so the dataset, `collate_fn` and
    `worker_init_fn` must be picklable."""

    _POLL_S = 0.5   # result-queue poll granularity for death detection

    def __init__(self, loader):
        self.loader = loader
        self._ctx = mp.get_context("spawn")
        n = loader.num_workers
        self._result_queue = self._ctx.Queue()
        self._index_queues = []
        self._workers = []
        self._pending = {}
        self._emit = 0
        self._seq = 0
        self._n_workers = n
        self._alive = True
        self._timeout = loader.timeout or None
        self._lock = threading.Lock()       # assignments + queue swaps
        self._assigned = [dict() for _ in range(n)]  # wid -> {seq: indices}
        self._finished = [False] * n        # clean sentinel-exit seen
        self._restarts = [0] * n
        self._max_restarts = int(_flags.flag(
            "dataloader_max_worker_restarts"))
        self._feed_done = False
        for wid in range(n):
            self._index_queues.append(self._ctx.Queue())
            self._workers.append(self._spawn(wid))
        self._feeder = threading.Thread(target=self._feed, daemon=True)
        self._feeder.start()

    def _spawn(self, wid):
        p = self._ctx.Process(
            target=_worker_loop,
            args=(self.loader.dataset, self._index_queues[wid],
                  self._result_queue, self.loader.worker_collate_fn,
                  self.loader.use_shared_memory, wid,
                  self.loader.worker_init_fn, self._n_workers),
            daemon=True)
        p.start()
        return p

    def _feed(self):
        for indices in self.loader.batch_sampler:
            indices = list(indices)
            wid = self._seq % self._n_workers
            with self._lock:
                self._assigned[wid][self._seq] = indices
                self._index_queues[wid].put((self._seq, indices))
            self._seq += 1
        with self._lock:
            self._feed_done = True
            for q in self._index_queues:
                q.put(_SENTINEL)

    def _respawn_dead_worker(self, wid):
        """Replace a dead worker: fresh index queue seeded with every
        assignment it still owed (the abandoned queue may hold some of
        them too — re-sending all is safe, the parent dedups by seq)."""
        self._restarts[wid] += 1
        if self._restarts[wid] > self._max_restarts:
            self._shutdown()
            raise RuntimeError(
                f"DataLoader worker {wid} died (exitcode "
                f"{self._workers[wid].exitcode}) and exhausted its "
                f"{self._max_restarts} respawns "
                "(FLAGS_dataloader_max_worker_restarts)")
        with self._lock:
            self._index_queues[wid] = self._ctx.Queue()
            for seq, indices in sorted(self._assigned[wid].items()):
                self._index_queues[wid].put((seq, indices))
            if self._feed_done:
                self._index_queues[wid].put(_SENTINEL)
        self._workers[wid] = self._spawn(wid)

    def _check_workers(self):
        for wid, p in enumerate(self._workers):
            if p.exitcode is not None and not self._finished[wid]:
                with self._lock:
                    owes = bool(self._assigned[wid]) or not self._feed_done
                if not owes:
                    # died after handing over everything it was assigned
                    # (e.g. killed while idle): nothing to recover
                    self._finished[wid] = True
                    continue
                self._respawn_dead_worker(wid)

    def __next__(self):
        deadline = (time.monotonic() + self._timeout) \
            if self._timeout else None
        while True:
            if self._emit in self._pending:
                desc, err = self._pending.pop(self._emit)
                self._emit += 1
                if err is not None:
                    self._shutdown()
                    raise RuntimeError(f"DataLoader worker failed:\n{err}")
                opened = []
                batch = _from_shm(desc, opened) \
                    if self.loader.use_shared_memory else desc
                for blk in opened:
                    blk.close()
                    try:
                        blk.unlink()
                    except FileNotFoundError:
                        pass
                return self.loader._post_collate(batch)
            # epoch complete: every fed batch has been emitted (robust to
            # sentinel loss/duplication across respawns)
            if self._feed_done and self._emit >= self._seq:
                self._shutdown()
                raise StopIteration
            try:
                poll = self._POLL_S
                if deadline is not None:
                    poll = min(poll, max(0.0, deadline - time.monotonic()))
                item = self._result_queue.get(timeout=poll)
            except pyqueue.Empty:
                if deadline is not None and time.monotonic() >= deadline:
                    self._shutdown()
                    raise RuntimeError(
                        f"DataLoader timed out after {self._timeout}s")
                self._check_workers()   # dead worker? respawn + re-enqueue
                continue
            if item[0] == _DONE:   # == : the marker crosses a pickle hop
                self._finished[item[1]] = True
                continue
            seq, desc, err = item
            if seq < self._emit or seq in self._pending:
                # duplicate from a worker that died after shipping (its
                # batches were conservatively re-enqueued): reclaim + drop
                if err is None and self.loader.use_shared_memory:
                    self._unlink_desc(desc)
                continue
            with self._lock:
                self._assigned[seq % self._n_workers].pop(seq, None)
            self._pending[seq] = (desc, err)

    def __iter__(self):
        return self

    @staticmethod
    def _unlink_desc(desc):
        """Reclaim shm segments of an unconsumed batch descriptor (the
        parent owns their lifetime — see _untrack)."""
        if isinstance(desc, tuple) and len(desc) == 4 and desc[0] == "__shm__":
            try:
                blk = shared_memory.SharedMemory(name=desc[1])
                blk.close()
                blk.unlink()
            except FileNotFoundError:
                pass
            return
        if isinstance(desc, (tuple, list)):
            for o in desc:
                MultiprocessIter._unlink_desc(o)
        elif isinstance(desc, dict):
            for o in desc.values():
                MultiprocessIter._unlink_desc(o)

    def _shutdown(self):
        if not self._alive:
            return
        self._alive = False
        for p in self._workers:
            if p.is_alive():
                p.terminate()
        for p in self._workers:
            p.join(timeout=2)
        # early exit (break / exception / GC): prefetched-but-unconsumed
        # batches still hold untracked shm segments — unlink them here
        if self.loader.use_shared_memory:
            for desc, _err in self._pending.values():
                self._unlink_desc(desc)
            self._pending.clear()
            while True:
                try:
                    item = self._result_queue.get_nowait()
                except (pyqueue.Empty, OSError, ValueError):
                    break
                if (item is not _SENTINEL and item[0] != _DONE
                        and item[2] is None):
                    self._unlink_desc(item[1])

    def __del__(self):
        try:
            self._shutdown()
        except Exception:
            pass
