"""DataLoader: batches from a dataset through a sampler, in order.

Counterpart of `paddle_tpu/io/dataloader.py` (DataLoader :183,
`default_collate_fn`, the thread prefetcher and the iterable-dataset
iterator), with the reference's hooks in the thread prefetcher: the
`io.dataloader.worker_batch` / `io.dataloader.queue_wait` histograms
(FLAGS_monitor), the consumer's wait booked as the timeline's
`data_wait` between steps (FLAGS_obs_timeline), and its threads as
`syncwatch.Thread`s. Worker processes are `io.worker`.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from .. import monitor as _monitor
from .. import obs as _obs
from ..utils import syncwatch as _syncwatch
from .dataset import IterableDataset
from .sampler import BatchSampler


def default_collate_fn(batch):
    """Samples -> a batch of host tensors: stacked arrays and tensors,
    int32 for integers and float32 for floats (the reference's dtypes),
    recursing into tuples, lists and dicts."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, dtype=np.int32))
    if isinstance(sample, float):
        return torch.from_numpy(np.asarray(batch, dtype=np.float32))
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return tuple(default_collate_fn(list(s)) for s in transposed)
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


class _PrefetchIter:
    def __init__(self, loader):
        self.loader = loader
        self.batch_sampler_iter = iter(loader.batch_sampler)
        self.queue = queue.Queue(maxsize=loader.prefetch_factor)
        self._stop = threading.Event()
        self._threads = []
        n_workers = max(1, loader.num_workers)
        self._n_workers = n_workers
        self._done_workers = 0
        self._index_lock = threading.Lock()
        self._seq = 0
        self._pending = {}
        self._emit = 0
        for _ in range(n_workers):
            t = _syncwatch.Thread(target=self._worker, daemon=True)
            t.start()
            self._threads.append(t)

    def _next_indices(self):
        with self._index_lock:
            try:
                idx = next(self.batch_sampler_iter)
            except StopIteration:
                return None, None
            seq = self._seq
            self._seq += 1
            return seq, idx

    def _worker(self):
        ds, collate = self.loader.dataset, self.loader.collate_fn
        while not self._stop.is_set():
            seq, indices = self._next_indices()
            if seq is None:
                self.queue.put((None, None))
                return
            try:
                if _monitor._ENABLED:
                    tb = time.time()
                    batch = collate([ds[i] for i in indices])
                    _monitor.observe("io.dataloader.worker_batch",
                                     time.time() - tb)
                else:
                    batch = collate([ds[i] for i in indices])
                self.queue.put((seq, batch))
            except Exception as e:  # propagate to consumer
                self.queue.put((seq, e))
                return

    def __next__(self):
        # re-order worker results to sampler order
        while True:
            if self._emit in self._pending:
                batch = self._pending.pop(self._emit)
                self._emit += 1
                if isinstance(batch, Exception):
                    raise batch
                return batch
            # all workers done: every produced batch is queued or pending
            if self._done_workers >= self._n_workers and self.queue.empty():
                raise StopIteration
            if _monitor._ENABLED or _obs._TL_ENABLED:
                # how long the consumer stalls on the workers: the signal
                # that the input pipeline, not the device, is the bottleneck
                tw = time.time()
                seq, batch = self.queue.get()
                t1 = time.time()
                if _monitor._ENABLED:
                    _monitor.observe("io.dataloader.queue_wait", t1 - tw)
                # between steps: folds into the next step record's
                # `between` bucket (obs/timeline.py)
                _obs.add_phase("data_wait", t1 - tw, tw, t1)
            else:
                seq, batch = self.queue.get()
            if seq is None:
                self._done_workers += 1
                continue
            self._pending[seq] = batch

    def __iter__(self):
        return self

    def __del__(self):
        self._stop.set()


class _SimpleIter:
    def __init__(self, loader):
        self.loader = loader
        self.it = iter(loader.batch_sampler)

    def __next__(self):
        indices = next(self.it)
        samples = [self.loader.dataset[i] for i in indices]
        return self.loader.collate_fn(samples)

    def __iter__(self):
        return self


class _IterableIter:
    def __init__(self, loader):
        self.loader = loader
        self.it = iter(loader.dataset)

    def __next__(self):
        batch = []
        for _ in range(self.loader.batch_size):
            try:
                batch.append(next(self.it))
            except StopIteration:
                break
        if not batch or (self.loader.drop_last
                         and len(batch) < self.loader.batch_size):
            raise StopIteration
        return self.loader.collate_fn(batch)

    def __iter__(self):
        return self


def _wrap_numpy(obj):
    """Parent-side: numpy batch structure -> host tensors."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if isinstance(obj, tuple):
        return tuple(_wrap_numpy(o) for o in obj)
    if isinstance(obj, list):
        return [_wrap_numpy(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _wrap_numpy(v) for k, v in obj.items()}
    return obj


class DataLoader:
    """`num_workers>0` uses real worker PROCESSES with shared-memory numpy
    transport (`io.worker`, dataloader_iter.py parity); pass
    `use_shared_memory=False` to ship batches by pickling, or
    `use_buffer_reader=False` to force the in-process thread prefetcher.
    A custom `collate_fn` runs in the worker and must return numpy.

    Batches are host tensors, in the sampler's order whatever the number
    of workers. The copy to the device is the consumer's: `TrainStep`
    makes it at each call, `io.DevicePrefetcher` ahead of the step on a
    side stream. `places` and `return_list` are accepted for signature
    parity."""

    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False,
                 collate_fn=None, num_workers=0, use_buffer_reader=True,
                 prefetch_factor=2, use_shared_memory=True, timeout=0,
                 worker_init_fn=None, persistent_workers=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate_fn
        self.worker_collate_fn = collate_fn  # None -> worker numpy collate
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.use_shared_memory = use_shared_memory
        self.use_buffer_reader = use_buffer_reader
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self._iterable = isinstance(dataset, IterableDataset)
        if not self._iterable:
            self.batch_sampler = batch_sampler or BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
        else:
            self.batch_sampler = None

    def _post_collate(self, np_batch):
        return _wrap_numpy(np_batch)

    def __iter__(self):
        if self._iterable:
            return _IterableIter(self)
        if self.num_workers > 0:
            if self.use_buffer_reader:
                from .worker import MultiprocessIter
                return MultiprocessIter(self)
            return _PrefetchIter(self)
        return _SimpleIter(self)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)
