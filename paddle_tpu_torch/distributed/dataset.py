"""Dataset tier: slot-format file ingestion for PS/CTR training.

Counterpart of `paddle_tpu/distributed/dataset.py`, the same parser and
batcher, so one seed gives bit-equal batches in both packages.

Reference parity: `python/paddle/fluid/dataset.py` (InMemoryDataset /
QueueDataset facade) over the C++ `framework/data_feed.cc`
MultiSlotDataFeed (slot-format text parsing, `data_feed.proto` config),
`data_set.cc` (in-memory store, local/global shuffle), driven by
`exe.train_from_dataset` (`executor.py:1731`).

Wire format (MultiSlotDataFeed): one sample per line; for each configured
slot, `<n> v1 ... vn` — uint64 slots carry sparse feature ids, float slots
carry dense values. Batches come out as {slot_name: np.ndarray}; ragged
id slots are padded via the LoD bucket policy with a companion
"<slot>.lengths" array.
"""
from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


class DatasetBase:
    def __init__(self):
        self._batch_size = 1
        self._slots: List[str] = []
        self._types: List[str] = []
        self._filelist: List[str] = []

    def init(self, batch_size: int = 1, use_slots: Sequence[str] = (),
             slot_types: Optional[Sequence[str]] = None, **kw):
        self._batch_size = int(batch_size)
        self._slots = list(use_slots)
        self._types = list(slot_types) if slot_types else \
            ["uint64"] * len(self._slots)
        if len(self._types) != len(self._slots):
            raise ValueError("slot_types length must match use_slots")
        return self

    def set_batch_size(self, bs: int):
        self._batch_size = int(bs)

    def set_filelist(self, files: Sequence[str]):
        self._filelist = list(files)

    def _parse_line(self, line: str):
        toks = line.split()
        out = []
        i = 0
        for ty in self._types:
            if i >= len(toks):
                raise ValueError(f"malformed slot line: {line!r}")
            n = int(toks[i])
            vals = toks[i + 1:i + 1 + n]
            if len(vals) != n:
                raise ValueError(f"slot declared {n} values, got "
                                 f"{len(vals)}: {line!r}")
            i += 1 + n
            out.append(np.asarray(vals, np.uint64 if ty == "uint64"
                                  else np.float32))
        return out

    def _batches_from_samples(self, samples) -> Iterator[Dict[str, np.ndarray]]:
        from ..core.lod import bucket_length
        bs = self._batch_size
        for i in range(0, len(samples) - bs + 1, bs):
            chunk = samples[i:i + bs]
            batch: Dict[str, np.ndarray] = {}
            for si, (name, ty) in enumerate(zip(self._slots, self._types)):
                vals = [s[si] for s in chunk]
                if ty == "uint64":
                    # sparse id slots are ALWAYS bucket-padded + lengths —
                    # per-type, not per-batch, so the batch layout is
                    # deterministic. Stays numpy uint64 host-side (full
                    # 64-bit hash ids: torch has no uint64 tensor).
                    lens = [len(v) for v in vals]
                    t = bucket_length(max(lens))
                    arr = np.zeros((len(vals), t), np.uint64)
                    for r, v in enumerate(vals):
                        arr[r, :len(v)] = v
                    batch[name] = arr
                    batch[name + ".lengths"] = np.asarray(lens, np.int32)
                else:
                    if any(len(v) != len(vals[0]) for v in vals):
                        raise ValueError(
                            f"dense float slot {name!r} has ragged lengths; "
                            "declare it uint64 or fix the data")
                    batch[name] = np.stack(vals)
            yield batch


class InMemoryDataset(DatasetBase):
    """Load-then-shuffle dataset (reference InMemoryDataset)."""

    def __init__(self):
        super().__init__()
        self._samples: List = []

    def load_into_memory(self):
        self._samples = []
        for path in self._filelist:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        self._samples.append(self._parse_line(line))

    def local_shuffle(self, seed: Optional[int] = None):
        random.Random(seed).shuffle(self._samples)

    def global_shuffle(self, fleet=None, seed: Optional[int] = None):
        # single-host: same as local (reference shuffles across trainers)
        self.local_shuffle(seed)

    def release_memory(self):
        self._samples = []

    def get_memory_data_size(self):
        return len(self._samples)

    def __iter__(self):
        return self._batches_from_samples(self._samples)


class QueueDataset(DatasetBase):
    """Streaming dataset: parse files lazily, no in-memory store
    (reference QueueDataset)."""

    def __iter__(self):
        def stream():
            buf = []
            for path in self._filelist:
                with open(path) as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            buf.append(self._parse_line(line))
                            if len(buf) == self._batch_size:
                                yield from self._batches_from_samples(buf)
                                buf = []
        return stream()
