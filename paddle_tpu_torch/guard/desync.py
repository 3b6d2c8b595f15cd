"""Cross-rank desync detection: parameter fingerprints, voted on across
the data-parallel group every N steps.

Counterpart of `paddle_tpu/guard/desync.py`. A rank can diverge silently
(a bit flip, a lost collective, a kernel that does not repeat) and train
a different model for hours. The detector folds a CRC32 of each
parameter's bytes with its name into one 32-bit fingerprint, all-gathers
it through the job's rendezvous store (`collective.store_all_gather_
object`), and votes: the majority value is the truth, a tie goes to the
lowest rank's value (rank 0 broadcast the initial parameters), and every
rank of the minority is named in a `RankDesyncError` raised on every rank.
"""
from __future__ import annotations

import zlib
from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from .. import monitor as _monitor
from .. import obs as _obs
from ..framework.io import _to_numpy
from .errors import RankDesyncError


def array_crc(arr) -> int:
    """CRC32 of a tensor's (or array's) bytes, copied to the host; bf16
    as its raw 2-byte values. A float32 array gives the reference's value
    for the same numbers."""
    a = _to_numpy(arr) if isinstance(arr, torch.Tensor) else np.asarray(arr)
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def fingerprint(named_arrays: Dict[str, object]) -> int:
    """One 32-bit value over every parameter: independent of the dict's
    order (names sorted), dependent on each name and on every byte."""
    crc = 0
    for name in sorted(named_arrays):
        crc = zlib.crc32(name.encode(), crc)
        crc = zlib.crc32(array_crc(named_arrays[name]).to_bytes(4, "little"),
                         crc)
    return crc & 0xFFFFFFFF


class DesyncDetector:
    """One per rank; the guard calls `check(step, named_arrays)` every
    `FLAGS_guard_desync_interval` good steps."""

    def __init__(self, store, rank: int, world_size: int,
                 timeout_s: float = 30.0, prefix: str = "guard/fp"):
        self.store = store
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.timeout_s = float(timeout_s)
        self.prefix = prefix

    def check(self, step: int, named_arrays: Dict[str, object]
              ) -> Dict[int, int]:
        """Exchange the fingerprints of round `step`: {rank: fingerprint},
        or RankDesyncError naming the minority rank(s)."""
        if self.world_size <= 1:
            return {self.rank: fingerprint(named_arrays)}
        if _monitor._ENABLED:
            _monitor.count("guard.desync_checks")
        from ..parallel.collective import store_all_gather_object
        fps = store_all_gather_object(
            self.store, f"{self.prefix}/{step}", fingerprint(named_arrays),
            self.rank, self.world_size, timeout_s=self.timeout_s)
        fps = {int(r): int(v) for r, v in fps.items()}
        offenders = self._vote(fps)
        if offenders:
            if _monitor._ENABLED:
                _monitor.count("guard.desync_errors")
            err = RankDesyncError(step=step, offenders=offenders,
                                  fingerprints=fps)
            if _obs._FR_ENABLED:
                _obs.record_event("guard.desync", step=step,
                                  offenders=offenders,
                                  fingerprints={str(r): v
                                                for r, v in fps.items()})
                _obs.dump_on_error(err)
            raise err
        return fps

    @staticmethod
    def _vote(fps: Dict[int, int]) -> List[int]:
        counts = Counter(fps.values())
        maxc = max(counts.values())
        tied = {v for v, c in counts.items() if c == maxc}
        ref = fps[min(r for r in fps if fps[r] in tied)]
        return sorted(r for r, v in fps.items() if v != ref)
