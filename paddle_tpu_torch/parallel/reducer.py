"""Bucketed gradient all-reduce for data parallelism.

Counterpart of `paddle_tpu/parallel/reducer.py` (the reference Paddle's
dygraph `Reducer`, `imperative/reducer.cc`): gradients are grouped into
size-capped buckets (`FLAGS_dp_bucket_mb`, DataParallel's
`comm_buffer_size`) in reverse parameter order, never mixing dtypes, and
each bucket is reduced by one flat all-reduce. `bucket_layout()` and
`bucket_sizes()` are the reference's for the same parameters and
`bucket_bytes`.

Two forms:
  - `reduce(grads)`: the reference's, over a list of gradients: one flat
    all-reduce per bucket in issue order, the mean when `mean=True`.
  - The eager form the reference's docstring describes: `attach(tensors)`
    registers a post-accumulate-grad hook on each parameter (or leaf
    alias); once every member of a bucket has its gradient, the bucket's
    async all-reduce starts, so communication overlaps the rest of the
    backward. Buckets are launched in bucket order on every rank (a
    ready bucket waits for the ones before it), as NCCL requires. At the
    end of the backward (an autograd-engine callback) the reductions are
    waited for, averaged and written back into each `.grad`. A parameter
    that got no gradient in a backward is reduced as zeros when
    `find_unused_parameters=True`, and raises otherwise.

Each bucket's collective is counted as `c_allreduce_bucket` (the
reference's :103, :108).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import flags as _flags
from . import collective

__all__ = ["Reducer"]


def _dtype_of(p):
    d = getattr(p, "dtype", None)
    if isinstance(d, torch.dtype):
        return d
    return torch.from_numpy(np.zeros(0, dtype=np.asarray(p).dtype)).dtype


def _nbytes(shape, dtype) -> int:
    item = torch.empty((), dtype=dtype).element_size()
    return int(np.prod(shape)) * item if shape else item


class Reducer:
    """Size-capped gradient buckets over a parameter list, reduced one
    collective per bucket in backward (reverse-parameter) order.

    `params` supplies shapes and dtypes (tensors or arrays); `axis` is the
    group (a `collective.Group` or a mesh axis name) the gradients are
    reduced over."""

    def __init__(self, params: Sequence, axis="dp",
                 bucket_bytes: Optional[int] = None, mean: bool = True,
                 find_unused_parameters: bool = False):
        self.axis = axis
        self.mean = mean
        self.find_unused_parameters = find_unused_parameters
        if bucket_bytes is None:
            bucket_bytes = int(_flags.flag("dp_bucket_mb")) << 20
        self.bucket_bytes = max(1, int(bucket_bytes))
        self._shapes = [tuple(getattr(p, "shape", np.shape(p)))
                        for p in params]
        self._dtypes = [_dtype_of(p) for p in params]
        self._buckets = self._build(self._shapes, self._dtypes)
        self._bucket_of = {i: b for b, members in enumerate(self._buckets)
                           for i in members}
        self._handles = []
        self._tensors = None

    def _build(self, shapes, dtypes) -> List[List[int]]:
        buckets: List[List[int]] = []
        cur: List[int] = []
        cur_bytes = 0
        cur_dtype = None
        # reverse order = backward production order
        for i in reversed(range(len(shapes))):
            nb = _nbytes(shapes[i], dtypes[i])
            if cur and (dtypes[i] != cur_dtype
                        or cur_bytes + nb > self.bucket_bytes):
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nb
            cur_dtype = dtypes[i]
        if cur:
            buckets.append(cur)
        return buckets

    # ---- introspection ----
    def bucket_layout(self) -> List[List[int]]:
        """Original-order parameter indices per bucket, in issue order."""
        return [list(b) for b in self._buckets]

    def bucket_sizes(self) -> List[int]:
        return [sum(_nbytes(self._shapes[i], self._dtypes[i]) for i in b)
                for b in self._buckets]

    def group(self):
        return collective._resolve(self.axis)

    def _scale(self, t, n):
        if self.mean and n > 1:
            t.mul_(torch.tensor(1.0 / n, dtype=t.dtype, device=t.device))

    # ---- the reference's form: a list of gradients ----
    def reduce(self, grads: Sequence) -> List:
        """Reduce a gradient list (aligned with the constructor's params)
        across the group: one flat all-reduce per bucket, in issue order.
        Returns new tensors, in the original parameter order."""
        n = self.group().nranks
        out: List = [None] * len(grads)
        for bucket in self._buckets:
            flat = self._flat([grads[i] for i in bucket])
            self._all_reduce(flat).wait()
            self._scale(flat, n)
            self._unflatten(flat, bucket, out)
        return out

    def _flat(self, gs):
        if len(gs) == 1:
            return gs[0].detach().clone()
        return torch.cat([g.detach().reshape(-1) for g in gs])

    def _all_reduce(self, flat):
        """One bucket's async all-reduce, recorded as c_allreduce_bucket
        (under `collective.record_only()`, as its `psum`)."""
        g = self.group()
        collective._rec("psum", self.axis, g, flat)
        if collective.recording():
            return collective._Task()
        collective._record("c_allreduce_bucket", flat)
        if not collective._live(g):
            return collective._Task()
        with collective._phase():
            return collective._all_reduce(flat, collective.ReduceOp.SUM, g,
                                          async_op=True)

    def _unflatten(self, flat, bucket, out):
        if len(bucket) == 1:
            out[bucket[0]] = flat.reshape(self._shapes[bucket[0]])
            return
        off = 0
        for i in bucket:
            size = int(np.prod(self._shapes[i])) if self._shapes[i] else 1
            out[i] = flat[off:off + size].reshape(self._shapes[i])
            off += size

    # ---- the eager form: hooks during the backward ----
    def attach(self, tensors: Sequence[torch.Tensor]):
        """Register the post-accumulate-grad hooks on `tensors` (aligned
        with the constructor's params), replacing those of an earlier
        attach. Every backward through them then reduces their `.grad`."""
        self.detach_hooks()
        self._tensors = list(tensors)
        self._reset()
        for i, t in enumerate(self._tensors):
            self._handles.append(t.register_post_accumulate_grad_hook(
                lambda p, i=i: self._on_grad(i)))
        return self

    def detach_hooks(self):
        for h in self._handles:
            h.remove()
        self._handles = []

    def _reset(self):
        self._ready = [0] * len(self._buckets)
        self._seen = set()
        self._works = {}
        self._next = 0
        self._queued = False

    def _on_grad(self, i):
        if not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finish)
        if i in self._seen:
            return
        self._seen.add(i)
        b = self._bucket_of[i]
        self._ready[b] += 1
        self._launch_ready()

    def _launch_ready(self):
        """Start every complete bucket whose predecessors have started."""
        while self._next < len(self._buckets) and \
                self._ready[self._next] == len(self._buckets[self._next]):
            self._launch(self._next)
            self._next += 1

    def _launch(self, b):
        bucket = self._buckets[b]
        flat = self._flat([self._tensors[i].grad for i in bucket])
        self._works[b] = (flat, self._all_reduce(flat))

    def _finish(self):
        """End of the backward: complete the buckets that are left (unused
        parameters as zeros, or raise), wait, average, write back."""
        missing = [i for i in range(len(self._tensors))
                   if i not in self._seen]
        if missing:
            if not self.find_unused_parameters:
                self._reset()
                raise RuntimeError(
                    f"DataParallel: parameters {missing[:8]} (of "
                    f"{len(self._tensors)}) got no gradient in this "
                    "backward; pass find_unused_parameters=True to reduce "
                    "them as zeros")
            for i in missing:
                t = self._tensors[i]
                if t.grad is None:
                    t.grad = torch.zeros_like(t)
                self._seen.add(i)
                self._ready[self._bucket_of[i]] += 1
            self._launch_ready()
        n = self.group().nranks
        out = [None] * len(self._tensors)
        for b in range(len(self._buckets)):
            flat, task = self._works[b]
            task.wait()
            self._scale(flat, n)
            self._unflatten(flat, self._buckets[b], out)
        with torch.no_grad():
            for t, g in zip(self._tensors, out):
                t.grad.copy_(g)
        self._reset()
