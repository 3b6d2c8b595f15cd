"""Collective communication API over `torch.distributed`.

Counterpart of `paddle_tpu/parallel/collective.py`. The reference runs
each collective per shard inside `shard_map` as an XLA op over a mesh
axis; the port runs one process per card, and each function is the same
collective over a process group: rank r of a group sees what shard r sees
inside the reference's `shard_map`. The world is made by
`env.init_parallel_env`; without one, a group holds this process alone and
every collective returns its input's value, as the reference's eager
single-controller regime does.

`group` takes a `Group`, a mesh axis name ('dp', 'sharding', 'mp', 'pp',
'sp': the axis's group of the process-world `HybridCommunicateGroup`,
else the whole world), or None: the whole world, as in paddle (the
reference's default axis of each function, 'dp', 'mp' or 'pp', spans the
world on a data-parallel mesh). `src` / `dst` are global ranks, as in
paddle.

NCCL runs every function as its own collective. Gloo has no form of some
of them, and none of some for CUDA tensors, so on gloo (and never on
NCCL) they are composed:
  - `ReduceOp.AVG` is SUM, then a division by the group size;
  - `reduce_scatter` is `all_reduce`, then the rank's slice;
  - on CUDA tensors, `scatter`, `alltoall`, `alltoall_single` and the
    point-to-point functions copy through host memory and run gloo's CPU
    form (gloo moves CUDA tensors through the host for every collective).

Every call is counted by `_record` into the monitor (`collective.<name>.
count` / `.bytes`, FLAGS_monitor) and the flight recorder's collective ring
(FLAGS_obs_flight_recorder), under the reference's names, and takes the
step timeline's `collective` phase when no phase is open.

`record_only()` is the port's counterpart of tracing a step for the
reference's `analysis.collective_sequence`: inside it no call
communicates; each appends a `CollectiveDesc(op, axis, shape, dtype,
perm)` (the reference's `analysis/graph.py:179`, with its primitive names:
`psum`, `pmax`, `pmin`, `pmean`, `all_gather`, `psum_scatter`,
`all_to_all`, `ppermute`, and `send` / `recv` / `broadcast` / `barrier`
for the point-to-point and rooted calls) and returns a value of the shape
the call would give. Run under `FakeTensorMode`, a step issues its whole
sequence without touching a number.
"""
from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

import torch
import torch.distributed as dist

from .. import monitor as _monitor
from .. import obs as _obs
from .env import TIMEOUT, is_world

# the collective sequence of a capture (`capture()`), or None
_SEQ = [None]
_SEQ_LOCK = threading.Lock()
# the CollectiveDesc lists of a `record_only()` / `trace()` block, or None
_REC = [None]
_TRACE = [None]


class CollectiveDesc:
    """One collective in a rank's sequence: what must match across peers
    for the call to complete instead of deadlocking (the reference's
    `analysis/graph.py:179`)."""

    __slots__ = ("op", "axis", "shape", "dtype", "perm")

    def __init__(self, op: str, axis, shape, dtype, perm=None):
        self.op = op
        self.axis = axis
        self.shape = tuple(shape)
        self.dtype = str(dtype).replace("torch.", "")
        self.perm = tuple(perm) if perm is not None else None

    def _key(self):
        return (self.op, self.axis, self.shape, self.dtype, self.perm)

    def __eq__(self, other):
        return isinstance(other, CollectiveDesc) and \
            self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        shp = ",".join(str(s) for s in self.shape)
        return f"{self.op}(axis={self.axis}, {self.dtype}[{shp}])"


@contextlib.contextmanager
def record_only():
    """Inside the block no collective communicates: each appends its
    CollectiveDesc to the yielded list and returns a value of its result's
    shape (the input's values, or copies of them)."""
    seq: List = []
    prev, _REC[0] = _REC[0], seq
    try:
        yield seq
    finally:
        _REC[0] = prev


@contextlib.contextmanager
def trace():
    """Collect the CollectiveDesc of every collective issued inside the
    block, which communicate as usual: what a step really issued, to hold
    against what `record_only()` traced."""
    seq: List = []
    prev, _TRACE[0] = _TRACE[0], seq
    try:
        yield seq
    finally:
        _TRACE[0] = prev


def first_divergence(a, b):
    """The index of the first entry where CollectiveDesc sequences `a` and
    `b` differ (or where the shorter one ends), or None when they are
    equal: the collective two ranks would deadlock on (the reference's
    `analysis.verify_collective_order`)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def recording() -> bool:
    return _REC[0] is not None


def _axis_name(group, g) -> Optional[str]:
    if isinstance(group, str):
        return group
    return g.axis_name


def _in_group(g, rank):
    """A global rank's index in group `g` (the rank itself when it is not
    a member): perms are recorded in group indices, as the reference's
    axis indices, so the ranks of one stage record the same sequence."""
    return g.ranks.index(rank) if rank in g.ranks else rank


def _rec(op, group, g, t, perm=None):
    """Append the call's CollectiveDesc to the open `record_only()` and
    `trace()` lists."""
    if _REC[0] is None and _TRACE[0] is None:
        return
    desc = CollectiveDesc(op, _axis_name(group, g), tuple(t.shape),
                          t.dtype, perm)
    for seq in (_REC[0], _TRACE[0]):
        if seq is not None:
            seq.append(desc)


_OP_NAME = {0: "psum", 1: "pmax", 2: "pmin", 3: "pprod", 4: "pmean"}


def _record(name: str, t) -> None:
    """Monitor + flight-recorder planes (and an open `capture()`): count
    the collective and its logical payload bytes."""
    if not (_monitor._ENABLED or _obs._FR_ENABLED or _SEQ[0] is not None):
        return
    nbytes = int(t.numel()) * t.element_size() if isinstance(
        t, torch.Tensor) else 0
    if _monitor._ENABLED:
        _monitor.record_collective(name, nbytes)
    if _obs._FR_ENABLED:
        _obs.record_collective(name, nbytes)
    seq = _SEQ[0]
    if seq is not None:
        with _SEQ_LOCK:
            seq.append((name, nbytes))


@contextlib.contextmanager
def capture():
    """Collect the (name, bytes) of every collective this process issues
    inside the block, from any thread, in issue order."""
    seq: List = []
    prev, _SEQ[0] = _SEQ[0], seq
    try:
        yield seq
    finally:
        _SEQ[0] = prev


def _phase():
    if _obs._TL_ENABLED and not _obs.in_phase():
        return _obs.phase("collective")
    return contextlib.nullcontext()


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT,
             ReduceOp.AVG: dist.ReduceOp.AVG}


class Group:
    """A communication group: its global `ranks`, this process's `rank`
    in it (-1 when it is not a member), and the `torch.distributed`
    process group (None for a group this process holds alone, whose
    collectives are local)."""

    def __init__(self, ranks, process_group=None, ring_id: int = 0,
                 axis_name: Optional[str] = None):
        self.ranks = list(ranks)
        self.nranks = len(self.ranks)
        self.process_group = process_group
        self.id = ring_id
        self.axis_name = axis_name
        me = dist.get_rank() if is_world() else 0
        self.rank = self.ranks.index(me) if me in self.ranks else -1

    @property
    def world_size(self):
        return self.nranks

    @property
    def backend(self) -> Optional[str]:
        pg = self.process_group
        return None if pg is None else dist.get_backend(pg)

    def __repr__(self):
        return (f"Group(id={self.id}, ranks={self.ranks}, "
                f"axis={self.axis_name}, backend={self.backend})")


_GROUPS = {}
_WORLD = [None]


def _world_group() -> Group:
    """Group 0: every rank of the world (a world of one included), or this
    process alone without a world."""
    g = _WORLD[0]
    up = is_world()
    if g is None or (g.process_group is not None) != up or (
            up and g.nranks != dist.get_world_size()):
        if up:
            g = Group(range(dist.get_world_size()), dist.group.WORLD, 0)
        else:
            g = Group([0], None, 0)
        _WORLD[0] = g
        _GROUPS[0] = g
    return g


def new_group(ranks=None, backend=None, axis_name: Optional[str] = None):
    """A group over `ranks` (global ranks; all of them when None). In a
    world every rank must call it, in the same order, as
    `torch.distributed.new_group` requires; the group is made with the
    world's timeout."""
    gid = len(_GROUPS) + (0 if 0 in _GROUPS else 1)
    if not is_world():
        g = Group(range(len(ranks)) if ranks else [0], None, gid, axis_name)
        g.rank = 0
    else:
        ranks = sorted(ranks) if ranks else list(range(dist.get_world_size()))
        pg = dist.new_group(ranks, timeout=TIMEOUT, backend=backend)
        member = dist.get_rank() in ranks
        g = Group(ranks, pg if member else None, gid, axis_name)
    _GROUPS[g.id] = g
    return g


def get_group(ring_id=0):
    if ring_id == 0:
        return _world_group()
    return _GROUPS.get(ring_id)


def _resolve(group) -> Group:
    if isinstance(group, Group):
        return group
    if not isinstance(group, str):
        return _world_group()
    name = group
    from .topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is not None and getattr(hcg, "process_mode", False):
        g = hcg.axis_group(name)
        if g is not None:
            return g
    return _world_group()


def _live(g: Group) -> bool:
    """True when the group's collectives go through a process group."""
    return g.process_group is not None


def _gloo(g: Group) -> bool:
    return g.backend == "gloo"


def _host_staged(g: Group, t: torch.Tensor) -> bool:
    """Gloo with a CUDA tensor, for a function gloo has no CUDA form of."""
    return _gloo(g) and t.is_cuda


class _Task:
    """What an async call returns: `wait()` completes the works and runs
    the composition's last step (a division, a copy back)."""

    def __init__(self, works=(), post=None):
        self._works = [w for w in works if w is not None]
        self._post = post

    def wait(self, timeout=None):
        for w in self._works:
            w.wait()
        self._works = []
        if self._post is not None:
            post, self._post = self._post, None
            post()
        return True

    def is_completed(self):
        return not self._works and self._post is None


def _all_reduce(t, op, g, async_op=False) -> _Task:
    pg = g.process_group
    post = None
    top = _TORCH_OP[op]
    if op == ReduceOp.AVG and (_gloo(g) or not t.is_floating_point()):
        top = dist.ReduceOp.SUM
        n = g.nranks
        if t.is_floating_point():
            def post():
                t.div_(n)
        else:
            def post():
                t.copy_(torch.div(t, n, rounding_mode="floor"))
    work = dist.all_reduce(t, op=top, group=pg, async_op=async_op)
    return _Task([work] if async_op else [], post)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """In place (paddle semantics): `tensor` is replaced with the result.
    Returns the tensor, or a task with `wait()` when `sync_op` is False."""
    g = _resolve(group)
    _rec(_OP_NAME[op], group, g, tensor)
    if _REC[0] is not None:
        return tensor if sync_op else _Task()
    _record("c_allreduce", tensor)
    if not _live(g):
        return tensor if sync_op else _Task()
    with _phase():
        task = _all_reduce(tensor, op, g, async_op=not sync_op)
        if sync_op:
            task.wait()
            return tensor
    return task


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """Every rank's `tensor`, stacked along a new dimension `axis` (the
    reference's `lax.all_gather(tiled=False)` at axis 0); `tensor_list`,
    when given, is extended with the parts in rank order."""
    g = _resolve(group)
    _rec("all_gather", group, g, tensor)
    if _REC[0] is not None:
        parts = [tensor.clone() for _ in range(g.nranks)]
    elif not _live(g):
        _record("c_allgather", tensor)
        parts = [tensor]
    else:
        _record("c_allgather", tensor)
        src = tensor.contiguous()
        parts = [torch.empty_like(src) for _ in range(g.nranks)]
        with _phase():
            dist.all_gather(parts, src, group=g.process_group)
    if tensor_list is not None:
        tensor_list.extend(parts)
    return torch.stack(parts, dim=axis)


def all_gather_object(obj_list, obj, group=None):
    g = _resolve(group)
    if not _live(g):
        obj_list.append(obj)
        return obj_list
    out = [None] * g.nranks
    dist.all_gather_object(out, obj, group=g.process_group)
    obj_list.extend(out)
    return obj_list


def reduce_scatter(tensor, tensor_list_or_input, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """The reduction of every rank's input (a list is concatenated along
    axis 0), split into group-size chunks along axis 0: rank r gets chunk
    r (the reference's `psum_scatter(tiled=True)`). Written into `tensor`
    when it is given; returns the chunk."""
    src = tensor_list_or_input
    if isinstance(src, (list, tuple)):
        src = torch.cat(list(src), dim=0)
    g = _resolve(group)
    _rec("psum_scatter", group, g, src)
    if _REC[0] is not None:
        out = src.chunk(g.nranks, 0)[max(g.rank, 0)].clone()
    elif not _live(g):
        _record("c_reducescatter", src)
        out = src
    elif src.shape[0] % g.nranks:
        _record("c_reducescatter", src)
        raise ValueError(f"reduce_scatter: axis 0 of {tuple(src.shape)} "
                         f"does not split into {g.nranks} chunks")
    else:
        _record("c_reducescatter", src)
        with _phase():
            if _gloo(g):
                # gloo: all_reduce, then this rank's slice
                buf = src.clone()
                _all_reduce(buf, op, g).wait()
                out = buf.chunk(g.nranks, 0)[g.rank].clone()
            else:
                out = src.new_empty((src.shape[0] // g.nranks,)
                                    + tuple(src.shape[1:]))
                dist.reduce_scatter_tensor(out, src.contiguous(),
                                           op=_TORCH_OP[op],
                                           group=g.process_group)
    if tensor is not None:
        tensor.copy_(out.reshape(tensor.shape))
        return tensor
    return out


def broadcast(tensor, src=0, group=None, sync_op=True):
    """In place: every rank's `tensor` becomes rank `src`'s."""
    g = _resolve(group)
    _rec("broadcast", group, g, tensor, perm=(_in_group(g, src),))
    if _REC[0] is not None:
        return tensor
    _record("c_broadcast", tensor)
    if _live(g):
        with _phase():
            dist.broadcast(tensor, src=src, group=g.process_group)
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """As in the reference, every rank holds the result (an all_reduce)."""
    return all_reduce(tensor, op, group, sync_op)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """In place: rank r's `tensor` becomes entry r of rank `src`'s
    `tensor_list`."""
    g = _resolve(group)
    _rec("scatter", group, g, tensor, perm=(_in_group(g, src),))
    if _REC[0] is not None:
        return tensor
    _record("c_scatter", tensor)
    if not _live(g):
        if tensor_list is not None:
            tensor.copy_(tensor_list[g.rank if g.rank >= 0 else 0])
        return tensor
    me = dist.get_rank()
    with _phase():
        if _host_staged(g, tensor):
            out = tensor.detach().cpu()
            parts = [t.detach().cpu() for t in tensor_list] \
                if me == src else None
            dist.scatter(out, parts, src=src, group=g.process_group)
            tensor.copy_(out)
        else:
            parts = [t.contiguous() for t in tensor_list] \
                if me == src else None
            dist.scatter(tensor, parts, src=src, group=g.process_group)
    return tensor


def _all_to_all_single(out, src, g, out_splits=None, in_splits=None):
    if _host_staged(g, src):
        host_out = out.new_empty(out.shape, device="cpu")
        dist.all_to_all_single(host_out, src.detach().cpu(), out_splits,
                               in_splits, group=g.process_group)
        out.copy_(host_out)
    else:
        dist.all_to_all_single(out, src.contiguous(), out_splits, in_splits,
                               group=g.process_group)
    return out


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """Entry j of rank i's list goes to rank j, as entry i of its output
    (stacked along axis 0; `out_tensor_list` is extended with the
    entries)."""
    if isinstance(in_tensor_list, (list, tuple)):
        src = torch.stack(list(in_tensor_list), dim=0)
    else:
        src = in_tensor_list
    g = _resolve(group)
    _rec("all_to_all", group, g, src)
    if _REC[0] is not None:
        out = src.clone()
    elif not _live(g):
        _record("alltoall", src)
        out = src
    else:
        _record("alltoall", src)
        with _phase():
            out = _all_to_all_single(torch.empty_like(src), src, g)
    if out_tensor_list is not None:
        out_tensor_list.extend(out.unbind(0))
    return out


def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """Axis 0 of `in_tensor` split into group-size chunks (or
    `in_split_sizes`), chunk j sent to rank j; the chunks received,
    concatenated in rank order (the reference's tiled `all_to_all`)."""
    g = _resolve(group)
    _rec("all_to_all", group, g, in_tensor)
    if _REC[0] is not None:
        out = in_tensor.clone()
    elif not _live(g):
        _record("alltoall_single", in_tensor)
        out = in_tensor
    else:
        _record("alltoall_single", in_tensor)
        rows = sum(out_split_sizes) if out_split_sizes else in_tensor.shape[0]
        out = out_tensor if out_tensor is not None else in_tensor.new_empty(
            (rows,) + tuple(in_tensor.shape[1:]))
        with _phase():
            _all_to_all_single(out, in_tensor, g, out_split_sizes,
                               in_split_sizes)
        return out
    if out_tensor is not None:
        out_tensor.copy_(out)
        return out_tensor
    return out


def _p2p(fn, tensor, peer, g, recv: bool):
    """isend / irecv of `tensor` to / from global rank `peer`: (work,
    post), through host memory for a CUDA tensor on gloo."""
    if _host_staged(g, tensor):
        host = tensor.detach().cpu() if not recv else \
            torch.empty(tensor.shape, dtype=tensor.dtype)
        work = fn(host, peer, group=g.process_group)
        return work, (lambda: tensor.copy_(host)) if recv else \
            (lambda: host)
    return fn(tensor.contiguous() if not recv else tensor, peer,
              group=g.process_group), None


def _me():
    return dist.get_rank() if is_world() else 0


def isend(tensor, dst=0, group=None, sync_op=False):
    g = _resolve(group)
    _rec("send", group, g, tensor,
         perm=(_in_group(g, _me()), _in_group(g, dst)))
    if _REC[0] is not None:
        return _Task()
    _record("send_v2", tensor)
    if not _live(g):
        return _Task()
    work, post = _p2p(dist.isend, tensor, dst, g, recv=False)
    return _Task([work], post)


def irecv(tensor, src=0, group=None, sync_op=False):
    g = _resolve(group)
    _rec("recv", group, g, tensor,
         perm=(_in_group(g, src), _in_group(g, _me())))
    if _REC[0] is not None:
        return _Task()
    if not _live(g):
        return _Task()
    work, post = _p2p(dist.irecv, tensor, src, g, recv=True)
    return _Task([work], post)


def send_recv(ops, group=None):
    """Point-to-point calls posted together, then waited on: `ops` is a
    list of ("send", tensor, dst) and ("recv", tensor, src) with global
    ranks; each received tensor is written in place. NCCL runs them as
    one group (`batch_isend_irecv`: a send and a receive that wait on each
    other's peers cannot deadlock on the stream); gloo posts each
    `isend` / `irecv`. Recorded as the `send` / `recv` they are."""
    g = _resolve(group)
    for kind, t, peer in ops:
        pair = (_me(), peer) if kind == "send" else (peer, _me())
        _rec(kind, group, g, t, perm=tuple(_in_group(g, x) for x in pair))
    if _REC[0] is not None or not _live(g):
        return
    for kind, t, _ in ops:
        if kind == "send":
            _record("send_v2", t)
    with _phase():
        if g.backend == "nccl":
            p2p = [dist.P2POp(dist.isend if kind == "send" else dist.irecv,
                              t.contiguous() if kind == "send" else t, peer,
                              g.process_group) for kind, t, peer in ops]
            for w in dist.batch_isend_irecv(p2p):
                w.wait()
            return
        tasks = []
        for kind, t, peer in ops:
            work, post = _p2p(dist.isend if kind == "send" else dist.irecv,
                              t, peer, g, recv=kind == "recv")
            tasks.append(_Task([work], post))
        for task in tasks:
            task.wait()


def send(tensor, dst=0, group=None, sync_op=True):
    """Send `tensor` to global rank `dst`."""
    task = isend(tensor, dst, group)
    if not sync_op:
        return task
    with _phase():
        task.wait()
    return None


def recv(tensor, src=0, group=None, sync_op=True):
    """In place: `tensor` receives global rank `src`'s send."""
    task = irecv(tensor, src, group)
    if not sync_op:
        return task
    with _phase():
        task.wait()
    return tensor


def p2p_shift(x, group="pp", shift=1):
    """Each rank's `x` moves `shift` places along the group (rank i's goes
    to rank i + shift): the reference's `ppermute` neighbour shift."""
    g = _resolve(group)
    n = g.nranks
    _rec("ppermute", group, g, x,
         perm=[(i, (i + shift) % n) for i in range(n)])
    if _REC[0] is not None:
        return x.clone()
    _record("p2p_shift", x)
    if not _live(g) or shift % n == 0:
        return x.clone()
    dst = g.ranks[(g.rank + shift) % n]
    src = g.ranks[(g.rank - shift) % n]
    out = torch.empty_like(x)
    with _phase():
        if _host_staged(g, x):
            host, got = x.detach().cpu(), torch.empty(x.shape, dtype=x.dtype)
            ops = [dist.P2POp(dist.isend, host, dst, g.process_group),
                   dist.P2POp(dist.irecv, got, src, g.process_group)]
        else:
            got = out
            ops = [dist.P2POp(dist.isend, x.contiguous(), dst,
                              g.process_group),
                   dist.P2POp(dist.irecv, got, src, g.process_group)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        if got is not out:
            out.copy_(got)
    return out


def barrier(group=None):
    """Every rank of the group reaches this call before any leaves it."""
    g = _resolve(group)
    _rec("barrier", group, g, torch.empty(0))
    if _REC[0] is not None:
        return
    if not _live(g):
        return
    kwargs = {}
    if g.backend == "nccl":
        kwargs["device_ids"] = [torch.cuda.current_device()]
    with _phase():
        dist.barrier(group=g.process_group, **kwargs)


def wait(tensor, group=None, use_calc_stream=True):
    """Block the host until the work queued on `tensor`'s stream is done."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()


__all__ = ["ReduceOp", "Group", "new_group", "get_group", "all_reduce",
           "all_gather", "all_gather_object", "reduce_scatter", "broadcast",
           "reduce", "scatter", "alltoall", "alltoall_single", "send", "recv",
           "isend", "irecv", "p2p_shift", "barrier", "wait", "capture",
           "CollectiveDesc", "record_only", "recording", "trace",
           "first_divergence", "send_recv"]
