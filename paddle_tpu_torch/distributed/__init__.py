"""paddle.distributed: the port's namespace over `paddle_tpu_torch.parallel`.

Counterpart of `paddle_tpu/distributed/__init__.py`: the collectives, the
process environment, `spawn` / `launch`, `fleet`, the gloo control plane
(`gloo_init_parallel_env`, `gloo_barrier`, `gloo_release`, over
`torch.distributed.TCPStore`), `split`, and the sparse-table entry
configs, and the tensor- and pipeline-parallel names of the reference's
`parallel/__init__.py:26-33`. `InMemoryDataset` and `QueueDataset` wait
for the parameter-server slice (ROADMAP.md Queue 1, "the host-side
distributed state").
"""
import time as _time

from ..parallel import *  # noqa: F401,F403
from ..parallel import (  # noqa: F401
    ColumnParallelLinear, LayerDesc, ParallelCrossEntropy, PipelineLayer,
    PipelineParallel, RowParallelLinear, SharedLayerDesc, TensorParallel,
    VocabParallelEmbedding,
    DataParallel, Group, ParallelEnv, ReduceOp, Reducer, SPMDTrainStep,
    all_gather, all_gather_object, all_reduce, alltoall, alltoall_single,
    barrier, broadcast, fleet, get_backend, get_group, get_rank,
    get_world_size, init_parallel_env, irecv, isend, launch, new_group,
    p2p_shift, recv, reduce, reduce_scatter, scatter, send, spawn, wait,
)


class _PsEntryConfig:
    """Sparse-table entry (admission) policies for the PS tier
    (`distributed/entry_attr.py`): gate which feature ids get rows."""

    def __init__(self, kind, *args):
        self._kind = kind
        self._args = args

    def _to_attr(self):
        return ":".join([self._kind] + [str(a) for a in self._args])

    def __repr__(self):
        return f"{type(self).__name__}({', '.join(map(str, self._args))})"


class CountFilterEntry(_PsEntryConfig):
    """Admit a feature only after it has been seen `count` times."""

    def __init__(self, count: int):
        if count < 0:
            raise ValueError("count must be non-negative")
        super().__init__("count_filter_entry", int(count))


class ShowClickEntry(_PsEntryConfig):
    """Admission scored by named show/click input slots (CTR tables)."""

    def __init__(self, show_name: str, click_name: str):
        super().__init__("show_click_entry", show_name, click_name)


class ProbabilityEntry(_PsEntryConfig):
    """Admit a feature with the given probability."""

    def __init__(self, probability: float):
        if not 0 <= probability <= 1:
            raise ValueError("probability must be in [0, 1]")
        super().__init__("probability_entry", float(probability))


_GLOO_STATE = {}


def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """The CPU control plane's rendezvous: a TCPStore at `server_endpoint`
    ('host:port'), served by rank 0, with the world's timeout."""
    import torch.distributed as dist
    from ..parallel.env import TIMEOUT
    host, port = server_endpoint.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), int(rank_num),
                          is_master=(int(rank_id) == 0), timeout=TIMEOUT)
    _GLOO_STATE.update(store=store, rank=int(rank_id), nranks=int(rank_num),
                       gen=0)
    return store


def gloo_barrier(timeout_s: float = 60.0):
    """Every rank of the gloo control plane reaches this call before any
    leaves it; raises TimeoutError after `timeout_s`."""
    store = _GLOO_STATE.get("store")
    if store is None:
        raise RuntimeError("gloo_barrier before gloo_init_parallel_env")
    n = _GLOO_STATE["nranks"]
    gen = _GLOO_STATE["gen"]
    _GLOO_STATE["gen"] = gen + 1
    key = f"gloo_barrier/{gen}"
    arrived = store.add(key, 1)
    deadline = _time.monotonic() + timeout_s
    while arrived < n:
        if _time.monotonic() > deadline:
            raise TimeoutError(f"gloo_barrier: {arrived} of {n} ranks "
                               f"arrived within {timeout_s} s")
        _time.sleep(0.01)
        arrived = store.add(key, 0)


def gloo_release():
    _GLOO_STATE.clear()


def split(x, num_or_sections, axis=0, name=None):
    """paddle.distributed.split: the tensor form, as paddle.split (the
    row/column-parallel layer form comes with mp_layers)."""
    from ..ops.manipulation import split as _split
    return _split(x, num_or_sections, axis)
