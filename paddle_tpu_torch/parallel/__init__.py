"""paddle_tpu_torch.parallel — the distributed stack (paddle.distributed).

Counterpart of `paddle_tpu/parallel/`. The reference is single-controller:
one process drives every chip of a mesh, and its collectives are XLA ops
over mesh axes. The port runs one process per card, NCCL between cards
through `torch.distributed` (gloo on the CPU):

  - `env.py`: `init_parallel_env`, `get_rank`, `get_world_size`,
    `ParallelEnv`, from the launcher's `PADDLE_*` environment;
  - `collective.py`: the collectives over process groups, `Group`,
    `new_group`;
  - `launch.py` (`python -m paddle_tpu_torch.parallel.launch`) and
    `spawn` below: one process per card;
  - `topology.py`: the strategy's hybrid topology; over a process world
    its dp and sharding groups are real groups;
  - `reducer.py`: bucketed gradient all-reduce overlapped with the
    backward; `data_parallel.py`: `DataParallel`;
  - `spmd.py`: `SPMDTrainStep`, data parallelism and ZeRO stages 1-3;
  - `mp_layers.py`: tensor parallelism (the dense layers without a
    world, the rank's slices and the collectives in one);
    `pp_layers.py` and `pipeline_parallel.py`: pipeline parallelism, 1F1B
    over the slots of one process's mesh or over the pp group of a world;
    `grad_clip.py`: norm clips over gradients split across ranks;
  - `hybrid_optimizer.py`, `meta_parallel.py` (`TensorParallel` =
    `ShardingParallel`), `fleet.py`: the fleet facade;
  - `strategy.py`, and `sp.py` (sequence parallelism, ring and Ulysses
    attention, still single-controller inside one process).

Expert parallelism (`moe.py`) is not ported yet.
"""
import os as _os
import traceback as _traceback

from .strategy import DistributedStrategy  # noqa: F401
from .env import (ParallelEnv, get_backend, get_rank,  # noqa: F401
                  get_world_size, init_parallel_env)
from .topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup, Mesh, create_mesh, get_mesh,
    get_hybrid_communicate_group, set_mesh, use_mesh,
)
from .collective import (  # noqa: F401
    Group, ReduceOp, all_gather, all_gather_object, all_reduce, alltoall,
    alltoall_single, barrier, broadcast, get_group, irecv, isend, new_group,
    p2p_shift, recv, reduce, reduce_scatter, scatter, send, wait,
)
from .reducer import Reducer  # noqa: F401
from .data_parallel import DataParallel  # noqa: F401
from .meta_parallel import ShardingParallel, TensorParallel  # noqa: F401
from .mp_layers import (ColumnParallelLinear,  # noqa: F401
                        ParallelCrossEntropy, RowParallelLinear,
                        VocabParallelEmbedding)
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc  # noqa: F401
from .pipeline_parallel import PipelineParallel  # noqa: F401
from .spmd import SPMDTrainStep  # noqa: F401
from .hybrid_optimizer import (  # noqa: F401
    DygraphShardingOptimizer, HybridParallelOptimizer, group_sharded_parallel,
    save_group_sharded_model,
)
from .sp import (  # noqa: F401
    SequenceParallelAttention, ring_attention_local,
    ring_flash_attention_local, sequence_parallel_attention,
    ulysses_attention_local,
)
from . import fleet  # noqa: F401
from . import launch  # noqa: F401

# seconds `spawn` waits for its ranks unless `timeout=` says otherwise
SPAWN_TIMEOUT = 900.0


def _spawn_entry(func, args, env, errors):
    """A rank's process: the launcher's environment, then func(*args). An
    exception is reported (rank, time, traceback) on `errors` and the
    process exits 1 at once, without waiting on its peers."""
    _os.environ.update(env)
    if "OMP_NUM_THREADS" in env:        # torch is imported already here
        import torch
        torch.set_num_threads(int(env["OMP_NUM_THREADS"]))
    try:
        func(*args)
    except BaseException:               # noqa: BLE001
        # reported, then the process ends at once: a re-raise would run
        # the atexit teardown, which can wait on peers that are gone
        import sys
        import time
        tb = _traceback.format_exc()
        sys.stderr.write(tb)
        sys.stderr.flush()
        errors.put((int(env["PADDLE_TRAINER_ID"]), time.time(), tb))
        _os._exit(1)
    from . import env as _env
    _env._release()


class _Proc:
    def __init__(self, p):
        self.p = p

    def poll(self):
        return self.p.exitcode


class SpawnContext:
    """The started ranks (`processes`); `join(timeout)` waits for them and
    raises on the first rank that failed or when the time runs out."""

    def __init__(self, processes, timeout, errors=None):
        self.processes = processes
        self.timeout = timeout
        self.errors = errors

    def join(self, timeout=None):
        timeout = self.timeout if timeout is None else timeout
        procs = [_Proc(p) for p in self.processes]
        rc = launch.watch(procs, timeout, stop=lambda q: q.p.kill())
        for p in self.processes:
            p.join(30)
        if rc == 124:
            raise TimeoutError(f"spawn: the ranks did not finish within "
                               f"{timeout} s; all were stopped")
        if rc != 0:
            failed = [(r, p.exitcode) for r, p in enumerate(self.processes)
                      if p.exitcode not in (0, None)]
            reports = []
            while self.errors is not None and not self.errors.empty():
                reports.append(self.errors.get())
            first, code, tail = failed[0][0], failed[0][1], ""
            if reports:      # the rank whose exception came first
                first, _, tb = min(reports, key=lambda e: e[1])
                code, tail = 1, "\n" + tb[-2000:]
            raise RuntimeError(f"spawn: rank {first} exited with code "
                               f"{code} (failed ranks, exit codes: "
                               f"{failed}); the others were stopped{tail}")
        return True


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """paddle.distributed.spawn: start `nprocs` processes (one per card)
    through `torch.multiprocessing`, each with the launcher's `PADDLE_*`
    environment, running `func(*args)` (a module-level function). Options:
    `backend` ('nccl' / 'gloo'; default NCCL on cards, gloo on the CPU),
    `gpus` (the card of each rank, '0,1' or a list; one card may be named
    twice for gloo), `device='cpu'` (every rank on the CPU) and `timeout`
    (seconds; SPAWN_TIMEOUT). `nprocs=-1` takes one rank per entry of
    `gpus`, else per visible card. With `join` (the default) waits for all
    and raises on the first failed rank (the first exception in time,
    with its traceback), stopping the others; returns the SpawnContext."""
    import torch
    import torch.multiprocessing as mp
    gpus = launch._gpu_list(options.get("gpus"))
    device = options.get("device")
    if nprocs == -1:
        if gpus:
            nprocs = len(gpus)
        elif device == "cpu":
            raise ValueError("spawn(device='cpu') needs nprocs")
        else:
            nprocs = torch.cuda.device_count()
    if nprocs < 1:
        raise ValueError(f"spawn: nprocs={nprocs} (no card visible?)")
    envs = launch.rank_envs(nprocs, gpus=gpus,
                            backend=options.get("backend"), device=device)
    ctx = mp.get_context("spawn")
    errors = ctx.SimpleQueue()
    procs = [ctx.Process(target=_spawn_entry,
                         args=(func, tuple(args), env, errors),
                         daemon=daemon) for env in envs]
    for p in procs:
        p.start()
    context = SpawnContext(procs, float(options.get("timeout",
                                                    SPAWN_TIMEOUT)), errors)
    if join:
        context.join()
    return context
