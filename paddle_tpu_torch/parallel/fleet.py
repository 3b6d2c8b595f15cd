"""Fleet facade: the DP and sharding path.

Counterpart of `paddle_tpu/parallel/fleet.py` (the reference Paddle's
`fleet_base.py:170` init, :896 distributed_model, :839
distributed_optimizer, and the role makers). `init` brings up the process
world (`init_parallel_env`) and its `HybridCommunicateGroup`;
`distributed_model` gives `DataParallel`, or `ShardingParallel` when the
sharding degree is above 1; `distributed_optimizer` gives a
`HybridParallelOptimizer`. Pipeline and tensor parallelism, the
meta-optimizers (gradient merge, LocalSGD, DGC) and the parameter-server
surface raise until their slices are ported (ROADMAP.md Queue 1 item 5).
"""
from __future__ import annotations

from typing import Optional

from .env import get_rank, get_world_size, init_parallel_env
from .strategy import DistributedStrategy
from .topology import HybridCommunicateGroup, get_hybrid_communicate_group

_FLEET = {"init": False, "strategy": None, "hcg": None}

_NEXT = "(ROADMAP.md Queue 1 item 5)"


class PaddleCloudRoleMaker:
    """Role discovery from the launcher's environment
    (`fleet/base/role_maker.py:519`)."""

    def __init__(self, is_collective=True, **kwargs):
        self.is_collective = is_collective

    def worker_index(self):
        return get_rank()

    def worker_num(self):
        return get_world_size()

    def is_worker(self):
        return True

    def is_first_worker(self):
        return get_rank() == 0


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    def __init__(self, is_collective=True, init_gloo=False, **kwargs):
        super().__init__(is_collective)


def init(role_maker=None, is_collective=True, strategy=None, log_dir=None):
    if not is_collective:
        raise NotImplementedError("fleet.init(is_collective=False): the "
                                  f"parameter-server mode is not ported {_NEXT}")
    strategy = strategy or DistributedStrategy()
    init_parallel_env()
    hcg = HybridCommunicateGroup(strategy)
    _FLEET.update(init=True, strategy=strategy, hcg=hcg)
    return hcg


def is_first_worker():
    return get_rank() == 0


def worker_index():
    return get_rank()


def worker_num():
    return get_world_size()


def get_hybrid_group() -> Optional[HybridCommunicateGroup]:
    return _FLEET["hcg"] or get_hybrid_communicate_group()


def get_strategy() -> Optional[DistributedStrategy]:
    return _FLEET["strategy"]


def distributed_model(model):
    """DataParallel, or ShardingParallel with a sharding degree above 1
    (`fleet_base.py:956-990`)."""
    from .data_parallel import DataParallel
    from .meta_parallel import ShardingParallel
    hcg = get_hybrid_group()
    strategy = _FLEET["strategy"] or DistributedStrategy()
    if hcg is not None and hcg.pp_degree > 1:
        raise NotImplementedError("fleet.distributed_model with pp_degree > "
                                  "1: PipelineParallel comes with the "
                                  f"pipeline slice {_NEXT}")
    if hcg is not None and hcg.mp_degree > 1:
        raise NotImplementedError("fleet.distributed_model with mp_degree > "
                                  "1: TensorParallel comes with the "
                                  f"mp_layers slice {_NEXT}")
    if hcg is not None and hcg.sharding_degree > 1:
        return ShardingParallel(model, hcg, strategy)
    return DataParallel(model, hcg=hcg, strategy=strategy,
                        find_unused_parameters=strategy.find_unused_parameters)


def distributed_optimizer(optimizer, strategy=None):
    from .hybrid_optimizer import HybridParallelOptimizer
    st = strategy or _FLEET["strategy"]
    for toggle in ("gradient_merge", "localsgd", "dgc"):
        if st is not None and getattr(st, toggle, False):
            raise NotImplementedError(
                f"DistributedStrategy.{toggle}: the meta-optimizers "
                f"(meta_optimizers.py) are not ported yet {_NEXT}")
    return HybridParallelOptimizer(optimizer, get_hybrid_group(), st)


def _ps(name):
    def fn(*a, **kw):
        raise NotImplementedError(f"fleet.{name}: the parameter-server "
                                  f"surface is not ported yet {_NEXT}")
    fn.__name__ = name
    return fn


init_server = _ps("init_server")
init_worker = _ps("init_worker")
run_server = _ps("run_server")
stop_worker = _ps("stop_worker")


def barrier_worker():
    from .collective import barrier
    barrier()
