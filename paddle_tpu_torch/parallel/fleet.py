"""Fleet facade: the collective path.

Counterpart of `paddle_tpu/parallel/fleet.py` (the reference Paddle's
`fleet_base.py:170` init, :896 distributed_model, :839
distributed_optimizer, and the role makers). `init` brings up the process
world (`init_parallel_env`) and its `HybridCommunicateGroup`;
`distributed_model` is the reference's (:80-92): with pp > 1 a
`PipelineLayer` is re-segmented to the pp degree and wrapped in
`PipelineParallel`; with mp or sharding > 1 the model is wrapped in
`TensorParallel` (= `ShardingParallel`); else in `DataParallel`.
`distributed_optimizer` gives a `HybridParallelOptimizer`, wrapped by
the strategy's meta-optimizer toggles as the reference wraps it
(:91-140): `gradient_merge`, then `localsgd`, then `dgc`, which takes over
the inner optimizer's momentum on a shallow copy. `utils.recompute` is
`meta_optimizers.recompute`. The parameter-server surface
(`init_server`, `init_worker`, `run_server`, `stop_worker`,
`barrier_worker`) drives `distributed.ps.PsContext`, as the reference's
does (:135-170).
"""
from __future__ import annotations

import copy
from typing import Optional

from .env import get_rank, get_world_size, init_parallel_env
from .strategy import DistributedStrategy
from .topology import HybridCommunicateGroup, get_hybrid_communicate_group

_FLEET = {"init": False, "strategy": None, "hcg": None}


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
    """PipelineParallel (pp > 1, a PipelineLayer), TensorParallel (mp or
    sharding > 1) or DataParallel (`fleet_base.py:956-990`)."""
    from .data_parallel import DataParallel
    from .meta_parallel import TensorParallel
    from .pipeline_parallel import PipelineParallel
    from .pp_layers import PipelineLayer
    hcg = get_hybrid_group()
    strategy = _FLEET["strategy"] or DistributedStrategy()
    if hcg is not None and hcg.pp_degree > 1:
        if not isinstance(model, PipelineLayer):
            raise TypeError("pp_degree > 1 requires a PipelineLayer model")
        if model.num_stages != hcg.pp_degree:
            model.resegment(hcg.pp_degree)
        return PipelineParallel(model, hcg, strategy)
    if hcg is not None and (hcg.mp_degree > 1 or hcg.sharding_degree > 1):
        return TensorParallel(model, hcg, strategy)
    return DataParallel(model, hcg=hcg, strategy=strategy,
                        find_unused_parameters=strategy.find_unused_parameters)


def distributed_optimizer(optimizer, strategy=None):
    """The optimizer wrapped per the strategy's toggles (the meta-optimizer
    resolution of the reference Paddle's `fleet_base.py:1367`): gradient
    merge and LocalSGD stack around the hybrid optimizer, DGC outermost.
    Under `dgc` an inner optimizer with momentum is shallow-copied with its
    momentum set to 0 and slots of its own, so DGC applies the momentum
    once and the caller's optimizer and its state are untouched."""
    from .hybrid_optimizer import HybridParallelOptimizer
    from .meta_optimizers import (DGCMomentumOptimizer,
                                  GradientMergeOptimizer, LocalSGDOptimizer)
    st = strategy or _FLEET["strategy"]
    dgc = st is not None and getattr(st, "dgc", False)
    dgc_inner_m = 0.0
    if dgc:
        dgc_inner_m = float(getattr(optimizer, "_momentum", 0.0) or 0.0)
        if dgc_inner_m > 0:
            optimizer = copy.copy(optimizer)
            optimizer._momentum = 0.0
            optimizer._accumulators = {}
    opt = HybridParallelOptimizer(optimizer, get_hybrid_group(), st)
    if st is not None and getattr(st, "gradient_merge", False):
        cfg = getattr(st, "gradient_merge_configs", {})
        opt = GradientMergeOptimizer(opt, k_steps=cfg.get("k_steps", 1),
                                     avg=cfg.get("avg", True))
    if st is not None and getattr(st, "localsgd", False):
        cfg = getattr(st, "localsgd_configs", {"k_steps": 4})
        opt = LocalSGDOptimizer(opt, k_steps=cfg.get("k_steps", 4))
    if dgc:
        cfg = getattr(st, "dgc_configs", {})
        momentum = cfg.get("momentum")
        if momentum is None:
            momentum = dgc_inner_m if dgc_inner_m > 0 else 0.9
        opt = DGCMomentumOptimizer(
            opt, momentum=momentum, sparsity=cfg.get("sparsity", 0.999),
            rampup_begin_step=cfg.get("rampup_begin_step", 0))
    return opt


# PS-mode surface (reference `parallel/fleet.py:135-170`, Paddle's
# fleet_base.py init_server / init_worker / run_server / stop_worker) over
# the PS tier (`distributed/ps/`).
_PS_CTX = [None]


def _ps_context():
    if _PS_CTX[0] is None:
        from ..distributed.ps import PsContext
        _PS_CTX[0] = PsContext()
    return _PS_CTX[0]


def init_server(host="127.0.0.1", port=0, **kw):
    return _ps_context().init_server(host, port)


def init_worker(endpoints=None, **kw):
    return _ps_context().init_worker(endpoints=endpoints)


def run_server(block=True):
    return _ps_context().run_server(block=block)


def stop_worker():
    ctx = _PS_CTX[0]
    if ctx is not None:
        ctx.stop_worker()


def barrier_worker():
    from .collective import barrier
    barrier()


class _FleetUtils:
    """The fleet.utils namespace (reference fleet/utils/)."""

    @staticmethod
    def recompute(function, *args, **kwargs):
        from .meta_optimizers import recompute as _rc
        return _rc(function, *args, **kwargs)


utils = _FleetUtils()


def save_inference_model(*a, **kw):
    raise NotImplementedError("use paddle_tpu_torch.jit.save")


def save_persistables(executor=None, dirname=None, main_program=None, **kw):
    raise NotImplementedError(
        "use paddle_tpu_torch.save(model.state_dict(), path)")
