"""HybridParallelOptimizer and the ZeRO API.

Counterpart of `paddle_tpu/parallel/hybrid_optimizer.py` (the reference
Paddle's `hybrid_parallel_optimizer.py:170` and
`distributed/sharding/group_sharded.py`): `group_sharded_parallel` maps
the levels 'os' / 'os_g' / 'p_g_os' onto sharding stages 1 / 2 / 3, which
`SPMDTrainStep(sharding_stage=...)` applies; `save_group_sharded_model`
writes the whole state from the first rank in the `.pdparams` layout.
"""
from __future__ import annotations

from .topology import get_hybrid_communicate_group


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg or get_hybrid_communicate_group()
        self._strategy = strategy

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)

    def step(self):
        self._inner_opt.step()

    def clear_grad(self, set_to_zero=True):
        self._inner_opt.clear_grad()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        return self._inner_opt.minimize(loss)


class DygraphShardingOptimizer(HybridParallelOptimizer):
    """Stage-1 shell (`dygraph_sharding_optimizer.py:28`): the slot
    sharding is SPMDTrainStep(sharding_stage=1)'s."""

    def __init__(self, hcg=None, user_defined_strategy=None, params=None,
                 inner_optimizer_class=None, **inner_kw):
        if inner_optimizer_class is not None:
            inner = inner_optimizer_class(parameters=params, **inner_kw)
        else:
            inner = inner_kw.pop("inner_opt")
        super().__init__(inner, hcg, user_defined_strategy)
        self.sharding_stage = 1


def group_sharded_parallel(model, optimizer, level="os", scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False):
    """ZeRO levels: 'os' = stage 1, 'os_g' = stage 2, 'p_g_os' = stage 3
    (`model._sharding_stage` and the optimizer's `sharding_stage`)."""
    stage = {"os": 1, "os_g": 2, "p_g_os": 3}[level]
    opt = optimizer._inner_opt if isinstance(
        optimizer, HybridParallelOptimizer) else optimizer
    wrapped = HybridParallelOptimizer(opt)
    wrapped.sharding_stage = stage
    model._sharding_stage = stage
    if scaler is not None:
        return model, wrapped, scaler
    return model, wrapped


def save_group_sharded_model(model, output, optimizer=None, step=None):
    """Write `output + '.pdparams'` (and `'.pdopt'` with an optimizer) from
    the first rank. Every rank must call it: with `step` (an
    SPMDTrainStep over the model), the whole parameters are gathered from
    the ranks' slices first."""
    from ..framework.io import save
    from .env import get_rank
    if step is not None:
        sd = step.state_dict()
        state = dict(model.state_dict())
        state.update({n: v for n, v in sd["params"].items()})
    else:
        state = model.state_dict()
    if get_rank() == 0:
        save(state, output + ".pdparams")
        if optimizer is not None:
            save(optimizer.state_dict(), output + ".pdopt")
