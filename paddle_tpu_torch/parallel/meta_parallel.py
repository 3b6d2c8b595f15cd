"""TensorParallel / ShardingParallel: the model wrappers of fleet.

Counterpart of `paddle_tpu/parallel/meta_parallel.py` (:13-31; the
reference Paddle's `fleet/meta_parallel/tensor_parallel.py` and
`sharding/*`). Like the reference's, a wrapper carries the hybrid group
and the strategy, and its `state_dict` / `set_state_dict` are the wrapped
layers' (whole tensors under the reference's keys: `mp_layers` gathers and
slices its shards). The slicing itself is `mp_layers`' (made when the
layers are) and `SPMDTrainStep(sharding_stage=...)`'s. Over a process
world the wrapper broadcasts the parameters and buffers per axis at wrap
(`broadcast_replicas`), so every replica starts from the same weights.
`ShardingParallel` is the same class, as in the reference.
"""
from __future__ import annotations

import torch

from ..nn.layer.layers import Layer
from . import collective


def broadcast_replicas(layers, hcg):
    """Over a process world: every parameter and buffer from the first
    rank of its data group (dp x sharding), then the ones that are not mp
    slices from the first rank of its mp group (`hcg` defaults to the
    current hybrid group)."""
    if hcg is None:
        from .topology import get_hybrid_communicate_group
        hcg = get_hybrid_communicate_group()
    if hcg is None or not getattr(hcg, "process_mode", False):
        return
    tensors = list(layers.parameters()) + list(layers.buffers())
    with torch.no_grad():
        data = hcg.get_data_axes_group()
        if collective._live(data):
            for t in tensors:
                collective.broadcast(t.data, src=data.ranks[0], group=data)
        mp = hcg.get_model_parallel_group()
        if collective._live(mp):
            for t in tensors:
                if getattr(t, "_mp_split", None) is None:
                    collective.broadcast(t.data, src=mp.ranks[0], group=mp)


class TensorParallel(Layer):
    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self.add_sublayer("_layers", layers)
        self.hcg = hcg
        self.strategy = strategy
        broadcast_replicas(layers, hcg)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *a, **kw):
        return self._layers.state_dict(*a, **kw)

    def set_state_dict(self, sd, *a, **kw):
        return self._layers.set_state_dict(sd, *a, **kw)


ShardingParallel = TensorParallel

__all__ = ["TensorParallel", "ShardingParallel", "broadcast_replicas"]
