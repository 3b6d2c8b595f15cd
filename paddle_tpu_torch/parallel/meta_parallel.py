"""ShardingParallel: the model wrapper of ZeRO sharding.

Counterpart of `paddle_tpu/parallel/meta_parallel.py` (the reference
Paddle's `fleet/meta_parallel/sharding/*`). Like the reference's, the
wrapper carries the hybrid group and the strategy; the slicing itself is
`SPMDTrainStep(sharding_stage=...)`'s. Over a process world it broadcasts
the parameters and buffers from the first rank at wrap, so every rank
starts from the same weights. `TensorParallel` waits for `mp_layers`
(ROADMAP.md Queue 1 item 5).
"""
from __future__ import annotations

import torch

from ..nn.layer.layers import Layer
from . import collective


class ShardingParallel(Layer):
    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self.add_sublayer("_layers", layers)
        self.hcg = hcg
        self.strategy = strategy
        world = collective.get_group(0)
        if collective._live(world):
            with torch.no_grad():
                for t in list(layers.parameters()) + list(layers.buffers()):
                    collective.broadcast(t.data, src=0, group=world)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *a, **kw):
        return self._layers.state_dict(*a, **kw)

    def set_state_dict(self, sd, *a, **kw):
        return self._layers.set_state_dict(sd, *a, **kw)
