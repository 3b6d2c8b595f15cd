"""DataParallel wrapper: one replica per rank, gradients averaged.

Counterpart of `paddle_tpu/parallel/data_parallel.py` (the reference
Paddle's `fluid/dygraph/parallel.py:400`). The reference shards the batch
inside its jitted step; the port is the reference Paddle's eager
DataParallel over a process world:

  - at wrap, every parameter and buffer is broadcast from the group's
    first rank, so all replicas start equal;
  - the Reducer's hooks are installed on the parameters: each rank runs
    `forward` and `backward` on its own batch, and the bucketed all-reduce
    of the gradients overlaps the backward; when the backward ends, every
    rank's `.grad` holds the mean over the group (`comm_buffer_size` MB
    per bucket);
  - a parameter that got no gradient is reduced as zeros with
    `find_unused_parameters=True`, and raises otherwise.

`scale_loss` returns the loss as it is (the mean is taken over the
gradients) and `apply_collective_grads` has nothing left to do (the
hooks reduced the gradients). `state_dict` and `set_state_dict` pass
through to the wrapped layers.
"""
from __future__ import annotations

import torch

from ..nn.layer.layers import Layer
from . import collective
from .reducer import Reducer


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 hcg=None, group=None):
        super().__init__()
        self._layers = layers
        self.add_sublayer("_layers", layers)
        self.hcg = hcg
        self.find_unused_parameters = find_unused_parameters
        if group is None and hcg is not None and \
                getattr(hcg, "process_mode", False):
            group = hcg.get_data_parallel_group()
        self.group = collective._resolve(group)
        self._params = [p for p in layers.parameters() if p.requires_grad]
        self._sync_from_first_rank()
        self.reducer = Reducer(self._params, axis=self.group,
                               bucket_bytes=int(comm_buffer_size) << 20,
                               find_unused_parameters=find_unused_parameters)
        self.reducer.attach(self._params)

    @torch.no_grad()
    def _sync_from_first_rank(self):
        if not collective._live(self.group):
            return
        src = self.group.ranks[0]
        for t in list(self._layers.parameters()) + \
                list(self._layers.buffers()):
            collective.broadcast(t.data, src=src, group=self.group)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *a, **kw):
        return self._layers.state_dict(*a, **kw)

    def set_state_dict(self, state_dict, *a, **kw):
        return self._layers.set_state_dict(state_dict, *a, **kw)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        """The reference Paddle's explicit reduction: the hooks already
        averaged the gradients when the backward ended."""

    @property
    def _inner_layers(self):
        return self._layers
