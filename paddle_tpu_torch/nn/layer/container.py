"""Container layers. Counterpart of `paddle_tpu/nn/layer/container.py`:
`Sequential` (positional layers named "0", "1", ..., (name, layer)
tuples, or one OrderedDict), `LayerList`, `LayerDict` and
`ParameterList`, with the reference's `<container>.<i>.` parameter
names."""
from __future__ import annotations

import collections

import torch

from .layers import Layer


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        else:
            for idx, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(idx), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        if isinstance(idx, str):
            return self._modules[idx]
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(torch.nn.ModuleList):
    pass


class LayerDict(torch.nn.ModuleDict):
    """`update`, `keys`, `items`, `values`, `pop`, `clear` and the mapping
    protocol, as the reference's."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)


class ParameterList(torch.nn.ParameterList):
    pass


__all__ = ["Sequential", "LayerList", "LayerDict", "ParameterList"]
