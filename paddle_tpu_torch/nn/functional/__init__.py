"""paddle.nn.functional counterpart: every functional of the reference's
namespace.

The public names are the Tensor API's boundary (`core.tensor.api`): with a
`Tensor` argument a functional runs on plain aliases and returns `Tensor`;
with plain torch tensors it is the module's function, called as it is.
"""
from ...core.tensor import api
from . import (activation, attention, common, conv, loss, norm, pooling,
               vision)

_MODULES = (activation, common, conv, pooling, norm, loss, vision)

__all__ = [n for m in _MODULES for n in m.__all__] + \
    ["scaled_dot_product_attention"]
for _m in _MODULES:
    for _n in _m.__all__:
        globals()[_n] = api(getattr(_m, _n))
scaled_dot_product_attention = api(attention.scaled_dot_product_attention)
del _m, _n
