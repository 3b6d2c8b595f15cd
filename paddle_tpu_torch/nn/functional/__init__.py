"""paddle.nn.functional counterpart: the functionals of the serving and
training paths.

The public names are the Tensor API's boundary (`core.tensor.api`): with a
`Tensor` argument a functional runs on plain aliases and returns `Tensor`;
with plain torch tensors it is the module's function, called as it is.
"""
from ...core.tensor import api
from . import activation, attention, common, loss, norm

gelu = api(activation.gelu)
tanh = api(activation.tanh)
scaled_dot_product_attention = api(attention.scaled_dot_product_attention)
dropout = api(common.dropout)
embedding = api(common.embedding)
linear = api(common.linear)
layer_norm = api(norm.layer_norm)
cross_entropy = api(loss.cross_entropy)

__all__ = ["gelu", "tanh", "scaled_dot_product_attention", "dropout",
           "embedding", "linear", "layer_norm", "cross_entropy"]
