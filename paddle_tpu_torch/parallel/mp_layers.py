"""Tensor-parallel (Megatron-style) layers.

Counterpart of `paddle_tpu/parallel/mp_layers.py`: `ColumnParallelLinear`
(:43), `RowParallelLinear` (:72), `VocabParallelEmbedding` (:109) and
`ParallelCrossEntropy` (:143), with the reference's constructors,
parameter shapes, initializers and `dist_attr` tags. The reference has two
regimes, and so does the port:

  - no process world, or an mp group of one (the reference's GSPMD
    regime, where the sharding annotations only place data): each layer
    computes the dense layer;
  - a process world whose hybrid topology has mp > 1 (the reference's
    manual regime inside `shard_map`, :55-60, :82-95, :117-132,
    :156-173): each rank holds its slice of each sharded weight and the
    layer runs the explicit collectives over the rank's mp group.

The regime is fixed when the layer is made (the rank keeps only its
slice). A rank draws the whole weight from the seeded initializer and
keeps its slice, so a run from one seed starts from the reference's
weights. Each collective on the autograd path is an autograd Function
whose backward is the conjugate collective: identity <-> all-reduce
(`copy_to_mp` / `reduce_from_mp`), split <-> gather (`split_last` /
`gather_last`). `ParallelCrossEntropy`'s manual form is one Function whose
backward is softmax - one-hot on the rank's vocabulary slice.

A sharded Parameter carries `_mp_split = (axis, n, rank, group)`:
`state_dict()` gathers it over the group into the whole tensor under the
reference's key (every mp rank must call it), and `set_state_dict()`
takes the whole tensor and keeps the rank's slice, so one `.pdparams`
moves between the packages and between degrees.
"""
from __future__ import annotations

import torch

from ..nn import functional as F
from ..nn import initializer as I
from ..nn.layer.layers import Layer
from . import collective


def model_parallel_group(mp_group=None):
    """The mp group of the manual regime, or None for the dense regime:
    `mp_group` when it is given and holds more than one rank, else the
    process-world hybrid topology's mp group when its degree is above 1."""
    if isinstance(mp_group, collective.Group):
        return mp_group if mp_group.nranks > 1 else None
    from .topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is None or not getattr(hcg, "process_mode", False) or \
            hcg.mp_degree <= 1:
        return None
    return hcg.get_model_parallel_group()


def _keep_slice(p, axis, group):
    """Keep the rank's slice of Parameter `p` along `axis` (in place) and
    tag it `_mp_split`."""
    n, r = group.nranks, group.rank
    if p.shape[axis] % n:
        raise ValueError(f"mp: axis {axis} of {tuple(p.shape)} does not "
                         f"split over {n} ranks")
    p.data = p.data.chunk(n, axis)[r].clone()
    p._mp_split = (axis, n, r, group)
    return p


def gather_whole(t, split):
    """The whole tensor of a slice `t` tagged `split` (one all_gather)."""
    axis, n, _, group = split
    parts = []
    collective.all_gather(parts, t.detach().contiguous(), group=group)
    return torch.cat(parts, dim=axis)


class MPLayer(Layer):
    """A Layer whose sharded parameters go into `state_dict()` whole."""

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        if keep_vars:
            return
        for name, p in self._parameters.items():
            split = getattr(p, "_mp_split", None)
            if split is not None:
                destination[prefix + name] = gather_whole(p, split)

    def _own_piece(self, name, value):
        """`set_state_dict` of a whole tensor: the rank's slice of it."""
        p = self._parameters.get(name)
        split = getattr(p, "_mp_split", None)
        if split is None or tuple(value.shape) == tuple(p.shape):
            return value
        axis, n, r, _ = split
        return value.chunk(n, axis)[r]


# ---- the conjugate collectives ----
class _CopyToMP(torch.autograd.Function):
    """Forward identity, backward all-reduce (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        collective.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromMP(torch.autograd.Function):
    """Forward all-reduce, backward identity (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        collective.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SplitLast(torch.autograd.Function):
    """Forward the rank's chunk of the last axis, backward all-gather."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.chunk(group.nranks, -1)[group.rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        parts = []
        collective.all_gather(parts, g.contiguous(), group=ctx.group)
        return torch.cat(parts, -1), None


class _GatherLast(torch.autograd.Function):
    """Forward all-gather along the last axis, backward the rank's chunk."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = []
        collective.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        grp = ctx.group
        return g.chunk(grp.nranks, -1)[grp.rank].contiguous(), None


def copy_to_mp(x, group):
    return _CopyToMP.apply(x, group)


def reduce_from_mp(x, group):
    return _ReduceFromMP.apply(x, group)


def split_last(x, group):
    return _SplitLast.apply(x, group)


def gather_last(x, group):
    return _GatherLast.apply(x, group)


# ---- the layers ----
class ColumnParallelLinear(MPLayer):
    """Weight [in, out] sharded on out ('mp'); the output stays sharded
    unless gather_output."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self.gather_output = gather_output
        self._group = model_parallel_group(mp_group)
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.weight.dist_attr = (None, "mp")
        self.bias = self.create_parameter([out_features], is_bias=True) \
            if has_bias else None
        if self.bias is not None:
            self.bias.dist_attr = ("mp",)
        if self._group is not None:
            _keep_slice(self.weight, 1, self._group)
            if self.bias is not None:
                _keep_slice(self.bias, 0, self._group)

    def forward(self, x):
        g = self._group
        if g is None:
            return F.linear(x, self.weight, self.bias)
        out = F.linear(copy_to_mp(x, g), self.weight, self.bias)
        return gather_last(out, g) if self.gather_output else out


class RowParallelLinear(MPLayer):
    """Weight [in, out] sharded on in ('mp'); the input is the last-axis
    slice when input_is_parallel, else it is split here."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self.input_is_parallel = input_is_parallel
        self._group = model_parallel_group(mp_group)
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=I.XavierNormal())
        self.weight.dist_attr = ("mp", None)
        self.bias = self.create_parameter([out_features], is_bias=True) \
            if has_bias else None
        if self._group is not None:
            _keep_slice(self.weight, 0, self._group)

    def forward(self, x):
        g = self._group
        if g is None:
            return F.linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = split_last(x, g)
        out = reduce_from_mp(F.linear(x, self.weight), g)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


class VocabParallelEmbedding(MPLayer):
    """Embedding table [vocab, dim] sharded on the vocab axis ('mp')."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self._group = model_parallel_group(mp_group)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=I.Normal(0.0, 0.02))
        self.weight.dist_attr = ("mp", None)
        if self._group is not None:
            _keep_slice(self.weight, 0, self._group)

    def forward(self, x):
        g = self._group
        if g is None:
            return F.embedding(x, self.weight)
        per = self.weight.shape[0]
        local = x.long() - g.rank * per
        outside = (local < 0) | (local >= per)
        emb = torch.nn.functional.embedding(local.masked_fill(outside, 0),
                                            self.weight)
        emb = emb.masked_fill(outside.unsqueeze(-1), 0.0)
        return reduce_from_mp(emb, g)


class _VocabParallelCE(torch.autograd.Function):
    """Softmax cross entropy over logits sharded on the last axis: the
    max, the sum of exponentials and the picked logit all-reduced over the
    group (the reference's :156-173). Backward: softmax - one-hot on the
    rank's slice."""

    @staticmethod
    def forward(ctx, logits, ids, group):
        x = logits.float()
        vmax = x.max(-1, keepdim=True).values
        collective.all_reduce(vmax, op=collective.ReduceOp.MAX, group=group)
        shifted = x - vmax
        ex = shifted.exp()
        denom = ex.sum(-1, keepdim=True)
        collective.all_reduce(denom, group=group)
        per = logits.shape[-1]
        local = ids.long() - group.rank * per
        inside = (local >= 0) & (local < per)
        safe = local.masked_fill(~inside, 0).unsqueeze(-1)
        picked = shifted.gather(-1, safe).masked_fill(
            ~inside.unsqueeze(-1), 0.0)
        collective.all_reduce(picked, group=group)
        ctx.save_for_backward(ex / denom, safe, inside)
        ctx.dtype = logits.dtype
        return (denom.log() - picked).to(logits.dtype)

    @staticmethod
    def backward(ctx, g):
        soft, safe, inside = ctx.saved_tensors
        grad = soft.clone()
        onehot = torch.zeros_like(grad).scatter_(-1, safe, 1.0)
        grad = grad - onehot * inside.unsqueeze(-1).to(grad.dtype)
        return (grad * g.float()).to(ctx.dtype), None, None


class ParallelCrossEntropy(Layer):
    """Vocab-parallel softmax cross entropy (`c_softmax_with_cross_entropy
    _op.cu:1`): per-row losses [..., 1]. The dense regime is
    `softmax_with_cross_entropy`; the manual regime takes the rank's
    logits slice."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self._group = model_parallel_group(mp_group)

    def forward(self, input, label):
        g = self._group
        if g is None:
            return F.softmax_with_cross_entropy(input, label)
        ids = label
        if ids.dim() == input.dim():
            ids = ids.squeeze(-1)
        return _VocabParallelCE.apply(input, ids, g)


def parallel_logits(h, embedding):
    """Logits of hidden states `h` against a (possibly vocab-parallel)
    embedding table, [..., vocab] (the rank's vocabulary slice in the
    manual regime, whose loss is `ParallelCrossEntropy`): the weight-tied
    LM head."""
    from ..amp.state import maybe_cast
    g = getattr(embedding, "_group", None)
    if g is not None:
        h = copy_to_mp(h, g)
    h, w = maybe_cast(h, embedding.weight)
    return torch.matmul(h, w.t())


__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "ParallelCrossEntropy",
           "model_parallel_group", "copy_to_mp", "reduce_from_mp",
           "split_last", "gather_last", "parallel_logits", "gather_whole"]
