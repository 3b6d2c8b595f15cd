"""Mixture of experts: top-k gating, capacity buckets, expert parallelism.

Counterpart of `paddle_tpu/parallel/moe.py` (the reference Paddle's
`global_scatter_op.cc` / `global_gather_op.cc`, `distributed/utils.py:
52-129`, and the incubate MoELayer's gate). As in the reference (the
GShard form), the variable-count token exchange is one of static shapes:
the gate gives a dispatch mask and combine weights, both [T, E, C] (C the
capacity of each expert), dispatch and combine are einsums, and the
experts run as one batched product over weights stacked [E, d, h].

Expert parallelism runs over a process group (the reference: a mesh axis
inside `shard_map`): rank r holds and runs experts [r E/ep, (r+1) E/ep),
and `global_scatter` / `global_gather` move the buckets to their experts
and back with one `alltoall_single` each, whose backward is the same
exchange of the gradients. `local_count` / `global_count` mask the rows of
a bucket past its count (the reference's op contract under static
shapes).

Memory: the [T, E, C] dispatch and combine tensors are f32. At T 4096, E
8 and the default capacity (C = ceil(1.25 k T / E) = 1280 for k 2) each
is 168 MB; under expert parallelism each rank gates only its own tokens.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.place import resolve_device
from ..core.tensor import Parameter
from ..nn.layer.layers import Layer
from . import collective


# ---- gating ----
def top_k_gating(logits, k=2, capacity=None, capacity_factor=1.25,
                 normalize=True):
    """GShard top-k gate over logits [T, E]: (dispatch [T, E, C] in
    {0, 1}, combine [T, E, C], aux_loss), all f32. The capacity defaults
    to ceil(capacity_factor * k * T / E); a token past its expert's
    capacity is dropped (no slot, zero weight). Ties in the gate's argmax
    go to the first expert, as `jnp.argmax` gives them; slot positions are
    the f32 cumulative sums of the reference."""
    T, E = logits.shape
    if capacity is None:
        capacity = int(math.ceil(capacity_factor * k * T / E))
    C = int(capacity)
    dev = logits.device
    probs = torch.softmax(logits.float(), dim=-1)
    remaining = probs
    offset = torch.zeros(E, dtype=torch.int32, device=dev)
    combine = torch.zeros((T, E, C), dtype=torch.float32, device=dev)
    dispatch = torch.zeros((T, E, C), dtype=torch.float32, device=dev)
    gates_sum = torch.zeros(T, dtype=torch.float32, device=dev)
    top1_mask = None
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)
        mask = F.one_hot(idx, E).float()
        if top1_mask is None:
            top1_mask = mask
        pos = (torch.cumsum(mask, dim=0) - 1) * mask + offset[None, :] * mask
        pos_t = pos.sum(dim=-1).to(torch.int32)
        keep = ((mask * (pos + 1)).sum(dim=-1) > 0) & (pos_t < C)
        gate = (probs * mask).sum(dim=-1)
        sel = mask * keep[:, None]
        slot = F.one_hot(pos_t.clamp(0, C - 1).long(), C).float()
        dispatch = dispatch + sel[:, :, None] * slot[:, None, :]
        combine = combine + (gate[:, None, None] * sel[:, :, None]
                             * slot[:, None, :])
        gates_sum = gates_sum + gate * keep
        offset = offset + sel.sum(dim=0).to(torch.int32)
        remaining = remaining * (1.0 - mask)
    if normalize and k > 1:
        combine = combine / torch.clamp(gates_sum, min=1e-9)[:, None, None]
    # load-balancing loss (Switch / GShard): E * sum_e mean prob_e *
    # the share of tokens routed to e first
    me = probs.mean(dim=0)
    ce = top1_mask.mean(dim=0)
    aux_loss = E * (me * ce).sum()
    return dispatch, combine, aux_loss


def moe_dispatch(x, dispatch):
    """x [T, d], dispatch [T, E, C] -> the expert buckets [E, C, d]."""
    return torch.einsum("tec,td->ecd", dispatch, x.float()).to(x.dtype)


def moe_combine(expert_out, combine):
    """expert_out [E, C, d], combine [T, E, C] -> [T, d]."""
    return torch.einsum("tec,ecd->td", combine,
                        expert_out.float()).to(expert_out.dtype)


# ---- the count-masked exchange (global_scatter / global_gather) ----
def _mask_counts(a, count):
    """Zero the rows of bucket e at index >= count[e]; a [E, C, d]."""
    count = torch.as_tensor(count, device=a.device)
    valid = torch.arange(a.shape[1], device=a.device)[None, :] < \
        count.to(torch.int64)[:, None]
    return torch.where(valid[:, :, None], a,
                       torch.zeros((), dtype=a.dtype, device=a.device))


class _AllToAll(torch.autograd.Function):
    """`alltoall_single` over a group, differentiable: the backward sends
    each gradient chunk back where its input chunk came from, which is
    the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return collective.alltoall_single(x.contiguous(), group=group)

    @staticmethod
    def backward(ctx, grad):
        return collective.alltoall_single(grad.contiguous(),
                                          group=ctx.group), None


def _ep_group(group):
    """The live expert-parallel group, or None (all experts local)."""
    if group is None:
        return None
    g = collective._resolve(group)
    return g if collective._live(g) and g.nranks > 1 else None


def global_scatter(x, local_count=None, global_count=None, group=None):
    """Send bucketed expert inputs to the ranks that own their experts.

    x [E, C, d], grouped by expert (E = ep * E_local, rank r owning
    experts r E_local..). Returns [E_local, ep C, d]: this rank's experts'
    buckets from every rank of the group, in rank order. `local_count[e]`
    keeps that many rows of bucket e before the exchange. Without a live
    group (a `Group` or an axis name) the buckets stay here."""
    if local_count is not None:
        x = _mask_counts(x, local_count)
    g = _ep_group(group)
    if g is None:
        return x
    ep = g.nranks
    e_local = x.shape[0] // ep
    out = _AllToAll.apply(x, g)                  # [ep * E_local, C, d]
    out = out.reshape(ep, e_local, x.shape[1], x.shape[2])
    return out.transpose(0, 1).reshape(e_local, ep * x.shape[1], x.shape[2])


def global_gather(x, local_count=None, global_count=None, group=None):
    """The inverse of global_scatter: [E_local, ep C, d] -> [E, C, d],
    rows of bucket e past `global_count[e]` zeroed."""
    g = _ep_group(group)
    if g is not None:
        ep = g.nranks
        e_local, epc, d = x.shape
        c = epc // ep
        b = x.reshape(e_local, ep, c, d).transpose(0, 1)
        x = _AllToAll.apply(b.reshape(ep * e_local, c, d), g)
    if global_count is not None:
        x = _mask_counts(x, global_count)
    return x


# ---- the layer ----
class MoELayer(Layer):
    """Mixture-of-experts FFN block (the incubate MoELayer's role) on
    tokens [T, d] (flatten batch and sequence first).

    The weights are drawn with the reference's numpy calls from `seed`
    (`paddle_tpu/parallel/moe.py:168-178`: wg, w1, w2 uniform; b1, b2
    zero), through f32, so both packages start equal. With `ep_axis` (a
    `Group`, or an axis name of the process world's hybrid group) over a
    live group of ep ranks, this rank keeps only its E/ep experts' slices
    of w1, b1, w2, b2 (`set_state_dict` of whole tensors takes the
    rank's slice) and runs them on the buckets of every rank; the gate
    `wg` is whole on every rank. Without one, every expert is local.

    `forward(x, capacity=None, return_aux=False)` returns [T, d], or
    (out, aux_loss); `aux_loss` is also kept on the layer."""

    def __init__(self, d_model, d_hidden, num_experts, top_k=2,
                 capacity_factor=1.25, ep_axis=None, seed=0,
                 dtype="float32"):
        super().__init__(dtype=dtype)
        rng = np.random.default_rng(seed)
        s1 = 1.0 / math.sqrt(d_model)
        s2 = 1.0 / math.sqrt(d_hidden)
        wg = rng.uniform(-s1, s1, (d_model, num_experts))
        w1 = rng.uniform(-s1, s1, (num_experts, d_model, d_hidden))
        w2 = rng.uniform(-s2, s2, (num_experts, d_hidden, d_model))
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.ep_axis = ep_axis
        self._group = _ep_group(ep_axis)
        ep = self._group.nranks if self._group is not None else 1
        if num_experts % ep:
            raise ValueError(f"MoELayer: {num_experts} experts do not "
                             f"split over {ep} expert-parallel ranks")
        self.num_local_experts = num_experts // ep
        self._rank = self._group.rank if self._group is not None else 0
        lo = self._rank * self.num_local_experts
        sl = slice(lo, lo + self.num_local_experts)
        zeros1 = np.zeros((num_experts, d_hidden))
        zeros2 = np.zeros((num_experts, d_model))
        for name, arr in (("wg", wg), ("w1", w1[sl]), ("b1", zeros1[sl]),
                          ("w2", w2[sl]), ("b2", zeros2[sl])):
            self.add_parameter(name, self._param(arr))
        self.aux_loss = 0.0

    def _param(self, arr):
        t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        return Parameter(t.to(device=resolve_device(), dtype=self._dtype))

    def _own_piece(self, name, value):
        """A whole stacked expert tensor loads as this rank's experts."""
        if name == "wg" or value.shape[0] == self.num_local_experts:
            return value
        lo = self._rank * self.num_local_experts
        return value[lo:lo + self.num_local_experts]

    @staticmethod
    def _ffn(inp, w1, b1, w2, b2):
        """[E', C', d] through the stacked expert FFNs (jax.nn.gelu's
        default tanh form)."""
        h = F.gelu(torch.einsum("ecd,edh->ech", inp, w1) + b1[:, None, :],
                   approximate="tanh")
        return torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None, :]

    def forward(self, x, capacity=None, return_aux=False):
        logits = x @ self.wg
        dispatch, combine, aux = top_k_gating(
            logits, self.top_k, capacity=capacity,
            capacity_factor=self.capacity_factor)
        self.aux_loss = aux
        buckets = moe_dispatch(x, dispatch)                  # [E, C, d]
        experts = (self.w1, self.b1, self.w2, self.b2)
        if self._group is not None:
            inp = global_scatter(buckets, group=self._group)
            out = global_gather(self._ffn(inp, *experts), group=self._group)
        else:
            out = self._ffn(buckets, *experts)
        y = moe_combine(out, combine)
        return (y, aux) if return_aux else y


__all__ = ["top_k_gating", "moe_dispatch", "moe_combine", "global_scatter",
           "global_gather", "MoELayer"]
