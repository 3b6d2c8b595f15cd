"""Norm-based gradient clipping over gradients split across ranks.

The reference clips inside its one SPMD program on the logical whole
gradients (`paddle_tpu/parallel/spmd.py:181`, `pipeline_parallel.py:
279-299`). Where the port's ranks each hold part of the gradients (ZeRO
slices over the sharding group, mp slices over the model group, a stage's
parameters over the pipe group), `sharded_clip` takes the same norms: each
rank sums the squares of its pieces in f32, one per parameter, counting a
piece that other ranks also hold (a parameter replicated over a group) on
one rank only; one all-reduce of that vector over each group whose ranks
hold pieces of the same parameters (sharding, mp) gives every parameter's
whole sum of squares, and for the global norm one all-reduce of the total
over each group whose ranks hold other parameters (the pipe group) gives
the sum over all of them. `ClipGradByGlobalNorm`
scales every clipped piece by clip_norm / max(global norm, clip_norm);
`ClipGradByNorm` scales each parameter's pieces by its own factor
(`nn/clip.py`'s formulas).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..nn.clip import ClipGradByGlobalNorm, ClipGradByNorm
from . import collective


def whole_squares(grads: Sequence[torch.Tensor], counted: Sequence[bool],
                  groups) -> torch.Tensor:
    """[n] f32: each parameter's sum of squares over every rank's piece."""
    dev = grads[0].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sq = torch.stack([torch.sum(g.float() ** 2) if c else zero
                      for g, c in zip(grads, counted)])
    for g in groups:
        collective.all_reduce(sq, group=g)
    return sq


def sharded_clip(clip, grads: List[torch.Tensor], params, groups,
                 counted, total_groups=()) -> List[torch.Tensor]:
    """`grads` (this rank's pieces, aligned with `params`) clipped by the
    norms of the whole gradients; other clips pass through. `groups`:
    the groups over which the per-parameter squares are summed;
    `total_groups`: those over which the global total is."""
    if not grads or not isinstance(clip, (ClipGradByGlobalNorm,
                                          ClipGradByNorm)):
        return grads
    need = [getattr(p, "need_clip", True) for p in params]
    sq = whole_squares(grads, counted, groups)
    if isinstance(clip, ClipGradByGlobalNorm):
        mask = torch.tensor(need, device=sq.device)
        total = torch.where(mask, sq, torch.zeros_like(sq)).sum()
        for g in total_groups:
            collective.all_reduce(total, group=g)
        total = torch.sqrt(total)
        factor = clip.clip_norm / torch.clamp(total, min=clip.clip_norm)
        return [g * factor.to(g.dtype) if nc else g
                for g, nc in zip(grads, need)]
    factors = torch.clamp(clip.clip_norm / torch.clamp(torch.sqrt(sq),
                                                       min=1e-12), max=1.0)
    return [g * factors[i].to(g.dtype) if nc else g
            for i, (g, nc) in enumerate(zip(grads, need))]


__all__ = ["sharded_clip", "whole_squares"]
