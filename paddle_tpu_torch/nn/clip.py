"""Gradient clipping.

Counterpart of `paddle_tpu/nn/clip.py` (:12-64): ClipGradByValue,
ClipGradByNorm and ClipGradByGlobalNorm over (param, grad) pairs. The
optimizer applies the same rules to its gradient list (`_clip_fn` in
`optimizer/optimizer.py`).
"""
from __future__ import annotations

import torch


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max) if g is not None
                 else None) for p, g in params_grads]


def _norm_factor(g, clip_norm):
    """min(clip_norm / max(||g||, 1e-12), 1) as a tensor of g's dtype."""
    n = torch.sqrt(torch.sum(g.float() ** 2))
    return torch.clamp(clip_norm / torch.clamp(n, min=1e-12),
                       max=1.0).to(g.dtype)


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        return [(p, None if g is None else g * _norm_factor(g, self.clip_norm))
                for p, g in params_grads]


def _global_factor(grads, clip_norm):
    """clip_norm / max(global_norm, clip_norm) over `grads` (f32)."""
    sq = torch.stack([torch.sum(g.float() ** 2) for g in grads])
    return clip_norm / torch.clamp(torch.sqrt(sq.sum()), min=clip_norm)


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _clip(self, params_grads):
        clipped = [g for p, g in params_grads
                   if g is not None and getattr(p, "need_clip", True)]
        if not clipped:
            return params_grads
        factor = _global_factor(clipped, self.clip_norm)
        return [(p, g) if g is None or not getattr(p, "need_clip", True)
                else (p, g * factor.to(g.dtype)) for p, g in params_grads]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every `.grad` by min(max_norm / max(total, 1e-6), 1), total the
    norm_type-norm over all of them in f32 (the reference's :64-77);
    returns total (0.0 when no parameter has a gradient)."""
    params = [p for p in parameters if p.grad is not None]
    if not params:
        return 0.0
    if norm_type == float("inf"):
        total = torch.stack([p.grad.abs().max().float() for p in params]).max()
    else:
        total = torch.pow(sum(torch.sum(p.grad.float().abs() ** norm_type)
                              for p in params), 1.0 / norm_type)
    factor = torch.clamp(max_norm / torch.clamp(total, min=1e-6), max=1.0)
    for p in params:
        p.grad = p.grad * factor.to(p.grad.dtype)
    return total


__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_"]
