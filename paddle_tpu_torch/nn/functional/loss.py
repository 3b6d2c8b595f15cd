"""Loss functionals: cross_entropy.

Counterpart of `paddle_tpu/nn/functional/loss.py` (`cross_entropy`
:25-92): hard labels (`[N]` or `[N, 1]`) with `ignore_index`, per-class
`weight` and `label_smoothing`, or soft labels; reductions mean, sum and
none. With hard labels and softmax the loss is taken as
`logsumexp(logits) - logits[target]`, never materialising the log-probs.
The arithmetic runs in the logits' dtype (bf16 under AMP), as in the
reference.
"""
from __future__ import annotations

import torch


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    return v


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    logits = input
    if weight is not None:
        weight = torch.as_tensor(weight, device=logits.device)
    n_class = logits.shape[axis]

    def _logp():
        if use_softmax:
            return torch.log_softmax(logits, dim=axis)
        return torch.log(torch.clamp(logits, min=1e-30))

    if soft_label:
        logp = _logp()
        tgt = label.to(logp.dtype)
        if label_smoothing > 0:
            tgt = tgt * (1 - label_smoothing) + label_smoothing / n_class
        per = -(tgt * logp).sum(axis)
        if weight is not None:
            shape = (1,) * (logp.dim() - 1) + (-1,)
            per = per * (tgt * weight.reshape(shape)).sum(axis)
        return _reduce(per, reduction)

    ids = label.long()
    squeeze = ids.dim() == logits.dim()  # [N, 1]-style labels
    if squeeze:
        ids = ids.squeeze(axis)
    mask = ids != ignore_index
    safe = torch.where(mask, ids, torch.zeros_like(ids))
    if use_softmax:
        lse = torch.logsumexp(logits, dim=axis)
        per = lse - torch.gather(logits, axis, safe.unsqueeze(axis)).squeeze(
            axis)
        if label_smoothing > 0:
            smooth = lse - logits.mean(axis)
            per = (1 - label_smoothing) * per + label_smoothing * smooth
    else:
        lp = _logp()
        per = -torch.gather(lp, axis, safe.unsqueeze(axis)).squeeze(axis)
        if label_smoothing > 0:
            smooth = -lp.mean(axis)
            per = (1 - label_smoothing) * per + label_smoothing * smooth
    if weight is not None:
        per = per * weight[safe]
    per = torch.where(mask, per, torch.zeros_like(per))
    if reduction == "mean":
        if weight is not None:
            picked = torch.where(mask, weight[safe],
                                 torch.zeros_like(weight[safe]))
            return per.sum() / torch.clamp(picked.sum(), min=1e-12)
        return per.sum() / torch.clamp(mask.to(per.dtype).sum(), min=1.0)
    if reduction == "sum":
        return per.sum()
    if squeeze:  # [N, 1]-style labels: the per-sample loss keeps their shape
        per = per.unsqueeze(axis)
    return per


__all__ = ["cross_entropy"]
