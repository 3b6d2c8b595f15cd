"""Loss functionals.

Counterpart of `paddle_tpu/nn/functional/loss.py`: every loss of the
reference, with its formulas, reductions and clamps.
`cross_entropy` (:25-92): hard labels (`[N]` or `[N, 1]`) with
`ignore_index`, per-class `weight` and `label_smoothing`, or soft labels;
reductions mean, sum and none. With hard labels and softmax the loss is
taken as `logsumexp(logits) - logits[target]`, never materialising the
log-probs. The arithmetic runs in the logits' dtype (bf16 under AMP), as
in the reference. `margin_cross_entropy` is the single-card form (the
reference's model-parallel form runs inside its `mp` shard_map, which
comes with the distributed slice).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF


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


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.square(input - label), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    d = input - label
    ad = torch.abs(d)
    return _reduce(torch.where(ad < delta, 0.5 * d * d / delta,
                               ad - 0.5 * delta), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """input: log-probs [N, C, ...]; label [N, ...]. The label takes no
    gradient. Mean with `weight` divides by the picked weights' sum."""
    ids = label.detach().long()
    mask = ids != ignore_index
    safe = torch.where(mask, ids, torch.zeros_like(ids))
    per = -torch.gather(input, 1, safe.unsqueeze(1)).squeeze(1)
    if weight is not None:
        per = per * weight[safe]
    per = torch.where(mask, per, torch.zeros_like(per))
    if reduction == "mean":
        denom = (weight[safe] * mask).sum() if weight is not None else \
            torch.clamp(mask.to(per.dtype).sum(), min=1.0)
        return per.sum() / denom
    return _reduce(per, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    eps = 1e-12
    v = -(label * torch.log(torch.clamp(input, min=eps))
          + (1 - label) * torch.log(torch.clamp(1 - input, min=eps)))
    if weight is not None:
        v = v * weight
    return _reduce(v, reduction)


def _softplus(z):
    """log(1 + exp(z)) without overflow (jax.nn.softplus)."""
    return torch.logaddexp(z, torch.zeros((), dtype=z.dtype,
                                          device=z.device))


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    z, y = logit, label
    if pos_weight is None:
        base = torch.clamp(z, min=0) - z * y + \
            torch.log1p(torch.exp(-torch.abs(z)))
    else:
        base = -(pos_weight * y * -_softplus(-z) + (1 - y) * -_softplus(z))
    if weight is not None:
        base = base * weight
    return _reduce(base, reduction)


def kl_div(input, label, reduction="mean", name=None):
    v = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return v.sum() / input.shape[0]
    return _reduce(v, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return _reduce(torch.where(label == 1, input,
                               torch.clamp(margin - input, min=0.0)),
                   reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    cos = (input1 * input2).sum(-1) / torch.clamp(
        torch.linalg.norm(input1, dim=-1) * torch.linalg.norm(input2, dim=-1),
        min=1e-12)
    return _reduce(torch.where(label == 1, 1 - cos,
                               torch.clamp(cos - margin, min=0.0)),
                   reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def dist(a, b):
        return torch.pow(torch.pow(torch.abs(a - b) + epsilon, p).sum(-1),
                         1 / p)

    dp, dn = dist(input, positive), dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


def square_error_cost(input, label):
    return torch.square(input - label)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    z, y = logit, label
    p = torch.sigmoid(z)
    ce = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-torch.abs(z)))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    v = a_t * torch.pow(1 - p_t, gamma) * ce
    if normalizer is not None:
        v = v / normalizer
    return _reduce(v, reduction)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace-family margin softmax CE on cosine logits [N, C]: the target
    logit becomes cos(m1 * theta + m2) - m3, everything is scaled by
    `scale`, then softmax CE (:359-433, outside mp)."""
    ids = label.long()
    if ids.dim() == logits.dim():
        ids = ids.squeeze(-1)
    per = logits.shape[-1]
    in_shard = (ids >= 0) & (ids < per)
    safe = torch.where(in_shard, ids, torch.zeros_like(ids))
    target = torch.gather(logits, -1, safe[:, None])[:, 0]
    theta = torch.arccos(torch.clamp(target.float(), -1.0 + 1e-6,
                                     1.0 - 1e-6))
    mod = (torch.cos(margin1 * theta + margin2) - margin3).to(logits.dtype)
    col = torch.arange(per, device=logits.device)[None, :]
    is_target = (col == safe[:, None]) & in_shard[:, None]
    lg2 = torch.where(is_target, mod[:, None], logits) * scale
    vmax = torch.amax(lg2.detach(), -1, keepdim=True)
    ex = torch.exp(lg2 - vmax)
    denom = ex.sum(-1, keepdim=True)
    sm = ex / denom
    picked = torch.where(in_shard[:, None],
                         torch.gather(lg2 - vmax, -1, safe[:, None]),
                         torch.zeros((), dtype=lg2.dtype,
                                     device=lg2.device))
    loss = torch.log(denom) - picked
    if reduction == "mean":
        loss = loss.mean()
    elif reduction == "sum":
        loss = loss.sum()
    return (loss, sm) if return_softmax else loss


def dice_loss(input, label, epsilon=1e-5, name=None):
    """1 - 2 |X ∩ Y| / (|X| + |Y|) per sample, meaned; label holds class
    ids [..., 1]."""
    ids = label.long()
    if ids.shape[-1] == 1:
        ids = ids[..., 0]
    oh = TF.one_hot(ids, input.shape[-1]).to(input.dtype)
    axes = tuple(range(1, input.ndim))
    inse = (input * oh).sum(axes)
    denom = input.sum(axes) + oh.sum(axes)
    return (1 - inse * 2 / (denom + epsilon)).mean()


def log_loss(input, label, epsilon=1e-4, name=None):
    return -label * torch.log(input + epsilon) - \
        (1.0 - label) * torch.log(1.0 - input + epsilon)


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    """Soft-label CE over the anchor-positive similarities plus an L2 term
    on the embeddings."""
    eq = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    soft = eq / eq.sum(1, keepdim=True)
    l2 = ((anchor * anchor).sum(1).mean() + (positive * positive).sum(1)
          .mean()) * 0.25 * l2_reg
    logp = torch.log_softmax(anchor @ positive.T, dim=-1)
    return l2 + (-(soft * logp).sum(-1)).mean()


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid loss [N, 1] over the default complete binary
    tree (node(bit) = (c >> (bit + 1)) - 1, branch(bit) = (c >> bit) & 1,
    c = label + num_classes), or a custom tree of `path_table` /
    `path_code` [N, L] (negative entries are padding)."""
    ids = label.long()
    if ids.dim() == 2:
        ids = ids[:, 0]
    if path_table is not None:
        nodes = path_table.long()
        bits = path_code.to(input.dtype)
        live = nodes >= 0
        nodes_safe = torch.clamp(nodes, min=0)
    else:
        c = ids + num_classes
        n_bits = int(2 * num_classes - 1).bit_length() - 1
        js = torch.arange(n_bits, device=input.device)
        nodes = (c[:, None] >> (js[None, :] + 1)) - 1
        bits = ((c[:, None] >> js[None, :]) & 1).to(input.dtype)
        length = torch.floor(torch.log2(c.float())).long()
        live = js[None, :] < length[:, None]
        nodes_safe = torch.clamp(nodes, 0, num_classes - 2)
    pre = torch.einsum("nd,nld->nl", input, weight[nodes_safe])
    if bias is not None:
        pre = pre + bias.reshape(-1)[nodes_safe]
    term = _softplus(pre) - bits * pre
    return torch.where(live, term, torch.zeros_like(term)).sum(
        1, keepdim=True)


def _logsumexp0(a):
    """logsumexp over dim 0 as jax computes it: the max held constant, so
    the gradient is softmax(a). torch's own takes exp(a - result), which
    is not a distribution once the terms sit at -1e30 (a rounded
    log-sum-exp equals its max there)."""
    m = a.max(0).values.detach()
    return torch.log(torch.exp(a - m).sum(0)) + m


class _LogAddExp(torch.autograd.Function):
    """jnp.logaddexp with its custom JVP: d/dx1 = exp(x1 - out) (torch's
    gives 1 / (1 + exp(x2 - x1)): the same in real arithmetic, not at
    -1e30)."""

    @staticmethod
    def forward(ctx, x1, x2):
        amax = torch.maximum(x1, x2)
        out = amax + torch.log1p(torch.exp(-(x1 - x2).abs()))
        ctx.save_for_backward(x1, x2, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x1, x2, out = ctx.saved_tensors
        return g * torch.exp(x1 - out), g * torch.exp(x2 - out)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """Connectionist Temporal Classification loss (reference :254-354).

    `log_probs` are UNSCALED logits [T, B, C] (a log-softmax in f32 runs
    inside); `reduction='mean'` divides each sample's loss by
    max(label_length, 1) first. The log-semiring alpha recursion runs on
    tensors, one step per time index, and autograd differentiates it, as
    the reference's scan and its VJP do. The alphas start at -1e30, not
    -inf (:281), so an infeasible alignment gives a large finite loss
    where torch's `F.ctc_loss` gives inf. Lengths given on the host are
    checked (:333-352); tensors are trusted, as in the reference."""
    if norm_by_times:
        raise NotImplementedError(
            "norm_by_times rescales gradients only (warpctc semantics); "
            "use reduction='mean' instead")
    logits = log_probs
    device = logits.device
    T_max = int(logits.shape[0])
    lab = torch.as_tensor(labels, device=device).long()
    L_max = int(lab.shape[1]) if lab.dim() > 1 else int(lab.shape[0])

    def _host_max(v):
        if isinstance(v, (int, list, tuple, np.ndarray, np.integer)):
            return int(np.max(np.asarray(v)))
        return None

    im, lm = _host_max(input_lengths), _host_max(label_lengths)
    if im is not None and im > T_max:
        raise ValueError(
            f"ctc_loss: input_lengths exceed max_logit_length {T_max}")
    if lm is not None and lm > L_max:
        raise ValueError(
            f"ctc_loss: label_lengths exceed labels length {L_max}")

    T, B, C = logits.shape
    L = lab.shape[1]
    S = 2 * L + 1
    logp = torch.log_softmax(logits.float(), dim=-1)
    in_len = torch.as_tensor(input_lengths, device=device).long()
    lab_len = torch.as_tensor(label_lengths, device=device).long()
    neg_inf = -1e30

    # extended label row per sample: blank, l1, blank, l2, ..., blank
    ext = torch.full((B, S), blank, dtype=torch.long, device=device)
    ext[:, 1::2] = lab
    # skip transition allowed where ext[s] != blank and != ext[s-2]
    ext_m2 = torch.cat([torch.full((B, 2), -1, dtype=torch.long,
                                   device=device), ext[:, :-2]], 1)
    can_skip = (ext != blank) & (ext != ext_m2)
    emit = torch.gather(logp, 2, ext[None].expand(T, B, S))  # [T, B, S]

    fill1 = logp.new_full((B, 1), neg_inf)
    fill2 = logp.new_full((B, 2), neg_inf)
    alpha = torch.cat([emit[0, :, :1],
                       torch.where(lab_len[:, None] > 0, emit[0, :, 1:2],
                                   fill1),
                       logp.new_full((B, max(S - 2, 0)), neg_inf)], 1)
    for t in range(1, T):
        a_m1 = torch.cat([fill1, alpha[:, :-1]], 1)
        a_m2 = torch.where(can_skip, torch.cat([fill2, alpha[:, :-2]], 1),
                           neg_inf)
        new = _logsumexp0(torch.stack([alpha, a_m1, a_m2], 0)) + emit[t]
        # past this sample's input length the alphas freeze
        alpha = torch.where((t < in_len)[:, None], new, alpha)

    end = 2 * lab_len                # blank after the last label
    a_last = alpha.gather(1, end[:, None])[:, 0]
    a_prev = alpha.gather(1, (end[:, None] - 1).clamp(min=0))[:, 0]
    a_prev = torch.where(lab_len > 0, a_prev, neg_inf)
    loss = -_LogAddExp.apply(a_last, a_prev)
    if reduction == "mean":
        return (loss / lab_len.clamp(min=1).to(loss.dtype)).mean()
    if reduction == "sum":
        return loss.sum()
    return loss


__all__ = ["ctc_loss", "cross_entropy", "softmax_with_cross_entropy",
           "mse_loss", "l1_loss", "smooth_l1_loss", "nll_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "kl_div",
           "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss",
           "square_error_cost", "sigmoid_focal_loss", "margin_cross_entropy",
           "dice_loss", "log_loss", "npair_loss", "hsigmoid_loss"]
