"""Attention functionals.

Counterpart of `paddle_tpu/nn/functional/attention.py` (:20-85). The
dispatch keeps the JAX package's conditions and thresholds, with "the
tensors lie on a CUDA device" in place of "a TPU is present": no mask, no
dropout, head_dim 64/128/256, q/k/v of one length, and a sequence of at
least 1024 (bf16 after promotion) or 4096 (otherwise) go to the
hand-written flash-attention kernel. It adds one condition, because the
port's kernels are built for fp32, bf16 and fp16 while the reference's
Pallas kernels take any dtype: the promoted dtype is one of those
(`KERNEL_DTYPES`; float64 is the one float it leaves out). So an fp16 call
(`amp.auto_cast(dtype="float16")`) reaches the kernel at S >= 4096, as
in the reference. Everything else takes the einsum path below, with the
causal mask at -1e9.
"""
from __future__ import annotations

import math

import torch

from ...kernels.flash_attention import KERNEL_DTYPES
from .common import dropout as _dropout


def _promoted(q, k, v) -> torch.dtype:
    return torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)


def _flash_eligible(q, k, v, attn_mask=None, dropout_p=0.0) -> bool:
    """Every kernel condition except the device one (:40-44), and the
    kernels' dtypes: the promoted dtype is fp32, bf16 or fp16. The length
    threshold is keyed on the promoted dtype, as in the reference: 1024
    for bf16, 4096 for the rest."""
    seq_len, head_dim = q.shape[1], q.shape[-1]
    promoted = _promoted(q, k, v)
    min_seq = 1024 if promoted == torch.bfloat16 else 4096
    return (promoted in KERNEL_DTYPES and attn_mask is None
            and dropout_p == 0.0
            and seq_len >= min_seq
            and k.shape[1] == seq_len and v.shape[1] == seq_len
            and head_dim in (64, 128, 256))


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """query/key/value: [batch, seqlen, num_heads, head_dim] (paddle
    layout). Returns [batch, seqlen, num_heads, head_dim]."""
    q, k, v = query, key, value
    if q.is_cuda and _flash_eligible(q, k, v, attn_mask, dropout_p):
        from ...kernels.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=is_causal)
    return _einsum_attention(q, k, v, attn_mask, dropout_p, is_causal,
                             training)


def _einsum_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                      is_causal=False, training=True):
    """The unfused path (:54-85): softmax(q k^T / sqrt(D)) v with masked
    logits at -1e9. Mixed operand dtypes promote, as jnp.einsum does."""
    ct = _promoted(q, k, v)
    q, k, v = q.to(ct), k.to(ct), v.to(ct)
    scale = 1.0 / math.sqrt(q.shape[-1])
    qa, ka, va = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    logits = torch.einsum("bhsd,bhtd->bhst", qa, ka) * scale
    # -1e9 in the logits' dtype, as the reference's jnp.asarray(-1e9,
    # dtype): -inf in fp16 (masked_fill refuses a Python scalar that
    # overflows the dtype; a scalar, not a tensor, keeps the call free of a
    # host-to-device copy)
    masked = float("-inf") if torch.finfo(logits.dtype).max < 1e9 else -1e9
    if is_causal:
        s, t = logits.shape[-2], logits.shape[-1]
        cmask = torch.ones((s, t), dtype=torch.bool,
                           device=logits.device).tril()
        logits = logits.masked_fill(~cmask, masked)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, masked)
        else:
            logits = logits + attn_mask.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0 and training:
        probs = _dropout(probs, dropout_p, training=True)
    out = torch.einsum("bhst,bhtd->bhsd", probs, va)
    return out.transpose(1, 2)


__all__ = ["scaled_dot_product_attention"]
