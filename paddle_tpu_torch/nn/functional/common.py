"""Common functionals: linear, embedding, the dropouts, one_hot,
interpolate, pixel shuffles, unfold / fold, pad and the rest.

Counterpart of `paddle_tpu/nn/functional/common.py`. These are plain
products, lookups, gathers and elementwise work, left to PyTorch as the
JAX package leaves them to XLA. `linear` is an AMP white-list op
(`:17-34`).

Dropout keeps the reference's semantics (:36-56): in eval,
`mode="downscale_in_infer"` scales by (1 - p) and `"upscale_in_train"`
returns x; in training a Bernoulli(1 - p) keep mask zeroes the dropped
entries, and the kept ones are divided by (1 - p) under
`"upscale_in_train"` and kept as they are under `"downscale_in_infer"`.
With `axis`, one mask is drawn over the listed axes and broadcast over
the others. The mask comes from torch's generator of the input's device
(seeded by `paddle_tpu_torch.seed`, graph-safe under a CUDA-graph
capture), so its bits differ from the reference's `jax.random` key.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as TF

from ...amp.state import maybe_cast
from ...core import random as rnd
from ...core.enforce import InvalidArgumentError
from ...ops import manipulation as _manip


def linear(x, weight, bias=None, name=None):
    """y = x @ W + b with W shaped [in, out] (paddle convention). Under
    `amp.auto_cast` the operands are cast to the autocast dtype first."""
    if bias is None:
        x, weight = maybe_cast(x, weight)
    else:
        x, weight, bias = maybe_cast(x, weight, bias)
    return TF.linear(x, weight.t(), bias)


class _SparseLookup(torch.autograd.Function):
    """The lookup with the reference's sparse backward
    (`nn/functional/common.py:91-128`): the weight's gradient is an
    uncoalesced sparse COO tensor with one entry per looked-up id, a
    `padding_idx` entry holding zeros (`core/selected_rows.py`)."""

    @staticmethod
    def forward(ctx, weight, ids, padding_idx):
        ctx.save_for_backward(ids)
        ctx.meta = (tuple(weight.shape), padding_idx)
        out = TF.embedding(ids, weight)
        if padding_idx is not None and padding_idx >= 0:  # tpu-lint: disable=tensor-branch (an int argument)
            out = out.masked_fill((ids == padding_idx).unsqueeze(-1), 0.0)
        return out

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        shape, pad = ctx.meta
        flat = ids.reshape(-1)
        vals = g.reshape(-1, *shape[1:])
        if pad is not None and pad >= 0:
            vals = vals.masked_fill((flat == pad).unsqueeze(-1), 0.0)
        grad = torch.sparse_coo_tensor(flat.unsqueeze(0), vals, shape,
                                       is_coalesced=False,
                                       check_invariants=False)
        return grad, None, None


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of weight [vocab, dim] looked up by integer ids; the row of
    `padding_idx` reads as zeros. sparse=True on a leaf weight: its
    gradient is the sparse row form (`_SparseLookup`) instead of a dense
    [vocab, dim] scatter. A weight that is not a leaf gets the dense
    gradient, as the reference densifies a SelectedRows cotangent entering
    another op's backward."""
    if sparse and torch.is_grad_enabled() and weight.requires_grad \
            and weight.grad_fn is None:
        return _SparseLookup.apply(weight, x.long(), padding_idx)
    out = TF.embedding(x.long(), weight)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((x == padding_idx).unsqueeze(-1), 0.0)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    shape = tuple(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = tuple(s if i in axes else 1 for i, s in enumerate(shape))
    keep = torch.empty(shape, dtype=torch.float32,
                       device=x.device).bernoulli_(1.0 - p).bool()
    out = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                           device=x.device))
    if mode == "upscale_in_train":
        # 1 - p in x's dtype, as the reference divides by it
        out = out / torch.full((), 1.0 - p, dtype=x.dtype, device=x.device)
    return out


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """One draw per (sample, channel) plane."""
    ax = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=ax, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    ax = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=ax, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: dropped entries take -alpha * scale, then
    an affine map restores the mean and variance (:59-76)."""
    if not training or p == 0.0:
        return x
    alpha_p = -1.6732632423543772 * 1.0507009873554805
    keep = torch.empty(tuple(x.shape), dtype=torch.float32,
                       device=x.device).bernoulli_(1.0 - p).bool()
    q = 1.0 - p
    coef_a = (q + alpha_p ** 2 * q * p) ** -0.5
    coef_b = -coef_a * alpha_p * p
    dropped = torch.full((), alpha_p, dtype=x.dtype, device=x.device)
    return coef_a * torch.where(keep, x, dropped) + coef_b


def one_hot(x, num_classes, name=None):
    """float32 [..., num_classes]; an id outside [0, num_classes) gives a
    row of zeros, as jax.nn.one_hot does."""
    ids = x.long()
    return (ids.unsqueeze(-1) == torch.arange(
        num_classes, device=x.device)).to(torch.float32)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


# ---- interpolate: jax.image.resize's weights, one spatial axis at a time --
def _triangle(d):
    return np.maximum(0.0, 1.0 - np.abs(d))


def _keys_cubic(d):
    """Keys' cubic kernel with a = -0.5, as jax.image's."""
    d = np.abs(d)
    out = ((1.5 * d - 2.5) * d) * d + 1.0
    out = np.where(d >= 1.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0, out)
    return np.where(d >= 2.0, 0.0, out)


def _resize_weights(n_in, n_out, kernel):
    """The [n_in, n_out] f32 weights of jax.image.scale_and_translate for
    one axis (antialiased: a downsampling kernel is widened by the scale),
    computed on the host as jax computes them."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    kscale = max(inv, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kscale
    w = kernel(dist).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(f32)


def _resize(x, axes, out_sizes, method):
    """jax.image.resize over `axes`: nearest by index (half-pixel centres),
    linear and cubic as one weighted sum per resized axis."""
    for ax, n_out in zip(axes, out_sizes):
        n_in = x.shape[ax]
        if n_in == n_out:
            continue
        if method == "nearest":
            idx = np.floor((np.arange(n_out, dtype=np.float32) + 0.5)
                           * n_in / n_out).astype(np.int64)
            x = torch.index_select(x, ax, torch.from_numpy(idx).to(x.device))
            continue
        kernel = _triangle if method == "linear" else _keys_cubic
        w = torch.from_numpy(_resize_weights(n_in, n_out, kernel)).to(
            device=x.device, dtype=x.dtype)
        x = torch.tensordot(x, w, dims=([ax], [0])).movedim(-1, ax)
    return x


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes as the reference does (`jax.image.resize`,
    :119-146): half-pixel centres, antialiased linear and cubic (Keys,
    a = -0.5) weights; `align_corners` and `align_mode` are not read, and
    "area" resizes linearly."""
    cf = data_format.upper().startswith("NC")
    axes = list(range(2, x.ndim)) if cf else list(range(1, x.ndim - 1))
    spatial = [x.shape[a] for a in axes]
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.tolist()  # tpu-lint: disable=host-sync (paddle API: Tensor size -> static ints)
        out = [int(s) for s in (size if isinstance(size, (list, tuple))
                                else [size])]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * len(spatial)
        out = [int(s * f) for s, f in zip(spatial, sf)]
    method = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
              "trilinear": "linear", "bicubic": "cubic",
              "area": "linear"}[mode]
    return _resize(x, axes, out, method)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        a = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return a.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    a = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return a.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    """NCHW whatever `data_format` says, as in the reference."""
    r = downscale_factor
    n, c, h, w = x.shape
    a = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
    return a.reshape(n, c * r * r, h // r, w // r)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(int(s) for s in v)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: [N, C, H, W] -> [N, C*kh*kw, L]; paddings an int, [ph, pw]
    or [top, left, bottom, right]."""
    if isinstance(paddings, int):
        pt = pb = pl = pr = paddings
    elif len(paddings) == 2:
        pt = pb = paddings[0]
        pl = pr = paddings[1]
    else:
        pt, pl, pb, pr = paddings
    a = TF.pad(x, (pl, pr, pt, pb))
    return TF.unfold(a, _pair(kernel_sizes), dilation=_pair(dilations),
                     stride=_pair(strides))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the inverse of unfold: [N, C*kh*kw, L] -> [N, C, H, W]."""
    oh, ow = _pair(output_sizes)
    kh, kw = _pair(kernel_sizes)
    sh, sw = _pair(strides)
    ph, pw = _pair(paddings)
    dh, dw = _pair(dilations)
    lh = (oh + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    lw = (ow + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    if x.shape[2] != lh * lw:
        raise InvalidArgumentError(
            f"fold: L={x.shape[2]} does not match computed {lh}*{lw}")
    return TF.fold(x, (oh, ow), (kh, kw), dilation=(dh, dw),
                   padding=(ph, pw), stride=(sh, sw))


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    num = torch.sum(x1 * x2, dim=axis)
    den = torch.sqrt(torch.sum(x1 * x1, dim=axis)) * \
        torch.sqrt(torch.sum(x2 * x2, dim=axis))
    return num / torch.clamp(den, min=eps)


def bilinear(x1, x2, weight, bias=None, name=None):
    """out[b, o] = x1[b] W[o] x2[b] (+ bias); weight [out, in1, in2]."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    n = torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=axis,
                            keepdim=True), 1.0 / p)
    return x / torch.clamp(n, min=epsilon)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    return _manip.pad.__wrapped__(x, pad, mode, value, data_format)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zero padding of H and W: padding [left, right, top, bottom]."""
    if isinstance(padding, torch.Tensor):
        padding = padding.tolist()  # tpu-lint: disable=host-sync (paddle API: Tensor padding -> static ints)
    left, right, top, bottom = [int(v) for v in padding]
    if data_format == "NCHW":
        return TF.pad(x, (left, right, top, bottom))
    return TF.pad(x, (0, 0, left, right, top, bottom))


def class_center_sample(label, num_classes, num_samples, group=None):
    """PartialFC class-centre sampling (:256-338): every positive class of
    `label` is kept, negatives drawn uniformly without replacement pad the
    list to `num_samples`, and labels are remapped into the sorted list.
    Runs on the host (its length depends on the data). The draw is seeded
    from the package's initialisation generator, so it repeats under
    `paddle_tpu_torch.seed`; its numbers differ from the reference's."""
    lab = label.detach().cpu().numpy().reshape(-1).astype(np.int64)
    if num_samples > num_classes:
        raise InvalidArgumentError(
            f"Expected num_samples <= {num_classes}, got {num_samples}")
    rank, nranks = 0, 1
    if group is not None:
        rank = getattr(group, "rank", 0) or 0
        nranks = getattr(group, "nranks", 1) or 1
    base_seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                  generator=rnd.default_generator()))

    def rank_sample(r):
        lo = r * num_classes
        pos = np.unique(lab[(lab >= lo) & (lab < lo + num_classes)]) - lo
        n_neg = max(0, num_samples - len(pos))
        if n_neg == 0:
            return pos
        rng = np.random.RandomState((base_seed + r) % (2 ** 31))  # tpu-lint: disable=stdlib-random (seeded from the device generator: host-side sampling, eager only)
        negatives = np.setdiff1d(np.arange(num_classes, dtype=np.int64),
                                 pos, assume_unique=True)
        picked = rng.choice(negatives, size=n_neg, replace=False)
        return np.sort(np.concatenate([pos, picked]))

    sampled_all = [rank_sample(r) for r in range(nranks)]
    offsets = np.cumsum([0] + [len(s) for s in sampled_all])
    remapped = np.zeros_like(lab)
    for r in range(nranks):
        lo = r * num_classes
        sel = (lab >= lo) & (lab < lo + num_classes)
        if sel.any():
            remapped[sel] = offsets[r] + np.searchsorted(sampled_all[r],
                                                         lab[sel] - lo)
    dev = label.device
    return (torch.from_numpy(remapped.astype(np.int32)).to(dev),
            torch.from_numpy(sampled_all[rank].astype(np.int32)).to(dev))


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """lengths [...] -> [..., maxlen] 0/1 mask (maxlen: the largest length
    when None, read on the host)."""
    from ...core.dtype import canonical, convert_dtype
    ml = int(x.max()) if maxlen is None else int(maxlen)
    mask = torch.arange(ml, device=x.device) < x.unsqueeze(-1)
    return mask.to(canonical(convert_dtype(dtype)))


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    return torch.diag_embed(input, offset, dim1, dim2)


def gather_tree(ids, parents):
    """Beam-search backtrace: ids/parents [T, B, beam] -> each beam's
    sequence, walking the parent pointers back from the last step."""
    T, B, K = ids.shape
    beam = torch.arange(K, device=ids.device).expand(B, K)
    out = torch.empty_like(ids)
    for t in range(T - 1, -1, -1):
        out[t] = torch.gather(ids[t], 1, beam)
        beam = torch.gather(parents[t], 1, beam).long()
    return out


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention over a CSR pattern (:481-545): q/k/v [B, H, S, D],
    offsets [B, H, S+1], columns [B, H, nnz]. The pattern becomes a dense
    boolean mask (built on the host) and the softmax runs masked, in f32;
    a row with no allowed key gives zeros."""
    B, H, S, D = query.shape
    off = sparse_csr_offset.detach().cpu().numpy()
    col = sparse_csr_columns.detach().cpu().numpy()
    mask = np.zeros((B, H, S, S), bool)
    counts = np.diff(off, axis=-1)
    rows = np.repeat(np.tile(np.arange(S), B * H), counts.reshape(-1))
    bh = np.repeat(np.arange(B * H), counts.sum(-1).reshape(-1))
    mask.reshape(B * H, S, S)[bh, rows, col.reshape(-1)] = True
    m = torch.from_numpy(mask).to(query.device)
    s = torch.einsum("bhsd,bhtd->bhst", query.float(), key.float()) / \
        float(np.sqrt(D))
    if key_padding_mask is not None:
        m = m & (key_padding_mask[:, None, None, :] > 0)
    if attn_mask is not None:
        m = m & (attn_mask[None, None] > 0 if attn_mask.ndim == 2
                 else attn_mask > 0)
    s = torch.where(m, s, torch.full((), -1e30, device=s.device))
    p = torch.softmax(s, dim=-1)
    p = torch.where(m.any(-1, keepdim=True), p, torch.zeros((), device=p.device))
    out = torch.einsum("bhst,bhtd->bhsd", p.to(value.dtype).float(),
                       value.float())
    return out.to(query.dtype)


__all__ = ["linear", "embedding", "dropout", "dropout2d", "dropout3d",
           "alpha_dropout", "one_hot", "label_smooth", "interpolate",
           "upsample", "pixel_shuffle", "pixel_unshuffle", "unfold", "fold",
           "cosine_similarity", "bilinear", "normalize", "pad", "zeropad2d",
           "class_center_sample", "sequence_mask", "diag_embed",
           "gather_tree", "sparse_attention"]
