"""ERNIE/BERT encoder family: the flagship pretraining model.

Counterpart of `paddle_tpu/models/ernie.py`: `ErnieEmbeddings` (:22),
`ErnieMLP` (:49), `ErnieSelfAttention.forward` (:86), `ErnieLayer.forward`
(:214), `ErnieModel` (:231), `ErnieForSequenceClassification` (:259),
`ErnieForPretraining` (:271, MLM head tied to the word embeddings) and the
`ernie_base`/`ernie_large`/`bert_base`/`bert_large` configs. Post-LN; same
parameter names and layouts, so a JAX state dict loads by name.

With `use_sp`, attention is `parallel.sequence_parallel_attention(impl=
"ring")` over the current mesh's 'sp' axis, and the attention mask and
dropout are ignored, as in the reference (:92-94). With `use_mp` the
layers are `parallel.mp_layers`' as the reference wires them (:22-99):
the word embeddings vocab-parallel, the MLP column then row parallel, the
attention's qkv column parallel with its output gathered (so every mp
rank runs all heads, as the reference's does) and its output projection
row parallel. Without a process world of mp > 1 they compute the dense
layers; in one, each rank holds its slices and runs the collectives. The
MLM head of `ErnieForPretraining(use_mp=True)` is then the rank's
vocabulary slice of the logits (`mp_layers.parallel_logits`), for
`ParallelCrossEntropy`.

`forward_cached` (:103-229), the cached-attention step of LLM serving,
keeps the reference's arithmetic (masked einsums over the whole page, the
validity mask at -1e9, per-row int8 scales) but writes the block's K/V
into the given pages in place, where the reference returns new pages: a
CUDA graph of the decode step reads and writes one pool that never moves.

`ErnieScanStack` (:321-466) keeps its layer weights stacked on a leading
[L] axis and always runs attention through the flash kernels; where the
reference scans one rematerialised layer, the port loops over the L
layers, with `torch.utils.checkpoint` for its `remat` modes.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as TF
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import nn
from ..amp.state import amp_enabled, amp_state
from ..core.enforce import InvalidArgumentError
from ..kernels.flash_attention import flash_attention_arrays
from ..nn.functional.attention import scaled_dot_product_attention
from ..parallel.mp_layers import (ColumnParallelLinear, RowParallelLinear,
                                  VocabParallelEmbedding, parallel_logits)
from ..parallel.sp import sequence_parallel_attention


class ErnieEmbeddings(nn.Layer):
    def __init__(self, vocab_size, hidden_size, max_position_embeddings=512,
                 type_vocab_size=2, dropout=0.1, use_mp=False):
        super().__init__()
        if use_mp:
            self.word_embeddings = VocabParallelEmbedding(vocab_size,
                                                          hidden_size)
        else:
            self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
        self.position_embeddings = nn.Embedding(max_position_embeddings,
                                                hidden_size)
        self.token_type_embeddings = nn.Embedding(type_vocab_size, hidden_size)
        self.layer_norm = nn.LayerNorm(hidden_size)
        self.dropout = nn.Dropout(dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        seq_len = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(seq_len, dtype=torch.int32,
                                        device=input_ids.device).unsqueeze(0)
        if token_type_ids is None:
            token_type_ids = torch.zeros(input_ids.shape, dtype=torch.int32,
                                         device=input_ids.device)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class ErnieMLP(nn.Layer):
    def __init__(self, hidden_size, intermediate_size, dropout=0.1,
                 use_mp=False):
        super().__init__()
        if use_mp:
            self.fc1 = ColumnParallelLinear(hidden_size, intermediate_size,
                                            gather_output=False)
            self.fc2 = RowParallelLinear(intermediate_size, hidden_size,
                                         input_is_parallel=True)
        else:
            self.fc1 = nn.Linear(hidden_size, intermediate_size)
            self.fc2 = nn.Linear(intermediate_size, hidden_size)
        self.act = nn.GELU()
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        return self.dropout(self.fc2(self.act(self.fc1(x))))


class ErnieSelfAttention(nn.Layer):
    def __init__(self, hidden_size, num_heads, dropout=0.1, use_mp=False,
                 use_sp=False, causal=False):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.causal = causal
        self.use_sp = use_sp
        if use_mp:
            self.qkv = ColumnParallelLinear(hidden_size, 3 * hidden_size,
                                            gather_output=True)
            self.out = RowParallelLinear(hidden_size, hidden_size)
        else:
            self.qkv = nn.Linear(hidden_size, 3 * hidden_size)
            self.out = nn.Linear(hidden_size, hidden_size)
        self.dropout_p = dropout

    def forward(self, x, attn_mask=None):
        b, s = x.shape[0], x.shape[1]
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.use_sp:
            ctx = sequence_parallel_attention(q, k, v, impl="ring",
                                              causal=self.causal)
        else:
            ctx = scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask,
                dropout_p=self.dropout_p if self.training else 0.0,
                is_causal=self.causal, training=self.training)
        ctx = ctx.reshape(b, s, self.num_heads * self.head_dim)
        return self.out(ctx)

    def forward_cached(self, x, k_cache, v_cache, positions,
                       k_scale=None, v_scale=None):
        """Cached-attention step over a fixed-shape KV cache (decode path).

        x: [B, T, H] current block (T = prompt bucket at prefill, the
        decode block at decode). k_cache/v_cache: [B, L, nh, hd] pages
        with L fixed (the slot page), fp32, or int8 for the quantized-KV
        arm. positions: [B] int32, tokens already cached per row. The
        block's K/V are written into the pages IN PLACE at rows
        positions[b] .. positions[b]+T-1 (the start clamped so the block
        fits, as `dynamic_update_slice` clamps it), and attention runs
        over the whole page under a validity mask: key j is visible to
        query i iff j <= positions[b] + i.

        int8 pages: symmetric quantization with one scale per row. With
        k_scale/v_scale None the scales are computed fresh from this
        block's K/V, max|x| / 127 floored at 1e-6 (the prefill step);
        otherwise the given [B] scales are reused and new entries clip into
        their grid (the decode steps). Reads dequantize cache * scale.

        Inference-only: no dropout inside the attention. Returns (out,
        k_cache, v_cache, k_scale, v_scale); the caches are the given
        tensors, the scales None for fp32 pages."""
        b, t = x.shape[0], x.shape[1]
        nh, hd = self.num_heads, self.head_dim
        qkv = self.qkv(x).reshape(b, t, 3, nh, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if k_cache.dtype == torch.int8:
            if k_scale is None:
                k_scale = k.abs().amax(dim=(1, 2, 3)).clamp_min(1e-6) / 127.0
                v_scale = v.abs().amax(dim=(1, 2, 3)).clamp_min(1e-6) / 127.0
            k = _quantize(k, k_scale)
            v = _quantize(v, v_scale)
        page = k_cache.shape[1]
        start = positions.long().clamp(0, page - t)
        rows = start[:, None] + torch.arange(t, device=x.device)
        bidx = torch.arange(b, device=x.device)[:, None].expand(b, t)
        k_cache.index_put_((bidx, rows), k)
        v_cache.index_put_((bidx, rows), v)
        kr, vr = k_cache, v_cache
        if k_cache.dtype == torch.int8:
            kr = k_cache.to(q.dtype) * k_scale[:, None, None, None]
            vr = v_cache.to(q.dtype) * v_scale[:, None, None, None]
        logits = torch.einsum("bhsd,bhtd->bhst", q.transpose(1, 2),
                              kr.transpose(1, 2)) * (1.0 / math.sqrt(hd))
        qpos = positions[:, None] + torch.arange(t, device=x.device)
        span = torch.arange(page, device=x.device)
        hidden = span[None, None, None, :] > qpos[:, None, :, None]
        probs = torch.softmax(logits.masked_fill(hidden, -1e9), dim=-1)
        ctx = torch.einsum("bhst,bhtd->bhsd", probs, vr.transpose(1, 2))
        ctx = ctx.transpose(1, 2).reshape(b, t, nh * hd)
        return self.out(ctx), k_cache, v_cache, k_scale, v_scale


def _quantize(x, scale):
    """[B, T, nh, hd] onto the int8 grid of its row's scale [B]."""
    return torch.round(x / scale[:, None, None, None]).clamp(
        -127, 127).to(torch.int8)


class ErnieLayer(nn.Layer):
    def __init__(self, hidden_size, num_heads, intermediate_size, dropout=0.1,
                 use_mp=False, use_sp=False, causal=False):
        super().__init__()
        self.attention = ErnieSelfAttention(hidden_size, num_heads, dropout,
                                            use_mp, use_sp, causal)
        self.mlp = ErnieMLP(hidden_size, intermediate_size, dropout, use_mp)
        self.norm1 = nn.LayerNorm(hidden_size)
        self.norm2 = nn.LayerNorm(hidden_size)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, attn_mask=None):
        x = self.norm1(x + self.dropout(self.attention(x, attn_mask)))
        x = self.norm2(x + self.mlp(x))
        return x

    def forward_cached(self, x, k_cache, v_cache, positions,
                       k_scale=None, v_scale=None):
        """One block through the cached-attention path, with forward's
        post-LN residual wiring. Returns (x, k_cache, v_cache, k_scale,
        v_scale)."""
        attn, k_cache, v_cache, k_scale, v_scale = \
            self.attention.forward_cached(x, k_cache, v_cache, positions,
                                          k_scale, v_scale)
        x = self.norm1(x + self.dropout(attn))
        x = self.norm2(x + self.mlp(x))
        return x, k_cache, v_cache, k_scale, v_scale


class ErnieModel(nn.Layer):
    def __init__(self, vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072,
                 max_position_embeddings=512, type_vocab_size=2,
                 hidden_dropout_prob=0.1, use_mp=False, use_sp=False,
                 causal=False):
        super().__init__()
        self.embeddings = ErnieEmbeddings(vocab_size, hidden_size,
                                          max_position_embeddings,
                                          type_vocab_size,
                                          hidden_dropout_prob, use_mp)
        self.layers = nn.LayerList([
            ErnieLayer(hidden_size, num_attention_heads, intermediate_size,
                       hidden_dropout_prob, use_mp, use_sp, causal)
            for _ in range(num_hidden_layers)])
        self.pooler = nn.Linear(hidden_size, hidden_size)
        self.pooler_act = nn.Tanh()

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        x = self.embeddings(input_ids, token_type_ids)
        if attention_mask is not None:
            # [B,S] 1/0 mask -> additive [B,1,1,S]
            m = attention_mask[:, None, None, :]
            attention_mask = (1.0 - m.float()) * -1e4
        for layer in self.layers:
            x = layer(x, attention_mask)
        pooled = self.pooler_act(self.pooler(x[:, 0]))
        return x, pooled


class ErnieForSequenceClassification(nn.Layer):
    def __init__(self, ernie: ErnieModel, num_classes=2, dropout=0.1):
        super().__init__()
        self.ernie = ernie
        self.dropout = nn.Dropout(dropout)
        self.classifier = nn.Linear(ernie.pooler.weight.shape[1], num_classes)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.ernie(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


class ErnieForPretraining(nn.Layer):
    """MLM + NSP heads (the pretraining objective the benchmark measures)."""

    def __init__(self, ernie: ErnieModel, use_mp=False):
        super().__init__()
        self.ernie = ernie
        hidden = ernie.pooler.weight.shape[1]
        self.transform = nn.Linear(hidden, hidden)
        self.transform_act = nn.GELU()
        self.transform_norm = nn.LayerNorm(hidden)
        self.nsp = nn.Linear(hidden, 2)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.ernie(input_ids, token_type_ids, attention_mask)
        h = self.transform_norm(self.transform_act(self.transform(seq)))
        # weight-tied MLM logits, [B*S, H] x [V, H]^T then back to [B, S, V]
        # (:291-296); the product is an AMP white-list matmul
        b, s = h.shape[0], h.shape[1]
        logits = parallel_logits(h.reshape(-1, h.shape[-1]),
                                 self.ernie.embeddings.word_embeddings)
        return logits.reshape(b, s, logits.shape[-1]), self.nsp(pooled)


# ---- configs ----
def ernie_base(**kw):
    return ErnieModel(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                      num_attention_heads=12, intermediate_size=3072, **kw)


def ernie_large(**kw):
    return ErnieModel(vocab_size=30522, hidden_size=1024, num_hidden_layers=24,
                      num_attention_heads=16, intermediate_size=4096, **kw)


def ernie_titan_10b(**kw):
    """The ~10B-parameter titan geometry (:311-315)."""
    return ErnieModel(vocab_size=50304, hidden_size=4096, num_hidden_layers=48,
                      num_attention_heads=64, intermediate_size=16384,
                      max_position_embeddings=2048, **kw)


bert_base = ernie_base
bert_large = ernie_large

# the "dots" policy (:453-458): the outputs of the products without batch
# dimensions and the flash forward's (out, lse) are saved; everything else
# (layer norms, residuals, GELU, layout copies) is recomputed
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
               torch.ops.paddle_tpu_torch.flash_fwd.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS_SAVED \
        else CheckpointPolicy.PREFER_RECOMPUTE


_dots_context = functools.partial(create_selective_checkpoint_contexts,
                                  _dots_policy)


def _layer_norm(v, g, b):
    """Statistics in fp32, the result back in the residual's dtype, eps
    1e-5 (:396-405)."""
    v32 = v.float()
    mu = v32.mean(-1, keepdim=True)
    var = v32.var(-1, keepdim=True, unbiased=False)
    n = ((v32 - mu) * torch.rsqrt(var + 1e-5)).to(v.dtype)
    return n * g + b


class ErnieScanStack(nn.Layer):
    """N identical post-LN transformer layers with stacked weights.

    The weights live on a leading [L] axis under the reference's names and
    shapes (`qkv_w [L, h, 3h]`, ...; :360-380), so a state dict moves
    across by name. Semantics are a loop of `ErnieLayer(dropout=0)`, with
    attention always through the flash kernels (:414-415).

    remat: False = plain autograd; True = per-layer checkpointing (only
    the layer boundaries are saved); "dots" = selective checkpointing: the
    products' outputs and the flash output are saved, and only the layer
    norms, residuals, GELU and layout copies are recomputed in the
    backward, so no product and no flash forward runs twice.
    """

    def __init__(self, hidden_size, num_heads, intermediate_size, n_layers,
                 remat=True, causal=False):
        super().__init__()
        if remat not in (False, True, "dots"):
            raise InvalidArgumentError(
                f"ErnieScanStack: remat must be False, True or 'dots', got "
                f"{remat!r}")
        h, ffn, n = hidden_size, intermediate_size, n_layers
        self.hidden_size, self.num_heads, self.n_layers = h, num_heads, n
        self.remat, self.causal = remat, causal
        k = 1.0 / math.sqrt(h)

        def mk(*shape):
            return self.create_parameter(
                shape, default_initializer=nn.initializer.Uniform(-k, k))

        def const(value, *shape):
            return self.create_parameter(
                shape, default_initializer=nn.initializer.Constant(value))

        self.qkv_w = mk(n, h, 3 * h)
        self.qkv_b = const(0.0, n, 3 * h)
        self.proj_w = mk(n, h, h)
        self.proj_b = const(0.0, n, h)
        self.fc1_w = mk(n, h, ffn)
        self.fc1_b = const(0.0, n, ffn)
        self.fc2_w = mk(n, ffn, h)
        self.fc2_b = const(0.0, n, h)
        self.ln1_g = const(1.0, n, h)
        self.ln1_b = const(0.0, n, h)
        self.ln2_g = const(1.0, n, h)
        self.ln2_b = const(0.0, n, h)

    def _weights(self):
        return [self.qkv_w, self.qkv_b, self.proj_w, self.proj_b, self.fc1_w,
                self.fc1_b, self.fc2_w, self.fc2_b, self.ln1_g, self.ln1_b,
                self.ln2_g, self.ln2_b]

    def _layer(self, x, qkv_w, qkv_b, proj_w, proj_b, fc1_w, fc1_b, fc2_w,
               fc2_b, ln1_g, ln1_b, ln2_g, ln2_b):
        """One layer (:388-425)."""
        b, s, h = x.shape
        nh = self.num_heads
        qkv = torch.matmul(x, qkv_w) + qkv_b
        q, k, v = (t.reshape(b, s, nh, h // nh) for t in qkv.chunk(3, -1))
        o = flash_attention_arrays(q, k, v, causal=self.causal)
        o = torch.matmul(o.reshape(b, s, h), proj_w) + proj_b
        x = _layer_norm(x + o, ln1_g, ln1_b)
        m = TF.gelu(torch.matmul(x, fc1_w) + fc1_b)
        m = torch.matmul(m, fc2_w) + fc2_b
        return _layer_norm(x + m, ln2_g, ln2_b)

    def forward(self, x):
        ws = self._weights()
        if amp_enabled():
            # the layer is below the AMP white list: the carry and the
            # floating weights take the AMP dtype once (:441-451)
            dt = amp_state().dtype
            x = x.to(dt)
            ws = [w.to(dt) if w.is_floating_point() else w for w in ws]
        for i in range(self.n_layers):
            wl = [w[i] for w in ws]
            if self.remat == "dots":
                x = checkpoint(self._layer, x, *wl, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=_dots_context)
            elif self.remat:
                x = checkpoint(self._layer, x, *wl, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = self._layer(x, *wl)
        return x


__all__ = ["ErnieEmbeddings", "ErnieMLP", "ErnieSelfAttention", "ErnieLayer",
           "ErnieModel", "ErnieForSequenceClassification",
           "ErnieForPretraining", "ErnieScanStack", "ernie_base",
           "ernie_large", "ernie_titan_10b", "bert_base", "bert_large"]
