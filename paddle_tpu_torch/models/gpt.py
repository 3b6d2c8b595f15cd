"""GPT-style decoder LM.

Counterpart of `paddle_tpu/models/gpt.py`: `GPTEmbeddings`, `GPTModel`,
`GPTForCausalLM` with the head tied to the word embeddings (:96-100), the
shifted-LM `GPTPretrainingCriterion` (:113-132, with the vocab-parallel
loss), `gpt_pipeline_layer` (:135-172, the `PipelineLayer` build for
pipeline parallelism) and the `gpt2_small`/`gpt2_medium`/`gpt_10b`
configs. `use_mp` / `use_sp` wire tensor and sequence parallelism into
the blocks as `models/ernie.py` does; with `use_mp` in a process world of
mp > 1 the tied head gives the rank's vocabulary slice of the logits, the
input of `GPTPretrainingCriterion(use_parallel_ce=True)`. The cached
decode path (`init_kv_cache`, `forward_cached`, :58-110) writes each
block's K/V into the given pages in place: a CUDA graph of the decode step
replays over the same pool.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from .. import nn
from ..core.dtype import convert_dtype
from ..parallel.mp_layers import (ParallelCrossEntropy,
                                  VocabParallelEmbedding, parallel_logits)
from .ernie import ErnieLayer


class GPTEmbeddings(nn.Layer):
    def __init__(self, vocab_size, hidden_size, max_seq_len=1024, dropout=0.1,
                 use_mp=False):
        super().__init__()
        if use_mp:
            self.word_embeddings = VocabParallelEmbedding(vocab_size,
                                                          hidden_size)
        else:
            self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
        self.position_embeddings = nn.Embedding(max_seq_len, hidden_size)
        self.dropout = nn.Dropout(dropout)

    def forward(self, input_ids, position_offset=None):
        pos = torch.arange(input_ids.shape[1], dtype=torch.int32,
                           device=input_ids.device).unsqueeze(0)
        if position_offset is None:
            pe = self.position_embeddings(pos)
        else:
            # cached decode: [B] tokens-already-seen offsets the block's
            # position ids so step N embeds position N, not 0
            pe = self._positions(pos + position_offset.reshape(-1, 1))
        return self.dropout(self.word_embeddings(input_ids) + pe)

    def _positions(self, pos):
        """Rows of the position table at `pos`, NaN where `pos` is past its
        end, as the reference's `jnp.take` fills them (nn/functional/
        common.py:104). The gather reads a clamped index: on CUDA an index
        out of range is a device-side assert, not a NaN."""
        table = self.position_embeddings.weight
        n = table.shape[0]
        rows = TF.embedding(pos.clamp(0, n - 1).long(), table)
        return rows.masked_fill(((pos < 0) | (pos >= n)).unsqueeze(-1),
                                float("nan"))


class GPTModel(nn.Layer):
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None, max_seq_len=1024,
                 dropout=0.1, use_mp=False, use_sp=False):
        super().__init__()
        intermediate_size = intermediate_size or 4 * hidden_size
        self.embeddings = GPTEmbeddings(vocab_size, hidden_size, max_seq_len,
                                        dropout, use_mp)
        self.layers = nn.LayerList([
            ErnieLayer(hidden_size, num_heads, intermediate_size, dropout,
                       use_mp, use_sp, causal=True)
            for _ in range(num_layers)])
        self.final_norm = nn.LayerNorm(hidden_size)

    def forward(self, input_ids):
        x = self.embeddings(input_ids)
        for layer in self.layers:
            x = layer(x)
        return self.final_norm(x)

    def init_kv_cache(self, batch_size, max_len, dtype="float32"):
        """Fresh zero KV pages for forward_cached: one (k, v) pair per
        layer, each [batch, max_len, num_heads, head_dim], on the model's
        device. dtype "int8" builds the quantized-KV pages (scales start
        as None and are computed by the first forward_cached call)."""
        attn = self.layers[0].attention
        shape = (batch_size, max_len, attn.num_heads, attn.head_dim)
        kw = dict(dtype=convert_dtype(dtype),
                  device=self.final_norm.weight.device)
        return [(torch.zeros(shape, **kw), torch.zeros(shape, **kw))
                for _ in self.layers]

    def forward_cached(self, input_ids, past_kv, positions, kv_scales=None):
        """Prefill/decode step over explicit KV-cache pages.

        input_ids [B, T]; past_kv: list over layers of (k, v) fixed-shape
        pages [B, L, nh, hd], written in place; positions [B] int32
        tokens-already-cached per row (also the position-embedding
        offset). kv_scales: list of (k_scale, v_scale) [B] pairs for int8
        pages, or None. Returns (hidden, past_kv, new_kv_scales)."""
        x = self.embeddings(input_ids, position_offset=positions)
        new_scales = []
        for i, layer in enumerate(self.layers):
            ks, vs = (None, None) if kv_scales is None else kv_scales[i]
            k, v = past_kv[i]
            x, _, _, ks, vs = layer.forward_cached(x, k, v, positions, ks,
                                                   vs)
            new_scales.append((ks, vs))
        return self.final_norm(x), past_kv, new_scales


class GPTForCausalLM(nn.Layer):
    def __init__(self, gpt: GPTModel):
        super().__init__()
        self.gpt = gpt

    def forward(self, input_ids):
        # the tied head is an AMP white-list matmul (ops/math.py:139-140)
        return parallel_logits(self.gpt(input_ids),
                               self.gpt.embeddings.word_embeddings)

    def forward_cached(self, input_ids, past_kv, positions, kv_scales=None):
        """Cached-attention LM step: (logits, past_kv, new_kv_scales), the
        pages written in place. Weight-tied head over
        GPTModel.forward_cached."""
        h, kv, scales = self.gpt.forward_cached(input_ids, past_kv,
                                                positions, kv_scales)
        w = self.gpt.embeddings.word_embeddings.weight
        return torch.matmul(h, w.t()), kv, scales


class GPTPretrainingCriterion(nn.Layer):
    """Shifted-LM loss: logits at position i against the token at i + 1,
    mean cross entropy over the batch; with `use_parallel_ce`, the
    vocab-parallel `ParallelCrossEntropy` (the rank's logits slice in a
    process world of mp > 1)."""

    def __init__(self, use_parallel_ce=False):
        super().__init__()
        self._parallel = bool(use_parallel_ce)
        self.ce = ParallelCrossEntropy() if self._parallel \
            else nn.CrossEntropyLoss()

    def forward(self, logits, labels):
        shifted = logits[:, :-1]
        tgt = labels[:, 1:]
        if self._parallel:
            return self.ce(shifted, tgt.unsqueeze(-1)).mean()
        b, s, v = shifted.shape
        return self.ce(shifted.reshape(b * s, v), tgt.reshape(b * s))


class _EmbedStage(nn.Layer):
    """`gpt_pipeline_layer`'s first entry: the embeddings."""

    def __init__(self, vocab_size, hidden_size, max_seq_len, dropout, use_mp):
        super().__init__()
        self.emb = GPTEmbeddings(vocab_size, hidden_size, max_seq_len,
                                 dropout, use_mp)

    def forward(self, ids):
        return self.emb(ids)


class _HeadStage(nn.Layer):
    """`gpt_pipeline_layer`'s last entry: the final norm and an untied
    LM head."""

    def __init__(self, hidden_size, vocab_size):
        super().__init__()
        self.norm = nn.LayerNorm(hidden_size)
        self.lm_head = nn.Linear(hidden_size, vocab_size, bias_attr=False)

    def forward(self, x):
        return self.lm_head(self.norm(x))


def gpt_pipeline_layer(vocab_size=50304, hidden_size=768, num_layers=12,
                       num_heads=12, num_stages=2, use_mp=False, dropout=0.1,
                       max_seq_len=1024, num_virtual_pipeline_stages=1):
    """PipelineLayer build of GPT for pipeline training (the reference's
    :135-172): the embeddings, `num_layers` causal ErnieLayers (FFN 4 x
    hidden), the norm and an untied head, with the shifted-LM loss."""
    from ..parallel.pp_layers import LayerDesc, PipelineLayer
    descs = [LayerDesc(_EmbedStage, vocab_size, hidden_size, max_seq_len,
                       dropout, use_mp)]
    for _ in range(num_layers):
        descs.append(LayerDesc(ErnieLayer, hidden_size, num_heads,
                               4 * hidden_size, dropout, use_mp, False, True))
    descs.append(LayerDesc(_HeadStage, hidden_size, vocab_size))
    return PipelineLayer(descs, num_stages=num_stages,
                         loss_fn=GPTPretrainingCriterion(),
                         num_virtual_pipeline_stages=num_virtual_pipeline_stages)


# configs
def gpt2_small(**kw):
    return GPTModel(hidden_size=768, num_layers=12, num_heads=12, **kw)


def gpt2_medium(**kw):
    return GPTModel(hidden_size=1024, num_layers=24, num_heads=16, **kw)


def gpt_10b(**kw):
    """Config 5's model (:178): 48 layers of hidden 4096, 64 heads of 64,
    FFN 16384, vocabulary 50304, sequence 2048."""
    return GPTModel(hidden_size=4096, num_layers=48, num_heads=64,
                    max_seq_len=2048, **kw)


__all__ = ["GPTEmbeddings", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion", "gpt_pipeline_layer", "gpt2_small",
           "gpt2_medium", "gpt_10b"]
