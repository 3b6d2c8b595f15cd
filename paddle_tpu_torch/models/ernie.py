"""ERNIE/BERT encoder family: the flagship pretraining model.

Counterpart of `paddle_tpu/models/ernie.py`: `ErnieEmbeddings` (:22),
`ErnieMLP` (:49), `ErnieSelfAttention.forward` (:86), `ErnieLayer.forward`
(:214), `ErnieModel` (:231), `ErnieForSequenceClassification` (:259),
`ErnieForPretraining` (:271, MLM head tied to the word embeddings) and the
`ernie_base`/`ernie_large`/`bert_base`/`bert_large` configs. Post-LN; same
parameter names and layouts, so a JAX state dict loads by name.

With `use_sp`, attention is `parallel.sequence_parallel_attention(impl=
"ring")` over the current mesh's 'sp' axis, and the attention mask and
dropout are ignored, as in the reference (:92-94). Tensor parallelism
(`use_mp=True`) raises: it comes with the distributed slice. The scanned
stack (`ErnieScanStack`) and the cached decode path (`forward_cached`) are
not ported yet.
"""
from __future__ import annotations

import torch

from .. import nn
from ..amp.state import maybe_cast
from ..core.enforce import UnimplementedError
from ..nn.functional.attention import scaled_dot_product_attention
from ..parallel.sp import sequence_parallel_attention


def _no_mp(use_mp, where):
    if use_mp:
        raise UnimplementedError(
            f"{where}(use_mp=True): tensor parallelism (mp_layers) comes with "
            "the distributed slice of the port")


class ErnieEmbeddings(nn.Layer):
    def __init__(self, vocab_size, hidden_size, max_position_embeddings=512,
                 type_vocab_size=2, dropout=0.1, use_mp=False):
        super().__init__()
        _no_mp(use_mp, "ErnieEmbeddings")
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
        _no_mp(use_mp, "ErnieMLP")
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
        _no_mp(use_mp, "ErnieSelfAttention")
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.causal = causal
        self.use_sp = use_sp
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
        _no_mp(use_mp, "ErnieForPretraining")
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
        h2, w = maybe_cast(h.reshape(-1, h.shape[-1]),
                           self.ernie.embeddings.word_embeddings.weight)
        logits = torch.matmul(h2, w.t())
        return logits.reshape(b, s, logits.shape[-1]), self.nsp(pooled)


# ---- configs ----
def ernie_base(**kw):
    return ErnieModel(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                      num_attention_heads=12, intermediate_size=3072, **kw)


def ernie_large(**kw):
    return ErnieModel(vocab_size=30522, hidden_size=1024, num_hidden_layers=24,
                      num_attention_heads=16, intermediate_size=4096, **kw)


bert_base = ernie_base
bert_large = ernie_large

__all__ = ["ErnieEmbeddings", "ErnieMLP", "ErnieSelfAttention", "ErnieLayer",
           "ErnieModel", "ErnieForSequenceClassification",
           "ErnieForPretraining", "ernie_base", "ernie_large", "bert_base",
           "bert_large"]
