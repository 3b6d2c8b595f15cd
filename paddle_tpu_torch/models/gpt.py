"""GPT-style decoder LM.

Counterpart of `paddle_tpu/models/gpt.py`: `GPTEmbeddings`, `GPTModel`,
`GPTForCausalLM` with the head tied to the word embeddings (:96-100), the
shifted-LM `GPTPretrainingCriterion` (:113-132) and the
`gpt2_small`/`gpt2_medium` configs. Tensor, sequence and pipeline
parallelism (and the vocab-parallel loss) come with the distributed slice.
"""
from __future__ import annotations

import torch

from .. import nn
from ..amp.state import maybe_cast
from .ernie import ErnieLayer


class GPTEmbeddings(nn.Layer):
    def __init__(self, vocab_size, hidden_size, max_seq_len=1024, dropout=0.1):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
        self.position_embeddings = nn.Embedding(max_seq_len, hidden_size)
        self.dropout = nn.Dropout(dropout)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], dtype=torch.int32,
                           device=input_ids.device).unsqueeze(0)
        return self.dropout(self.word_embeddings(input_ids)
                            + self.position_embeddings(pos))


class GPTModel(nn.Layer):
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=None, max_seq_len=1024,
                 dropout=0.1):
        super().__init__()
        intermediate_size = intermediate_size or 4 * hidden_size
        self.embeddings = GPTEmbeddings(vocab_size, hidden_size, max_seq_len,
                                        dropout)
        self.layers = nn.LayerList([
            ErnieLayer(hidden_size, num_heads, intermediate_size, dropout,
                       causal=True)
            for _ in range(num_layers)])
        self.final_norm = nn.LayerNorm(hidden_size)

    def forward(self, input_ids):
        x = self.embeddings(input_ids)
        for layer in self.layers:
            x = layer(x)
        return self.final_norm(x)


class GPTForCausalLM(nn.Layer):
    def __init__(self, gpt: GPTModel):
        super().__init__()
        self.gpt = gpt

    def forward(self, input_ids):
        h = self.gpt(input_ids)
        # the tied head is an AMP white-list matmul (ops/math.py:139-140)
        h, w = maybe_cast(h, self.gpt.embeddings.word_embeddings.weight)
        return torch.matmul(h, w.t())


class GPTPretrainingCriterion(nn.Layer):
    """Shifted-LM loss: logits at position i against the token at i + 1,
    mean cross entropy over the batch."""

    def __init__(self, use_parallel_ce=False):
        super().__init__()
        if use_parallel_ce:
            raise NotImplementedError(
                "GPTPretrainingCriterion(use_parallel_ce=True): the "
                "vocab-parallel loss comes with the distributed slice")
        self.ce = nn.CrossEntropyLoss()

    def forward(self, logits, labels):
        shifted = logits[:, :-1]
        tgt = labels[:, 1:]
        b, s, v = shifted.shape
        return self.ce(shifted.reshape(b * s, v), tgt.reshape(b * s))


# configs
def gpt2_small(**kw):
    return GPTModel(hidden_size=768, num_layers=12, num_heads=12, **kw)


def gpt2_medium(**kw):
    return GPTModel(hidden_size=1024, num_layers=24, num_heads=16, **kw)


__all__ = ["GPTEmbeddings", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion", "gpt2_small", "gpt2_medium"]
