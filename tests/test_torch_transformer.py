"""The port's transformer layers (`nn/layer/transformer.py`) against the
JAX package on the CPU, with the reference's weights: MultiHeadAttention
without a mask, with float and bool masks, other key / value widths,
`Cache` (incremental self-attention over `gen_cache`) and `StaticCache`;
the encoder and decoder layers with `normalize_before` both ways; the
stacks; `Transformer` with its masks; `generate_square_subsequent_mask`.
Forward and the gradients of `sum(out * g)` for every parameter and
input within 1e-5 (1 + |ref|) in fp32 (dropout 0, or eval mode). The
reference ignores the stacks' `cache` argument and `need_weights`; so
does the port (ROADMAP Queue 3 item 10).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core import autograd as jautograd
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from torch_parity import dev, n_, pair, run_both

B, S, T, E, H = 2, 6, 5, 16, 4


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture(autouse=True)
def _fresh_reference_op_cache():
    jautograd._JIT_CACHE.clear()


def _causal(n):
    return np.where(np.tril(np.ones((n, n), bool)), 0.0, -1e9).astype(
        np.float32)


def _to(x, like):
    """A constant numpy mask -> the package of `like` (a reference Tensor
    or torch)."""
    if isinstance(like, paddle.Tensor):
        return paddle.to_tensor(x)
    return torch.from_numpy(x)


def test_mha_self_attention_no_mask():
    j, t = pair(lambda m: m.MultiHeadAttention(E, H))
    run_both(j, t, [n_(B, S, E)])


@pytest.mark.parametrize("kind", ["float", "bool"])
def test_mha_masks(kind):
    j, t = pair(lambda m: m.MultiHeadAttention(E, H))
    mask = _causal(S) if kind == "float" else \
        np.tril(np.ones((S, S), bool))
    run_both(j, t, [n_(B, S, E)],
             call=lambda layer, x: layer(x, x, x, _to(mask, x)))


def test_mha_cross_attention_other_widths():
    j, t = pair(lambda m: m.MultiHeadAttention(E, H, kdim=12, vdim=8))
    run_both(j, t, [n_(B, S, E), n_(B, T, 12, seed=2), n_(B, T, 8, seed=3)])


def test_mha_incremental_cache():
    """Two decoding steps over gen_cache's empty Cache: the caches grow
    and the outputs equal the reference's."""
    j, t = pair(lambda m: m.MultiHeadAttention(E, H))

    def call(layer, x1, x2):
        cache = layer.gen_cache(x1)
        o1, cache = layer(x1, x1, x1, None, cache)
        o2, cache = layer(x2, x2, x2, None, cache)
        assert tuple(cache.k.shape) == (B, 2, H, E // H)
        return [o1, o2, cache.k, cache.v]

    run_both(j, t, [n_(B, 1, E), n_(B, 1, E, seed=2)], call=call)


def test_mha_static_cache():
    j, t = pair(lambda m: m.MultiHeadAttention(E, H))

    def call(layer, q, mem):
        cache = layer.gen_cache(mem, mem, type=type(layer).StaticCache)
        return layer(q, mem, mem, None, cache)

    run_both(j, t, [n_(B, S, E), n_(B, T, E, seed=2)], call=call)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_layer_and_stack(normalize_before):
    def make(m):
        layer = m.TransformerEncoderLayer(E, H, 32, dropout=0.0,
                                          normalize_before=normalize_before)
        return m.TransformerEncoder(layer, 2, m.LayerNorm(E)
                                    if normalize_before else None)

    j, t = pair(make)
    run_both(j, t, [n_(B, S, E)],
             call=lambda layer, x: [layer(x), layer(x, _to(_causal(S), x))])


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_layer_and_stack(normalize_before):
    def make(m):
        layer = m.TransformerDecoderLayer(E, H, 32, dropout=0.0,
                                          activation="gelu",
                                          normalize_before=normalize_before)
        return m.TransformerDecoder(layer, 2, m.LayerNorm(E)
                                    if normalize_before else None)

    j, t = pair(make)
    run_both(j, t, [n_(B, T, E), n_(B, S, E, seed=2)],
             call=lambda layer, y, mem: layer(y, mem, _to(_causal(T), y)))


def test_decoder_layer_with_cache():
    j, t = pair(lambda m: m.TransformerDecoderLayer(E, H, 32, dropout=0.0))

    def call(layer, y, mem):
        cache = (layer.self_attn.gen_cache(y),)
        out, (new,) = layer(y, mem, None, None, cache)
        return [out, new.k, new.v]

    run_both(j, t, [n_(B, 1, E), n_(B, S, E, seed=2)], call=call)


def test_transformer_with_masks():
    def make(m):
        return m.Transformer(E, H, 2, 2, 32, dropout=0.0)

    j, t = pair(make)
    mem_mask = np.ones((T, S), bool)
    mem_mask[:, -1] = False
    run_both(j, t, [n_(B, S, E), n_(B, T, E, seed=2)],
             call=lambda layer, s, y: layer(
                 s, y, tgt_mask=_to(_causal(T), s),
                 memory_mask=_to(mem_mask, s)))


def test_transformer_eval_with_default_dropout():
    j, t = pair(lambda m: m.Transformer(E, H, 1, 1, 32,
                                        normalize_before=True))
    j.eval()
    t.eval()
    run_both(j, t, [n_(B, S, E), n_(B, S, E, seed=2)], grads=False)


def test_generate_square_subsequent_mask():
    jm = jnn.Transformer(E, H, 1, 1, 32).generate_square_subsequent_mask(7)
    tm = tnn.Transformer(E, H, 1, 1, 32).generate_square_subsequent_mask(7)
    assert tm.dtype == torch.float32 and tm.device.type == "cpu"
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm.numpy()))


def test_kept_reference_defects():
    """The stacks take `cache` and read it not; `need_weights` is not
    read: the result is the plain output in both packages."""
    j, t = pair(lambda m: m.TransformerEncoder(
        m.TransformerEncoderLayer(E, H, 32, dropout=0.0), 1))
    x = n_(B, S, E)
    junk = object()
    got = t(torch.from_numpy(x), None, junk)
    want = j(paddle.to_tensor(x), None, junk)
    assert dev(got.detach().numpy(), want.numpy()) <= 1e-5
    mha = tnn.MultiHeadAttention(E, H, need_weights=True)
    out = mha(torch.from_numpy(x))
    assert isinstance(out, torch.Tensor) and tuple(out.shape) == (B, S, E)
