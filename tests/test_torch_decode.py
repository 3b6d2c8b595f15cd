"""The port's beam search (`nn/decode.py`) against the JAX package on the
CPU: `BeamSearchDecoder` over a GRU and an LSTM cell with an embedding and
an output projection carrying the reference's weights, and over a
deterministic table "LM", stepped by `dynamic_decode`: the same ids,
parents and lengths at every step (exact), scores within 1e-5
(1 + |ref|). Also the cases of `tests/test_decode.py`: `gather_tree`,
`tile_beam_merge_with_batch`, a custom decoder without `finalize`, the
`impute_finished` guard, and the default 10000-step cap with its warning.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core import autograd as jautograd
from paddle_tpu.nn.decode import gather_tree as j_gather_tree
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn.decode import gather_tree
from torch_parity import dev, n_, state_of
from paddle_tpu_torch.utils import load_numpy_state


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture(autouse=True)
def _fresh_reference_op_cache():
    jautograd._JIT_CACHE.clear()


def _decoders(cell, vocab=10, emb=8, hidden=8, beam=4, start=1, end=2,
              seed=0):
    """The reference's and the port's BeamSearchDecoder over the same
    weights."""
    mods = {}
    for name, m in (("j", jnn), ("t", tnn)):
        paddle.seed(seed)
        e, c, p = m.Embedding(vocab, emb), cell(m, emb, hidden), \
            m.Linear(hidden, vocab)
        mods[name] = (e, c, p)
    for jm, tm in zip(mods["j"], mods["t"]):
        load_numpy_state(tm, state_of(jm))
    return [m.BeamSearchDecoder(c, start_token=start, end_token=end,
                                beam_size=beam, embedding_fn=e,
                                output_fn=p)
            for m, (e, c, p) in ((jnn, mods["j"]), (tnn, mods["t"]))]


def _steps(dec, inits, n):
    """Per step (ids, parents, scores, finished, lengths) from initialize
    and n steps."""
    inputs, state, finished = dec.initialize(inits)
    rows = []
    for t in range(n):
        out, state, inputs, finished = dec.step(t, inputs, state)
        rows.append((np.asarray(out.predicted_ids),
                     np.asarray(out.parent_ids), np.asarray(out.scores),
                     np.asarray(finished), np.asarray(state.lengths)))
        if finished.all():
            break
    return rows


@pytest.mark.parametrize("kind", ["gru", "lstm"])
def test_beam_search_matches_the_reference(kind):
    cell = (lambda m, i, h: m.GRUCell(i, h)) if kind == "gru" else \
        (lambda m, i, h: m.LSTMCell(i, h))
    jdec, tdec = _decoders(cell)
    h = n_(3, 8)
    if kind == "gru":
        jinit, tinit = paddle.to_tensor(h), torch.from_numpy(h)
    else:
        c = n_(3, 8, seed=2)
        jinit = (paddle.to_tensor(h), paddle.to_tensor(c))
        tinit = (torch.from_numpy(h), torch.from_numpy(c))
    jrows, trows = _steps(jdec, jinit, 8), _steps(tdec, tinit, 8)
    assert len(jrows) == len(trows)
    for jr, tr in zip(jrows, trows):
        for k in (0, 1, 3, 4):
            np.testing.assert_array_equal(tr[k], jr[k])
        assert dev(tr[2], jr[2]) <= 1e-5

    jdec, tdec = _decoders(cell)
    jo, js, jl = jnn.dynamic_decode(jdec, inits=jinit, max_step_num=6,
                                    return_length=True)
    to, ts, tl = tnn.dynamic_decode(tdec, inits=tinit, max_step_num=6,
                                    return_length=True)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo.numpy()))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl.numpy()))
    assert tuple(to.shape)[0] == 3 and tuple(to.shape)[2] == 4
    for a, b in zip(_flat(js.cell_states), _flat(ts.cell_states)):
        assert dev(b.detach().numpy(), a.numpy()) <= 1e-5


def _flat(x):
    return [y for v in x for y in _flat(v)] if isinstance(x, tuple) else [x]


class _TableCell:
    """Stateless 'LM': logits are a row of a fixed table picked by the
    previous token (`tests/test_decode.py` BiasCell), for either
    package."""

    def __init__(self, table, torch_side):
        self.table = table
        self.torch_side = torch_side

    def __call__(self, ids, states):
        if self.torch_side:
            return torch.from_numpy(self.table)[ids.long()], states
        return paddle.index_select(paddle.to_tensor(self.table),
                                   ids.astype("int64"), axis=0), states


@pytest.mark.parametrize("table", ["random", "end_dominant"])
def test_table_lm_against_the_reference(table):
    if table == "random":
        tab = np.random.RandomState(0).randn(6, 6).astype(np.float32) * 2
    else:
        tab = np.full((6, 6), -5.0, np.float32)
        tab[:, 5] = 5.0
    res = []
    for m, torch_side in ((jnn, False), (tnn, True)):
        dec = m.BeamSearchDecoder(_TableCell(tab, torch_side), 0, 5, 3)
        init = np.zeros((2, 1), np.float32)
        init = torch.from_numpy(init) if torch_side else \
            paddle.to_tensor(init)
        out, state, lengths = m.dynamic_decode(dec, inits=init,
                                               max_step_num=5,
                                               return_length=True)
        res.append((np.asarray(out.numpy()), np.asarray(lengths.numpy()),
                    np.asarray(state.log_probs.numpy()
                               if hasattr(state.log_probs, "numpy")
                               else state.log_probs)))
    (jo, jl, js), (to, tl, ts) = res
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tl, jl)
    assert dev(ts, js) <= 1e-5


def test_ties_take_the_lower_index_first():
    """A table whose rows are all equal: every candidate ties, and the
    beams take tokens 0, 1, 2 of beam 0 in order, as jax.lax.top_k
    does."""
    tab = np.zeros((6, 6), np.float32)
    dec = tnn.BeamSearchDecoder(_TableCell(tab, True), 0, 5, 3)
    inputs, state, _ = dec.initialize(torch.zeros(1, 1))
    out, state, _, _ = dec.step(0, inputs, state)
    np.testing.assert_array_equal(out.predicted_ids, [[0, 1, 2]])
    np.testing.assert_array_equal(out.parent_ids, [[0, 0, 0]])
    jdec = jnn.BeamSearchDecoder(_TableCell(tab, False), 0, 5, 3)
    ji, js, _ = jdec.initialize(paddle.to_tensor(np.zeros((1, 1),
                                                          np.float32)))
    jout, _, _, _ = jdec.step(0, ji, js)
    np.testing.assert_array_equal(out.predicted_ids, jout.predicted_ids)


def test_gather_tree_backtrace():
    ids = np.array([[[3, 4]], [[5, 6]]])       # [T=2, B=1, W=2]
    parents = np.array([[[0, 0]], [[1, 0]]])
    out = gather_tree(ids, parents)
    assert out[0, 0, 0] == 4 and out[1, 0, 0] == 5
    assert out[0, 0, 1] == 3 and out[1, 0, 1] == 6
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 9, (5, 3, 4))
    parents = rng.integers(0, 4, (5, 3, 4))
    np.testing.assert_array_equal(gather_tree(ids, parents),
                                  j_gather_tree(ids, parents))


def test_tile_beam_merge_with_batch():
    x = np.arange(4, dtype=np.float32).reshape(2, 2)
    t = tnn.BeamSearchDecoder.tile_beam_merge_with_batch(
        torch.from_numpy(x), 3)
    j = jnn.BeamSearchDecoder.tile_beam_merge_with_batch(
        paddle.to_tensor(x), 3)
    assert tuple(t.shape) == (6, 2)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j.numpy()))


def _greedy(m, torch_side):
    class Greedy(m.Decoder):
        def __init__(self, table):
            self.table = np.asarray(table)

        def _wrap(self, a):
            return torch.from_numpy(a) if torch_side else \
                paddle.to_tensor(a)

        def initialize(self, inits):
            b = inits.shape[0]
            return (self._wrap(np.zeros(b, np.int64)), np.zeros(b, np.int64),
                    np.zeros(b, bool))

        def step(self, time, inputs, states, **kw):
            ids = np.asarray(inputs.numpy()).astype(int)
            nxt = self.table[ids].argmax(-1)
            return self._wrap(nxt), nxt, self._wrap(nxt), nxt == 5

    return Greedy


def test_custom_decoder_without_finalize():
    table = np.full((6, 6), -5.0, np.float32)
    table[:, 5] = 5.0
    res = []
    for m, ts in ((jnn, False), (tnn, True)):
        out, _, lengths = m.dynamic_decode(
            _greedy(m, ts)(table), inits=np.zeros((3, 1), np.float32),
            max_step_num=4, return_length=True)
        res.append((np.asarray(out.numpy()), np.asarray(lengths.numpy())))
    (jo, jl), (to, tl) = res
    assert to.shape == (3, 1) and (tl == 0).all()
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tl, jl)


def test_impute_finished_guard():
    class Dummy(tnn.Decoder):
        pass

    with pytest.raises(NotImplementedError, match="impute_finished"):
        tnn.dynamic_decode(Dummy(), impute_finished=True)


def test_default_step_cap_warns():
    class Never(tnn.Decoder):
        def initialize(self, inits):
            return torch.zeros(2), None, np.zeros(2, bool)

        def step(self, time, inputs, states, **kw):
            return np.zeros(2, np.int64), None, inputs, np.zeros(2, bool)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out, _ = tnn.dynamic_decode(Never())
    assert tuple(out.shape) == (2, 10000)
    assert any("10000-step cap" in str(w.message) for w in caught)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out, _ = tnn.dynamic_decode(Never(), max_step_num=7)
    assert tuple(out.shape) == (2, 7) and not caught
