"""The port's recurrent layers (`nn/layer/rnn.py`) against the JAX
package on the CPU: the cases of `tests/test_rnn.py`, each run through the
reference layer and the port's with the reference's weights
(`load_numpy_state`): the cells; the sweep (torch's fused op in the port,
`lax.scan` in the reference), reversed and time-major; `sequence_length`
(the step loop: carry masked, raw outputs at padded steps, the reverse
direction over the whole padded sequence), also multi-layer; BiRNN; a
custom cell; initial and final states; the gradients of `sum(out * g)`
for every parameter and the input; the `state_dict` names and the flat
aliases. Forward and gradients within 1e-5 (1 + |ref|) in fp32.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core import autograd as jautograd
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from torch_parity import dev as _dev, n_, pair as _pair, \
    run_both as _run_both

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")


@pytest.fixture(autouse=True)
def _fresh_reference_op_cache():
    jautograd._JIT_CACHE.clear()


# ---- cells ----

@pytest.mark.parametrize("make,states", [
    (lambda m: m.SimpleRNNCell(16, 32), 1),
    (lambda m: m.SimpleRNNCell(8, 8, activation="relu"), 1),
    (lambda m: m.LSTMCell(16, 32), 2),
    (lambda m: m.GRUCell(16, 32), 1),
    (lambda m: m.GRUCell(6, 10), 0),          # the default zero state
    (lambda m: m.LSTMCell(6, 10, bias_ih_attr=False), 2),
], ids=["simple", "simple_relu", "lstm", "gru", "gru_zero_state",
        "lstm_no_bias_ih"])
def test_cell(make, states):
    """A cell's step against the reference's. The reference cannot
    differentiate a one-state cell called alone (its eager op returns a
    1-tuple, and the VJP raises: ROADMAP Queue 3 item 10), so the port's
    gradients of those are held to the reference's RNN over one step,
    the same function."""
    j, t = _pair(make)
    x = n_(4, j.input_size)
    hs = [n_(4, j.hidden_size, seed=2 + i) for i in range(states)]
    if states == 2:
        _run_both(j, t, [x, hs[0], hs[1]],
                  call=lambda layer, x, h, c: layer(x, (h, c)))
        return
    _run_both(j, t, [x] + hs, grads=False)
    with pytest.raises(ValueError):
        y, _ = j(paddle.to_tensor(x, stop_gradient=False),
                 *[paddle.to_tensor(h) for h in hs])
        paddle.sum(y).backward()
    jr = jnn.RNN(j)
    _run_both(jr, _CellAsRNN(t), [x[:, None]] + hs,
              call=lambda layer, x, *h: layer(x, *h)[0])


class _CellAsRNN(torch.nn.Module):
    """A port cell named as the reference's RNN(cell) names it, run on
    the one step of a [B, 1, I] input."""

    def __init__(self, cell):
        super().__init__()
        self.cell = cell

    def forward(self, x, h=None):
        out, _ = self.cell(x[:, 0], h)
        return out[:, None], None


def test_cell_errors_and_weight_shapes():
    with pytest.raises(ValueError):
        tnn.LSTMCell(4, 0)
    with pytest.raises(ValueError):
        tnn.SimpleRNNCell(4, 8, activation="gelu")
    lstm = tnn.LSTMCell(16, 32)
    assert tuple(lstm.weight_ih.shape) == (128, 16)
    assert tuple(lstm.weight_hh.shape) == (128, 32)
    gru = tnn.GRUCell(16, 32)
    assert tuple(gru.weight_ih.shape) == (96, 16)
    assert tuple(gru.bias_hh.shape) == (96,)


# ---- RNN / BiRNN ----

def test_rnn_sweep_with_initial_state():
    j, t = _pair(lambda m: m.RNN(m.SimpleRNNCell(8, 16)))
    _run_both(j, t, [n_(4, 12, 8), n_(4, 16, seed=2)])


def test_rnn_lstm_reverse():
    j, t = _pair(lambda m: m.RNN(m.LSTMCell(8, 16), is_reverse=True))
    _run_both(j, t, [n_(2, 7, 8)])


def test_rnn_time_major():
    j, t = _pair(lambda m: m.RNN(m.GRUCell(5, 9), time_major=True))
    _run_both(j, t, [n_(11, 3, 5)])


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cell", ["gru", "lstm", "simple"])
def test_rnn_sequence_length(cell, reverse):
    make = {"gru": lambda m: m.GRUCell(4, 8),
            "lstm": lambda m: m.LSTMCell(4, 8),
            "simple": lambda m: m.SimpleRNNCell(4, 8)}[cell]
    j, t = _pair(lambda m: m.RNN(make(m), is_reverse=reverse))
    seq = np.array([10, 4, 7], np.int64)
    _run_both(j, t, [n_(3, 10, 4)],
              call=lambda layer, x: layer(
                  x, sequence_length=paddle.to_tensor(seq)
                  if isinstance(x, paddle.Tensor) else torch.from_numpy(seq)))


def test_padded_outputs_are_raw_step_outputs():
    """At padded steps the port, like the reference, returns the cell's
    output on the frozen carry, not zeros (cuDNN's packed sequences would
    give zeros)."""
    j, t = _pair(lambda m: m.RNN(m.GRUCell(4, 8)))
    x = n_(2, 6, 4)
    out, _ = t(torch.from_numpy(x), sequence_length=torch.tensor([6, 2]))
    assert out[1, 2:].abs().min() > 0
    jout, _ = j(paddle.to_tensor(x),
                sequence_length=paddle.to_tensor(np.array([6, 2])))
    assert _dev(out.detach().numpy(), jout.numpy()) <= TOL


def test_custom_cell_step_loop():
    def make(m):
        class MyCell(m.RNNCellBase):
            def __init__(self):
                super().__init__()
                self.lin = m.Linear(4, 4)

            @property
            def state_shape(self):
                return (4,)

            def forward(self, x, h=None):
                if h is None:
                    h = self.get_initial_states(x, self.state_shape)
                out = (self.lin(x) + h).tanh()
                return out, out

        return m.RNN(MyCell())

    j, t = _pair(make)
    _run_both(j, t, [n_(2, 5, 4)])
    seq = np.array([5, 3], np.int64)
    _run_both(j, t, [n_(2, 5, 4, seed=3)],
              call=lambda layer, x: layer(
                  x, sequence_length=paddle.to_tensor(seq)
                  if isinstance(x, paddle.Tensor) else torch.from_numpy(seq)))


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_birnn(cell):
    make = {"lstm": lambda m: m.LSTMCell(6, 8),
            "gru": lambda m: m.GRUCell(6, 8)}[cell]
    j, t = _pair(lambda m: m.BiRNN(make(m), make(m)))
    assert "rnn_fw" not in dict(t.named_children())
    _run_both(j, t, [n_(2, 5, 6)])


# ---- multi-layer ----

@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("make", [
    lambda m, d: m.SimpleRNN(8, 16, num_layers=2, direction=d),
    lambda m, d: m.SimpleRNN(8, 16, num_layers=2, direction=d,
                             activation="relu"),
    lambda m, d: m.LSTM(8, 16, num_layers=2, direction=d),
    lambda m, d: m.GRU(8, 16, num_layers=2, direction=d),
], ids=["simple", "simple_relu", "lstm", "gru"])
def test_two_layer(make, direction):
    j, t = _pair(lambda m: make(m, direction))
    j.eval()
    t.eval()
    _run_both(j, t, [n_(4, 6, 8)])


def test_time_major_bidirectional_gru():
    j, t = _pair(lambda m: m.GRU(5, 7, num_layers=2, direction="bidirect",
                                 time_major=True))
    _run_both(j, t, [n_(6, 3, 5)])


def test_initial_and_final_states():
    j, t = _pair(lambda m: m.GRU(4, 8, num_layers=2))
    _run_both(j, t, [n_(2, 3, 4), n_(2, 2, 8, seed=2)])
    x, x2, h0 = n_(2, 3, 4), n_(2, 3, 4, seed=3), n_(2, 2, 8, seed=2)
    with torch.no_grad():
        _, hT = t(torch.from_numpy(x), torch.from_numpy(h0))
        outs2, _ = t(torch.from_numpy(x2), hT)
        both, _ = t(torch.from_numpy(np.concatenate([x, x2], 1)),
                    torch.from_numpy(h0))
    np.testing.assert_allclose(outs2.numpy(), both.numpy()[:, 3:],
                               rtol=1e-5, atol=1e-5)


def test_lstm_initial_states_bidirectional():
    j, t = _pair(lambda m: m.LSTM(4, 8, num_layers=2, direction="bidirect"))
    _run_both(j, t, [n_(2, 3, 4), n_(4, 2, 8, seed=2), n_(4, 2, 8, seed=3)],
              call=lambda layer, x, h, c: layer(x, (h, c)))


@pytest.mark.parametrize("mode", ["LSTM", "GRU", "SimpleRNN"])
def test_sequence_length_multilayer(mode):
    j, t = _pair(lambda m: getattr(m, mode)(4, 8, num_layers=2,
                                            direction="bidirect"))
    j.eval()
    t.eval()
    seq = np.array([7, 3, 5], np.int64)
    _run_both(j, t, [n_(3, 7, 4)],
              call=lambda layer, x: layer(
                  x, sequence_length=paddle.to_tensor(seq)
                  if isinstance(x, paddle.Tensor) else torch.from_numpy(seq)))


def test_dropout_zero_in_eval_and_drawn_in_train():
    net = tnn.SimpleRNN(4, 8, num_layers=2, dropout=0.5)
    x = torch.from_numpy(n_(2, 3, 4))
    net.eval()
    a, _ = net(x)
    b, _ = net(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    net.train()
    c, _ = net(x)
    assert not torch.equal(a, c)


def test_state_dict_names_and_flat_aliases():
    for mode in ("LSTM", "GRU", "SimpleRNN"):
        for d in ("forward", "bidirect"):
            paddle.seed(0)
            j = getattr(jnn, mode)(4, 8, num_layers=2, direction=d)
            t = getattr(tnn, mode)(4, 8, num_layers=2, direction=d)
            assert list(t.state_dict()) == list(j.state_dict())
            assert [n for n, _ in t.named_parameters()] == \
                [n for n, _ in j.named_parameters()]
    net = tnn.LSTM(4, 8, num_layers=2, direction="bidirect")
    assert net.weight_ih_l0 is net[0].cell_fw.weight_ih
    assert net.bias_hh_l1_reverse is net[1].cell_bw.bias_hh
    assert len(net.state_dict()) == 16
    assert len(list(net.parameters())) == 16
    with pytest.raises(ValueError):
        tnn.GRU(4, 8, direction="sideways")


def test_masked_steps_contribute_no_input_grad():
    j, t = _pair(lambda m: m.RNN(m.SimpleRNNCell(3, 5)))
    x = torch.tensor(n_(2, 6, 3), requires_grad=True)
    _, hT = t(x, sequence_length=torch.tensor([6, 2]))
    hT.sum().backward()
    assert x.grad[1, 2:].abs().max() == 0.0
    assert x.grad[1, :2].abs().max() > 0.0


def test_lstm_trains():
    pt.seed(0)
    lstm, head = tnn.LSTM(4, 16), tnn.Linear(16, 2)
    opt = pt.optimizer.Adam(learning_rate=1e-2,
                            parameters=list(lstm.parameters())
                            + list(head.parameters()))
    x = n_(8, 10, 4)
    y = torch.from_numpy((x.sum((1, 2)) > 0).astype(np.int64))
    losses = []
    for _ in range(30):
        _, (h, _) = lstm(torch.from_numpy(x))
        loss = torch.nn.functional.cross_entropy(head(h[-1]), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] * 0.5, losses


def test_export_keeps_one_lstm_node_per_layer():
    """torch.export of a 2-layer bidirectional LSTM keeps one
    aten.lstm.input node per BiRNN layer, with the weights as the
    program's inputs."""
    net = tnn.LSTM(4, 8, num_layers=2, direction="bidirect")
    net.eval()

    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.__dict__["net"] = net

        def forward(self, *flat):
            from paddle_tpu_torch.jit.functional import functional_call
            names = [n for n, _ in net.named_parameters()]
            return functional_call(net, names, flat[:-1], [], [],
                                   flat[-1])[0]

    ps = [p.detach() for p in net.parameters()]
    ep = torch.export.export(Wrap(), tuple(ps) + (torch.zeros(2, 5, 4),))
    targets = [str(n.target) for n in ep.graph.nodes if n.op ==
               "call_function"]
    assert targets.count("aten.lstm.input") == 2, targets
