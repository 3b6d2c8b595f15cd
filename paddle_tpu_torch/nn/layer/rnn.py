"""Recurrent layers: SimpleRNN / LSTM / GRU cells and multi-layer wrappers.

Counterpart of `paddle_tpu/nn/layer/rnn.py`: `split_states` /
`concat_states` (:37, :53), the three cells (:224-284), `RNN` (:320) with
its step loop for custom cells (:378), `BiRNN` (:417), `RNNBase` (:446) and
`SimpleRNN` / `LSTM` / `GRU` (:565-605), with the reference's parameter
names (`0.cell_fw.weight_ih`, ...) and its flat aliases (`weight_ih_l0`
... `bias_hh_l1_reverse`), kept out of the `state_dict`.

Where the reference runs a builtin cell's whole sweep as one `lax.scan`
(:286-317), the port calls torch's fused RNN op once per layer
(`torch._VF.lstm` / `gru` / `rnn_tanh` / `rnn_relu`: cuDNN on the card,
aten's loop on the CPU); a `BiRNN` of two builtin cells is one call with
`bidirectional=True`. The gate orders are torch's: LSTM i|f|g|o, GRU r|z|n
with the reset applied after the product (the reference's r|z|c). The
weights are read from the cells at call time, so `functional_call` and
`torch.export` see them as the op's arguments; `jit.save` keeps one
`aten.lstm.input` node per layer. The between-layer dropout is the port's
`F.dropout` (:543-546), not the op's.

With `sequence_length` the reference's semantics are not cuDNN's packed
sequences: the carry is masked at padded steps, the reverse direction
flips the whole padded sequence, and the outputs at padded steps are the
raw step outputs. That path, and any custom cell, runs the per-step loop
(`_loop_forward`).
"""
from __future__ import annotations

import math

import torch

from .. import functional as F
from .. import initializer as I
from .container import LayerList
from .layers import Layer

__all__ = [
    "RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell",
    "RNN", "BiRNN", "SimpleRNN", "LSTM", "GRU",
]


def split_states(states, bidirectional=False, state_components=1):
    """[L*D, B, H]-stacked states -> per-layer (per-direction) structures.

    Reference parity: `nn/layer/rnn.py:37`."""
    if state_components == 1:
        states = list(torch.unbind(states, 0))
    else:
        comps = [torch.unbind(c, 0) for c in states]
        states = [tuple(c[i] for c in comps) for i in range(len(comps[0]))]
    if not bidirectional:
        return states
    return [(states[2 * i], states[2 * i + 1])
            for i in range(len(states) // 2)]


def concat_states(states, bidirectional=False, state_components=1):
    """Inverse of split_states. Reference parity: `nn/layer/rnn.py:53`."""
    if bidirectional:
        flat = []
        for pair in states:
            flat.extend(pair)
    else:
        flat = list(states)
    if state_components == 1:
        return torch.stack(flat, 0)
    return tuple(torch.stack([s[c] for s in flat], 0)
                 for c in range(state_components))


class RNNCellBase(Layer):
    """Base for cells: zero initial states from a batch reference.

    Reference parity: `nn/layer/rnn.py:71`."""

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        shape = shape if shape is not None else self.state_shape
        ref = batch_ref
        while isinstance(ref, (list, tuple)):
            ref = ref[0]
        batch = ref.shape[batch_dim_idx]
        dtype = dtype or ref.dtype

        def make(s):
            return torch.full((batch,) + tuple(s), init_value, dtype=dtype,
                              device=ref.device)

        if shape and isinstance(shape[0], (list, tuple)):
            return tuple(make(s) for s in shape)
        return make(shape)


# ---- per-step transitions (the cells' forward and the step loop) ----

def _affine(x, h, w_ih, w_hh, b_ih, b_hh):
    xg = x @ w_ih.T
    if b_ih is not None:
        xg = xg + b_ih
    hg = h @ w_hh.T
    if b_hh is not None:
        hg = hg + b_hh
    return xg, hg


def _simple_rnn_step(x, hs, w_ih, w_hh, b_ih, b_hh, activation):
    h, = hs
    xg, hg = _affine(x, h, w_ih, w_hh, b_ih, b_hh)
    g = xg + hg
    h = torch.tanh(g) if activation == "tanh" else torch.relu(g)
    return h, (h,)


def _lstm_step(x, hs, w_ih, w_hh, b_ih, b_hh, _activation=None):
    h, c = hs
    xg, hg = _affine(x, h, w_ih, w_hh, b_ih, b_hh)
    i, f, cand, o = (xg + hg).chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(cand)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, (h, c)


def _gru_step(x, hs, w_ih, w_hh, b_ih, b_hh, _activation=None):
    h, = hs
    xg, hg = _affine(x, h, w_ih, w_hh, b_ih, b_hh)
    x_r, x_z, x_c = xg.chunk(3, dim=-1)
    h_r, h_z, h_c = hg.chunk(3, dim=-1)
    r = torch.sigmoid(x_r + h_r)
    z = torch.sigmoid(x_z + h_z)
    cand = torch.tanh(x_c + r * h_c)  # reset gate applied after the product
    h = z * h + (1.0 - z) * cand
    return h, (h,)


def _promoted(*tensors):
    dt = tensors[0].dtype
    for t in tensors[1:]:
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    return dt


class _BuiltinCell(RNNCellBase):
    """Shared weight plumbing for the three builtin cells."""

    _gates = 1
    _step = staticmethod(_simple_rnn_step)
    _state_components = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        if hidden_size <= 0:
            raise ValueError(
                f"hidden_size of {type(self).__name__} must be greater than "
                f"0, but now equals to {hidden_size}")
        std = 1.0 / math.sqrt(hidden_size)
        g = self._gates
        self.weight_ih = self.create_parameter(
            (g * hidden_size, input_size), weight_ih_attr,
            default_initializer=I.Uniform(-std, std))
        self.weight_hh = self.create_parameter(
            (g * hidden_size, hidden_size), weight_hh_attr,
            default_initializer=I.Uniform(-std, std))
        self.bias_ih = None if bias_ih_attr is False else \
            self.create_parameter((g * hidden_size,), bias_ih_attr,
                                  is_bias=True,
                                  default_initializer=I.Uniform(-std, std))
        self.bias_hh = None if bias_hh_attr is False else \
            self.create_parameter((g * hidden_size,), bias_hh_attr,
                                  is_bias=True,
                                  default_initializer=I.Uniform(-std, std))
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = "tanh"

    def _weights(self):
        return self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, self.state_shape)
        flat = tuple(states) if isinstance(states, (list, tuple)) \
            else (states,)
        ws = self._weights()
        dt = _promoted(inputs, *flat, *ws)
        out, new = self._step(inputs.to(dt), tuple(s.to(dt) for s in flat),
                              *[None if w is None else w.to(dt) for w in ws],
                              self.activation)
        if self._state_components == 1:
            return out, new[0]
        return out, tuple(new)

    def extra_repr(self):
        return f"{self.input_size}, {self.hidden_size}"


class SimpleRNNCell(_BuiltinCell):
    r"""Elman cell: h_t = act(W_ih x_t + b_ih + W_hh h_{t-1} + b_hh).

    Reference parity: `nn/layer/rnn.py:224`."""

    _gates = 1
    _step = staticmethod(_simple_rnn_step)
    _state_components = 1

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, name)
        if activation not in ("tanh", "relu"):
            raise ValueError(
                "activation for SimpleRNNCell should be tanh or relu, "
                f"but get {activation}")
        self.activation = activation

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def extra_repr(self):
        s = f"{self.input_size}, {self.hidden_size}"
        if self.activation != "tanh":
            s += f", activation={self.activation}"
        return s


class LSTMCell(_BuiltinCell):
    r"""LSTM cell; weights hold the i|f|g|o gate concatenation.

    Reference parity: `nn/layer/rnn.py:255`."""

    _gates = 4
    _step = staticmethod(_lstm_step)
    _state_components = 2

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))


class GRUCell(_BuiltinCell):
    r"""GRU cell; weights hold the r|z|c gate concatenation.

    Reference parity: `nn/layer/rnn.py:271`."""

    _gates = 3
    _step = staticmethod(_gru_step)
    _state_components = 1

    @property
    def state_shape(self):
        return (self.hidden_size,)


def _fused_op(cell):
    if isinstance(cell, LSTMCell):
        return torch._VF.lstm
    if isinstance(cell, GRUCell):
        return torch._VF.gru
    return torch._VF.rnn_tanh if cell.activation == "tanh" \
        else torch._VF.rnn_relu


def _fusable(cells):
    """One fused call can run these cells: builtin, of one kind and
    activation."""
    first = cells[0]
    return all(isinstance(c, _BuiltinCell) and type(c) is type(first)
               and c.activation == first.activation for c in cells)


def _fused_sweep(cells, x, states, time_major):
    """One call of torch's fused RNN op over `cells` (one, or the forward
    and backward cells of a BiRNN). states: per cell, a tuple of [B, H]
    state components. Returns (outputs, per cell a tuple of finals)."""
    ws = [w for c in cells for w in c._weights()]
    dt = _promoted(x, *[s for st in states for s in st], *ws)
    has_bias = any(c.bias_ih is not None or c.bias_hh is not None
                   for c in cells)
    flat = []
    for c in cells:
        w_ih, w_hh, b_ih, b_hh = (None if w is None else w.to(dt)
                                  for w in c._weights())
        flat += [w_ih, w_hh]
        if has_bias:
            # the op takes both biases or none; a missing one adds zeros
            zeros = w_ih.new_zeros(w_ih.shape[0])
            flat += [zeros if b_ih is None else b_ih,
                     zeros if b_hh is None else b_hh]
    n_comp = len(states[0])
    hx = tuple(torch.stack([st[k] for st in states], 0).to(dt)
               for k in range(n_comp))
    # `train` keeps what the backward needs (cuDNN refuses a backward of
    # an inference-mode call); the op's own dropout stays 0
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *hx, *flat))
    res = _fused_op(cells[0])(x.to(dt), hx if n_comp == 2 else hx[0], flat,
                              has_bias, 1, 0.0, train, len(cells) == 2,
                              not time_major)
    out, finals = res[0], res[1:]
    per_cell = [tuple(f[i] for f in finals) for i in range(len(cells))]
    return out, per_cell


def _as_tuple(states):
    return tuple(states) if isinstance(states, (list, tuple)) else (states,)


def _from_tuple(cell, states):
    return states if cell._state_components > 1 else states[0]


class RNN(Layer):
    """Run a cell over a sequence.

    Reference parity: `nn/layer/rnn.py:320`: padded steps pass the previous
    state through and the outputs are the raw per-step outputs. A builtin
    cell without `sequence_length` takes torch's fused op (reversed: the
    sequence flipped, swept forward and flipped back); any other call runs
    the per-step loop (:378)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        cell = self.cell
        if isinstance(cell, _BuiltinCell) and not kwargs \
                and sequence_length is None:
            if initial_states is None:
                initial_states = cell.get_initial_states(
                    inputs, cell.state_shape,
                    batch_dim_idx=1 if self.time_major else 0)
            t_axis = 0 if self.time_major else 1
            x = inputs.flip(t_axis) if self.is_reverse else inputs
            out, (final,) = _fused_sweep(
                [cell], x, [_as_tuple(initial_states)], self.time_major)
            if self.is_reverse:
                out = out.flip(t_axis)
            return out, _from_tuple(cell, final)
        return self._loop_forward(inputs, initial_states, sequence_length,
                                  **kwargs)

    def _loop_forward(self, inputs, initial_states, sequence_length,
                      **kwargs):
        cell = self.cell
        time_axis = 0 if self.time_major else 1
        T = inputs.shape[time_axis]
        if initial_states is None:
            initial_states = cell.get_initial_states(
                inputs, batch_dim_idx=1 if self.time_major else 0)
        states = initial_states
        mask = None
        if sequence_length is not None:
            seq = torch.as_tensor(sequence_length, device=inputs.device)
            mask = (torch.arange(T, device=inputs.device)[:, None]
                    < seq[None, :]).to(inputs.dtype)
        order = range(T - 1, -1, -1) if self.is_reverse else range(T)
        outs = []
        for t in order:
            out, new_states = cell(inputs.select(time_axis, t), states,
                                   **kwargs)
            if mask is not None:
                m = mask[t][:, None]
                merged = tuple(n * m + o * (1.0 - m) for n, o in
                               zip(_as_tuple(new_states), _as_tuple(states)))
                new_states = merged if isinstance(new_states, tuple) \
                    else merged[0]
            states = new_states
            outs.append(out)
        if self.is_reverse:
            outs.reverse()
        return torch.stack(outs, time_axis), states


class BiRNN(Layer):
    """Forward + backward sweeps, outputs concatenated on the last axis.

    Reference parity: `nn/layer/rnn.py:417`. Two builtin cells of one kind
    without `sequence_length` run as one fused call with
    `bidirectional=True`; otherwise `rnn_fw` and `rnn_bw` run in turn.
    `rnn_fw` / `rnn_bw` stay out of the module tree, so the parameters are
    named `cell_fw.*` / `cell_bw.*` once, as in the reference."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.__dict__["rnn_fw"] = RNN(cell_fw, is_reverse=False,
                                      time_major=time_major)
        self.__dict__["rnn_bw"] = RNN(cell_bw, is_reverse=True,
                                      time_major=time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        cells = [self.cell_fw, self.cell_bw]
        if initial_states is None:
            states_fw = states_bw = None
        else:
            states_fw, states_bw = initial_states
        if _fusable(cells) and not kwargs and sequence_length is None:
            bdim = 1 if self.time_major else 0
            if states_fw is None:
                states_fw = self.cell_fw.get_initial_states(
                    inputs, self.cell_fw.state_shape, batch_dim_idx=bdim)
            if states_bw is None:
                states_bw = self.cell_bw.get_initial_states(
                    inputs, self.cell_bw.state_shape, batch_dim_idx=bdim)
            out, (f_fw, f_bw) = _fused_sweep(
                cells, inputs, [_as_tuple(states_fw), _as_tuple(states_bw)],
                self.time_major)
            return out, (_from_tuple(self.cell_fw, f_fw),
                         _from_tuple(self.cell_bw, f_bw))
        out_fw, final_fw = self.rnn_fw(inputs, states_fw, sequence_length,
                                       **kwargs)
        out_bw, final_bw = self.rnn_bw(inputs, states_bw, sequence_length,
                                       **kwargs)
        return torch.cat([out_fw, out_bw], -1), (final_fw, final_bw)


class RNNBase(LayerList, Layer):
    """Multi-layer, optionally bidirectional recurrent network: a list of
    RNN / BiRNN wrappers that is a Layer too.

    Reference parity: `nn/layer/rnn.py:446`; `flatten_parameters` is a
    no-op, as in the reference (the fused op takes the cells' weights as a
    list at each call)."""

    def __init__(self, mode, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, activation=None):
        super().__init__()
        bidirectional_list = ("bidirectional", "bidirect")
        self.mode = mode
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.dropout = dropout
        self.num_directions = 2 if direction in bidirectional_list else 1
        self.time_major = time_major
        self.num_layers = num_layers
        self.state_components = 2 if mode == "LSTM" else 1

        kwargs = {"weight_ih_attr": weight_ih_attr,
                  "weight_hh_attr": weight_hh_attr,
                  "bias_ih_attr": bias_ih_attr,
                  "bias_hh_attr": bias_hh_attr}
        if mode == "LSTM":
            rnn_cls = LSTMCell
        elif mode == "GRU":
            rnn_cls = GRUCell
        else:
            rnn_cls = SimpleRNNCell
            kwargs["activation"] = activation or "tanh"

        if direction == "forward":
            self.append(RNN(rnn_cls(input_size, hidden_size, **kwargs),
                            False, time_major))
            for _ in range(1, num_layers):
                self.append(RNN(rnn_cls(hidden_size, hidden_size, **kwargs),
                                False, time_major))
        elif direction in bidirectional_list:
            self.append(BiRNN(rnn_cls(input_size, hidden_size, **kwargs),
                              rnn_cls(input_size, hidden_size, **kwargs),
                              time_major))
            for _ in range(1, num_layers):
                self.append(BiRNN(
                    rnn_cls(2 * hidden_size, hidden_size, **kwargs),
                    rnn_cls(2 * hidden_size, hidden_size, **kwargs),
                    time_major))
        else:
            raise ValueError(
                "direction should be forward or bidirect (or bidirectional), "
                f"received direction = {direction}")

        # the reference's flat aliases (weight_ih_l0, bias_hh_l1_reverse,
        # ...), outside the module's parameters so state_dict counts each
        # weight once
        for layer in range(num_layers):
            for d in range(self.num_directions):
                suffix = "_reverse" if d == 1 else ""
                wrapper = self[layer]
                cell = (wrapper.cell_fw if d == 0 else wrapper.cell_bw) \
                    if self.num_directions == 2 else wrapper.cell
                for wname in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                    p = getattr(cell, wname, None)
                    if p is not None:
                        self.__dict__[f"{wname}_l{layer}{suffix}"] = p

    def flatten_parameters(self):
        """cuDNN's weight-coalescing hook: nothing to do."""

    def forward(self, inputs, initial_states=None, sequence_length=None):
        batch_index = 1 if self.time_major else 0
        if initial_states is None:
            L = self.num_layers * self.num_directions
            z = torch.zeros((L, inputs.shape[batch_index], self.hidden_size),
                            dtype=inputs.dtype, device=inputs.device)
            initial_states = z if self.state_components == 1 \
                else tuple(z for _ in range(self.state_components))
        elif self.state_components > 1:
            initial_states = tuple(initial_states)
        elif isinstance(initial_states, (list, tuple)):
            initial_states = initial_states[0]
        states = split_states(initial_states, self.num_directions == 2,
                              self.state_components)
        final_states = []
        outputs = inputs
        for i, rnn_layer in enumerate(self):
            if i > 0:
                outputs = F.dropout(outputs, self.dropout,
                                    training=self.training,
                                    mode="upscale_in_train")
            outputs, final = rnn_layer(outputs, states[i], sequence_length)
            final_states.append(final)
        return outputs, concat_states(final_states, self.num_directions == 2,
                                      self.state_components)

    def extra_repr(self):
        s = f"{self.input_size}, {self.hidden_size}"
        if self.num_layers != 1:
            s += f", num_layers={self.num_layers}"
        if self.time_major:
            s += f", time_major={self.time_major}"
        if self.dropout != 0:
            s += f", dropout={self.dropout}"
        return s


class SimpleRNN(RNNBase):
    """Multilayer Elman network. Reference parity: `nn/layer/rnn.py:565`."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        if activation == "tanh":
            mode = "RNN_TANH"
        elif activation == "relu":
            mode = "RNN_RELU"
        else:
            raise ValueError(f"Unknown activation '{activation}'")
        super().__init__(mode, input_size, hidden_size, num_layers, direction,
                         time_major, dropout, weight_ih_attr, weight_hh_attr,
                         bias_ih_attr, bias_hh_attr, activation=activation)
        self.activation = activation


class LSTM(RNNBase):
    """Multilayer LSTM. Reference parity: `nn/layer/rnn.py:584`."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__("LSTM", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)


class GRU(RNNBase):
    """Multilayer GRU. Reference parity: `nn/layer/rnn.py:596`."""

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__("GRU", input_size, hidden_size, num_layers,
                         direction, time_major, dropout, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)
