"""Recurrent layers (counterpart of ``paddle_tpu/nn/layer/rnn.py``):
``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``, ``RNN``, ``BiRNN`` and the
multi-layer ``SimpleRNN`` / ``LSTM`` / ``GRU`` (``sequence_length``,
``time_major``, ``direction="bidirect"``, dropout between layers).

JAX runs a layer's whole time loop as one ``rnn_scan`` op over
``lax.scan``; here it is one ``rnn_scan`` op too, whose body loops over
time with torch ops, in JAX's gate order (LSTM ``i, f, g, o``; GRU ``r, z,
c`` with ``c = tanh(x_c + r * (h W_hc + b_hc))``) and with JAX's masking:
a row past its ``sequence_length`` keeps its state and outputs zeros, and
the reverse direction reads each row's valid region reversed in place.
The input's products with ``weight_ih`` for every step are one matrix
product before the loop (the same sums as JAX's per-step products); the
recurrent products are ``torch.matmul``, cuBLAS on the card.  cuDNN's
fused RNN is not used: its gate layout, its two biases' handling and its
packed-sequence semantics are not JAX's.  The parameters keep JAX's names
and shapes (``weight_ih [G * H, in]``, ``weight_hh [G * H, H]``,
``bias_ih`` / ``bias_hh [G * H]`` a cell; ``cell_fw_{layer}`` /
``cell_bw_{layer}`` in the multi-layer stacks), so a JAX ``state_dict()``
loads unchanged.
"""

from __future__ import annotations

import math

import torch

from ...ops.dispatch import apply, as_tensor
from ...tensor.creation import zeros
from ...tensor.manipulation import concat, stack
from .. import functional as F
from .. import initializer as I
from .layers import Layer

__all__ = ["SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "SimpleRNN",
           "LSTM", "GRU", "BiRNN", "RNNCellBase"]


class RNNCellBase(Layer):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        b = batch_ref.shape[batch_dim_idx]
        return zeros([b, self.hidden_size], dtype=dtype or "float32")


def _uniform_init(hidden_size):
    k = 1.0 / math.sqrt(hidden_size)
    return I.Uniform(-k, k)


class _Cell(RNNCellBase):
    GATES = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        init = _uniform_init(hidden_size)
        g = self.GATES * hidden_size
        self.weight_ih = self.create_parameter(
            [g, input_size], attr=weight_ih_attr, default_initializer=init)
        self.weight_hh = self.create_parameter(
            [g, hidden_size], attr=weight_hh_attr, default_initializer=init)
        self.bias_ih = self.create_parameter(
            [g], attr=bias_ih_attr, is_bias=True, default_initializer=init)
        self.bias_hh = self.create_parameter(
            [g], attr=bias_hh_attr, is_bias=True, default_initializer=init)

    def _weights(self):
        return (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)


def _simple_step(act):
    def step(xw, h, wh, bh):
        return (act(xw + h @ wh.T + bh),)
    return step


def _lstm_step(xw, h, c, wh, bh):
    i, f, g, o = (xw + h @ wh.T + bh).chunk(4, -1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def _gru_step(xw, h, wh, bh):
    ir, iz, ic = xw.chunk(3, -1)
    hr, hz, hc = (h @ wh.T + bh).chunk(3, -1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    c = torch.tanh(ic + r * hc)
    return ((1 - z) * c + z * h,)


class SimpleRNNCell(_Cell):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)
        self.activation = activation

    def _step(self):
        return _simple_step(torch.tanh if self.activation == "tanh"
                            else torch.relu)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        step = self._step()
        out = apply("simple_rnn_cell",
                    lambda x, h, wi, wh, bi, bh: step(x @ wi.T + bi, h, wh,
                                                      bh)[0],
                    as_tensor(inputs), as_tensor(states), *self._weights())
        return out, out


class LSTMCell(_Cell):
    GATES = 4

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 proj_size=None, name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def _step(self):
        return _lstm_step

    def forward(self, inputs, states=None):
        if states is None:
            b = inputs.shape[0]
            states = (zeros([b, self.hidden_size]),
                      zeros([b, self.hidden_size]))
        h, c = states
        h_new, c_new = apply(
            "lstm_cell",
            lambda x, hh, cc, wi, wh, bi, bh: _lstm_step(x @ wi.T + bi, hh,
                                                         cc, wh, bh),
            as_tensor(inputs), as_tensor(h), as_tensor(c), *self._weights())
        return h_new, (h_new, c_new)


class GRUCell(_Cell):
    GATES = 3

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def _step(self):
        return _gru_step

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        out = apply("gru_cell",
                    lambda x, h, wi, wh, bi, bh: _gru_step(x @ wi.T + bi, h,
                                                           wh, bh)[0],
                    as_tensor(inputs), as_tensor(states), *self._weights())
        return out, out


class RNN(Layer):
    """A cell run over time (``rnn_scan``)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        return _run_cell_scan(self.cell, inputs, initial_states,
                              self.is_reverse, self.time_major,
                              sequence_length)


def _reversed_in_place(x, lens):
    """Each row's first ``lens`` steps reversed ([T, B, ...]); the padding
    steps read step 0."""
    T = x.shape[0]
    t_idx = (lens[None, :] - 1 - torch.arange(T, device=x.device)[:, None]
             ).clamp(min=0)
    return x.gather(0, t_idx[:, :, None].expand(-1, -1, x.shape[-1]))


def _run_cell_scan(cell, inputs, initial_states, is_reverse, time_major,
                   sequence_length=None):
    inputs = as_tensor(inputs)
    b = inputs.shape[1] if time_major else inputs.shape[0]
    is_lstm = isinstance(cell, LSTMCell)
    hs = cell.hidden_size
    if initial_states is None:
        initial_states = (zeros([b, hs], dtype=inputs.dtype),
                          zeros([b, hs], dtype=inputs.dtype)) if is_lstm \
            else zeros([b, hs], dtype=inputs.dtype)
    states = initial_states if isinstance(initial_states, (tuple, list)) \
        else (initial_states,)
    n_state = 2 if is_lstm else 1
    has_len = sequence_length is not None
    # a cell of another class runs as JAX runs it: SimpleRNN's step over
    # its weight_ih / weight_hh / bias_ih / bias_hh
    step = cell._step() if isinstance(cell, _Cell) else _simple_step(
        torch.relu if getattr(cell, "activation", "tanh") == "relu"
        else torch.tanh)

    def fn(x, *args):
        st = list(args[:n_state])
        lens = args[n_state].long() if has_len else None
        wi, wh, bi, bh = args[n_state + has_len:]
        if not time_major:
            x = x.transpose(0, 1)                            # [T, B, F]
        T = x.shape[0]
        if has_len:
            if is_reverse:
                x = _reversed_in_place(x, lens)
            mask = (torch.arange(T, device=x.device)[:, None] <
                    lens[None, :])[..., None]
        else:
            if is_reverse:
                x = x.flip(0)
            mask = None
        xw = x @ wi.T + bi                                   # every step
        outs = []
        for t in range(T):
            new = step(xw[t], *st, wh, bh)
            if mask is None:
                st = list(new)
                outs.append(new[0])
            else:
                m = mask[t]
                st = [torch.where(m, n, o) for n, o in zip(new, st)]
                outs.append(torch.where(m, st[0], torch.zeros_like(st[0])))
        out = torch.stack(outs)
        if is_reverse:
            if has_len:
                out = _reversed_in_place(out, lens)
                out = torch.where(mask, out, torch.zeros_like(out))
            else:
                out = out.flip(0)
        if not time_major:
            out = out.transpose(0, 1)
        return (out,) + tuple(st)

    extra = [as_tensor(sequence_length)] if has_len else []
    results = apply("rnn_scan", fn, inputs, *[as_tensor(s) for s in states],
                    *extra, cell.weight_ih, cell.weight_hh, cell.bias_ih,
                    cell.bias_hh)
    return results[0], (tuple(results[1:]) if is_lstm else results[1])


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        if initial_states is None:
            initial_states = (None, None)
        out_f, st_f = _run_cell_scan(self.cell_fw, inputs,
                                     initial_states[0], False,
                                     self.time_major, sequence_length)
        out_b, st_b = _run_cell_scan(self.cell_bw, inputs,
                                     initial_states[1], True,
                                     self.time_major, sequence_length)
        return concat([out_f, out_b], axis=-1), (st_f, st_b)


class _MultiLayerRNN(Layer):
    """``num_layers`` stacked recurrences, each forward or both ways."""

    CELL = None

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirectional = direction in ("bidirect", "bidirectional")
        self._activation = activation
        num_dir = 2 if self.bidirectional else 1
        kwargs = {"activation": activation} \
            if self.CELL is SimpleRNNCell else {}
        self.cells = []
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else hidden_size * num_dir
            fw = self.CELL(in_sz, hidden_size, **kwargs)
            self.add_sublayer(f"cell_fw_{layer}", fw)
            cells = [fw]
            if self.bidirectional:
                bw = self.CELL(in_sz, hidden_size, **kwargs)
                self.add_sublayer(f"cell_bw_{layer}", bw)
                cells.append(bw)
            self.cells.append(cells)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        is_lstm = self.CELL is LSTMCell
        out = inputs
        last_h, last_c = [], []
        for li, cells in enumerate(self.cells):
            outs_dir = []
            for di, cell in enumerate(cells):
                init = None
                if initial_states is not None:
                    idx = li * len(cells) + di
                    init = (initial_states[0][idx], initial_states[1][idx]) \
                        if is_lstm else initial_states[idx]
                o, st = _run_cell_scan(cell, out, init, di == 1,
                                       self.time_major, sequence_length)
                outs_dir.append(o)
                if is_lstm:
                    last_h.append(st[0])
                    last_c.append(st[1])
                else:
                    last_h.append(st)
            out = outs_dir[0] if len(outs_dir) == 1 else concat(outs_dir,
                                                                axis=-1)
            if self.dropout > 0 and li < self.num_layers - 1:
                out = F.dropout(out, p=self.dropout, training=self.training)
        h = stack(last_h, axis=0)
        if is_lstm:
            return out, (h, stack(last_c, axis=0))
        return out, h


class SimpleRNN(_MultiLayerRNN):
    CELL = SimpleRNNCell


class LSTM(_MultiLayerRNN):
    CELL = LSTMCell


class GRU(_MultiLayerRNN):
    CELL = GRUCell
