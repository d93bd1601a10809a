"""RNN Layers (counterpart of `paddle_tpu/nn/layer/rnn.py`).

The cells carry the reference's parameter names, shapes and gate order
(LSTM i, f, c, o; GRU r, z, c with the reset gate applied to
`h @ W_hh.T + b_hh`), and the time loop is the reference's: a Python loop
over the cell, one `apply_op` a step, on the inputs' device. With
`sequence_length`, a reverse RNN runs over each sample's valid segment
flipped in place, a finished sample holds its state and emits zeros, and
a zero-length sample keeps its initial state. A fused cuDNN RNN is not
used: it would be a measured change of its own, and it would have to keep
these semantics.
"""
import torch

from ...core.tensor import apply_op
from ..initializer import Uniform
from .layers import Layer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "SimpleRNN", "LSTM", "GRU", "BiRNN"]


def _zeros_state(inputs, hidden_size):
    """The cells' default state: zeros (B, hidden) on the inputs' device."""
    return apply_op(lambda x: torch.zeros((x.shape[0], hidden_size),
                                          dtype=x.dtype, device=x.device),
                    inputs)


class RNNCellBase(Layer):
    def _params(self, gates, input_size, hidden_size, weight_ih_attr,
                weight_hh_attr, bias_ih_attr, bias_hh_attr):
        bound = 1.0 / hidden_size ** 0.5
        init = Uniform(-bound, bound)
        self.weight_ih = self.create_parameter(
            (gates * hidden_size, input_size), weight_ih_attr,
            default_initializer=init)
        self.weight_hh = self.create_parameter(
            (gates * hidden_size, hidden_size), weight_hh_attr,
            default_initializer=init)
        self.bias_ih = self.create_parameter(
            (gates * hidden_size,), bias_ih_attr, is_bias=True,
            default_initializer=init)
        self.bias_hh = self.create_parameter(
            (gates * hidden_size,), bias_hh_attr, is_bias=True,
            default_initializer=init)


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation
        self._params(1, input_size, hidden_size, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = _zeros_state(inputs, self.hidden_size)
        act = torch.tanh if self.activation == "tanh" else torch.relu

        def fn(x, h, wi, wh, bi, bh):
            return act(x @ wi.T + bi + h @ wh.T + bh)
        out = apply_op(fn, inputs, states, self.weight_ih, self.weight_hh,
                       self.bias_ih, self.bias_hh)
        return out, out


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self._params(4, input_size, hidden_size, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            h = c = _zeros_state(inputs, self.hidden_size)
        else:
            h, c = states

        def fn(x, hh, cc, wi, wh, bi, bh):
            gates = x @ wi.T + bi + hh @ wh.T + bh
            i, f, g, o = torch.chunk(gates, 4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            c_new = f * cc + i * torch.tanh(g)
            return o * torch.tanh(c_new), c_new

        h_new, c_new = apply_op(fn, inputs, h, c, self.weight_ih,
                                self.weight_hh, self.bias_ih, self.bias_hh)
        return h_new, (h_new, c_new)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self._params(3, input_size, hidden_size, weight_ih_attr,
                     weight_hh_attr, bias_ih_attr, bias_hh_attr)

    def forward(self, inputs, states=None):
        if states is None:
            states = _zeros_state(inputs, self.hidden_size)

        def fn(x, h, wi, wh, bi, bh):
            ir, iz, ic = torch.chunk(x @ wi.T + bi, 3, dim=-1)
            hr, hz, hc = torch.chunk(h @ wh.T + bh, 3, dim=-1)
            r = torch.sigmoid(ir + hr)
            z = torch.sigmoid(iz + hz)
            c = torch.tanh(ic + r * hc)
            return (1 - z) * c + z * h

        out = apply_op(fn, inputs, states, self.weight_ih, self.weight_hh,
                       self.bias_ih, self.bias_hh)
        return out, out


class RNN(Layer):
    """Wraps a cell into a sequence runner (paddle.nn.RNN)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ...tensor.manipulation import stack

        seq_axis = 0 if self.time_major else 1
        T = inputs.shape[seq_axis]
        if sequence_length is not None:
            # pad+mask variable-length semantics: a reverse RNN runs
            # forward over each sample's valid segment flipped in place,
            # steps past a sample's length hold the state and emit zeros
            from ..functional.common import sequence_mask
            inputs_eff = _flip_valid(inputs, sequence_length, seq_axis) \
                if self.is_reverse else inputs
            mask = sequence_mask(sequence_length, maxlen=T, dtype="bool")
            outs, states = [], initial_states
            prev = initial_states   # zero-length rows keep their initial
            for t in range(T):      # state, not one padded step's
                x_t = inputs_eff[t] if self.time_major else inputs_eff[:, t]
                o, states = self.cell(x_t, states)
                valid = mask[:, t]                           # (B,) bool
                o = _mask_rows(o, valid)
                if prev is None:
                    # no explicit initial state: the cell's default is
                    # zeros, so finished rows hold zeros at step 0 too
                    prev = _zeros_like_states(states)
                states = _select_states(valid, states, prev)
                prev = states
                outs.append(o)
            out = stack(outs, axis=seq_axis)
            if self.is_reverse:
                out = _flip_valid(out, sequence_length, seq_axis)
            return out, states
        steps = range(T - 1, -1, -1) if self.is_reverse else range(T)
        outs, states = [], initial_states
        for t in steps:
            x_t = inputs[t] if self.time_major else inputs[:, t]
            o, states = self.cell(x_t, states)
            outs.append(o)
        if self.is_reverse:
            outs = outs[::-1]
        return stack(outs, axis=seq_axis), states


def _rows(v, a):
    """The (B,) mask `v` shaped to broadcast over `a`'s rows."""
    return v.to(a.device).reshape((-1,) + (1,) * (a.dim() - 1))


def _mask_rows(o, valid):
    return apply_op(lambda a, v: torch.where(_rows(v, a), a,
                                             torch.zeros_like(a)), o, valid)


def _zeros_like_states(states):
    if isinstance(states, (tuple, list)):
        return type(states)(_zeros_like_states(s) for s in states)
    return apply_op(torch.zeros_like, states)


def _select_states(valid, new, old):
    """Hold the pre-step state for finished samples (the state at each
    sample's last valid step)."""
    if isinstance(new, (tuple, list)):
        return type(new)(_select_states(valid, n, o)
                         for n, o in zip(new, old))
    return apply_op(lambda v, a, b: torch.where(_rows(v, a), a, b), valid,
                    new, old)


def _flip_valid(x, sequence_length, seq_axis):
    """Reverse each sample's first `len` steps in place (steps beyond stay
    put): a gather with idx_t = len - 1 - t for t < len, else t."""
    def fn(a, sl):
        T = a.shape[seq_axis]
        t_idx = torch.arange(T, device=a.device)[None, :]
        sli = sl.to(a.device, torch.int64).reshape(-1, 1)      # (B, 1)
        idx = torch.where(t_idx < sli, sli - 1 - t_idx, t_idx)  # (B, T)
        if seq_axis == 1:                                       # (B, T, ...)
            return torch.take_along_dim(
                a, idx.reshape(idx.shape + (1,) * (a.dim() - 2)), dim=1)
        bt = a.transpose(0, 1)                                  # (B, T, ...)
        out = torch.take_along_dim(
            bt, idx.reshape(idx.shape + (1,) * (bt.dim() - 2)), dim=1)
        return out.transpose(0, 1)
    return apply_op(fn, x, sequence_length)


class _MultiLayerRNN(Layer):
    MODE = "RNN"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.bidirect = direction in ("bidirect", "bidirectional")
        self.dropout = dropout
        from .container import LayerList
        cells, cells_bw = [], []
        for i in range(num_layers):
            in_size = input_size if i == 0 else \
                hidden_size * (2 if self.bidirect else 1)
            cells.append(self._make_cell(in_size, hidden_size, activation))
            if self.bidirect:
                cells_bw.append(self._make_cell(in_size, hidden_size,
                                                activation))
        self.cells = LayerList(cells)
        self.cells_bw = LayerList(cells_bw) if self.bidirect else None

    def _make_cell(self, in_size, hidden, activation):
        if self.MODE == "LSTM":
            return LSTMCell(in_size, hidden)
        if self.MODE == "GRU":
            return GRUCell(in_size, hidden)
        return SimpleRNNCell(in_size, hidden, activation)

    def _layer_init(self, initial_states, i, d):
        """Layer i, direction d of the paddle-layout initial state
        ((L * D, B, H), or the (h, c) pair of those for LSTM)."""
        if initial_states is None:
            return None
        k = i * (2 if self.bidirect else 1) + d
        if self.MODE == "LSTM":
            h0, c0 = initial_states
            return (h0[k], c0[k])
        return initial_states[k]

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ...tensor.manipulation import concat, stack
        x = inputs
        final_h, final_c = [], []
        for i in range(self.num_layers):
            runner = RNN(self.cells[i], time_major=self.time_major)
            out_f, st_f = runner(x, self._layer_init(initial_states, i, 0),
                                 sequence_length=sequence_length)
            if self.bidirect:
                runner_b = RNN(self.cells_bw[i], is_reverse=True,
                               time_major=self.time_major)
                out_b, st_b = runner_b(
                    x, self._layer_init(initial_states, i, 1),
                    sequence_length=sequence_length)
                x = concat([out_f, out_b], axis=-1)
                sts = [st_f, st_b]
            else:
                x = out_f
                sts = [st_f]
            for st in sts:
                if self.MODE == "LSTM":
                    final_h.append(st[0])
                    final_c.append(st[1])
                else:
                    final_h.append(st)
        h = stack(final_h, axis=0)
        if self.MODE == "LSTM":
            return x, (h, stack(final_c, axis=0))
        return x, h


class SimpleRNN(_MultiLayerRNN):
    MODE = "RNN"


class LSTM(_MultiLayerRNN):
    MODE = "LSTM"


class GRU(_MultiLayerRNN):
    MODE = "GRU"


class BiRNN(Layer):
    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)

    def forward(self, inputs, initial_states=None, sequence_length=None):
        from ...tensor.manipulation import concat
        init_f = init_b = None
        if initial_states is not None:
            init_f, init_b = initial_states   # (states_fw, states_bw)
        out_f, st_f = self.rnn_fw(inputs, init_f,
                                  sequence_length=sequence_length)
        out_b, st_b = self.rnn_bw(inputs, init_b,
                                  sequence_length=sequence_length)
        return concat([out_f, out_b], axis=-1), (st_f, st_b)
