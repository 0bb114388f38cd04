"""RNN layers (`paddle_tpu/nn/layer/rnn.py`; reference
`python/paddle/nn/layer/rnn.py`).

The JAX package runs the recurrence as one `lax.scan`; here it is a Python
loop over time steps of plain torch ops, in the same order, recorded by
torch's autograd. Weights keep the JAX package's (and Paddle's) names,
layouts ([gates * hidden, in]) and gate order: LSTM i, f, g, o; GRU r, z,
n with the reset gate applied to the hidden projection after its bias.
"""

import math

import torch

from paddle_tpu_torch.core.tensor import Tensor, apply
from paddle_tpu_torch.nn.layer.layers import Layer
from paddle_tpu_torch.nn import initializer as I


class _RNNBase(Layer):
    MODE = "RNN_TANH"
    GATES = 1

    def __init__(self, input_size, hidden_size, num_layers=1, direction="forward",
                 time_major=False, dropout=0.0, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, activation="tanh", name=None):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        self.bidirect = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if self.bidirect else 1
        self.activation = activation

        std = 1.0 / math.sqrt(hidden_size)
        gate = self.GATES
        for layer in range(num_layers):
            for direction in range(self.num_directions):
                suffix = "_reverse" if direction == 1 else ""
                in_size = input_size if layer == 0 else hidden_size * self.num_directions
                setattr(self, f"weight_ih_l{layer}{suffix}", self.create_parameter(
                    [gate * hidden_size, in_size], attr=weight_ih_attr,
                    default_initializer=I.Uniform(-std, std)))
                setattr(self, f"weight_hh_l{layer}{suffix}", self.create_parameter(
                    [gate * hidden_size, hidden_size], attr=weight_hh_attr,
                    default_initializer=I.Uniform(-std, std)))
                setattr(self, f"bias_ih_l{layer}{suffix}", self.create_parameter(
                    [gate * hidden_size], attr=bias_ih_attr, is_bias=True,
                    default_initializer=I.Uniform(-std, std)))
                setattr(self, f"bias_hh_l{layer}{suffix}", self.create_parameter(
                    [gate * hidden_size], attr=bias_hh_attr, is_bias=True,
                    default_initializer=I.Uniform(-std, std)))

    def _cell(self, mode):
        act = torch.tanh if self.activation == "tanh" else torch.relu

        if mode == "LSTM":
            def cell(carry, x_t, w_ih, w_hh, b_ih, b_hh):
                h, c = carry
                gates = x_t @ w_ih.T + b_ih + h @ w_hh.T + b_hh
                i, f, g, o = gates.chunk(4, dim=-1)
                i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
                g = torch.tanh(g)
                c = f * c + i * g
                h = o * torch.tanh(c)
                return (h, c), h
        elif mode == "GRU":
            def cell(carry, x_t, w_ih, w_hh, b_ih, b_hh):
                h = carry[0]
                gi = x_t @ w_ih.T + b_ih
                gh = h @ w_hh.T + b_hh
                ir, iz, ig = gi.chunk(3, dim=-1)
                hr, hz, hg = gh.chunk(3, dim=-1)
                r = torch.sigmoid(ir + hr)
                z = torch.sigmoid(iz + hz)
                n = torch.tanh(ig + r * hg)
                h = (1 - z) * n + z * h
                return (h,), h
        else:
            def cell(carry, x_t, w_ih, w_hh, b_ih, b_hh):
                h = carry[0]
                h = act(x_t @ w_ih.T + b_ih + h @ w_hh.T + b_hh)
                return (h,), h

        return cell

    def forward(self, inputs, initial_states=None, sequence_length=None):
        mode = self.MODE
        is_lstm = mode == "LSTM"
        n_state = 2 if is_lstm else 1
        cell = self._cell(mode)

        params = []
        for layer in range(self.num_layers):
            for direction in range(self.num_directions):
                suffix = "_reverse" if direction == 1 else ""
                params += [getattr(self, f"weight_ih_l{layer}{suffix}"),
                           getattr(self, f"weight_hh_l{layer}{suffix}"),
                           getattr(self, f"bias_ih_l{layer}{suffix}"),
                           getattr(self, f"bias_hh_l{layer}{suffix}")]

        time_major = self.time_major
        num_layers, num_directions = self.num_layers, self.num_directions
        hidden = self.hidden_size

        init_datas = []
        if initial_states is not None:
            states = initial_states if isinstance(initial_states, (list, tuple)) else [initial_states]
            init_datas = [s._data for s in states]

        def fn(x, *wparams):
            xs = x if time_major else x.transpose(0, 1)  # [T, B, I]
            b = xs.shape[1]
            if init_datas:
                h0 = init_datas[0]
                c0 = init_datas[1] if is_lstm else None
            else:
                h0 = xs.new_zeros((num_layers * num_directions, b, hidden))
                c0 = torch.zeros_like(h0) if is_lstm else None

            out = xs
            final_h, final_c = [], []
            idx = 0
            for layer in range(num_layers):
                outs_dir = []
                for direction in range(num_directions):
                    w_ih, w_hh, b_ih, b_hh = wparams[idx:idx + 4]
                    idx += 4
                    sl = layer * num_directions + direction
                    carry0 = (h0[sl], c0[sl]) if is_lstm else (h0[sl],)
                    seq = out if direction == 0 else out.flip(0)
                    carry, ys = carry0, []
                    for x_t in seq:
                        carry, y = cell(carry, x_t, w_ih, w_hh, b_ih, b_hh)
                        ys.append(y)
                    ys = torch.stack(ys)
                    if direction == 1:
                        ys = ys.flip(0)
                    outs_dir.append(ys)
                    final_h.append(carry[0])
                    if is_lstm:
                        final_c.append(carry[1])
                out = torch.cat(outs_dir, dim=-1) if num_directions == 2 else outs_dir[0]
            out_final = out if time_major else out.transpose(0, 1)
            hN = torch.stack(final_h, 0)
            if is_lstm:
                cN = torch.stack(final_c, 0)
                return out_final, hN, cN
            return out_final, hN

        results = apply(fn, inputs, *params, _name=f"rnn_{mode}")
        if is_lstm:
            out, hN, cN = results
            return out, (hN, cN)
        out, hN = results
        return out, hN


class SimpleRNN(_RNNBase):
    MODE = "RNN_TANH"
    GATES = 1


class LSTM(_RNNBase):
    MODE = "LSTM"
    GATES = 4


class GRU(_RNNBase):
    MODE = "GRU"
    GATES = 3


class SimpleRNNCell(Layer):
    def __init__(self, input_size, hidden_size, activation="tanh", weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        std = 1.0 / math.sqrt(hidden_size)
        self.hidden_size = hidden_size
        self.activation = activation
        self.weight_ih = self.create_parameter([hidden_size, input_size],
                                               default_initializer=I.Uniform(-std, std))
        self.weight_hh = self.create_parameter([hidden_size, hidden_size],
                                               default_initializer=I.Uniform(-std, std))
        self.bias_ih = self.create_parameter([hidden_size], is_bias=True,
                                             default_initializer=I.Uniform(-std, std))
        self.bias_hh = self.create_parameter([hidden_size], is_bias=True,
                                             default_initializer=I.Uniform(-std, std))

    def forward(self, inputs, states=None):
        act = torch.tanh if self.activation == "tanh" else torch.relu
        if states is None:
            import paddle_tpu_torch as paddle

            states = paddle.zeros([inputs.shape[0], self.hidden_size], dtype=inputs.dtype)

        def fn(x, h, wi, wh, bi, bh):
            out = act(x @ wi.T + bi + h @ wh.T + bh)
            return out

        out = apply(fn, inputs, states, self.weight_ih, self.weight_hh,
                    self.bias_ih, self.bias_hh, _name="rnn_cell")
        return out, out


class LSTMCell(Layer):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        std = 1.0 / math.sqrt(hidden_size)
        self.hidden_size = hidden_size
        self.weight_ih = self.create_parameter([4 * hidden_size, input_size],
                                               default_initializer=I.Uniform(-std, std))
        self.weight_hh = self.create_parameter([4 * hidden_size, hidden_size],
                                               default_initializer=I.Uniform(-std, std))
        self.bias_ih = self.create_parameter([4 * hidden_size], is_bias=True,
                                             default_initializer=I.Uniform(-std, std))
        self.bias_hh = self.create_parameter([4 * hidden_size], is_bias=True,
                                             default_initializer=I.Uniform(-std, std))

    def forward(self, inputs, states=None):
        if states is None:
            import paddle_tpu_torch as paddle

            h = paddle.zeros([inputs.shape[0], self.hidden_size], dtype=inputs.dtype)
            c = paddle.zeros([inputs.shape[0], self.hidden_size], dtype=inputs.dtype)
        else:
            h, c = states

        def fn(x, h_, c_, wi, wh, bi, bh):
            gates = x @ wi.T + bi + h_ @ wh.T + bh
            i, f, g, o = gates.chunk(4, dim=-1)
            i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
            c_new = f * c_ + i * torch.tanh(g)
            h_new = o * torch.tanh(c_new)
            return h_new, c_new

        h_new, c_new = apply(fn, inputs, h, c, self.weight_ih, self.weight_hh,
                             self.bias_ih, self.bias_hh, _name="lstm_cell")
        return h_new, (h_new, c_new)


class GRUCell(Layer):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None):
        super().__init__()
        std = 1.0 / math.sqrt(hidden_size)
        self.hidden_size = hidden_size
        self.weight_ih = self.create_parameter([3 * hidden_size, input_size],
                                               default_initializer=I.Uniform(-std, std))
        self.weight_hh = self.create_parameter([3 * hidden_size, hidden_size],
                                               default_initializer=I.Uniform(-std, std))
        self.bias_ih = self.create_parameter([3 * hidden_size], is_bias=True,
                                             default_initializer=I.Uniform(-std, std))
        self.bias_hh = self.create_parameter([3 * hidden_size], is_bias=True,
                                             default_initializer=I.Uniform(-std, std))

    def forward(self, inputs, states=None):
        if states is None:
            import paddle_tpu_torch as paddle

            states = paddle.zeros([inputs.shape[0], self.hidden_size], dtype=inputs.dtype)

        def fn(x, h, wi, wh, bi, bh):
            gi = x @ wi.T + bi
            gh = h @ wh.T + bh
            ir, iz, ig = gi.chunk(3, dim=-1)
            hr, hz, hg = gh.chunk(3, dim=-1)
            r = torch.sigmoid(ir + hr)
            z = torch.sigmoid(iz + hz)
            n = torch.tanh(ig + r * hg)
            return (1 - z) * n + z * h

        out = apply(fn, inputs, states, self.weight_ih, self.weight_hh,
                    self.bias_ih, self.bias_hh, _name="gru_cell")
        return out, out
