"""Recurrent layers — counterpart of ``paddle_tpu.nn.layer.rnn``: the cells
(``SimpleRNNCell``, ``LSTMCell``, ``GRUCell``), the wrappers ``RNN`` and
``BiRNN``, and the multi-layer ``SimpleRNN``, ``LSTM`` and ``GRU``.

The reference runs its time loop as a ``lax.scan``; the port runs it as a
plain per-step loop in PyTorch (a cuDNN RNN is a later performance item),
with the reference's step formulas:

- LSTM gates in the order i, f, g, o: ``c' = σ(f)·c + σ(i)·tanh(g)``,
  ``h' = σ(o)·tanh(c')``;
- GRU gates r, z, n: ``n = tanh(x_n + σ(r)·h_n)``, ``h' = (1 − z)·n + z·h``;
- the simple RNN ``act(x W_ihᵀ + b_ih + h W_hhᵀ + b_hh)`` (tanh or relu).

The input projection of every step is one product over the whole
sequence, taken before the loop; each step adds the recurrent product in
the reference's order (``x W_ihᵀ + b_ih``, then ``+ h W_hhᵀ``, then
``+ b_hh``). Parameters carry the reference's names
(``weight_ih_l{k}[_reverse]``, ``weight_hh_…``, ``bias_ih_…``,
``bias_hh_…``; the cells' ``weight_ih`` …) and its ``Uniform(±1/√h)``
init, drawn from the initializers' generator (``nn.initializer.seed``),
on the card unless ``device=`` says otherwise. The dropout between layers
draws one [batch, hidden·directions] mask per layer, kept over time, from
``generator`` (a ``torch.Generator`` on the input's device; else the
layer's own); the reference draws from its key, so the masks differ.

Not copied: the reference takes ``sequence_length`` and ignores it; the
port raises ``NotImplementedError`` for one that is not None.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...core.place import resolve_device
from .. import initializer as I
from ..layer_base import create_parameter
from .common import _RandomLayer

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]


def _no_lengths(sequence_length, who: str) -> None:
    if sequence_length is not None:
        raise NotImplementedError(
            f"{who}: sequence_length is not supported (the reference takes "
            "it and ignores it; the port refuses it instead)")


def _lstm_step(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _gru_step(gi, gh, h):
    ir, iz, in_ = gi.chunk(3, dim=-1)
    hr, hz, hn = gh.chunk(3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(in_ + r * hn)
    return (1.0 - z) * n + z * h


def _act(name: str):
    return torch.tanh if name == "tanh" else torch.relu


class RNNCellBase(nn.Module):
    """A cell: ``forward(inputs, states=None) -> (outputs, new_states)``,
    zero states when none are given."""

    def _make_weights(self, gates, input_size, hidden_size, attrs, device,
                      dtype, suffix=""):
        std = 1.0 / math.sqrt(hidden_size)
        kw = dict(dtype=dtype, device=device,
                  default_initializer=I.Uniform(-std, std))
        wih, whh, bih, bhh = attrs
        for name, shape, attr, bias in (
                ("weight_ih", [gates * hidden_size, input_size], wih, False),
                ("weight_hh", [gates * hidden_size, hidden_size], whh, False),
                ("bias_ih", [gates * hidden_size], bih, True),
                ("bias_hh", [gates * hidden_size], bhh, True)):
            self.register_parameter(name + suffix, create_parameter(
                shape, attr, is_bias=bias, **kw))

    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0, batch_dim_idx=0):
        batch = batch_ref.shape[batch_dim_idx]
        shape = shape or self.state_shape
        dtype = dtype if dtype is not None else torch.float32
        make = lambda s: torch.full(  # noqa: E731
            [batch, *s], init_value, dtype=dtype, device=batch_ref.device)
        if isinstance(shape[0], (list, tuple)):
            return tuple(make(s) for s in shape)
        return make(shape)


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        self._make_weights(1, input_size, hidden_size,
                           (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                            bias_hh_attr), resolve_device(device), dtype)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = _act(self.activation)(
            inputs @ self.weight_ih.t() + self.bias_ih
            + states @ self.weight_hh.t() + self.bias_hh)
        return h, h


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self._make_weights(4, input_size, hidden_size,
                           (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                            bias_hh_attr), resolve_device(device), dtype)

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs, self.state_shape)
        h, c = states
        gates = (inputs @ self.weight_ih.t() + self.bias_ih
                 + h @ self.weight_hh.t() + self.bias_hh)
        h, c = _lstm_step(gates, c)
        return h, (h, c)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype=None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self._make_weights(3, input_size, hidden_size,
                           (weight_ih_attr, weight_hh_attr, bias_ih_attr,
                            bias_hh_attr), resolve_device(device), dtype)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        h = _gru_step(inputs @ self.weight_ih.t() + self.bias_ih,
                      states @ self.weight_hh.t() + self.bias_hh, states)
        return h, h


class RNN(nn.Module):
    """``cell`` run over the time axis (axis 1, or 0 if ``time_major``),
    backwards if ``is_reverse``: ``(outputs, final_states)``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _no_lengths(sequence_length, "RNN")
        x = inputs if self.time_major else inputs.transpose(0, 1)
        steps = range(x.shape[0] - 1, -1, -1) if self.is_reverse \
            else range(x.shape[0])
        states, outs = initial_states, []
        for t in steps:
            out, states = self.cell(x[t], states)
            outs.append(out)
        if self.is_reverse:
            outs = outs[::-1]
        y = torch.stack(outs, 0)
        return (y if self.time_major else y.transpose(0, 1)), states


class BiRNN(nn.Module):
    """A forward and a backward ``RNN``; outputs concatenated on the last
    axis, states ``(forward, backward)``."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, False, time_major)
        self.rnn_bw = RNN(cell_bw, True, time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _no_lengths(sequence_length, "BiRNN")
        s_fw, s_bw = (initial_states if initial_states is not None
                      else (None, None))
        y_fw, st_fw = self.rnn_fw(inputs, s_fw)
        y_bw, st_bw = self.rnn_bw(inputs, s_bw)
        return torch.cat([y_fw, y_bw], -1), (st_fw, st_bw)


class _RNNBase(_RandomLayer):
    """Multi-layer, one- or two-direction recurrent network:
    ``forward(inputs, initial_states=None) -> (outputs, final_states)``
    with states [num_layers·directions, batch, hidden] (LSTM: ``(h,
    c)``)."""

    _mode = "RNN_TANH"
    _gates = {"LSTM": 4, "GRU": 3}

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, *,
                 device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(generator)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.direction = direction
        self.time_major = time_major
        self.dropout = dropout
        self.activation = activation
        self.num_directions = 2 if direction in ("bidirect",
                                                 "bidirectional") else 1
        g = self._gates.get(self._mode, 1)
        dev = resolve_device(device)
        attrs = (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr)
        for layer in range(num_layers):
            for d in range(self.num_directions):
                in_size = (input_size if layer == 0
                           else hidden_size * self.num_directions)
                RNNCellBase._make_weights(
                    self, g, in_size, hidden_size, attrs, dev, dtype,
                    f"_l{layer}{'_reverse' if d else ''}")

    def _run(self, x, h, c, wi, wh, bi, bh, reverse):
        """One direction of one layer over time-major ``x``: (outputs
        [T, B, H], final h, final c)."""
        xi = x @ wi.t() + bi  # every step's input projection at once
        act = _act(self.activation)
        steps = range(x.shape[0] - 1, -1, -1) if reverse \
            else range(x.shape[0])
        ys = [None] * x.shape[0]
        for t in steps:
            if self._mode == "LSTM":
                h, c = _lstm_step(xi[t] + h @ wh.t() + bh, c)
            elif self._mode == "GRU":
                h = _gru_step(xi[t], h @ wh.t() + bh, h)
            else:
                h = act(xi[t] + h @ wh.t() + bh)
            ys[t] = h
        return torch.stack(ys, 0), h, c

    def forward(self, inputs, initial_states=None, sequence_length=None):
        _no_lengths(sequence_length, type(self).__name__)
        lstm = self._mode == "LSTM"
        nl, nd, hs = self.num_layers, self.num_directions, self.hidden_size
        x = inputs if self.time_major else inputs.transpose(0, 1)
        batch = x.shape[1]
        p = self.dropout if self.training else 0.0
        if initial_states is None:
            zero = x.new_zeros(nl * nd, batch, hs)
            h0, c0 = zero, zero
        elif lstm:
            h0, c0 = initial_states
        else:
            h0, c0 = initial_states, None
        hs_out, cs_out = [], []
        for layer in range(nl):
            outs = []
            for d in range(nd):
                sfx = f"_l{layer}{'_reverse' if d else ''}"
                k = layer * nd + d
                y, h, c = self._run(
                    x, h0[k], c0[k] if lstm else None,
                    getattr(self, "weight_ih" + sfx),
                    getattr(self, "weight_hh" + sfx),
                    getattr(self, "bias_ih" + sfx),
                    getattr(self, "bias_hh" + sfx), d == 1)
                outs.append(y)
                hs_out.append(h)
                cs_out.append(c)
            x = torch.cat(outs, -1) if nd == 2 else outs[0]
            if p > 0.0 and layer < nl - 1:
                keep = torch.empty(batch, hs * nd, device=x.device).bernoulli_(
                    1.0 - p, generator=self._gen(x))
                x = x * (keep / (1.0 - p)).to(x.dtype)[None]
        y = x if self.time_major else x.transpose(0, 1)
        h = torch.stack(hs_out, 0)
        return (y, (h, torch.stack(cs_out, 0))) if lstm else (y, h)


class SimpleRNN(_RNNBase):
    _mode = "RNN_TANH"


class LSTM(_RNNBase):
    _mode = "LSTM"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, **kw):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, "tanh", weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, **kw)


class GRU(_RNNBase):
    _mode = "GRU"

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, **kw):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, "tanh", weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, **kw)
