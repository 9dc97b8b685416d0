"""Stacked and bidirectional RNNs (port of ``apex_tpu/rnn/models.py``).

``LSTM(input_size, hidden_size, num_layers)`` (and ``GRU``, ``ReLU``,
``Tanh``, ``mLSTM``) returns a model with ``.params`` (a list with one
dict of cell weights a layer, or ``{"fwd", "rev"}`` pairs when
bidirectional) and ``__call__(x, params=None, h0=None, generator=None)
-> (outputs, final_states)``. ``x`` is [seq, batch, in] ([batch, seq,
in] with ``batch_first``). Each layer steps its cell over time in a
Python loop; the reverse direction walks time back to front and writes
each output at its own position, so no reversed copy of the input is
made, and the two directions' outputs join on the feature dim. With
``output_size`` the cell's h is projected by ``w_ho`` and the projected h
is what the carry holds. Dropout applies between layers only, drawn from
the ``generator`` the caller passes.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch import _device
from apex_tpu_torch.rnn.cells import CELLS, init_cell_params


class _RNNModel:
    """``models.py:23``; the params are drawn from a generator seeded
    with ``seed``, on ``device`` (the GPU unless asked for the CPU)."""

    def __init__(self, mode: str, input_size: int, hidden_size: int,
                 num_layers: int = 1, bias: bool = True,
                 dropout: float = 0.0, bidirectional: bool = False,
                 batch_first: bool = False,
                 output_size: Optional[int] = None, seed: int = 0,
                 dtype=torch.float32, device: _device.DeviceLike = None):
        self.mode = mode
        (self.cell, self.gate_multiplier, self.n_states,
         self.extra_m) = CELLS[mode]
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        self.bidirectional = bidirectional
        self.batch_first = batch_first
        self.n_directions = 2 if bidirectional else 1
        self.output_size = (output_size if output_size is not None
                            else hidden_size)
        device = _device.resolve(device)
        gen = torch.Generator().manual_seed(seed)
        self.params = []
        for layer in range(num_layers):
            in_sz = (input_size if layer == 0
                     else self.output_size * self.n_directions)
            dirs = [init_cell_params(
                gen, in_sz, hidden_size, self.gate_multiplier, bias=bias,
                extra_m=self.extra_m, output_size=self.output_size,
                dtype=dtype, device=device)
                for _ in range(self.n_directions)]
            self.params.append(dirs[0] if not bidirectional
                               else {"fwd": dirs[0], "rev": dirs[1]})

    def init_hidden(self, batch: int, dtype=torch.float32,
                    device: _device.DeviceLike = None) -> list:
        """Zero states a layer: h of ``output_size``, the other states
        (the LSTMs' c) of ``hidden_size``; a bidirectional layer carries
        a (forward, reverse) pair. On the params' device by default."""
        if device is None:
            first = self.params[0]
            device = (first["fwd"] if self.bidirectional
                      else first)["w_ih"].device
        sizes = [self.output_size] + [self.hidden_size] * (self.n_states - 1)

        def one():
            return tuple(torch.zeros((batch, s), dtype=dtype, device=device)
                         for s in sizes)

        return [(one(), one()) if self.bidirectional else one()
                for _ in range(self.num_layers)]

    def _run_dir(self, lp, state, xs, reverse: bool):
        """One direction of one layer over ``xs`` [seq, batch, in]: the
        final carry and the outputs [seq, batch, out] in time order."""
        seq = xs.shape[0]
        ys = [None] * seq
        carry = tuple(state)
        for t in (range(seq - 1, -1, -1) if reverse else range(seq)):
            carry, y = self.cell(lp, carry, xs[t])
            if "w_ho" in lp:
                y = torch.matmul(y, lp["w_ho"].t())
                carry = (y,) + tuple(carry[1:])
            ys[t] = y
        return carry, torch.stack(ys)

    def __call__(self, x, params=None, h0=None,
                 generator: Optional[torch.Generator] = None):
        """x [seq, batch, in] ([batch, seq, in] when ``batch_first``) ->
        (outputs [seq, batch, out * directions] (batch first likewise),
        the final states a layer)."""
        if self.batch_first:
            x = x.transpose(0, 1)
        p = params if params is not None else self.params
        states = (h0 if h0 is not None
                  else self.init_hidden(x.shape[1], x.dtype, x.device))
        outs = x
        finals = []
        for layer in range(self.num_layers):
            lp = p[layer]
            if self.bidirectional:
                s_f, s_r = states[layer]
                final_f, out_f = self._run_dir(lp["fwd"], s_f, outs, False)
                final_r, out_r = self._run_dir(lp["rev"], s_r, outs, True)
                outs = torch.cat([out_f, out_r], dim=-1)
                finals.append((final_f, final_r))
            else:
                final, outs = self._run_dir(lp, states[layer], outs, False)
                finals.append(final)
            if self.dropout > 0.0 and layer < self.num_layers - 1:
                if generator is None:
                    raise ValueError(
                        "dropout > 0 requires a generator (or construct "
                        "with dropout=0.0 for eval)")
                gen = _device.generator_on(generator, outs.device)
                keep = torch.rand(outs.shape, generator=gen,
                                  device=outs.device) < 1.0 - self.dropout
                outs = torch.where(keep, outs / (1.0 - self.dropout),
                                   torch.zeros_like(outs))
        if self.batch_first:
            outs = outs.transpose(0, 1)
        return outs, finals


def LSTM(input_size, hidden_size, num_layers=1, bias=True, batch_first=False,
         dropout=0.0, bidirectional=False, **kw):
    """``models.py:117``."""
    return _RNNModel("LSTM", input_size, hidden_size, num_layers, bias,
                     dropout, bidirectional, batch_first, **kw)


def GRU(input_size, hidden_size, num_layers=1, bias=True, batch_first=False,
        dropout=0.0, bidirectional=False, **kw):
    return _RNNModel("GRU", input_size, hidden_size, num_layers, bias,
                     dropout, bidirectional, batch_first, **kw)


def ReLU(input_size, hidden_size, num_layers=1, bias=True, batch_first=False,
         dropout=0.0, bidirectional=False, **kw):
    return _RNNModel("ReLU", input_size, hidden_size, num_layers, bias,
                     dropout, bidirectional, batch_first, **kw)


def Tanh(input_size, hidden_size, num_layers=1, bias=True, batch_first=False,
         dropout=0.0, bidirectional=False, **kw):
    return _RNNModel("Tanh", input_size, hidden_size, num_layers, bias,
                     dropout, bidirectional, batch_first, **kw)


def mLSTM(input_size, hidden_size, num_layers=1, bias=True, batch_first=False,
          dropout=0.0, bidirectional=False, **kw):
    """``models.py:142``: the multiplicative LSTM."""
    return _RNNModel("mLSTM", input_size, hidden_size, num_layers, bias,
                     dropout, bidirectional, batch_first, **kw)


def params_from_numpy(params, device: _device.DeviceLike = None) -> list:
    """The JAX model's ``params`` (a list of layer dicts, or of
    ``{"fwd", "rev"}`` pairs, with numpy leaves: ``jax.tree_util.
    tree_map(np.asarray, model.params)``) as the port's, on ``device``."""
    device = _device.resolve(device)
    return [_device.from_numpy(lp, device) for lp in params]
