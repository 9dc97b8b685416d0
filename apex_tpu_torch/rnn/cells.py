"""RNN cells (port of ``apex_tpu/rnn/cells.py``).

Each cell is a function ``cell(p, carry, x) -> (new_carry, output)`` of
``torch.matmul`` and pointwise ops, stepped by a Python loop in time
(:mod:`apex_tpu_torch.rnn.models`). Weights follow torch's layout:
``w_ih`` [gates * h, in], ``w_hh`` [gates * h, out], gate order (i, f,
g, o) for the LSTMs and (r, z, n) for the GRU; the mLSTM's
multiplicative weights ``w_mih`` [out, in] and ``w_mhh`` [out, out];
``w_ho`` [out, h] projects h to ``output_size`` when that differs from
the hidden size.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import _device


def init_cell_params(generator: torch.Generator, input_size: int,
                     hidden_size: int, gate_multiplier: int,
                     bias: bool = True, extra_m: bool = False,
                     output_size=None, dtype=torch.float32,
                     device: _device.DeviceLike = None) -> dict:
    """One cell's params drawn from U(-1/sqrt(h), 1/sqrt(h))
    (``cells.py:19``), in the order ``w_ih``, ``w_hh``, ``b_ih``,
    ``b_hh``, ``w_mih``, ``w_mhh``, ``w_ho``, on ``device`` (the GPU
    unless asked for the CPU)."""
    device = _device.resolve(device)
    gen = _device.generator_on(generator, device)
    out = output_size if output_size is not None else hidden_size
    bound = 1.0 / hidden_size ** 0.5
    g = gate_multiplier

    def u(*shape):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        return t.uniform_(-bound, bound, generator=gen).to(dtype)

    p = {"w_ih": u(g * hidden_size, input_size),
         "w_hh": u(g * hidden_size, out)}
    if bias:
        p["b_ih"] = u(g * hidden_size)
        p["b_hh"] = u(g * hidden_size)
    if extra_m:
        p["w_mih"] = u(out, input_size)
        p["w_mhh"] = u(out, out)
    if out != hidden_size:
        p["w_ho"] = u(out, hidden_size)
    return p


def _linear(x, w):
    return torch.matmul(x, w.t())


def _gates(p, x, h):
    y = _linear(x, p["w_ih"]) + _linear(h, p["w_hh"])
    if "b_ih" in p:
        y = y + p["b_ih"] + p["b_hh"]
    return y


def lstm_cell(p, carry, x):
    """LSTM (``cells.py:53``): carry (h, c)."""
    h, c = carry
    i, f, g, o = torch.chunk(_gates(p, x, h), 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return (h_new, c_new), h_new


def mlstm_cell(p, carry, x):
    """Multiplicative LSTM (``cells.py:62``): the gates' hidden input is
    m = (W_mih x) * (W_mhh h)."""
    h, c = carry
    m = _linear(x, p["w_mih"]) * _linear(h, p["w_mhh"])
    i, f, g, o = torch.chunk(_gates(p, x, m), 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return (h_new, c_new), h_new


def gru_cell(p, carry, x):
    """GRU with torch's gate layout (r, z, n) (``cells.py:73``)."""
    (h,) = carry
    gi = _linear(x, p["w_ih"])
    gh = _linear(h, p["w_hh"])
    if "b_ih" in p:
        gi = gi + p["b_ih"]
    if "b_hh" in p:
        gh = gh + p["b_hh"]
    ir, iz, in_ = torch.chunk(gi, 3, dim=-1)
    hr, hz, hn = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(ir + hr)
    z = torch.sigmoid(iz + hz)
    n = torch.tanh(in_ + r * hn)
    h_new = (1.0 - z) * n + z * h
    return (h_new,), h_new


def relu_cell(p, carry, x):
    """Elman RNN with ReLU (``cells.py:87``)."""
    (h,) = carry
    h_new = torch.relu(_gates(p, x, h))
    return (h_new,), h_new


def tanh_cell(p, carry, x):
    """Elman RNN with tanh (``cells.py:94``)."""
    (h,) = carry
    h_new = torch.tanh(_gates(p, x, h))
    return (h_new,), h_new


#: mode -> (cell, gate multiplier, states carried, mLSTM's extra weights)
CELLS = {
    "LSTM": (lstm_cell, 4, 2, False),
    "mLSTM": (mlstm_cell, 4, 2, True),
    "GRU": (gru_cell, 3, 1, False),
    "ReLU": (relu_cell, 1, 1, False),
    "Tanh": (tanh_cell, 1, 1, False),
}
