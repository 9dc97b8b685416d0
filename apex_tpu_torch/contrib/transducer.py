"""RNN-T transducer joint and loss (port of
``apex_tpu/contrib/transducer.py``; ref apex/contrib/transducer/
transducer.py ``TransducerJoint``, ``TransducerLoss``).

- The joint is the broadcast sum ``f[:, :, None] + g[:, None]`` with an
  optional ReLU and dropout; ``pack_output`` gathers each sequence's
  valid ``f_len x g_len`` block into the reference's packed layout (rows
  at ``batch_offset[b - 1]``, ``batch_offset`` the INCLUSIVE
  ``cumsum(f_len * g_len)``).
- The loss is the negative log-likelihood of the targets over the
  alignment lattice, ``alpha[t, u] = logaddexp(alpha[t-1, u] +
  blank[t-1, u], alpha[t, u-1] + emit[t, u-1])`` in fp32. The reference
  computes it as a ``lax.scan`` over T of log-semiring associative scans
  over U; here the lattice goes by anti-diagonals ``d = t + u``: every
  cell of a diagonal depends only on the one before, so T + U steps, each
  vectorised over the batch and the diagonal, compute it. Gradients come
  from autograd through the steps (as the reference's from AD through
  its scans); cells off the lattice hold the reference's -1e30 sentinel
  and are re-masked after each step, so nothing accumulates towards inf
  or NaN.

Dropout draws from a ``torch.Generator``: its bits are not JAX's, and
it is held by its properties (the kept share, the 1/(1-p) scale, zeros
where dropped).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_NEG_INF = -1e30

__all__ = ["TransducerJoint", "TransducerLoss", "transducer_joint",
           "transducer_loss"]


# ------------------------------------------------------------------- joint


def _packed_row_coords(rows, batch_offset, block_len, g_len):
    """``(b, t, u)`` of each packed row (``transducer.py:76``)."""
    starts = batch_offset - block_len  # inclusive cumsum -> start
    b = torch.clamp(torch.searchsorted(batch_offset, rows, right=True), 0,
                    batch_offset.shape[0] - 1)
    local = torch.minimum(torch.clamp(rows - starts[b], min=0),
                          torch.clamp(block_len[b] - 1, min=0))
    g = torch.clamp(g_len[b], min=1)
    return b, local // g, local % g


def transducer_joint(f, g, f_len=None, g_len=None, pack_output: bool = False,
                     relu: bool = False, dropout: float = 0.0,
                     generator: Optional[torch.Generator] = None,
                     batch_offset=None, packed_batch: int = 0):
    """``h[b, t, u] = f[b, t] + g[b, u]`` (ref ``TransducerJoint.forward``,
    ``transducer.py:39-73``): ``[B, T, U, H]``, or with ``pack_output``
    the packed ``[packed_batch, H]`` (``batch_offset`` and the lengths
    required). ``dropout`` draws its keep mask from ``generator``, on
    the joint's device."""
    h = f[:, :, None, :] + g[:, None, :, :]
    if relu:
        h = F.relu(h)
    if dropout > 0.0:
        if generator is None:
            raise ValueError("dropout > 0 requires a torch.Generator")
        keep = torch.rand(h.shape, generator=generator, device=h.device,
                          dtype=torch.float32) < 1.0 - dropout
        h = torch.where(keep, h / (1.0 - dropout),
                        torch.zeros((), dtype=h.dtype, device=h.device))
    if not pack_output:
        return h
    if batch_offset is None or not packed_batch:
        raise ValueError(
            "pack_output=True requires batch_offset and packed_batch")
    if f_len is None or g_len is None:
        raise ValueError("pack_output=True requires f_len and g_len")
    rows = torch.arange(packed_batch, device=h.device)
    b, t, u = _packed_row_coords(rows, batch_offset, f_len * g_len, g_len)
    return h[b, t, u]


class TransducerJoint:
    """ref ``transducer.py:87`` TransducerJoint."""

    def __init__(self, pack_output=False, relu=False, dropout=False,
                 dropout_prob=0.0, probe=None):
        del probe
        self.pack_output = pack_output
        self.relu = relu
        self.dropout_prob = dropout_prob if dropout else 0.0

    def __call__(self, f, g, f_len=None, g_len=None, batch_offset=None,
                 packed_batch=0, generator=None):
        return transducer_joint(f, g, f_len, g_len, self.pack_output,
                                self.relu, self.dropout_prob, generator,
                                batch_offset=batch_offset,
                                packed_batch=packed_batch)


# -------------------------------------------------------------------- loss


def _unpack(logits, f_len, y_len, batch_offset, T: int, U1: int):
    """The packed rows ``[N, V]`` on the padded lattice ``[B, T, U+1,
    V]``; cells off a sequence's block are 0 (ref ``:167-179``)."""
    g_len = y_len + 1
    dev = logits.device
    t_idx = torch.arange(T, device=dev)[None, :, None]
    u_idx = torch.arange(U1, device=dev)[None, None, :]
    starts = (batch_offset - f_len * g_len)[:, None, None]
    rows = starts + t_idx * g_len[:, None, None] + u_idx
    valid = (t_idx < f_len[:, None, None]) & (u_idx < g_len[:, None, None])
    rows = torch.where(valid, rows, torch.zeros_like(rows))
    return torch.where(valid[..., None], logits[rows],
                       torch.zeros((), dtype=logits.dtype, device=dev))


def _skew(x, D: int):
    """``out[b, d, t] = x[b, t, d - t]`` (-1e30 where ``d - t`` is off
    ``[0, U+1)``) and that validity ``[D, T]``: a ``[B, T, U+1]`` lattice
    by anti-diagonals."""
    B, T, U1 = x.shape
    dev = x.device
    t = torch.arange(T, device=dev)[None, :]
    u = torch.arange(D, device=dev)[:, None] - t  # [D, T]
    valid = (u >= 0) & (u < U1)
    out = x.reshape(B, T * U1)[:, t * U1 + torch.clamp(u, 0, U1 - 1)]
    return torch.where(valid[None], out, torch.full(
        (), _NEG_INF, dtype=out.dtype, device=dev)), valid


def _alphas(blank, emit):
    """Every anti-diagonal of the forward variables, ``[B, D, T]``
    (``alpha[b, d, t] = alpha[t, d - t]``), D = T + U."""
    B, T, U1 = blank.shape
    D = T + U1 - 1
    blank_d, valid = _skew(blank, D)  # blank[t, d - t] by diagonal
    emit_d, _ = _skew(emit, D)
    neg = torch.full((B, 1), _NEG_INF, dtype=blank.dtype,
                     device=blank.device)
    first = torch.full((B, T), _NEG_INF, dtype=blank.dtype,
                       device=blank.device)
    first[:, 0] = 0.0
    alphas = [first]
    for d in range(1, D):
        prev = alphas[-1]
        # from (t-1, u): the diagonal before, shifted one frame, plus the
        # blank of cell (t-1, u), diagonal d - 1 at t - 1
        down = torch.cat([neg, (prev + blank_d[:, d - 1])[:, :-1]], dim=1)
        # from (t, u-1): the diagonal before at t, plus emit[t, u-1]
        right = prev + emit_d[:, d - 1]
        alpha = torch.logaddexp(down, right)
        alphas.append(torch.where(valid[d][None], alpha, neg))
    return torch.stack(alphas, dim=1)


def transducer_loss(logits, targets, f_len, y_len, blank_idx: int = 0,
                    packed_input: bool = False, batch_offset=None,
                    max_f_len: Optional[int] = None):
    """The negative log-likelihood of each sequence, fp32 ``[B]`` (ref
    ``TransducerLoss``, ``transducer.py:131-201``).

    ``logits`` ``[B, T, U+1, V]`` joint outputs, ``targets`` ``[B, U]``
    label ids, ``f_len`` the valid frames, ``y_len`` the valid labels.
    ``packed_input``: ``logits`` are the packed rows ``[N, V]`` (sequence
    b's ``f_len[b] x (y_len[b] + 1)`` block at ``batch_offset[b - 1]``,
    ``batch_offset`` the inclusive ``cumsum(f_len * (y_len + 1))``) and
    ``max_f_len`` the padded T; gradients flow back to the packed
    rows."""
    if packed_input:
        if batch_offset is None or max_f_len is None:
            raise ValueError(
                "packed_input=True requires batch_offset and max_f_len")
        logits = _unpack(logits, f_len, y_len, batch_offset,
                         int(max_f_len), targets.shape[1] + 1)
    B, T, U1, _ = logits.shape
    lp = torch.log_softmax(logits.float(), dim=-1)
    blank = lp[..., blank_idx]
    emit = torch.gather(lp[:, :, :-1, :], 3,
                        targets[:, None, :, None].expand(B, T, U1 - 1, 1)
                        .long())[..., 0]
    # no label past y_len is ever emitted
    u_pos = torch.arange(U1 - 1, device=lp.device)[None, None, :]
    emit = torch.where(u_pos < y_len[:, None, None], emit,
                       torch.full((), _NEG_INF, device=lp.device))
    emit = torch.cat([emit, torch.full((B, T, 1), _NEG_INF,
                                       device=lp.device)], dim=2)
    alphas = _alphas(blank, emit)
    # ll = alpha[f_len - 1, y_len] + blank[f_len - 1, y_len]
    t_last = torch.clamp(f_len.long() - 1, 0, T - 1)
    y = y_len.long()
    rows = torch.arange(B, device=lp.device)
    ll = alphas[rows, t_last + y, t_last] + blank[rows, t_last, y]
    return -ll


class TransducerLoss:
    """ref ``transducer.py:204`` TransducerLoss (``Function.apply``
    shape)."""

    def __init__(self, fuse_softmax_backward=True, opt=1,
                 packed_input=False):
        del fuse_softmax_backward, opt
        self.packed_input = packed_input

    def __call__(self, x, label, f_len, y_len, blank_idx=0,
                 batch_offset=None, max_f_len=None, debug_list=None):
        del debug_list
        return transducer_loss(x, label, f_len, y_len, blank_idx,
                               self.packed_input,
                               batch_offset=batch_offset,
                               max_f_len=max_f_len)
