"""Fused MLP (port of ``apex_tpu/mlp.py``, Apex's ``apex.mlp``).

A chain of dense layers, each ``act(x @ w + b)`` with no activation on
the last (``none | relu | sigmoid``). Every product goes through the amp
hook :func:`~apex_tpu_torch.ops.precision.matmul_amp` at site ``"mlp"``
with its fp32 accumulator kept: the bias and the activation are applied
in fp32 and the storage dtype is restored after each layer
(``mlp.py:39-57``), so the bias gradient's sum stays in fp32 too.

:func:`mlp_function` saves only its inputs and recomputes the hidden
activations in the backward (``_mlp_bwd``, ``mlp.py:68-79``). Under the
O4 fp8 context (``amp.scaler.Fp8DelayedScaler.step``) it steps aside and
autograd takes the fp8 products' own backward, as the reference does
(``mlp.py:89``): a recomputed registered site would take a second
ordinal, and the saved fp8 operands are the memory the recompute was
buying.

The products are plain PyTorch (``torch.matmul``, or the fp8 product of
``ops.precision``), as the reference's are XLA dots outside any Pallas
kernel; under O4 the operands' casts run the fp8 cast kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from apex_tpu_torch import _device
from apex_tpu_torch.amp.amp import half_function
from apex_tpu_torch.ops.precision import matmul_amp

_ACTIVATIONS = ("none", "relu", "sigmoid")


def _act(y, activation: str):
    if activation == "relu":
        return torch.relu(y)
    if activation == "sigmoid":
        return torch.sigmoid(y)
    return y


def _forward(bias: bool, activation: str, x, wb):
    step = 2 if bias else 1
    n = len(wb) // step
    y = x
    for i in range(n):
        w = wb[i * step]
        out_dtype = torch.promote_types(y.dtype, w.dtype)
        y = matmul_amp(y, w, name="mlp", keep_acc=True)
        if bias:
            y = y + wb[i * step + 1]
        if i < n - 1:
            y = _act(y, activation)
        y = y.to(out_dtype)
    return y


class _MlpFunction(torch.autograd.Function):
    """The reference's ``custom_vjp`` (``mlp.py:34``): the inputs saved,
    the chain recomputed under autograd in the backward."""

    @staticmethod
    def forward(ctx, bias, activation, x, *wb):
        ctx.bias, ctx.activation = bias, activation
        ctx.save_for_backward(x, *wb)
        return _forward(bias, activation, x, wb)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            live = [t.detach().requires_grad_(t.is_floating_point())
                    for t in saved]
            y = _forward(ctx.bias, ctx.activation, live[0], live[1:])
            grads = torch.autograd.grad(y, live, g, allow_unused=True)
        return (None, None) + tuple(grads)


def mlp_function(bias: bool, activation: str, x, *weights_and_biases):
    """Functional fused MLP (``mlp.py:81``). ``weights_and_biases``:
    ``w0, b0, w1, b1, ...`` with ``bias``, else ``w0, w1, ...``; weights
    are ``(in, out)``. The activation applies to every layer but the
    last."""
    from apex_tpu_torch.amp.scaler import current_fp8

    if activation not in _ACTIVATIONS:
        raise TypeError(f"activation must be one of {_ACTIVATIONS}, got "
                        f"{activation}")
    if current_fp8() is not None:
        return _forward(bias, activation, x, weights_and_biases)
    return _MlpFunction.apply(bias, activation, x, *weights_and_biases)


# O1 boundary cast: the chain is matmul work, in the compute dtype
mlp_function = half_function(mlp_function)


class MLP:
    """Apex-shaped MLP container (``mlp.py:117``). ``mlp_sizes`` e.g.
    ``[1024, 1024, 1024]`` builds two layers. Parameters live in
    ``.params`` (``[{"w", "b"}, ...]``, usable with the functional
    optimizers), drawn uniform in ``+-1/sqrt(fan_in)`` from a generator
    seeded with ``seed`` on ``device`` (default: the GPU, raising when
    there is none): the reference's law, not its bits.
    ``__call__(x[, params])`` runs the chain."""

    def __init__(self, mlp_sizes: Sequence[int], bias: bool = True,
                 activation: str = "relu", seed: int = 0,
                 dtype: torch.dtype = torch.float32,
                 device: _device.DeviceLike = None):
        if activation not in _ACTIVATIONS:
            raise TypeError(f"activation must be one of {_ACTIVATIONS}, "
                            f"got {activation}")
        self.mlp_sizes = list(mlp_sizes)
        self.num_layers = len(mlp_sizes) - 1
        self.bias = bias
        self.activation = activation
        device = _device.resolve(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.params = []
        for fan_in, fan_out in zip(self.mlp_sizes[:-1], self.mlp_sizes[1:]):
            bound = fan_in ** -0.5
            shapes = {"w": (fan_in, fan_out)}
            if bias:
                shapes["b"] = (fan_out,)
            self.params.append({
                k: (torch.rand(s, generator=gen, dtype=torch.float32,
                               device=device) * (2 * bound) - bound).to(dtype)
                for k, s in shapes.items()})

    def flat(self, params: Optional[list] = None) -> list:
        """``w0, b0, w1, ...`` as :func:`mlp_function` takes them."""
        out = []
        for layer in params if params is not None else self.params:
            out.append(layer["w"])
            if self.bias:
                out.append(layer["b"])
        return out

    def __call__(self, x, params: Optional[list] = None):
        return mlp_function(self.bias, self.activation, x, *self.flat(params))
