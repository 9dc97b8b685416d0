"""DCGAN generator and discriminator (port of ``apex_tpu/models/dcgan.py``):
the reference's mixed-precision GAN example (Apex's
``examples/dcgan/main_amp.py``), amp over two models, two optimizers and
three losses.

Functional over a variables tree ``{"params", "batch_stats"}`` keyed by
flax's module paths (``Dense_0``, ``ConvTranspose_0``, ``Conv_1``,
``BatchNorm_0/BatchNorm_0``), so amp's ``cast_model`` keeps every
``BatchNorm_*`` leaf fp32. The API takes and gives NHWC images, as the
reference does; inside, activations are NCHW in channels_last memory, as
in ``models/resnet.py``.

Kernel layouts differ from flax's, once, in :func:`variables_from_flax`:

- ``Conv`` kernels are OIHW (``F.conv2d``'s), flax's HWIO permuted. The
  discriminator's 4x4 stride-2 ``SAME`` convolutions pad 1 on each side
  at every even size, symmetric, so ``resnet.conv`` takes them as they
  are.
- ``ConvTranspose`` kernels are ``(in, out, kh, kw)``, ``F.conv_transpose2d``'s,
  and flipped in both spatial dims. flax's ``nn.ConvTranspose``
  (``transpose_kernel=False``) is not the gradient of ``nn.Conv``: it
  correlates the input dilated by the stride, padded by ``lax``'s
  ``SAME`` transpose padding (2 and 2 for kernel 4, stride 2), with the
  kernel as stored. ``F.conv_transpose2d`` correlates the same dilated
  input with the kernel flipped, padded ``k - 1 - padding``; at
  ``padding=1`` the two agree, with the flip moved into the weights, and
  each layer doubles the size (4 -> 8 -> 16 -> 32).

Convolutions and the BatchNorm (``models/_common.BatchNorm``) are plain
PyTorch, as the reference's are XLA ops outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch import _device
from apex_tpu_torch.models._common import BatchNorm
from apex_tpu_torch.models.resnet import _to_nchw, conv, lecun_normal

_K, _S = 4, 2  # every convolution: kernel 4x4, stride 2


def _dense(p, x):
    """``nn.Dense`` in ``x``'s dtype."""
    return x @ p["kernel"].to(x.dtype) + p["bias"].to(x.dtype)


def _conv_transpose(p, x):
    """``nn.ConvTranspose(k=4, strides=2, padding="SAME")`` with a bias,
    on NCHW-ordered ``x``, in ``x``'s dtype (module docstring)."""
    return F.conv_transpose2d(x, p["kernel"].to(x.dtype),
                              p["bias"].to(x.dtype), stride=_S, padding=1)


def _conv(p, x):
    """``nn.Conv(k=4, strides=2, padding="SAME")`` with a bias."""
    return conv(x, p["kernel"], (_S, _S)) + p["bias"].to(x.dtype)[:, None,
                                                                   None]


def _bn(sync: bool, axis_name):
    return BatchNorm(sync=sync, axis_name=axis_name)


@dataclasses.dataclass(frozen=True)
class Generator:
    """``dcgan.py:18``: z ``[b, latent]`` -> a ``Dense`` to 4x4 x 4w, then
    (BatchNorm, ReLU, ConvTranspose) three times to 32x32 x
    ``out_channels``, tanh. ``dtype`` is the activations'."""

    latent_dim: int = 100
    width: int = 64
    out_channels: int = 3
    sync_bn: bool = False
    axis_name: Optional[str] = "data"
    dtype: torch.dtype = torch.float32

    def channels(self):
        """``(in, out)`` of each ConvTranspose."""
        w = self.width
        return [(4 * w, 2 * w), (2 * w, w), (w, self.out_channels)]

    def apply(self, variables, z, train: bool = True):
        """``(images [b, 32, 32, c] in (-1, 1), new_batch_stats)``; in
        eval mode the stats come back as they are."""
        params, stats = variables["params"], variables["batch_stats"]
        bn = _bn(self.sync_bn, self.axis_name)
        x = _dense(params["Dense_0"], z.to(self.dtype))
        x = _to_nchw(x.reshape(x.shape[0], 4, 4, 4 * self.width))
        new = {}
        for i in range(3):
            name = f"BatchNorm_{i}"
            x, new[name] = bn(params[name], stats[name], x, train, ch=1)
            x = _conv_transpose(params[f"ConvTranspose_{i}"], F.relu(x))
        return torch.tanh(x).permute(0, 2, 3, 1), (new if train else stats)


@dataclasses.dataclass(frozen=True)
class Discriminator:
    """``dcgan.py:44``: image ``[b, 32, 32, c]`` -> three strided convs
    (width x 1, 2, 4; BatchNorm after the second and third), leaky ReLU
    0.2 after each, a ``Dense`` to one logit in fp32."""

    width: int = 64
    in_channels: int = 3
    sync_bn: bool = False
    axis_name: Optional[str] = "data"
    dtype: torch.dtype = torch.float32

    def channels(self):
        w = self.width
        return [(self.in_channels, w), (w, 2 * w), (2 * w, 4 * w)]

    def apply(self, variables, x, train: bool = True):
        """``(logits [b] fp32, new_batch_stats)``."""
        params, stats = variables["params"], variables["batch_stats"]
        bn = _bn(self.sync_bn, self.axis_name)
        x = _to_nchw(x.to(self.dtype))
        new = {}
        for i in range(3):
            x = _conv(params[f"Conv_{i}"], x)
            if i > 0:
                name = f"BatchNorm_{i - 1}"
                x, new[name] = bn(params[name], stats[name], x, train, ch=1)
            x = F.leaky_relu(x, 0.2)
        # flatten in NHWC order, as the reference's reshape does
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        dense = params["Dense_0"]
        logits = x.float() @ dense["kernel"].float() + dense["bias"].float()
        return logits[:, 0], (new if train else stats)


def init_variables(generator: torch.Generator, model,
                   device: _device.DeviceLike = None) -> Dict:
    """Random variables of a :class:`Generator` or :class:`Discriminator`
    from ``generator`` (drawn on its device) with flax's default laws
    (lecun-normal kernels over each kernel's fan-in, zero biases,
    BatchNorm scale 1, bias 0, mean 0, var 1), fp32, placed on ``device``
    (default: the GPU, raising when there is none). The same laws as the
    reference's init, not the same bits."""
    device = _device.resolve(device)
    bn = _bn(model.sync_bn, model.axis_name)
    zeros = lambda n: torch.zeros(n, dtype=torch.float32,  # noqa: E731
                                  device=device)
    params, stats = {}, {}
    w = model.width
    if isinstance(model, Generator):
        n = 16 * 4 * w
        params["Dense_0"] = {"kernel": lecun_normal(
            generator, (model.latent_dim, n), model.latent_dim, device),
            "bias": zeros(n)}
        for i, (cin, cout) in enumerate(model.channels()):
            # flax's fan-in of a ConvTranspose kernel: kh * kw * in
            params[f"ConvTranspose_{i}"] = {
                "kernel": lecun_normal(generator, (cin, cout, _K, _K),
                                       cin * _K * _K, device),
                "bias": zeros(cout)}
            params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"] = bn.init(
                cin, device)
    else:
        for i, (cin, cout) in enumerate(model.channels()):
            params[f"Conv_{i}"] = {
                "kernel": lecun_normal(generator, (cout, cin, _K, _K),
                                       cin * _K * _K, device),
                "bias": zeros(cout)}
            if i > 0:
                params[f"BatchNorm_{i - 1}"], stats[f"BatchNorm_{i - 1}"] = \
                    bn.init(cout, device)
        n = 16 * 4 * w
        params["Dense_0"] = {"kernel": lecun_normal(generator, (n, 1), n,
                                                    device),
                             "bias": zeros(1)}
    return {"params": params, "batch_stats": stats}


def _from_flax(tree, name: str = ""):
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "kernel" and np.ndim(v) == 4:
            v = np.asarray(v)
            if name.startswith("ConvTranspose"):
                # (kh, kw, in, out) -> flipped (in, out, kh, kw)
                v = np.ascontiguousarray(v[::-1, ::-1].transpose(2, 3, 0, 1))
            else:  # HWIO -> OIHW
                v = np.ascontiguousarray(v.transpose(3, 2, 0, 1))
            out[k] = v
        else:
            out[k] = _from_flax(v, k)
    return out


def variables_from_flax(variables, device: _device.DeviceLike = None
                        ) -> Dict:
    """The JAX package's Generator or Discriminator variables with numpy
    leaves (e.g. ``jax.tree_util.tree_map(np.asarray, variables)``) as
    the port's: ConvTranspose kernels flipped and laid out ``(in, out,
    kh, kw)``, Conv kernels HWIO -> OIHW, the rest as it is."""
    return _device.from_numpy(_from_flax(variables), _device.resolve(device))

