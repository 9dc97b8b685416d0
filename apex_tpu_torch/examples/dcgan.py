"""DCGAN with mixed precision (port of ``examples/dcgan.py``, after
Apex's ``examples/dcgan/main_amp.py``): amp with several models,
optimizers and losses::

    python -m apex_tpu_torch.examples.dcgan --steps 20 [--cpu]

``amp.initialize([pG, pD], opt_level=...)`` casts both nets' params (the
BatchNorm leaves kept fp32); three loss-scale states scale errD_real,
errD_fake and errG (Apex's ``num_losses=3``); two ``fused_adam``
transforms (lr 2e-4, betas 0.5, 0.999). :func:`d_step` and
:func:`g_step` keep the reference's bookkeeping as written
(``:71-114``): the discriminator's gradient is that of both scaled
losses, unscaled and applied under errD_fake's state, while errD_real's
state moves on its own overflow check of the same gradient. The "real"
images are 4x4 noise upsampled bilinearly to 32x32, ``tanh(2 x)``.

Each step: a generator forward in training mode (its BatchNorm stats
move), the discriminator step on the real and the fake batch, then the
generator step through the discriminator in eval mode.
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Optional

import torch
import torch.nn.functional as F

from apex_tpu_torch import _device, _tree
from apex_tpu_torch.models.dcgan import (
    Discriminator,
    Generator,
    init_variables,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--latent", type=int, default=32)
    p.add_argument("--width", type=int, default=16)
    p.add_argument("--opt-level", default="O2")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the GPU)")
    return p.parse_args(argv)


def bce(logits, target: float):
    """``optax.sigmoid_binary_cross_entropy(logits, target).mean()``."""
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, target))


def real_batch(gen: torch.Generator, batch: int, device):
    """Smooth random images in (-1, 1): 4x4 noise, bilinear to 32x32."""
    noise = torch.randn((batch, 3, 4, 4), generator=gen, device=device)
    up = F.interpolate(noise, size=(32, 32), mode="bilinear",
                       align_corners=False)
    return torch.tanh(up * 2.0).permute(0, 2, 3, 1)


class DCGANTrainer:
    """The two nets, their optimizers and the amp handle's scaler; the
    reference's ``fake_batch``, ``d_step`` and ``g_step`` as methods over
    variables trees ``{"params", "batch_stats"}`` (params updated in
    place)."""

    def __init__(self, netG: Generator, netD: Discriminator, scaler, txG,
                 txD):
        self.netG, self.netD, self.scaler = netG, netD, scaler
        self.txG, self.txD = txG, txD

    def fake_batch(self, varG, z):
        """``(images, new G stats)``: the generator in training mode."""
        return self.netG.apply(varG, z, train=True)

    def d_grads(self, varD, s_real, s_fake, real, fake):
        """The gradients of errD_real and errD_fake, each scaled by its
        own state, w.r.t. D's params: ``(grads, new D stats, errD)``."""
        scaler = self.scaler
        live = _tree.map_leaves(lambda p: p.detach().requires_grad_(),
                                varD["params"])
        logits_r, stats = self.netD.apply(
            {"params": live, "batch_stats": varD["batch_stats"]}, real)
        err_real = bce(logits_r, 1.0)
        logits_f, stats = self.netD.apply(
            {"params": live, "batch_stats": stats}, fake.detach())
        err_fake = bce(logits_f, 0.0)
        scaled = (scaler.scale_loss(err_real, s_real)
                  + scaler.scale_loss(err_fake, s_fake))
        grads = torch.autograd.grad(scaled, _tree.leaves(live))
        return (_tree.unflatten(_tree.paths(live), list(grads)), stats,
                (err_real + err_fake).detach())

    def d_step(self, varD, optD, s_real, s_fake, real, fake):
        """One discriminator step (``dcgan.py:71``): ``(new D stats,
        optD, s_real, s_fake, errD)``."""
        grads, stats, err = self.d_grads(varD, s_real, s_fake, real, fake)
        # each loss id advances its own automaton, as the reference does
        _, ov_real = self.scaler.unscale(grads, s_real)
        optD, s_fake = self._update(self.txD, varD["params"], optD, grads,
                                    s_fake)
        s_real = self.scaler.update(s_real, ov_real)
        return stats, optD, s_real, s_fake, err

    def g_grads(self, varG, varD, s_g, z):
        """The gradients of errG, scaled by ``s_g``, w.r.t. G's params,
        the discriminator in eval mode: ``(grads, new G stats, errG)``."""
        live = _tree.map_leaves(lambda p: p.detach().requires_grad_(),
                                varG["params"])
        fake, stats = self.netG.apply(
            {"params": live, "batch_stats": varG["batch_stats"]}, z)
        logits, _ = self.netD.apply(varD, fake, train=False)
        err = bce(logits, 1.0)
        grads = torch.autograd.grad(self.scaler.scale_loss(err, s_g),
                                    _tree.leaves(live))
        return (_tree.unflatten(_tree.paths(live), list(grads)), stats,
                err.detach())

    def g_step(self, varG, varD, optG, s_g, z):
        """One generator step (``dcgan.py:98``): ``(new G stats, optG,
        s_g, errG)``."""
        grads, stats, err = self.g_grads(varG, varD, s_g, z)
        optG, s_g = self._update(self.txG, varG["params"], optG, grads, s_g)
        return stats, optG, s_g, err

    def _update(self, tx, params, opt_state, grads, sstate):
        """``amp.scaled_update`` then the update added in place."""
        from apex_tpu_torch.amp import scaled_update

        updates, opt_state, sstate, _ = scaled_update(
            tx, self.scaler, grads, opt_state, params, sstate)
        with torch.no_grad():
            for p, u in zip(_tree.leaves(params), _tree.leaves(updates)):
                p.add_(u)
        return opt_state, sstate

    def step(self, varG, varD, optG, optD, sstates, z, real):
        """One training step of the example's loop: ``(optG, optD,
        sstates, errD, errG)``; the variables updated in place."""
        fake, varG["batch_stats"] = self.fake_batch(varG, z)
        (varD["batch_stats"], optD, sstates[0], sstates[1],
         errD) = self.d_step(varD, optD, sstates[0], sstates[1], real, fake)
        varG["batch_stats"], optG, sstates[2], errG = self.g_step(
            varG, varD, optG, sstates[2], z)
        return optG, optD, sstates, errD, errG


def setup(args, device):
    """The nets, their amp-cast variables, the handle, the optimizers and
    their states, and the three loss-scale states."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import fused_adam

    netG = Generator(latent_dim=args.latent, width=args.width,
                     axis_name=None)
    netD = Discriminator(width=args.width, axis_name=None)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    varG = init_variables(gen, netG, device=device)
    varD = init_variables(gen, netD, device=device)
    (pG, pD), handle = amp.initialize([varG["params"], varD["params"]],
                                      opt_level=args.opt_level, verbosity=0)
    varG["params"], varD["params"] = pG, pD
    scaler = handle.scaler
    sstates = [scaler.init() for _ in range(3)]  # errD_real/fake, errG
    txG = fused_adam(lr=2e-4, betas=(0.5, 0.999))
    txD = fused_adam(lr=2e-4, betas=(0.5, 0.999))
    trainer = DCGANTrainer(netG, netD, scaler, txG, txD)
    return trainer, varG, varD, txG.init(pG), txD.init(pD), sstates


def main(argv: Optional[list] = None) -> int:
    from apex_tpu_torch.amp._amp_state import _amp_state

    args = parse_args(argv)
    device = _device.resolve("cpu" if args.cpu else None)
    trainer, varG, varD, optG, optD, sstates = setup(args, device)
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    errD = errG = None
    try:
        for it in range(args.steps):
            z = torch.randn((args.batch, args.latent), generator=gen,
                            device=device)
            real = real_batch(gen, args.batch, device)
            t0 = time.perf_counter()
            optG, optD, sstates, errD, errG = trainer.step(
                varG, varD, optG, optD, sstates, z, real)
            errD, errG = float(errD), float(errG)
            ms = (time.perf_counter() - t0) * 1e3
            if it % 5 == 0 or it == args.steps - 1:
                print(f"step {it:3d}  errD {errD:.4f}  errG {errG:.4f}  "
                      f"({ms:.1f} ms)", flush=True)
    finally:
        _amp_state.handle = None
    if errD is None or not (math.isfinite(errD) and math.isfinite(errG)):
        print(f"dcgan: non-finite or no losses ({errD}, {errG})")
        return 1
    print("dcgan amp training ran to completion: OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
