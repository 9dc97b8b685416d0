"""The port's DCGAN (``apex_tpu_torch.models.dcgan`` and
``apex_tpu_torch.examples.dcgan``) against the JAX package's flax modules
and the reference example's steps (``examples/dcgan.py:71-114``, written
out here: the example builds them inside ``main``), on the CPU, from the
same variables (flax's init carried over by ``variables_from_flax``) and
the same numpy batches.

Tolerances:

- forward, batch stats and gradients in fp32: elementwise within RTOL =
  1e-5 and a floor of 1e-5 times the array's (or, for gradients, the
  whole tree's) largest value: both sides sum the same fp32 products in
  another order, and a BatchNorm bias's gradient is a sum over the batch
  that cancels.
- the example's steps, each of fake_batch, d_step and g_step held from
  the port's state before it: losses, fakes and batch stats as above,
  the loss-scale states exactly, each param's displacement within
  STEP_REL in relative L2. At O0 the params are fp32 (STEP_REL = 1e-4: Adam divides by
  sqrt(v) + 1e-8, which turns a gradient's last-bit difference into an
  update difference where |g| is small); at O2 they are bf16, and an
  update that lands within an fp32 rounding of a bf16 tie rounds one
  bf16 ulp the other way (STEP_REL = 2e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu import amp as jamp
from apex_tpu.models.dcgan import Discriminator as JD
from apex_tpu.models.dcgan import Generator as JG
from apex_tpu.optimizers import fused_adam as jfused_adam
from apex_tpu_torch import _tree
from apex_tpu_torch.amp._amp_state import _amp_state
from apex_tpu_torch.examples import dcgan as ex
from apex_tpu_torch.models import dcgan

RTOL = 1e-5
STEP_REL = {"O0": 1e-4, "O2": 2e-2}
LATENT, WIDTH, BATCH = 8, 4, 4


@pytest.fixture(autouse=True)
def _fresh_amp_state():
    yield
    _amp_state.handle = None
    from apex_tpu.amp import _amp_state as jstate

    jstate._amp_state.handle = None


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _to_flax_np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _to_flax(variables):
    """The inverse of ``dcgan.variables_from_flax``, as numpy (bf16 leaves
    as their fp32 values): ConvTranspose kernels unflipped to (kh, kw,
    in, out), Conv kernels OIHW -> HWIO."""
    def back(tree, name=""):
        if not isinstance(tree, dict):
            return _to_flax_np(tree)
        out = {}
        for k, v in tree.items():
            if k == "kernel" and v.dim() == 4:
                a = _to_flax_np(v)
                out[k] = np.ascontiguousarray(
                    a.transpose(2, 3, 0, 1)[::-1, ::-1]
                    if name.startswith("ConvTranspose")
                    else a.transpose(2, 3, 1, 0))
            else:
                out[k] = back(v, k)
        return out

    return back(variables)


def _flax_vars(seed=0):
    g = JG(latent_dim=LATENT, width=WIDTH, axis_name=None)
    d = JD(width=WIDTH, axis_name=None)
    vg = g.init(jax.random.PRNGKey(seed), jnp.zeros((2, LATENT)),
                train=False)
    vd = d.init(jax.random.PRNGKey(seed + 1), jnp.zeros((2, 32, 32, 3)),
                train=False)
    return (g, jax.tree_util.tree_map(np.asarray, vg),
            d, jax.tree_util.tree_map(np.asarray, vd))


def _nets():
    return (dcgan.Generator(latent_dim=LATENT, width=WIDTH, axis_name=None),
            dcgan.Discriminator(width=WIDTH, axis_name=None))


def _close(got, want, atol_of=None):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    top = float(np.abs(want if atol_of is None else atol_of).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * top)


def _tree_close(got, want, grads=False):
    paths = _tree.paths(got)
    wl = [np.asarray(_get(want, p)) for p in paths]
    top = max(float(np.abs(w).max()) for w in wl) if grads else None
    for p, w in zip(paths, wl):
        g = _get(got, p)
        _close(g, w, atol_of=np.array(top) if grads else None)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_variables_from_flax_round_trip_and_init_layout():
    """The converter's layouts (ConvTranspose flipped to (in, out, kh,
    kw), Conv OIHW) and back; the port's own init has the same shapes
    as the converted flax init."""
    g, vg, d, vd = _flax_vars()
    netG, netD = _nets()
    for net, flax_vars in ((netG, vg), (netD, vd)):
        ours = dcgan.variables_from_flax(flax_vars, device="cpu")
        back = _to_flax(ours)
        jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                               jax.tree_util.tree_map(np.asarray, flax_vars))
        init = dcgan.init_variables(torch.Generator().manual_seed(0), net,
                                    device="cpu")
        assert _tree.paths(init) == _tree.paths(ours)
        for p in _tree.paths(init):
            assert _get(init, p).shape == _get(ours, p).shape, p
    k = vg["params"]["ConvTranspose_0"]["kernel"]
    got = dcgan.variables_from_flax(vg, device="cpu")["params"][
        "ConvTranspose_0"]["kernel"]
    assert tuple(got.shape) == (k.shape[2], k.shape[3], 4, 4)
    assert float(got[1, 2, 0, 3]) == float(k[3, 0, 1, 2])


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_generator_and_discriminator_match_flax(train):
    """Images (4x4 -> 8x8 -> 16x16 -> 32x32), logits and the new batch
    stats of both nets, running stats away from (0, 1)."""
    g, vg, d, vd = _flax_vars()
    rng = np.random.default_rng(5)
    for tree in (vg, vd):
        tree["batch_stats"] = jax.tree_util.tree_map(
            lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32),
            tree["batch_stats"])
    netG, netD = _nets()
    z = _rand((BATCH, LATENT), 1)
    x = np.tanh(_rand((BATCH, 32, 32, 3), 2))
    if train:
        jimg, jmut = g.apply(vg, jnp.asarray(z), train=True,
                             mutable=["batch_stats"])
        jlog, jdmut = d.apply(vd, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    else:
        jimg, jlog = (g.apply(vg, jnp.asarray(z), train=False),
                      d.apply(vd, jnp.asarray(x), train=False))
    img, sG = netG.apply(dcgan.variables_from_flax(vg, device="cpu"),
                         torch.from_numpy(z), train=train)
    logits, sD = netD.apply(dcgan.variables_from_flax(vd, device="cpu"),
                            torch.from_numpy(x), train=train)
    assert tuple(img.shape) == (BATCH, 32, 32, 3) and logits.shape == (BATCH,)
    _close(img, jimg)
    _close(logits, jlog)
    if train:
        _tree_close(sG, jmut["batch_stats"])
        _tree_close(sD, jdmut["batch_stats"])


def test_gradients_match_flax():
    """Gradients of a D-of-G loss w.r.t. both nets' params in training
    mode, against jax.grad of the flax modules."""
    g, vg, d, vd = _flax_vars(3)
    netG, netD = _nets()
    z = _rand((BATCH, LATENT), 4)

    def jloss(pg, pd):
        img, _ = g.apply({"params": pg, "batch_stats": vg["batch_stats"]},
                         jnp.asarray(z), train=True, mutable=["batch_stats"])
        logits, _ = d.apply({"params": pd, "batch_stats": vd["batch_stats"]},
                            img, train=True, mutable=["batch_stats"])
        return jnp.mean(optax.sigmoid_binary_cross_entropy(
            logits, jnp.ones_like(logits)))

    jg = jax.grad(jloss, argnums=(0, 1))(vg["params"], vd["params"])
    varG = dcgan.variables_from_flax(vg, device="cpu")
    varD = dcgan.variables_from_flax(vd, device="cpu")
    live = [_tree.map_leaves(lambda t: t.requires_grad_(), v["params"])
            for v in (varG, varD)]
    img, _ = netG.apply(varG, torch.from_numpy(z))
    logits, _ = netD.apply(varD, img)
    loss = ex.bce(logits, 1.0)
    want = float(jloss(vg["params"], vd["params"]))
    np.testing.assert_allclose(float(loss.detach()), want, rtol=RTOL)
    for tree, want in zip(live, jg):
        leaves = _tree.leaves(tree)
        grads = torch.autograd.grad(loss, leaves, retain_graph=True)
        back = _to_flax({"params": _tree.unflatten(
            _tree.paths(tree), list(grads))})["params"]
        _tree_close(back, jax.tree_util.tree_map(np.asarray, want),
                    grads=True)


# biases whose gradient is 0 in exact arithmetic: each feeds a training-
# mode BatchNorm, whose mean removes it, so both sides' gradients are
# rounding noise and Adam's first steps move them by +-lr at random
NOISE_LEAVES = {"G": {("ConvTranspose_0", "bias"), ("ConvTranspose_1", "bias")},
                "D": {("Conv_1", "bias"), ("Conv_2", "bias")}}


def _jnp(t):
    """A port tensor as a JAX array of the same dtype (bf16 exactly)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _to_jax(var):
    """Port variables (params and stats) in flax's layout as JAX arrays,
    each leaf in its own dtype."""
    flax = _to_flax(var)
    dtypes = {p: _get(var, p).dtype for p in _tree.paths(var)}
    return _tree.unflatten(_tree.paths(flax), [
        jnp.asarray(_get(flax, p), jnp.bfloat16
                    if dtypes[p] == torch.bfloat16 else jnp.float32)
        for p in _tree.paths(flax)])


def _adam_to_jax(state, jtx, jparams):
    def tree(t):
        return jax.tree_util.tree_map(
            jnp.asarray, _to_flax({"params": t})["params"])
    return jtx.init(jparams)._replace(
        count=jnp.asarray(int(state.count), jnp.int32), mu=tree(state.mu),
        nu=tree(state.nu))


def _scale_to_jax(sstate, jscaler):
    return jscaler.init()._replace(**{
        f: jnp.asarray(getattr(sstate, f).numpy())
        for f in sstate._fields})


def _assert_scale_states(got, want):
    for f in got._fields:
        assert float(getattr(got, f)) == float(np.asarray(getattr(want, f))), f


def _assert_update(name, before, after, jafter, tol):
    """Each params leaf's displacement within ``tol`` (relative L2),
    the noise leaves excepted (NOISE_LEAVES), whose update is at most
    lr an element."""
    b = _to_flax({"params": before})["params"]
    a = _to_flax({"params": after})["params"]
    for path in _tree.paths(a):
        got = np.asarray(_get(a, path), np.float32) - np.asarray(
            _get(b, path), np.float32)
        want = np.asarray(jnp.asarray(_get(jafter, path), jnp.float32)) \
            - np.asarray(_get(b, path), np.float32)
        if path in NOISE_LEAVES[name]:
            assert np.abs(got).max() <= 2.5e-4, (name, path)
            continue
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= tol, (name, path, rel)


@pytest.mark.parametrize("opt_level", ["O0", "O2"])
def test_example_steps_match_reference(opt_level):
    """Two steps of the example's trainer (amp list-of-models cast, three
    scale states, fake_batch, d_step and g_step) against the reference's
    functions (``examples/dcgan.py:60-114``, written out here), each of
    the three held from the port's own state before it: the fakes and G
    stats, D's update, stats and errD, then G's update, stats and errG,
    and the three scale states exactly. Held as one trajectory the two
    diverge: the noise leaves' +-lr moves shift D's eval-mode forward in
    g_step, which flips the sign of Adam's first update wherever G's
    gradient is small."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.optimizers import fused_adam

    g, vg, d, vd = _flax_vars(7)
    netG, netD = _nets()
    varG = dcgan.variables_from_flax(vg, device="cpu")
    varD = dcgan.variables_from_flax(vd, device="cpu")
    (pG, pD), handle = amp.initialize([varG["params"], varD["params"]],
                                      opt_level=opt_level, verbosity=0)
    (jpG, jpD), jhandle = jamp.initialize([vg["params"], vd["params"]],
                                          opt_level=opt_level, verbosity=0)
    policy, jscaler = jhandle.policy, jhandle.scaler
    if opt_level == "O2":
        assert pG["Dense_0"]["kernel"].dtype == torch.bfloat16
        assert jpG["Dense_0"]["kernel"].dtype == jnp.bfloat16
        assert pG["BatchNorm_0"]["BatchNorm_0"]["scale"].dtype == \
            torch.float32
    varG["params"], varD["params"] = pG, pD
    txG = fused_adam(lr=2e-4, betas=(0.5, 0.999))
    txD = fused_adam(lr=2e-4, betas=(0.5, 0.999))
    jtxG = jfused_adam(lr=2e-4, betas=(0.5, 0.999))
    jtxD = jfused_adam(lr=2e-4, betas=(0.5, 0.999))
    trainer = ex.DCGANTrainer(netG, netD, handle.scaler, txG, txD)
    optG, optD = txG.init(pG), txD.init(pD)
    sstates = [handle.scaler.init() for _ in range(3)]

    def bce(logit, target):
        return optax.sigmoid_binary_cross_entropy(logit, target).mean()

    def fake_batch(pG, sG, z):
        imgs, mut = g.apply({"params": policy.cast_model(pG),
                             "batch_stats": sG}, z, train=True,
                            mutable=["batch_stats"])
        return imgs, mut["batch_stats"]

    def d_step(pD, optD, sD, s_real, s_fake, real, fake):
        def loss_fn(pD):
            logits_r, mut = d.apply(
                {"params": policy.cast_model(pD), "batch_stats": sD},
                real, train=True, mutable=["batch_stats"])
            errD_real = bce(logits_r, jnp.ones_like(logits_r))
            logits_f, mut = d.apply(
                {"params": policy.cast_model(pD),
                 "batch_stats": mut["batch_stats"]},
                fake, train=True, mutable=["batch_stats"])
            errD_fake = bce(logits_f, jnp.zeros_like(logits_f))
            scaled = (jscaler.scale_loss(errD_real, s_real)
                      + jscaler.scale_loss(errD_fake, s_fake))
            return scaled, (errD_real + errD_fake, mut["batch_stats"])

        grads, (errD, sD) = jax.grad(loss_fn, has_aux=True)(pD)
        _, ov_r = jscaler.unscale(grads, s_real)
        updates, optD, s_fake, _ = jamp.scaled_update(
            tx=jtxD, scaler=jscaler, grads=grads, opt_state=optD,
            params=pD, scaler_state=s_fake)
        s_real = jscaler.update(s_real, ov_r)
        pD = optax.apply_updates(pD, updates)
        return pD, optD, sD, s_real, s_fake, errD

    def g_step(pG, optG, sG, pD, sD, s_g, z):
        def loss_fn(pG):
            fake, newsG = fake_batch(pG, sG, z)
            logits = d.apply({"params": policy.cast_model(pD),
                              "batch_stats": sD}, fake, train=False)
            errG = bce(logits, jnp.ones_like(logits))
            return jscaler.scale_loss(errG, s_g), (errG, newsG)

        grads, (errG, sG) = jax.grad(loss_fn, has_aux=True)(pG)
        updates, optG, s_g, _ = jamp.scaled_update(
            tx=jtxG, scaler=jscaler, grads=grads, opt_state=optG,
            params=pG, scaler_state=s_g)
        pG = optax.apply_updates(pG, updates)
        return pG, optG, sG, s_g, errG

    tol = STEP_REL[opt_level]
    for i in range(2):
        z, real = _rand((BATCH, LATENT), 20 + i), np.tanh(
            _rand((BATCH, 32, 32, 3), 30 + i))
        jz, jreal = jnp.asarray(z), jnp.asarray(real)
        # the generator's forward in training mode
        jG = _to_jax(varG)
        jfake, jsG = fake_batch(jG["params"], jG["batch_stats"], jz)
        fake, varG["batch_stats"] = trainer.fake_batch(varG,
                                                       torch.from_numpy(z))
        _close(fake, jfake)
        _tree_close(varG["batch_stats"], jsG)
        # the discriminator's step on the port's fakes
        jD, before = _to_jax(varD), _tree.map_leaves(torch.clone, pD)
        jout = d_step(jD["params"], _adam_to_jax(optD, jtxD, jD["params"]),
                      jD["batch_stats"],
                      *[_scale_to_jax(s, jscaler) for s in sstates[:2]],
                      jreal, _jnp(fake))
        (varD["batch_stats"], optD, sstates[0], sstates[1],
         errD) = trainer.d_step(varD, optD, sstates[0], sstates[1],
                                torch.from_numpy(real), fake)
        np.testing.assert_allclose(float(errD), float(jout[5]), rtol=RTOL)
        _assert_update("D", before, pD, jout[0], tol)
        _tree_close(varD["batch_stats"], jout[2])
        _assert_scale_states(sstates[0], jout[3])
        _assert_scale_states(sstates[1], jout[4])
        # the generator's step through the updated discriminator
        jG, jD = _to_jax(varG), _to_jax(varD)
        before = _tree.map_leaves(torch.clone, pG)
        jout = g_step(jG["params"], _adam_to_jax(optG, jtxG, jG["params"]),
                      jG["batch_stats"], jD["params"], jD["batch_stats"],
                      _scale_to_jax(sstates[2], jscaler), jz)
        varG["batch_stats"], optG, sstates[2], errG = trainer.g_step(
            varG, varD, optG, sstates[2], torch.from_numpy(z))
        np.testing.assert_allclose(float(errG), float(jout[4]), rtol=RTOL)
        _assert_update("G", before, pG, jout[0], tol)
        _tree_close(varG["batch_stats"], jout[2])
        _assert_scale_states(sstates[2], jout[3])
    # O0 scales by 1 with its scaler off: its states never move
    want = 2 if opt_level == "O2" else 0
    assert [int(s.steps) for s in sstates] == [want] * 3


def test_real_batch_is_the_reference_resize():
    """F.interpolate(bilinear, align_corners=False) upsampling 4x4 -> 32x32
    equals jax.image.resize(..., "bilinear") of the same noise."""
    noise = _rand((2, 4, 4, 3), 9)
    want = jax.image.resize(jnp.asarray(noise), (2, 32, 32, 3), "bilinear")
    got = torch.nn.functional.interpolate(
        torch.from_numpy(noise).permute(0, 3, 1, 2), size=(32, 32),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    _close(got, want)


def test_example_main_runs_to_ok(capsys):
    assert ex.main(["--steps", "3", "--batch", "4", "--latent", "8",
                    "--width", "4", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "dcgan amp training ran to completion: OK" in out
    assert "step   2" in out
