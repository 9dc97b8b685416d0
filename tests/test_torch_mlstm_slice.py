"""The slice as a whole on the CPU: a tiny weight-normed mLSTM language
model (an embedding, ``rnn.mLSTM`` over ``compute_weights``, a decoder)
trained 3 steps under ``FP16_Optimizer(FusedAdam(flat=True))`` with a
dynamic loss scale and ``clip_master_grads``, an inf planted at step 1,
beside the same loop written with ``apex_tpu``.

Each step both sides take the loss and the bf16 gradients of their own
bf16 model; those agree to bf16 rounding (LOSS_RTOL, GRAD_REL). Both
optimizers are then fed the port's gradients, so the two trajectories
stay one: the clip norms, the skip and the scales equal, the fp32
masters within 1e-6 of their largest value and the bf16 model trees
within one bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu import fp16_utils as jfp
from apex_tpu import reparameterization as jrp
from apex_tpu import rnn as jrnn
from apex_tpu.optimizers import FusedAdam as JaxFusedAdam
from apex_tpu_torch import _tree
from apex_tpu_torch import fp16_utils as pfp
from apex_tpu_torch import reparameterization as prp
from apex_tpu_torch import rnn as prnn
from apex_tpu_torch.optimizers import FusedAdam

VOCAB, EMBED, HID, SEQ, BATCH = 16, 4, 8, 6, 3
STEPS, INF_STEP, LR, CLIP = 3, 1, 1e-2, 1.0
LOSS_RTOL = 2e-2  # two bf16 forwards, rounding in other places
GRAD_REL = 0.05
MASTER_REL = 1e-6
BF16_RTOL = 2 ** -7


def _params_np():
    jm = jrnn.mLSTM(EMBED, HID, seed=1)
    rng = np.random.default_rng(0)
    layer = jax.tree_util.tree_map(np.asarray, jrp.apply_weight_norm(
        jm.params[0]))
    return jm, {"embed": (0.5 * rng.standard_normal((VOCAB, EMBED))
                          ).astype(np.float32),
                "rnn": layer,
                "dec_w": (0.3 * rng.standard_normal((VOCAB, HID))
                          ).astype(np.float32),
                "dec_b": np.zeros(VOCAB, np.float32)}


def _port_loss(model, p, tokens):
    x = p["embed"][tokens[:, :-1]].transpose(0, 1)
    out, _ = model(x, params=[prp.compute_weights(p["rnn"])])
    logits = torch.matmul(out, p["dec_w"].t()) + p["dec_b"]
    return F.cross_entropy(logits.float().reshape(-1, VOCAB),
                           tokens[:, 1:].t().reshape(-1))


def _jax_loss(model, p, tokens):
    x = jnp.swapaxes(p["embed"][tokens[:, :-1]], 0, 1)
    out, _ = model(x, params=[jrp.compute_weights(p["rnn"])])
    logits = (out @ p["dec_w"].T + p["dec_b"]).astype(jnp.float32)
    logp = jax.nn.log_softmax(logits, axis=-1)
    tgt = jnp.swapaxes(tokens[:, 1:], 0, 1)
    return -jnp.mean(jnp.take_along_axis(logp, tgt[..., None], -1))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_fp16_optimizer_mlstm_loop_matches_jax():
    jm, params = _params_np()
    pm = prnn.mLSTM(EMBED, HID, device="cpu")
    pm.params = None
    tokens = np.random.default_rng(1).integers(0, VOCAB, (BATCH, SEQ + 1))
    ptok, jtok = torch.from_numpy(tokens), jnp.asarray(tokens)
    jopt = jfp.FP16_Optimizer(
        JaxFusedAdam(jfp.tofp16(jax.tree_util.tree_map(jnp.asarray, params)),
                     lr=LR, flat=True), dynamic_loss_scale=True,
        dynamic_loss_args={"init_scale": 2.0 ** 16})
    ptree = _tree.map_leaves(lambda a: torch.from_numpy(np.array(a)),
                             params)
    popt = pfp.FP16_Optimizer(
        FusedAdam(pfp.tofp16(ptree), lr=LR, flat=True),
        dynamic_loss_scale=True, dynamic_loss_args={"init_scale": 2.0 ** 16})
    paths = _tree.paths(params)
    for step in range(STEPS):
        scale = popt.loss_scale
        assert scale == jopt.loss_scale
        live = _tree.map_leaves(lambda t: t.detach().requires_grad_(),
                                popt.model_params)
        loss = _port_loss(pm, live, ptok)
        grads = torch.autograd.grad(popt.scale_loss(loss),
                                    _tree.leaves(live))
        jloss, jgrads = jax.value_and_grad(
            lambda p: jopt.scale_loss(_jax_loss(jm, p, jtok)))(
                jopt.model_params)
        np.testing.assert_allclose(float(loss.detach()),
                                   float(jloss) / scale, rtol=LOSS_RTOL)
        for g, jg in zip(grads, jax.tree_util.tree_leaves(jgrads)):
            assert _rel(_np(g), _np(jg)) <= GRAD_REL
        # both optimizers take the port's gradients
        pg = _tree.unflatten(paths, list(grads))
        if step == INF_STEP:
            pg["dec_b"][0] = float("inf")
        jg = jax.tree_util.tree_map(
            lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16),
            pg)
        pg, pnorm = popt.clip_master_grads(pg, CLIP)
        jg, jnorm = jopt.clip_master_grads(jg, CLIP)
        if step == INF_STEP:
            assert not np.isfinite(float(pnorm))
            assert not np.isfinite(float(jnorm))
        else:
            np.testing.assert_allclose(float(pnorm), float(jnorm),
                                       rtol=1e-5)
        pmodel = popt.step(pg)
        jmodel = jopt.step(jg)
        assert popt.overflow == jopt.overflow == (step == INF_STEP)
        assert popt.loss_scale == jopt.loss_scale
        for a, b in zip(_tree.leaves(popt.optimizer.params),
                        jax.tree_util.tree_leaves(jopt.optimizer.params)):
            a, b = _np(a), _np(b)
            assert np.max(np.abs(a - b)) <= MASTER_REL * np.max(np.abs(b))
        for a, b in zip(_tree.leaves(pmodel),
                        jax.tree_util.tree_leaves(jmodel)):
            assert a.dtype == torch.bfloat16
            np.testing.assert_allclose(_np(a), _np(b), rtol=BF16_RTOL,
                                       atol=1e-30)
    assert popt.loss_scale == 2.0 ** 15
    assert int(popt.optimizer.state.count) == int(
        jopt.optimizer.state.count) == STEPS - 1
