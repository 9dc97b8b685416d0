"""Parity of the port's ``contrib.multihead_attn`` with the JAX package's
flax modules on the CPU, from the same flax params (loaded with
``load_flax_params``) and numpy inputs, fp32:

- SelfMultiheadAttn, packed and separate qkv, with and without bias and
  ``include_norm_add``, under every mask kind (none: the flash path;
  key padding; bool, int and additive float attention masks; key padding
  and a bool mask together): output, and the gradients of every param
  and of the input (``jax.vjp``), to fp32 rounding (ATOL/RTOL);
- EncdecMultiheadAttn (keys longer than queries) the same way;
- the flash path at dropout > 0 bit for bit on the keep mask: the port
  gets the JAX key's ``_dropout_seed`` (``flash_attention.py:610``) as
  its int seed, and matches to fp32 rounding;
- ``mask_softmax_dropout``/``MaskSoftmaxDropout`` against JAX's;
- the masked path at dropout > 0 by the reference's statistics (keep
  share 1 - p, kept values scaled by 1/(1 - p); ``tests/contrib/
  test_attention_dropout.py``): its keep mask comes from a torch
  generator, and jax's threefry ``bernoulli`` cannot be matched bit for
  bit from torch.

JAX's flash attention runs its Pallas kernels in interpret mode; the
port's kernel wrappers take their plain versions on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.contrib import multihead_attn as jax_mha
from apex_tpu.ops import pallas_config
from apex_tpu.ops.flash_attention import _dropout_seed
from apex_tpu_torch.contrib import multihead_attn as mha

#: fp32 products, softmax and LayerNorm of the same values summed in
#: another order
ATOL, RTOL = 2e-5, 1e-4
S, SK, B, H, HEADS = 16, 24, 2, 32, 4

MASKS = ["none", "key_padding", "bool", "int", "additive", "both"]


def _masks(kind: str):
    """(key_padding_mask, attn_mask) as numpy, or None each."""
    kpm = np.zeros((B, S), bool)
    kpm[1, 11:] = True
    causal = np.triu(np.ones((S, S), bool), k=1)
    return {"none": (None, None), "key_padding": (kpm, None),
            "bool": (None, causal), "int": (None, causal.astype(np.int32)),
            "additive": (None, np.where(causal, -np.inf, 0.0).astype(
                np.float32)),
            "both": (kpm, causal)}[kind]


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_grads(mod, inputs, g, **kw):
    """(output, {name: grad}) of the port module: params by their flax
    names (``a.b`` for ``a/b``), inputs as ``in0``, ``in1``."""
    xs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    out = mod(*xs, **kw)
    names = [n for n, _ in mod.named_parameters()]
    leaves = [p for _, p in mod.named_parameters()] + xs
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    return out.detach().numpy(), dict(
        zip(names + [f"in{i}" for i in range(len(xs))], grads))


def _jax_grads(jmod, variables, inputs, g, **kw):
    def f(params, *xs):
        return jmod.apply({"params": params}, *xs, **kw)

    with pallas_config.force("interpret"):
        out, vjp = jax.vjp(f, variables["params"],
                           *[jnp.asarray(x) for x in inputs])
        cot = vjp(jnp.asarray(g))
    flat = {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(cot[0])[0]}
    flat.update({f"in{i}": np.asarray(c) for i, c in enumerate(cot[1:])})
    return np.asarray(out), flat


def _assert_match(got, ref):
    out, grads = got
    ref_out, ref_grads = ref
    np.testing.assert_allclose(out, ref_out, atol=ATOL, rtol=RTOL)
    assert sorted(grads) == sorted(ref_grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[name], atol=ATOL,
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("norm_add", [False, True], ids=["plain", "norm"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("separate", [False, True], ids=["packed", "sep"])
def test_self_attn_matches_flax(separate, bias, norm_add, mask):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((S, B, H)).astype(np.float32)
    g = rng.standard_normal((S, B, H)).astype(np.float32)
    kpm, am = _masks(mask)
    cfg = dict(bias=bias, include_norm_add=norm_add,
               separate_qkv_params=separate)
    jmod = jax_mha.SelfMultiheadAttn(H, HEADS, **cfg)
    variables = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x),
                          is_training=False)
    jkw = dict(is_training=False,
               key_padding_mask=None if kpm is None else jnp.asarray(kpm),
               attn_mask=None if am is None else jnp.asarray(am))
    mod = mha.SelfMultiheadAttn(H, HEADS, device="cpu", **cfg)
    mha.load_flax_params(mod, _tree_np(variables["params"]))
    kw = dict(is_training=False,
              key_padding_mask=None if kpm is None else torch.from_numpy(kpm),
              attn_mask=None if am is None else torch.from_numpy(am))
    _assert_match(_port_grads(mod, [x], g, **kw),
                  _jax_grads(jmod, variables, [x], g, **jkw))


@pytest.mark.parametrize("norm_add", [False, True], ids=["plain", "norm"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_encdec_attn_matches_flax(bias, norm_add):
    """Queries from the decoder (S), keys and values from the encoder
    (SK != S): the flash path, non-causal."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((S, B, H)).astype(np.float32)
    k = rng.standard_normal((SK, B, H)).astype(np.float32)
    g = rng.standard_normal((S, B, H)).astype(np.float32)
    cfg = dict(bias=bias, include_norm_add=norm_add)
    jmod = jax_mha.EncdecMultiheadAttn(H, HEADS, **cfg)
    variables = jmod.init(jax.random.PRNGKey(2), jnp.asarray(q),
                          jnp.asarray(k), is_training=False)
    mod = mha.EncdecMultiheadAttn(H, HEADS, device="cpu", **cfg)
    mha.load_flax_params(mod, _tree_np(variables["params"]))
    _assert_match(_port_grads(mod, [q, k], g, is_training=False),
                  _jax_grads(jmod, variables, [q, k], g, is_training=False))


class _KeyRecorder:
    """Wraps the JAX module's flash_attention to record the dropout key
    flax derived (``make_rng("dropout")``)."""

    def __init__(self, monkeypatch):
        self.keys = []
        real = jax_mha.flash_attention

        def flash(*args, **kw):
            self.keys.append(kw.get("dropout_key"))
            return real(*args, **kw)

        monkeypatch.setattr(jax_mha, "flash_attention", flash)

    def seed(self) -> int:
        assert len(self.keys) >= 1 and self.keys[0] is not None
        return int(_dropout_seed(self.keys[0]))


@pytest.mark.parametrize("module", ["self", "encdec"])
def test_flash_dropout_keep_mask_matches_jax(module, monkeypatch):
    """At dropout 0.25 in training, the port with the JAX key's uint32
    seed drops exactly the probabilities JAX's kernels drop: output and
    grads within fp32 rounding (a different mask would be O(1) off)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((S, B, H)).astype(np.float32)
    k = rng.standard_normal((SK, B, H)).astype(np.float32)
    g = rng.standard_normal((S, B, H)).astype(np.float32)
    inputs = [x] if module == "self" else [x, k]
    jcls = (jax_mha.SelfMultiheadAttn if module == "self"
            else jax_mha.EncdecMultiheadAttn)
    pcls = (mha.SelfMultiheadAttn if module == "self"
            else mha.EncdecMultiheadAttn)
    jmod = jcls(H, HEADS, dropout=0.25, include_norm_add=True)
    variables = jmod.init(jax.random.PRNGKey(3),
                          *[jnp.asarray(t) for t in inputs],
                          is_training=False)
    recorder = _KeyRecorder(monkeypatch)
    key = jax.random.PRNGKey(9)

    def f(params, *xs):
        return jmod.apply({"params": params}, *xs, is_training=True,
                          rngs={"dropout": key})

    with pallas_config.force("interpret"):
        out, vjp = jax.vjp(f, variables["params"],
                           *[jnp.asarray(t) for t in inputs])
        cot = vjp(jnp.asarray(g))
    mod = pcls(H, HEADS, dropout=0.25, include_norm_add=True, device="cpu")
    mha.load_flax_params(mod, _tree_np(variables["params"]))
    got_out, grads = _port_grads(mod, inputs, g, is_training=True,
                                 dropout_key=recorder.seed())
    ref_grads = {".".join(k_.key for k_ in path): np.asarray(v)
                 for path, v in jax.tree_util.tree_flatten_with_path(
                     cot[0])[0]}
    ref_grads.update({f"in{i}": np.asarray(c)
                      for i, c in enumerate(cot[1:])})
    _assert_match((got_out, grads), (np.asarray(out), ref_grads))
    # and dropout did act: eval mode differs
    with torch.no_grad():
        eval_out = mod(*[torch.from_numpy(t) for t in inputs],
                       is_training=False)
    assert float(np.abs(eval_out.numpy() - got_out).max()) > 1e-3


@pytest.mark.parametrize("pad", ["key_padding", "score_mask", "additive",
                                 "none"])
def test_mask_softmax_dropout_matches_jax(pad):
    """Forward and gradient at dropout 0, through the function and the
    Function-shaped class."""
    rng = np.random.default_rng(3)
    x = (2 * rng.standard_normal((B * HEADS, S, SK))).astype(np.float32)
    g = rng.standard_normal((B * HEADS, S, SK)).astype(np.float32)
    lens = np.array([SK, 15])
    kpm = (np.arange(SK)[None, :] >= lens[:, None])[:, None, :]  # [b,1,sk]
    pm, additive = {
        "key_padding": (kpm, False),
        "score_mask": (np.triu(np.ones((S, SK), bool), k=3), False),
        "additive": (np.where(kpm, -1e9, 0.0).astype(np.float32), True),
        "none": (None, False)}[pad]

    def jf(x):
        return jax_mha.mask_softmax_dropout(
            x, None if pm is None else jnp.asarray(pm), heads=HEADS,
            mask_additive=additive)

    ref, vjp = jax.vjp(jf, jnp.asarray(x))
    (ref_g,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = mha.MaskSoftmaxDropout()(True, HEADS, xt,
                                   None if pm is None else
                                   torch.from_numpy(pm), additive, 0.0)
    (got_g,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(ref_g), atol=1e-6,
                               rtol=1e-5)
    direct = mha.mask_softmax_dropout(
        xt.detach(), None if pm is None else torch.from_numpy(pm),
        heads=HEADS, mask_additive=additive)
    torch.testing.assert_close(direct, got.detach(), rtol=0, atol=0)


def test_masked_dropout_statistics():
    """Inverted dropout on the masked path, by the reference's own
    statistics: over 2 x 4 x 64 x 64 probabilities at p = 0.3 the kept
    share is 0.7 within 5 binomial standard deviations, each kept value
    is the undropped one times 1/(1 - p), the row sums average 1, and a
    seed gives the same mask again, another seed another mask."""
    p = 0.3
    x = torch.randn(2 * 4, 64, 64, generator=torch.Generator().manual_seed(0))
    kpm = torch.zeros(2, 1, 64, dtype=torch.bool)
    kpm[1, :, 40:] = True
    base = mha.mask_softmax_dropout(x, kpm, heads=4)
    dropped = mha.mask_softmax_dropout(x, kpm, heads=4, dropout_prob=p,
                                       dropout_key=11)
    again = mha.mask_softmax_dropout(x, kpm, heads=4, dropout_prob=p,
                                     dropout_key=11)
    other = mha.mask_softmax_dropout(x, kpm, heads=4, dropout_prob=p,
                                     dropout_key=12)
    assert torch.equal(dropped, again) and not torch.equal(dropped, other)
    live = base > 0
    kept = (dropped > 0) & live
    n = int(live.sum())
    share = float(kept.sum()) / n
    assert abs(share - (1 - p)) < 5 * ((p * (1 - p) / n) ** 0.5)
    torch.testing.assert_close(dropped[kept], base[kept] / (1 - p))
    assert float(dropped[~kept].abs().max()) == 0.0
    assert abs(float(dropped.sum(-1).mean()) - 1.0) < 0.02
    with pytest.raises(ValueError, match="dropout_key"):
        mha.mask_softmax_dropout(x, kpm, heads=4, dropout_prob=p)
    # eval: no dropout whatever the probability
    torch.testing.assert_close(
        mha.mask_softmax_dropout(x, kpm, heads=4, dropout_prob=p,
                                 is_training=False), base)


def test_masked_path_dropout_in_the_module():
    """The module's masked path in training: a seed repeats its output,
    another seed moves it, eval mode ignores the dropout."""
    mod = mha.SelfMultiheadAttn(H, HEADS, dropout=0.4, device="cpu")
    x = torch.randn(S, B, H, generator=torch.Generator().manual_seed(4))
    pad = torch.zeros(B, S, dtype=torch.bool)
    pad[:, -4:] = True
    with torch.no_grad():
        t1 = mod(x, key_padding_mask=pad, dropout_key=2)
        t1b = mod(x, key_padding_mask=pad,
                  dropout_key=torch.Generator().manual_seed(2))
        t2 = mod(x, key_padding_mask=pad, dropout_key=3)
        ev = mod(x, key_padding_mask=pad, is_training=False)
    torch.testing.assert_close(t1, t1b, rtol=0, atol=0)
    assert float((t1 - t2).abs().max()) > 1e-5
    assert float((t1 - ev).abs().max()) > 1e-5
    with pytest.raises(ValueError, match="dropout_key"):
        mod(x, key_padding_mask=pad)


def test_load_flax_params_checks_names_and_entry_points_need_a_gpu(
        monkeypatch):
    mod = mha.SelfMultiheadAttn(H, HEADS, device="cpu")
    with pytest.raises(RuntimeError, match="Missing key"):
        mha.load_flax_params(mod, {"qkv_proj": {
            "kernel": np.zeros((H, 3 * H), np.float32)}})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mha.SelfMultiheadAttn(H, HEADS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mha.EncdecMultiheadAttn(H, HEADS)


@pytest.mark.parametrize("elsewhere", [False, True])
def test_inverted_dropout_draws_on_the_probs_device(monkeypatch, elsewhere):
    """The masked path's keep mask is drawn on the probabilities' device:
    from a ``dropout_key`` generator itself when it lies there, else
    from a generator there seeded with one draw of it (forced here by
    making the CPU generator count as lying elsewhere), never drawn on
    another device and copied over."""
    from apex_tpu_torch import _device

    p = 0.25
    probs = torch.rand(2, 4, 8, 8, generator=torch.Generator().manual_seed(0))
    if elsewhere:
        monkeypatch.setattr(_device, "_same", lambda a, b: False)
    got = mha._inverted_dropout(probs, p, torch.Generator().manual_seed(5))
    key = torch.Generator().manual_seed(5)
    if elsewhere:
        key = torch.Generator().manual_seed(int(torch.randint(
            0, 2 ** 63 - 1, (), generator=key)))
    keep = torch.rand(probs.shape, generator=key) < 1.0 - p
    torch.testing.assert_close(
        got, torch.where(keep, probs / (1.0 - p), torch.zeros_like(probs)),
        rtol=0, atol=0)

