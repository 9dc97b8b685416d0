"""GPT-2 and BERT tensor parallelism in the port (``tp_axis`` through
``models/_common.py``, ``gpt2.py``, ``bert.py``; ``param_specs``;
``examples/gpt2_train.py``) held against the JAX package's.

The port runs ``tiny()`` (fp32) on 2 gloo CPU ranks at tp 2
(``tests/torch_cp_suites.py::suite_tp_models``): each rank's loss against
the reference's tp loss under ``shard_map``, with the full and the
chunked head; each rank's shard gradients against its block of
``jax.grad`` of the single-device loss (each rank's autograd gives the
true gradient of its shards and of the replicated leaves); each rank's
shards after one ``train_step`` (tree ``fused_adam``) against its block
of the reference's Adam step applied to the port's own gradients from
the same params (Adam at eps 1e-8 turns a gradient's rounding into an
update up to lr / eps times larger where |g| is near 0, so the step is
held on the same gradients, as ``test_torch_megatron_llama.py`` holds
its steps). Tolerance: 1e-5 of each array's largest value (fp32).
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from apex_tpu.models import bert as jbert
from apex_tpu.models import gpt2 as jgpt2
from apex_tpu.optimizers import fused_adam as jfused_adam
from apex_tpu_torch.models import bert as port_bert
from apex_tpu_torch.models import gpt2 as port_gpt2
from torch_dist_worker import ROOT, run_ranks

TP = 2
TOL = 1e-5
LR = 1e-3
B, S = 2, 16
MODELS = {"gpt2": jgpt2, "bert": jbert}


def _close(got, want, what, tol=TOL):
    want = np.asarray(want, np.float32)
    err = float(np.max(np.abs(np.asarray(got, np.float32) - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= tol * max(scale, 1e-30), f"{what}: {err} > {tol} x {scale}"


def _flat_params(params, prefix):
    flat = {}
    for k, v in params.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                flat[f"{prefix}p.{k}.{kk}"] = np.asarray(vv)
        else:
            flat[f"{prefix}p.{k}"] = np.asarray(v)
    return flat


@functools.lru_cache(maxsize=None)
def _setup():
    params = {name: m.init_params(jax.random.PRNGKey(i), m.tiny())
              for i, (name, m) in enumerate(MODELS.items())}
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int64)
    pad = np.zeros((B, S), bool)
    pad[1, 11:] = True
    data = {"tokens": tokens,
            "bert_targets": rng.integers(0, 256, (B, S)).astype(np.int64),
            "bert_loss_mask": (rng.random((B, S)) < 0.3).astype(np.float32),
            "bert_pad_mask": pad}
    return params, data


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory):
    params, data = _setup()
    inputs = dict(data)
    for name, p in params.items():
        inputs.update(_flat_params(p, name + "_"))
    return run_ranks("tp_models", TP, tmp_path_factory.mktemp("tp"), inputs)


def _batch(name, data):
    tok = jnp.asarray(data["tokens"])
    if name == "gpt2":
        return (tok, jnp.roll(tok, -1, axis=-1)), {}
    return ((tok, jnp.asarray(data["bert_targets"]),
             jnp.asarray(data["bert_loss_mask"])),
            {"pad_mask": jnp.asarray(data["bert_pad_mask"])})


def _leaves(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _specs(name):
    specs = MODELS[name].param_specs(MODELS[name].tiny())
    return {k: tuple(v) for k, v in _leaves(jax.tree_util.tree_map(
        lambda s: np.array(tuple(s), dtype=object), specs,
        is_leaf=lambda s: isinstance(s, P))).items()}


def _block(full, spec, t):
    out = full
    for dim, axis in enumerate(spec):
        if axis == "tp":
            size = full.shape[dim] // TP
            out = np.take(out, np.arange(t * size, (t + 1) * size), axis=dim)
    return out


@functools.lru_cache(maxsize=None)
def _reference(name, chunks):
    """The reference's tp loss under shard_map, and the single-device
    loss's value and gradients."""
    m = MODELS[name]
    cfg = m.tiny()
    params, data = _setup()
    batch, kw = _batch(name, data)
    mesh = Mesh(np.array(jax.devices()[:TP]), ("tp",))
    tp_loss = jax.jit(shard_map(
        lambda p, b, k: m.loss_fn(p, b, cfg, tp_axis="tp",
                                  vocab_chunks=chunks, **k),
        mesh=mesh, in_specs=(m.param_specs(cfg), P(), P()),
        out_specs=P()))(params[name], batch, kw)
    loss, grads = jax.value_and_grad(
        lambda p: m.loss_fn(p, batch, cfg, tp_axis=None,
                            vocab_chunks=chunks, **kw))(params[name])
    return float(tp_loss), float(loss), _leaves(grads), grads


@pytest.mark.parametrize("chunks", [None, 4], ids=["head", "chunked"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_tp_loss_and_grads_match_reference(tp_ranks, name, chunks):
    tp_loss, loss, grads, _ = _reference(name, chunks)
    np.testing.assert_allclose(tp_loss, loss, rtol=TOL)
    specs = _specs(name)
    tag = f"{name}_{chunks or 0}"
    for t, res in enumerate(tp_ranks):
        np.testing.assert_allclose(res[f"{tag}_loss"], tp_loss, rtol=TOL)
        for key, g in grads.items():
            _close(res[f"{tag}_g.{key}"], _block(g, specs[key], t),
                   f"{tag} rank {t} {key}")


def _assemble(ranks, prefix, key, spec):
    """The full leaf ``key`` from the ranks' blocks (replicated leaves:
    rank 0's)."""
    blocks = [res[f"{prefix}.{key}"] for res in ranks]
    dims = [d for d, axis in enumerate(spec) if axis == "tp"]
    return np.concatenate(blocks, axis=dims[0]) if dims else blocks[0]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_tp_train_step_matches_reference(tp_ranks, name):
    """Each rank's shards after one ``train_step``: its block of the
    reference's Adam step applied to the port's gradients (assembled
    from the ranks' blocks), from the same params."""
    params, _ = _setup()
    _, loss, _, _ = _reference(name, None)
    specs = _specs(name)
    grads = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params[name]),
        [jnp.asarray(_assemble(tp_ranks, f"{name}_0_g", key, specs[key]))
         for key in _leaves(params[name])])
    tx = jfused_adam(lr=LR)
    updates, _ = tx.update(grads, tx.init(params[name]), params[name])
    after = _leaves(jax.tree_util.tree_map(jnp.add, params[name], updates))
    for t, res in enumerate(tp_ranks):
        np.testing.assert_allclose(res[f"{name}_step_loss"], loss,
                                   rtol=TOL)
        for key, want in after.items():
            _close(res[f"{name}_stepped.{key}"],
                   _block(want, specs[key], t), f"{name} rank {t} {key}")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_param_specs_match_reference(name):
    port = {"gpt2": port_gpt2, "bert": port_bert}[name]
    got = port.param_specs(port.tiny())
    flat = {".".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(
                got, is_leaf=lambda x: isinstance(x, tuple))[0]}
    assert flat == _specs(name)
    if name == "bert":
        assert port.param_specs(port.tiny(), with_decoder_bias=True)[
            "mlm_decoder_bias"] == tuple(jbert.param_specs(
                jbert.tiny(), with_decoder_bias=True)["mlm_decoder_bias"])


def test_gpt2_train_step_matches_single_device(tp_ranks):
    """The example's step (``TensorParallelGPT2Step.grads`` at dp 1 x tp
    2, remat): the loss and the single-device gradients' blocks."""
    _, loss, grads, _ = _reference("gpt2", None)
    specs = _specs("gpt2")
    for t, res in enumerate(tp_ranks):
        np.testing.assert_allclose(res["ex_loss"], loss, rtol=TOL)
        for key, g in grads.items():
            _close(res[f"ex_g.{key}"], _block(g, specs[key], t),
                   f"example rank {t} {key}")


def test_gpt2_train_example_checkpoint_resume(tmp_path):
    """``multiproc --cpu`` runs the example at dp 2 x tp 2: its parity
    line and a falling loss; then 2 steps with checkpoints, resumed for
    the third, end where 3 uninterrupted steps do (each rank's last
    checkpoint equal leaf for leaf)."""
    import torch

    from apex_tpu_torch.checkpoint import restore_checkpoint

    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")

    def launch(*args):
        proc = subprocess.run(
            [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
             "--nprocs", "4", "--backend", "gloo", "--cpu",
             str(ROOT / "apex_tpu_torch" / "examples" / "gpt2_train.py"),
             "--dp", "2", "--tp", "2", "--save-every", "1", *args],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=240)
        assert proc.returncode == 0, (proc.stdout[-2000:]
                                      + proc.stderr[-2000:])
        return proc.stdout

    out = launch("--steps", "3", "--checkpoint-dir", str(tmp_path / "a"))
    assert "parity: sharded loss" in out and "OK" in out
    assert "(decreased)" in out
    launch("--steps", "2", "--checkpoint-dir", str(tmp_path / "b"))
    out = launch("--steps", "3", "--checkpoint-dir", str(tmp_path / "b"),
                 "--resume")
    assert "=> resumed from step 1" in out
    for r in range(4):
        a = restore_checkpoint(str(tmp_path / "a" / f"rank{r}"), step=2,
                               device="cpu")
        b = restore_checkpoint(str(tmp_path / "b" / f"rank{r}"), step=2,
                               device="cpu")
        fa = jax.tree_util.tree_leaves(a)
        fb = jax.tree_util.tree_leaves(b)
        assert len(fa) == len(fb) > 0
        for x, y in zip(fa, fb):
            assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_reference_example_gradients_carry_a_dp_factor():
    """The reference example's step (``examples/gpt2_train.py:66-82``) at
    dp 2 x tp 2 gives twice the single-device gradient of the global
    batch on every leaf: its params are cast varying over dp and tp
    (the casts' transposes already sum over dp), and the dp ``pmean``
    of the summed gradient keeps the sum. The port's example gives the
    gradient itself (``test_gpt2_train_step_matches_single_device``);
    ROADMAP Queue 3 logs the factor."""
    from apex_tpu.transformer.tensor_parallel.mappings import _to_varying

    dp, tp = 2, 2
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(dp, tp), ("dp", "tp"))
    cfg = jgpt2.tiny(num_layers=2, num_heads=2 * tp, hidden_size=32 * tp,
                     vocab_size=128 * tp, max_seq_len=32)
    params = jgpt2.init_params(jax.random.PRNGKey(0), cfg)
    specs = jgpt2.param_specs(cfg)
    tok = jax.random.randint(jax.random.PRNGKey(1), (4 * dp, 32), 0,
                             cfg.vocab_size)
    tgt = jnp.roll(tok, -1, axis=-1)

    def pmean(t, ax):
        return jax.lax.pmean(_to_varying(t, ax), ax)

    def step(params, tokens, targets):
        def loss_fn(params):
            vary = params
            for ax in ("dp", "tp"):
                vary = jax.tree_util.tree_map(
                    lambda a, ax=ax: _to_varying(a, ax), vary)
            return jgpt2.loss_fn(vary, (tokens, targets), cfg, tp_axis="tp")
        grads = jax.grad(loss_fn)(params)
        grads = jax.tree_util.tree_map(lambda g: pmean(g, "dp"), grads)
        return jax.tree_util.tree_map(
            lambda g, s: g if "tp" in s else pmean(g, "tp"), grads, specs)

    got = jax.jit(shard_map(step, mesh=mesh,
                            in_specs=(specs, P("dp", None), P("dp", None)),
                            out_specs=specs))(params, tok, tgt)
    ref = jax.grad(lambda p: jgpt2.loss_fn(p, (tok, tgt), cfg,
                                           tp_axis=None))(params)
    for key, g in _leaves(got).items():
        _close(g, dp * _leaves(ref)[key], f"reference example {key}")
