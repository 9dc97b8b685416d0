"""The port's context parallelism (``apex_tpu_torch.transformer.
context_parallel``, Llama's ``cp_axis``, ``examples/long_context.py``)
held against the JAX package's.

The port runs on 2 and 4 gloo CPU ranks (``tests/torch_cp_suites.py``);
the reference under ``shard_map`` on the conftest's simulated devices.
``ring_attention`` is held against both of the reference's rings: its
flash ring (``_ring_flash``, the Pallas kernels in interpret mode) and
its jnp online-softmax ring (Pallas off), outputs and dq, dk, dv, causal
and not, MHA and GQA (the port's ring is always the flash ring, on the
CPU the kernels' plain versions). Llama ``tiny()`` at cp 2 and at
tp 2 x cp 2: each rank's loss against the reference's per-rank loss,
and the mean of the ranks' gradients (the long-context example's
reduction) against ``jax.grad`` of the single-device loss. Tolerance:
1e-5 of each array's largest value (fp32).
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

from apex_tpu.models import llama as jllama
from apex_tpu.ops import pallas_config
from apex_tpu.transformer import context_parallel as jcp
from torch_cp_suites import RING_CASES
from torch_dist_worker import ROOT, run_ranks

B, S, H, D = 2, 16, 4, 8
TOL = 1e-5
SEQ = 32


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    err = float(np.max(np.abs(np.asarray(got, np.float32) - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= TOL * max(scale, 1e-30), f"{what}: {err} > {TOL} x {scale}"


def _ring_inputs():
    rng = np.random.default_rng(0)
    out = {}
    for name, (_, kv_div) in RING_CASES.items():
        for t, heads in (("q", H), ("k", H // kv_div), ("v", H // kv_div),
                         ("do", H)):
            out[f"{name}_{t}"] = rng.standard_normal(
                (B, S, heads, D)).astype(np.float32)
    for t in ("q", "k", "v", "do"):
        out[f"ulysses_{t}"] = rng.standard_normal((B, S, H, D)).astype(
            np.float32)
    out["split_x"] = rng.standard_normal((B, S, D)).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["cp2", "cp4"])
def ring_ranks(request, tmp_path_factory):
    inputs = _ring_inputs()
    n = request.param
    ranks = run_ranks("cp_ring", n, tmp_path_factory.mktemp(f"ring{n}"),
                      inputs)
    return n, inputs, ranks


def _mesh(n, names=("cp",)):
    return Mesh(np.array(jax.devices()[:n]), names)


def _reference_ring(n, inputs, name, mode):
    causal, _ = RING_CASES[name]
    q, k, v, do = (jnp.asarray(inputs[f"{name}_{t}"])
                   for t in ("q", "k", "v", "do"))
    spec = P(None, "cp")
    fn = shard_map(functools.partial(jcp.ring_attention, causal=causal),
                   mesh=_mesh(n), in_specs=(spec,) * 3, out_specs=spec,
                   check_vma=mode == "off")
    with pallas_config.force(mode):
        return _jit_vjp(fn)(q, k, v, do)


def _jit_vjp(fn):
    """``fn``'s output and its inputs' cotangents for ``do``, jitted."""
    def run(q, k, v, do):
        o, vjp = jax.vjp(fn, q, k, v)
        return (o, *vjp(do))
    return jax.jit(run)


def _block(a, r, n, dim=1):
    a = np.asarray(a)
    size = a.shape[dim] // n
    return np.take(a, np.arange(r * size, (r + 1) * size), axis=dim)


@pytest.mark.parametrize("mode", ["interpret", "off"],
                         ids=["flash_ring", "jnp_ring"])
@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_attention_matches_reference(ring_ranks, name, mode):
    n, inputs, ranks = ring_ranks
    want = _reference_ring(n, inputs, name, mode)
    for r, res in enumerate(ranks):
        for t, w in zip(("o", "dq", "dk", "dv"), want):
            _close(res[f"{name}_{t}"], _block(w, r, n),
                   f"cp{n} {name} {mode} rank {r} {t}")


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_attention_matches_reference(ring_ranks, causal):
    n, inputs, ranks = ring_ranks
    q, k, v, do = (jnp.asarray(inputs[f"ulysses_{t}"])
                   for t in ("q", "k", "v", "do"))
    spec = P(None, "cp")
    fn = shard_map(functools.partial(jcp.ulysses_attention, causal=causal),
                   mesh=_mesh(n), in_specs=(spec,) * 3, out_specs=spec)
    want = _jit_vjp(fn)(q, k, v, do)
    for r, res in enumerate(ranks):
        for t, w in zip(("o", "dq", "dk", "dv"), want):
            _close(res[f"ulysses_{int(causal)}_{t}"], _block(w, r, n),
                   f"ulysses cp{n} rank {r} {t}")


def test_split_gather_round_trip_and_positions(ring_ranks):
    n, inputs, ranks = ring_ranks
    x = inputs["split_x"]
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["split_local"], _block(x, r, n))
        np.testing.assert_array_equal(res["split_gathered"], x)
        np.testing.assert_array_equal(
            res["positions"], np.arange(r * S // n, (r + 1) * S // n))


# ------------------------------------------------------------- llama


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
def _llama_setup():
    cfg = jllama.tiny()
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1),
                                           (2, SEQ), 0, cfg.vocab_size))
    return cfg, params, tokens


@pytest.fixture(scope="module", params=[2, 4], ids=["cp2", "tp2xcp2"])
def llama_ranks(request, tmp_path_factory):
    _, params, tokens = _llama_setup()
    n = request.param
    inputs = dict(_flat_params(params, "llama_"), tokens=tokens)
    return n, run_ranks("cp_llama", n, tmp_path_factory.mktemp(f"ll{n}"),
                        inputs)


@functools.lru_cache(maxsize=None)
def _reference_llama(cp):
    """The reference's per-rank losses at cp ``cp`` (its ring under
    shard_map, Pallas off: the jnp ring) and its single-device loss and
    gradients on the whole sequence."""
    cfg, params, tokens = _llama_setup()
    tok = jnp.asarray(tokens)
    tgt = jnp.roll(tok, -1, axis=-1)
    per_rank = jax.jit(shard_map(
        lambda p, t, g: jllama.loss_fn(p, (t, g), cfg, tp_axis=None,
                                       cp_axis="cp")[None],
        mesh=_mesh(cp), in_specs=(P(), P(None, "cp"), P(None, "cp")),
        out_specs=P("cp")))(params, tok, tgt)
    loss, grads = jax.value_and_grad(
        lambda p: jllama.loss_fn(p, (tok, tgt), cfg, tp_axis=None,
                                 cp_axis=None))(params)
    return (np.asarray(per_rank), float(loss),
            jax.tree_util.tree_map(np.asarray, grads))


def _leaf(tree, key):
    node = tree
    for part in key.split("."):
        node = node[part]
    return np.asarray(node)


def _tp_block(full, spec, t):
    out = full
    for dim, axis in enumerate(spec):
        if axis == "tp":
            size = full.shape[dim] // 2
            out = np.take(out, np.arange(t * size, (t + 1) * size),
                          axis=dim)
    return out


def test_llama_cp_loss_and_grads_match_reference(llama_ranks):
    n, ranks = llama_ranks
    tp = 2 if n == 4 else 1
    cp = n // tp
    per_rank, _, grads = _reference_llama(cp)
    specs = jllama.param_specs(jllama.tiny())
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["loss"], per_rank[r // tp],
                                   rtol=TOL)
    keys = [k[2:] for k in ranks[0] if k.startswith("g.")]
    assert len(keys) == len(jax.tree_util.tree_leaves(grads))
    for key in keys:
        node = specs
        for part in key.split("."):
            node = node[part]
        want_full = _leaf(grads, key)
        for t in range(tp):
            # the mean over the cp ranks of this tp rank's gradient
            got = np.mean([ranks[c * tp + t][f"g.{key}"]
                           for c in range(cp)], axis=0)
            want = _tp_block(want_full, tuple(node), t) if tp > 1 \
                else want_full
            _close(got, want, f"{n} ranks grad {key} tp {t}")
    if tp == 1:
        # the example's step (``ContextParallelStep.grads``): the reduced
        # loss and gradients are the single-device ones of the batch
        _, loss, _ = _reference_llama(cp)
        for res in ranks:
            np.testing.assert_allclose(res["ex_loss"], loss, rtol=TOL)
            for key in keys:
                _close(res[f"ex_g.{key}"], _leaf(grads, key),
                       f"example {key}")


def test_long_context_example_on_cpu_ranks(tmp_path):
    """``multiproc --cpu`` runs the example: its parity line and a loss
    that falls."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    proc = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
         "--nprocs", "4", "--backend", "gloo", "--cpu",
         str(ROOT / "apex_tpu_torch" / "examples" / "long_context.py"),
         "--cp", "2", "--dp", "2", "--seq", "64", "--batch", "2",
         "--steps", "3"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "parity: sharded loss" in proc.stdout and "OK" in proc.stdout
    assert "(decreased)" in proc.stdout
