"""The port's expert parallelism (``moe.expert_parallel_apply`` with a
bound ``ep_axis``, Llama's ``ep_axis``, ``examples/moe_train.py``) held
against the JAX package's.

The port runs on 2 and 4 gloo CPU ranks (``tests/torch_cp_suites.py``),
tokens and experts split over ep. Outputs and aux against the
reference's ``moe_mlp`` under ``shard_map`` with ``ep_axis`` bound
(``tests/run_transformer/test_moe.py:121-144``); gradients against
``jax.grad`` of the same sum on one device, each rank's token shard
routed on its own (the ep path routes each rank's tokens with that
rank's capacity, so the two are the same function): one expert a rank,
two a rank, and a binding capacity that drops tokens. The all-to-all's
gradient (the inverse all-to-all) is what carries the expert gradients
home. Tolerance: 1e-5 of each array's largest value (fp32).
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
from apex_tpu.transformer import moe as jmoe
from torch_dist_worker import ROOT, run_ranks

TOL = 1e-5
ROWS = 8  # tokens a rank
H = 16


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    err = float(np.max(np.abs(np.asarray(got, np.float32) - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= TOL * max(scale, 1e-30), f"{what}: {err} > {TOL} x {scale}"


def _cases(n):
    """name -> (experts, top_k, capacity_factor): one and two experts a
    rank with room for every token (E / k), and two a rank at a binding
    capacity."""
    return {"one": (n, 2, n / 2), "two": (2 * n, 2, float(n)),
            "binding": (2 * n, 2, 1.0)}


def _cfg(e, k, cf):
    return jmoe.MoEConfig(hidden_size=H, ffn_hidden_size=2 * H,
                          num_experts=int(e), top_k=int(k),
                          capacity_factor=cf)


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
def _inputs(n):
    out = {"moe_cases": np.array(sorted(_cases(n)))}
    for i, (name, c) in enumerate(sorted(_cases(n).items())):
        params = jmoe.init_moe_params(jax.random.PRNGKey(10 + i), _cfg(*c))
        out[f"{name}_cfg"] = np.array(c, np.float64)
        for key, v in params.items():
            out[f"{name}_{key}"] = np.asarray(v)
        rng = np.random.default_rng(i)
        out[f"{name}_x"] = rng.standard_normal((ROWS * n, H)).astype(
            np.float32)
        out[f"{name}_ct"] = rng.standard_normal((ROWS * n, H)).astype(
            np.float32)
    if n == 2:
        cfg = jllama.tiny(num_experts=4)
        out.update(_flat_params(jllama.init_params(jax.random.PRNGKey(0),
                                                   cfg), "llama_"))
        out["tokens"] = np.asarray(jax.random.randint(
            jax.random.PRNGKey(1), (2, 16), 0, cfg.vocab_size))
        ex = jmoe.init_moe_params(jax.random.PRNGKey(3),
                                  _cfg(2 * n, 2, 2.0))
        for key, v in ex.items():
            out[f"ex_{key}"] = np.asarray(v)
        out["ex_x"] = np.random.default_rng(9).standard_normal(
            (16 * n, H)).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["ep2", "ep4"])
def ep_ranks(request, tmp_path_factory):
    n = request.param
    return n, run_ranks("ep_moe", n, tmp_path_factory.mktemp(f"ep{n}"),
                        _inputs(n))


def _shards(x, n):
    return [x[r * (x.shape[0] // n):(r + 1) * (x.shape[0] // n)]
            for r in range(n)]


def _check_margin(params, xs, k):
    """Routing must not sit on a tie: each token's k largest router
    logits (and the next, where there is one) at least 1e-5 apart, so
    the choices and their order are the same on both sides."""
    logits = np.asarray(xs, np.float32) @ np.asarray(params["router"])
    top = np.sort(logits, axis=-1)[:, -min(k + 1, logits.shape[-1]):]
    assert float(np.min(np.diff(top, axis=-1))) >= 1e-5


@pytest.mark.parametrize("case", ["one", "two", "binding"])
def test_moe_mlp_matches_reference(ep_ranks, case):
    n, ranks = ep_ranks
    inp = _inputs(n)
    cfg = _cfg(*inp[f"{case}_cfg"])
    params = {key: jnp.asarray(inp[f"{case}_{key}"])
              for key in ("router", "wi", "wo")}
    x, ct = inp[f"{case}_x"], inp[f"{case}_ct"]
    _check_margin(params, x, cfg.top_k)
    mesh = Mesh(np.array(jax.devices()[:n]), ("ep",))
    y, aux = jax.jit(shard_map(
        lambda p, xx: (lambda yy, a: (yy, a[None]))(
            *jmoe.moe_mlp(p, xx, cfg, ep_axis="ep")),
        mesh=mesh, in_specs=(jmoe.moe_param_specs(cfg), P("ep", None)),
        out_specs=(P("ep", None), P("ep"))))(params, jnp.asarray(x))

    def total(p):
        out = 0.0
        for xs, cs in zip(_shards(x, n), _shards(ct, n)):
            yy, a = jmoe.moe_mlp(p, jnp.asarray(xs), cfg, ep_axis=None)
            out = out + jnp.sum(yy * cs) + a
        return out

    grads = jax.jit(jax.grad(total))(params)
    dropped = []
    for r, res in enumerate(ranks):
        _close(res[f"{case}_y"], _shards(np.asarray(y), n)[r],
               f"ep{n} {case} y rank {r}")
        np.testing.assert_allclose(res[f"{case}_aux"], np.asarray(aux)[r],
                                   rtol=TOL)
        dropped.append(float(res[f"{case}_dropped"]))
        for key in ("wi", "wo"):
            _close(res[f"{case}_g_{key}"], _shards(np.asarray(grads[key]),
                                                   n)[r],
                   f"ep{n} {case} d{key} rank {r}")
    _close(np.sum([res[f"{case}_g_router"] for res in ranks], axis=0),
           grads["router"], f"ep{n} {case} drouter")
    assert (max(dropped) > 0) == (case == "binding"), dropped


@pytest.mark.parametrize("ep_ranks", [2], indirect=True,
                         ids=["ep2"])
def test_llama_moe_ep2_loss_and_grads_match_reference(ep_ranks):
    """Llama MoE ``tiny()`` at ep 2 (one sequence a rank, two experts a
    rank): each rank's loss is the reference's on its sequence, its
    expert gradients its block of the gradient of the ranks' summed
    losses, and the replicated leaves' gradients sum to it."""
    n, ranks = ep_ranks
    inp = _inputs(2)
    cfg = jllama.tiny(num_experts=4)
    params = jllama.init_params(jax.random.PRNGKey(0), cfg)
    tokens = jnp.asarray(inp["tokens"])

    def loss_of(p, r):
        tok = tokens[r:r + 1]
        return jllama.loss_fn(p, (tok, jnp.roll(tok, -1, axis=-1)), cfg,
                              tp_axis=None, cp_axis=None, ep_axis=None)

    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["llama_loss"],
                                   float(loss_of(params, r)), rtol=TOL)
    grads = jax.grad(lambda p: loss_of(p, 0) + loss_of(p, 1))(params)
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    for path, g in flat:
        key = ".".join(str(getattr(k, "key", k)) for k in path)
        g = np.asarray(g)
        if key.split(".")[-1] in ("wg", "wu", "wd"):  # [L, E, ...]
            for r, res in enumerate(ranks):
                _close(res[f"llama_g.{key}"], g[:, 2 * r:2 * r + 2],
                       f"llama {key} rank {r}")
        else:
            _close(ranks[0][f"llama_g.{key}"] + ranks[1][f"llama_g.{key}"],
                   g, f"llama {key}")


@pytest.mark.parametrize("ep_ranks", [2], indirect=True,
                         ids=["ep2"])
def test_moe_train_step_matches_single_device(ep_ranks):
    """The example's step (``ExpertParallelStep.grads``, dp 1 x ep 2):
    the global mean MSE and the gradients of the mean over the ranks'
    shards of MSE + aux."""
    n, ranks = ep_ranks
    inp = _inputs(2)
    cfg = _cfg(4, 2, 2.0)
    params = {key: jnp.asarray(inp[f"ex_{key}"])
              for key in ("router", "wi", "wo")}
    x = inp["ex_x"]

    def mean_loss(p, with_aux=True):
        out = 0.0
        for xs in _shards(x, n):
            xs = jnp.asarray(xs)
            y, aux = jmoe.moe_mlp(p, xs, cfg, ep_axis=None)
            out = out + jnp.mean((y - jnp.sin(3.0 * xs)) ** 2) + (
                aux if with_aux else 0.0)
        return out / n

    grads = jax.grad(mean_loss)(params)
    mse = float(mean_loss(params, with_aux=False))
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["ex_mse"], mse, rtol=TOL)
        _close(res["ex_g_router"], grads["router"], "example drouter")
        for key in ("wi", "wo"):
            _close(res[f"ex_g_{key}"], _shards(np.asarray(grads[key]), n)[r],
                   f"example d{key} rank {r}")


def test_moe_train_example_on_cpu_ranks(tmp_path):
    """``multiproc --cpu`` runs the example at dp 2 x ep 2: its parity
    line and an MSE that falls."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    proc = subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
         "--nprocs", "4", "--backend", "gloo", "--cpu",
         str(ROOT / "apex_tpu_torch" / "examples" / "moe_train.py"),
         "--dp", "2", "--ep", "2", "--steps", "6"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "parity: sharded loss" in proc.stdout and "OK" in proc.stdout
    assert "(decreased)" in proc.stdout


def test_reference_example_gradients_have_no_factor():
    """The reference example's step (``examples/moe_train.py:68-90``) at
    dp 2 x ep 2 gives the gradient of the mean over the token shards of
    MSE + aux exactly (its loss is pmean'd over both axes before the
    gradient), unlike the GPT-2 example's (ROADMAP Queue 3)."""
    from apex_tpu.transformer.tensor_parallel.mappings import make_varying

    dp = ep = 2
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(dp, ep), ("dp", "ep"))
    cfg = _cfg(2 * ep, 2, 2.0)
    params = jmoe.init_moe_params(jax.random.PRNGKey(0), cfg)
    x = jax.random.normal(jax.random.PRNGKey(2), (16 * dp * ep, H))
    target = jnp.sin(3.0 * x)

    def pmean(t, ax):
        return jax.lax.pmean(make_varying(t, ax), ax)

    def step(params, x, target):
        def loss_fn(params):
            vary = params
            for ax in ("dp", "ep"):
                vary = jax.tree_util.tree_map(
                    lambda a, ax=ax: make_varying(a, ax), vary)
            y, aux = jmoe.moe_mlp(vary, x, cfg, ep_axis="ep")
            mse = jnp.mean((y - target) ** 2)
            for ax in ("dp", "ep"):
                mse = jax.lax.pmean(mse, ax)
                aux = jax.lax.pmean(aux, ax)
            return mse + aux
        g = jax.grad(loss_fn)(params)
        return {"router": pmean(pmean(g["router"], "ep"), "dp"),
                "wi": pmean(g["wi"], "dp"), "wo": pmean(g["wo"], "dp")}

    specs = jmoe.moe_param_specs(cfg)
    got = jax.jit(shard_map(
        step, mesh=mesh, in_specs=(specs, P(("dp", "ep"), None),
                                   P(("dp", "ep"), None)),
        out_specs=specs))(params, x, target)

    def single(p):
        total = 0.0
        for xs, ts in zip(jnp.split(x, dp * ep), jnp.split(target, dp * ep)):
            y, aux = jmoe.moe_mlp(p, xs, cfg, ep_axis=None)
            total = total + jnp.mean((y - ts) ** 2) + aux
        return total / (dp * ep)

    ref = jax.grad(single)(params)
    for key in ("router", "wi", "wo"):
        _close(got[key], ref[key], f"reference example d{key}")
