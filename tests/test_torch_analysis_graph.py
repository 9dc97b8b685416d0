"""The port's ATen-graph checks on the CPU (``apex_tpu_torch.analysis.
graph_checks``, the counterpart of ``apex_tpu.analysis.jaxpr_checks``):
an aligned pair for each of ``donation``, ``recompile`` and
``pallas-block`` (a small JAX program with the hazard through
``apex_tpu.analysis``, its torch counterpart through the port, both
naming the id; a clean twin of each naming none); each hand-written
kernel as one graph node with its launch plan; and the Llama-3-8B-width
step at 4 layers holding exactly the kernel nodes the card launches
(9 RMSNorm forwards and backwards, 4 flash forwards, dq and dk/dv, 1
Adam)."""

import collections
import pathlib
import re

import jax
import jax.numpy as jnp
import pytest
import torch

from apex_tpu.analysis import jaxpr_checks as ref_checks
from apex_tpu_torch.analysis import graph_checks, interp, targets
from apex_tpu_torch.ops import (
    flash_attention,
    fp8_cast_kernel,
    fused_adam_kernel,
    kernel_config,
    kernel_nodes,
    layer_norm,
)
from apex_tpu_torch.transformer.functional import fused_softmax

CSRC = pathlib.Path(__file__).resolve().parents[1] / "apex_tpu_torch" / \
    "ops" / "csrc"


@pytest.fixture
def jax_graph_compat(monkeypatch):
    """The JAX package's graph engines name ``jax.core.Var``, a Pallas
    ``BlockMapping.array_shape_dtype`` and int block dims, which newer jax
    moved (``jax.extend.core``, ``array_aval``, ``Blocked``): alias them
    for this test."""
    import jax.extend.core as ext

    for name in ("Var", "ClosedJaxpr", "Jaxpr", "Literal", "JaxprEqn"):
        if not hasattr(jax.core, name):
            monkeypatch.setattr(jax.core, name, getattr(ext, name),
                                raising=False)
    from jax._src.pallas import core as pallas_core

    bm = pallas_core.BlockMapping
    if not hasattr(bm, "array_shape_dtype"):
        monkeypatch.setattr(bm, "array_shape_dtype",
                            property(lambda self: self.array_aval),
                            raising=False)
    if hasattr(pallas_core, "Blocked"):
        # block dims as the ints they were (Blocked(block_size=n) -> n)
        get = bm.__getattribute__

        def getattribute(self, name):
            value = get(self, name)
            if name == "block_shape":
                return tuple(getattr(d, "block_size", d) for d in value)
            return value
        monkeypatch.setattr(bm, "__getattribute__", getattribute)


def _ids(findings):
    return sorted({f.check for f in findings})


def _fake(make):
    return interp.on_trace_device(make)


# ------------------------------------------------- the JAX programs


def _alias_kernel(x_ref, o_ref):
    o_ref[...] = x_ref[...] * 2


def _aliased_call(x):
    from jax.experimental import pallas as pl

    return pl.pallas_call(
        _alias_kernel, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        input_output_aliases={0: 0})(x)


def _jax_donation(clean):
    def step(x):
        y = _aliased_call(x)
        return y if clean else y + x
    return ref_checks.analyze_fn(step, jnp.ones((8, 128)),
                                 donate_argnums=(0,), checks=("donation",))


def _jax_wasted(clean):
    def step(x, g):
        return (x + g,) if clean else (x[:4] + g[:4],)
    return ref_checks.analyze_fn(step, jnp.ones((8,)), jnp.ones((8,)),
                                 donate_argnums=(0,), checks=("donation",))


def _jax_scalar(clean):
    lr = jnp.asarray(1e-3, jnp.float32) if clean else 1e-3
    return ref_checks.analyze_fn(lambda x, lr: x * lr, jnp.ones((4,)), lr,
                                 checks=("recompile",))


def _jax_const(clean):
    table = jnp.arange(16 if clean else 4096, dtype=jnp.float32)
    return ref_checks.analyze_fn(lambda x: x + table[:4], jnp.ones((4,)),
                                 checks=("recompile",))


def _jax_block(clean):
    from jax.experimental import pallas as pl

    minor = 128 if clean else 100

    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] + 1

    def step(x):
        spec = pl.BlockSpec((8, minor), lambda i: (i, 0))
        return pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
            grid=(x.shape[0] // 8,), in_specs=[spec], out_specs=spec)(x)
    return ref_checks.analyze_fn(step, jnp.ones((64, 2 * minor)),
                                 checks=("pallas-block",))


def _jax_vmem(clean):
    from jax.experimental import pallas as pl

    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] + 1

    def step(x):
        spec = pl.BlockSpec((512, 1024), lambda i: (i, 0))
        return pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
            grid=(1,), in_specs=[spec], out_specs=spec)(x)
    return ref_checks.analyze_fn(
        step, jnp.ones((512, 1024)), checks=("pallas-block",),
        vmem_bytes=(64 if clean else 1) << 20)


# ----------------------------------------------- the torch programs


def _adam_args(dev):
    n = 4096
    return (torch.ones(n, device=dev), torch.zeros(n, device=dev),
            torch.zeros(n, device=dev), torch.zeros(n, device=dev))


def _adam(g, p, m, v):
    return fused_adam_kernel.adam_flat(
        g, p, m, v, 1e-3, 1.0, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
        adam_w_mode=True, bias_correction=True)


def _torch_donation(clean):
    def step(g, p, m, v):
        with torch.no_grad():
            if clean:
                norm = torch.linalg.vector_norm(m)
                delta, m, v = _adam(g, p, m, v)
                return delta, m, v, norm
            delta, m2, v = _adam(g, p, m, v)
            # m read after the kernel's output was copied into it
            return delta, m2, v, torch.linalg.vector_norm(m)
    return graph_checks.analyze_fn(step, *_fake(_adam_args),
                                   donate_argnums=(2,), checks=("donation",))


def _torch_wasted(clean):
    x, g = _fake(lambda dev: (torch.ones(8, device=dev),
                              torch.ones(8, device=dev)))

    def step(x, g):
        return (x + g,) if clean else (x[:4] + g[:4],)
    return graph_checks.analyze_fn(step, x, g, donate_argnums=(0,),
                                   checks=("donation",))


def _torch_scalar(clean):
    x, lr_t = _fake(lambda dev: (torch.ones(4, device=dev),
                                 torch.tensor(1e-3, device=dev)))
    return graph_checks.analyze_fn(lambda x, lr: x * lr, x,
                                   lr_t if clean else 1e-3,
                                   checks=("recompile",))


def _torch_const(clean):
    table = torch.arange(16 if clean else 4096, dtype=torch.float32)
    x = _fake(lambda dev: torch.ones(4, device=dev))
    return graph_checks.analyze_fn(lambda x: x + table[:4].to(x.device), x,
                                   checks=("recompile",))


def _torch_block(clean):
    h = 1024 if clean else 1001
    x, w, b = _fake(lambda dev: (
        torch.zeros((64, h), dtype=torch.bfloat16, device=dev),
        torch.ones(h, device=dev), torch.zeros(h, device=dev)))
    return graph_checks.analyze_fn(
        lambda x, w, b: layer_norm.layer_norm(x, w, b, (h,)), x, w, b,
        checks=("pallas-block",))


def _torch_smem(clean):
    q = _fake(lambda dev: torch.zeros((1, 128, 4, 128), dtype=torch.bfloat16,
                                      device=dev))
    budget = kernel_config.device_smem_bytes("h100" if clean else "v100")
    return graph_checks.analyze_fn(
        lambda q, k, v: flash_attention.flash_attention(q, k, v,
                                                        causal=True),
        q, q, q, checks=("pallas-block",), smem_bytes=budget)


PAIRS = {
    # (check, case): (JAX program, torch program)
    ("donation", "read-after-kernel-write"): (_jax_donation, _torch_donation),
    ("donation", "wasted"): (_jax_wasted, _torch_wasted),
    ("recompile", "python-scalar"): (_jax_scalar, _torch_scalar),
    ("recompile", "closed-over-constant"): (_jax_const, _torch_const),
    ("pallas-block", "row-alignment"): (_jax_block, _torch_block),
    ("pallas-block", "on-chip-memory"): (_jax_vmem, _torch_smem),
}


@pytest.mark.parametrize("clean", [False, True], ids=["hazard", "clean"])
@pytest.mark.parametrize("check,case", sorted(PAIRS))
def test_aligned_pair(jax_graph_compat, check, case, clean):
    jax_prog, torch_prog = PAIRS[(check, case)]
    want = [] if clean else [check]
    assert _ids(jax_prog(clean)) == want
    assert _ids(torch_prog(clean)) == want


def test_donation_names_the_kernel_and_the_reader():
    (f,) = _torch_donation(clean=False)
    assert f.severity == "error" and f.path == "<graph:step>"
    assert "kernel adam_flat's output, copied into it" in f.message
    assert "'aten::linalg_vector_norm'" in f.message


def test_flat_adam_step_donating_params_and_state_is_clean():
    assert targets.run_targets({"fused_adam_flat_step"}) == ([], {})


def test_smem_budget_off_the_card_is_the_h100_opt_in(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert kernel_config.device_smem_bytes() == 48 << 10
    assert graph_checks.smem_budget() == \
        kernel_config.device_smem_bytes("h100") == 232448
    assert graph_checks.smem_budget(1000) == 1000


def test_unknown_graph_check_raises():
    with pytest.raises(ValueError, match="collective-axis"):
        graph_checks.analyze_fn(lambda x: x, torch.ones(2),
                                checks=("collective-axis",))


# ------------------------------------------------------ kernel nodes


def _nodes(gm):
    return [(n.meta["kernel"], n.meta["plan"])
            for n in interp.kernel_nodes_of(gm)]


def test_each_kernel_entry_is_one_node_with_its_plan():
    def run(dev):
        x = torch.zeros((256, 1024), dtype=torch.bfloat16, device=dev)
        w = torch.ones(1024, device=dev)
        s = torch.zeros((4, 64, 64), dtype=torch.bfloat16, device=dev)
        long_row = torch.zeros((2, 4, 16400), dtype=torch.bfloat16,
                               device=dev)
        mask = torch.zeros((1, 64, 64), dtype=torch.bool, device=dev)
        return x, w, s, long_row, mask

    x, w, s, long_row, mask = _fake(run)

    def prog(x, w, s, long_row, mask):
        y = layer_norm.layer_norm(x, w, w, (1024,))
        r = layer_norm.rms_norm(x, w, (1024,))
        a = fused_softmax.scaled_upper_triang_masked_softmax(s, None, 0.5)
        b = fused_softmax.scaled_masked_softmax(s, mask, 0.5)
        c = fused_softmax.scaled_upper_triang_masked_softmax(long_row, None,
                                                             1.0)
        y8, _ = fp8_cast_kernel.cast_and_scale_stats(
            x, 2.0, torch.float8_e4m3fn, 448.0)
        t8, _ = fp8_cast_kernel.cast_and_scale_stats(
            x, 2.0, torch.float8_e4m3fn, 448.0, col_major=True)
        return y, r, a, b, c, y8, t8

    gm = interp.trace(prog, x, w, s, long_row, mask)
    got = _nodes(gm)
    assert [k for k, _ in got] == [
        "layer_norm_fwd", "rms_norm_fwd", "fused_softmax_causal",
        "fused_softmax_masked", "fused_softmax_stats", "fused_softmax_apply",
        "fp8_cast_scale", "fp8_cast_scale_t"]
    plans = dict(got)
    # the norms' plans are the launch's own plan functions'
    fwd = layer_norm._fwd_plan(256, 1024, torch.bfloat16)
    assert plans["layer_norm_fwd"] == dict(zip(
        kernel_nodes.PLAN_FIELDS,
        layer_norm.kernel_plan(fwd, 1024, torch.bfloat16)))
    row = fused_softmax._softmax_plan(64, torch.bfloat16)
    assert plans["fused_softmax_causal"]["row_threads"] == row.row_threads
    assert plans["fp8_cast_scale_t"]["threads"] == 256
    # the column-major cast's node keeps y's layout
    (t8,) = [n for n in interp.kernel_nodes_of(gm)
             if n.meta["kernel"] == "fp8_cast_scale_t"]
    y = [u for u in t8.users][0].meta["val"]
    assert y.stride() == (1, 256) and y.dtype == torch.float8_e4m3fn


def test_backward_kernels_are_nodes_and_the_plain_path_has_none():
    x, w = _fake(lambda dev: (torch.zeros((64, 512), device=dev),
                              torch.ones(512, device=dev)))

    def grads(x, w):
        x = x.detach().requires_grad_()
        w = w.detach().requires_grad_()
        y = layer_norm.rms_norm(x, w, (512,))
        return torch.autograd.grad(y.sum(), (x, w))

    assert [k for k, _ in _nodes(interp.trace(grads, x, w))] == [
        "rms_norm_fwd", "rms_norm_bwd"]
    # the plain versions where the mode says so: no kernel node
    with kernel_config.force("off"):
        assert _nodes(interp.trace(grads, x, w)) == []
    # outside the tracer a CPU tensor takes the plain version, counting
    # nothing
    before = layer_norm.launches
    grads(torch.randn(8, 512), torch.ones(512))
    assert layer_norm.launches == before


def test_kernel_op_raises_on_a_real_tensor():
    kernel_nodes._define()
    with pytest.raises(RuntimeError, match="only under the analysis tracer"):
        torch.ops.apex_tpu_torch.rms_norm_fwd(
            [torch.ones(2, 8)], [32, 32, 1, 2, 0, 8, 4], [1e-5],
            [0, 2, 2, 8, 0])


def test_flash_plans_mirror_the_compiled_kernels():
    """The flash nodes' shared memory is the CUDA sources' own formula:
    5, 6 and 6 swizzled 64-row tiles (+ lse/delta rings for dk/dv) and
    1 KiB of alignment, 81, 97 and 98 KB at head dim 128."""
    fwd = (CSRC / "flash_fwd.cu").read_text()
    bwd = (CSRC / "flash_bwd.cu").read_text()
    assert "return 5 * tile_bytes<D>() + 1024;" in fwd
    assert "return 6 * tile_bytes<D>() + 1024;" in bwd
    assert "return 6 * tile_bytes<D>() + 4 * kBQ * sizeof(float) + 1024;" \
        in bwd
    assert re.search(r"constexpr int kThreads = 128;",
                     (CSRC / "flash_tc.cuh").read_text())
    bf16 = torch.bfloat16
    assert [flash_attention._smem_bytes(e, 128, bf16) for e in (
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")] == [
            82944, 99328, 100352]
    q = torch.empty((2, 2048, 32, 128), dtype=bf16, device="meta")
    k = torch.empty((2, 2048, 8, 128), dtype=bf16, device="meta")
    plan = flash_attention.flash_plan("flash_bwd_dkv", q, k)
    assert (plan.threads, plan.rows_per_block, plan.blocks) == (
        128, 64, 2 * 8 * 32)


def test_llama_step_kernel_nodes_equal_the_cards_launches():
    counts = targets.llama_step_kernel_nodes(num_layers=4)
    L = 4
    assert counts == {"rms_norm_fwd": 2 * L + 1, "rms_norm_bwd": 2 * L + 1,
                      "flash_fwd": L, "flash_bwd_dq": L,
                      "flash_bwd_dkv": L, "adam_flat": 1}


def test_llama_step_plans_pass_the_block_check():
    from apex_tpu_torch.models import llama
    from apex_tpu_torch.optimizers import fused_adam

    cfg = llama.llama3_8b(num_layers=1)
    tx = fused_adam(lr=1e-4, flat=True)

    def make(dev):
        params = llama.init_params(torch.Generator().manual_seed(0), cfg,
                                   device=dev)
        tokens = torch.zeros((2, 2048), dtype=torch.long, device=dev)
        return params, tx.init(params), (tokens, tokens)

    params, state, batch = _fake(make)
    found = graph_checks.analyze_fn(
        lambda p, s, b: llama.train_step(p, s, b, cfg, tx, remat=False),
        params, state, batch, donate_argnums=(0, 1), name="llama_step")
    assert found == []
    gm = interp.trace(
        lambda p, s, b: llama.train_step(p, s, b, cfg, tx, remat=False),
        params, state, batch)
    by = collections.Counter(k for k, _ in _nodes(gm))
    assert by == {"rms_norm_fwd": 3, "rms_norm_bwd": 3, "flash_fwd": 1,
                  "flash_bwd_dq": 1, "flash_bwd_dkv": 1, "adam_flat": 1}
    for kernel, plan in _nodes(gm):
        if kernel.startswith("flash"):
            assert plan["smem_bytes"] <= graph_checks.smem_budget()
            assert plan["width"] == 128
