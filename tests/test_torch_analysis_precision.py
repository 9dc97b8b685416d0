"""The port's precision-flow checks on the CPU (``apex_tpu_torch.analysis.
precision_checks`` over ``dataflow``, the counterparts of the JAX
package's): an aligned pair for each of the seven ids (a small JAX program
with the hazard through ``apex_tpu.analysis``, its torch counterpart
through the port, both naming the id; a clean twin of each naming none),
the torch forms where the hazard differs (a half GEMM only while cuBLAS
may reduce in half precision, half atomics, the fp8 cast kernel's node),
and the registry counters."""

import jax
import jax.numpy as jnp
import pytest
import torch

from apex_tpu.analysis import precision_checks as ref
from apex_tpu_torch.analysis import interp, precision_checks as port
from apex_tpu_torch.observability.registry import MetricRegistry
from apex_tpu_torch.ops import fp8_cast_kernel
from apex_tpu_torch.ops.precision import matmul_fp32acc

BF16, F32, F8 = torch.bfloat16, torch.float32, torch.float8_e4m3fn
JBF16, JF32, JF8 = jnp.bfloat16, jnp.float32, jnp.float8_e4m3fn


@pytest.fixture
def jax_graph_compat(monkeypatch):
    """The JAX package's graph engines name ``jax.core.Var``, which newer
    jax moved to ``jax.extend.core``: alias it for this test."""
    import jax.extend.core as ext

    for name in ("Var", "ClosedJaxpr", "Jaxpr", "Literal", "JaxprEqn"):
        if not hasattr(jax.core, name):
            monkeypatch.setattr(jax.core, name, getattr(ext, name),
                                raising=False)


@pytest.fixture
def reduced_precision(monkeypatch):
    """cuBLAS may reduce a half GEMM's partial sums in half (torch's
    default), set here so the test does not depend on the default."""
    m = torch.backends.cuda.matmul
    monkeypatch.setattr(m, "allow_bf16_reduced_precision_reduction", True)
    monkeypatch.setattr(m, "allow_fp16_reduced_precision_reduction", True)


def _ids(findings):
    return sorted({f.check for f in findings})


def _fake(*shapes):
    """Fake tensors on the trace device, one per (shape, dtype)."""
    return interp.on_trace_device(lambda dev: tuple(
        torch.zeros(s, dtype=d, device=dev) for s, d in shapes))


# (check, case): (JAX program(clean) -> findings, torch program(clean))


def _jax_dot(clean):
    a, b = jnp.zeros((8, 16), JBF16), jnp.zeros((16, 4), JBF16)
    kw = {"preferred_element_type": JF32} if clean else {}
    return ref.analyze_precision(lambda a, b: jnp.dot(a, b, **kw), a, b)


def _torch_dot(clean):
    a, b = _fake(((8, 16), BF16), ((16, 4), BF16))
    fn = (lambda a, b: matmul_fp32acc(a, b)) if clean else torch.mm
    return port.analyze_precision(fn, a, b)


def _jax_sum(clean):
    x = jnp.zeros((64,), JBF16)
    if clean:  # jnp.sum upcasts a half operand: the idiomatic path
        return ref.analyze_precision(jnp.sum, x)
    return ref.analyze_precision(
        lambda x: jax.lax.reduce_sum_p.bind(x, axes=(0,)), x)


def _torch_index_add(clean):
    x, idx = interp.on_trace_device(lambda dev: (
        torch.zeros((64, 8), dtype=BF16, device=dev),
        torch.zeros(64, dtype=torch.long, device=dev)))

    def fn(x, idx):
        acc = torch.zeros((4, 8), dtype=F32 if clean else BF16,
                          device=x.device)
        return acc.index_add_(0, idx, x.to(acc.dtype))
    return port.analyze_precision(fn, x, idx)


def _jax_master_input(clean):
    m = jnp.zeros((8,), JF32 if clean else JBF16)
    return ref.analyze_precision(lambda m, g: m - 0.1 * g, m,
                                 jnp.zeros((8,), JF32), roles={0: "master"})


def _torch_master_input(clean):
    m, g = _fake(((8,), F32 if clean else BF16), ((8,), F32))
    return port.analyze_precision(lambda m, g: m - 0.1 * g, m, g,
                                  roles={0: "master"})


def _jax_master_touched(clean):
    m = jnp.zeros((8,), JF32)
    if clean:
        return ref.analyze_precision(lambda m: (m * 0.9).astype(JBF16), m,
                                     roles={0: "master"})
    return ref.analyze_precision(lambda m: m.astype(JBF16) * 0.9, m,
                                 roles={0: "master"})


def _torch_master_touched(clean):
    (m,) = _fake(((8,), F32))
    if clean:
        return port.analyze_precision(lambda m: (m * 0.9).to(BF16), m,
                                      roles={0: "master"})
    return port.analyze_precision(lambda m: m.to(BF16) * 0.9, m,
                                  roles={0: "master"})


def _jax_exp(clean):
    x = jnp.zeros((4, 8), JBF16)
    if clean:
        return ref.analyze_precision(
            lambda x: jnp.exp(x - jnp.max(x, axis=-1, keepdims=True)), x)
    return ref.analyze_precision(jnp.exp, x)


def _torch_exp(clean):
    (x,) = _fake(((4, 8), BF16))
    if clean:
        return port.analyze_precision(
            lambda x: torch.exp(x - torch.amax(x, -1, keepdim=True)), x)
    return port.analyze_precision(torch.exp, x)


def _jax_churn(clean):
    x = jnp.zeros((8,), JBF16)
    if clean:
        return ref.analyze_precision(
            lambda x: (x.astype(JF32) * 2).astype(JBF16), x)
    return ref.analyze_precision(lambda x: x.astype(JF32).astype(JBF16), x)


def _torch_churn(clean):
    (x,) = _fake(((8,), BF16))
    if clean:
        return port.analyze_precision(lambda x: (x.float() * 2).to(BF16), x)
    return port.analyze_precision(lambda x: x.float().to(BF16), x)


def _jax_bypass(clean):
    args = (jnp.zeros((8,), JF32), jnp.zeros((8,), JF32),
            jnp.ones((), JF32))
    if clean:
        return ref.analyze_precision(
            lambda m, g, s: m - 0.1 * (g * (1.0 / s)), *args,
            roles={0: "master", 1: "grad", 2: "scale"})
    return ref.analyze_precision(lambda m, g, s: m - 0.1 * g, *args,
                                 roles={0: "master", 1: "grad", 2: "scale"})


def _torch_bypass(clean):
    args = _fake(((8,), F32), ((8,), F32), ((), F32))
    roles = {0: "master", 1: "grad", 2: "scale"}
    if clean:
        return port.analyze_precision(
            lambda m, g, s: m - 0.1 * (g * (1.0 / s)), *args, roles=roles)
    return port.analyze_precision(lambda m, g, s: m - 0.1 * g, *args,
                                  roles=roles)


def _jax_fp8_unscaled(clean):
    a, b = jnp.zeros((8, 16), JBF16), jnp.zeros((16, 4), JBF16)
    state = jnp.ones((4,), JF32)

    def prog(a, b, state):
        s = (448.0 / jnp.maximum(jnp.max(state), 1e-6)) if clean else 1.0
        a8 = (a.astype(JF32) * s).astype(JF8)
        b8 = (b.astype(JF32) * s).astype(JF8)
        return jnp.matmul(a8, b8, preferred_element_type=JF32)
    return ref.analyze_precision(prog, a, b, state,
                                 roles={2: ("fp8_scale", "amax_hist")},
                                 checks=("fp8-unscaled",))


def _torch_fp8_unscaled(clean):
    a, b, state = _fake(((8, 16), BF16), ((16, 4), BF16), ((4,), F32))

    def prog(a, b, state):
        s = (448.0 / torch.clamp(torch.amax(state), min=1e-6)) if clean \
            else 1.0
        a8 = (a.float() * s).to(F8)
        b8 = (b.float() * s).to(F8)
        return torch.mm(a8.float(), b8.float())
    return port.analyze_precision(prog, a, b, state,
                                  roles={2: ("fp8_scale", "amax_hist")},
                                  checks=("fp8-unscaled",))


def _jax_stale(clean):
    a = jnp.zeros((8, 16), JBF16)
    roles = {1: ("fp8_scale", "amax_hist") if clean else "fp8_scale"}
    return ref.analyze_precision(
        lambda a, s: (a.astype(JF32) * s).astype(JF8), a,
        jnp.float32(16.0), roles=roles, checks=("fp8-stale-amax",))


def _torch_stale(clean):
    a, s = _fake(((8, 16), BF16), ((), F32))
    roles = {1: ("fp8_scale", "amax_hist") if clean else "fp8_scale"}
    # the port's cast: the fp8 cast kernel's node, its scale an input
    return port.analyze_precision(
        lambda a, s: fp8_cast_kernel.cast_and_scale_stats(
            a, s, F8, 448.0)[0], a, s, roles=roles,
        checks=("fp8-stale-amax",))


PAIRS = {
    ("lowprec-accum", "half-contraction"): (_jax_dot, _torch_dot),
    ("lowprec-accum", "half-accumulator"): (_jax_sum, _torch_index_add),
    ("master-weights", "half-input"): (_jax_master_input,
                                       _torch_master_input),
    ("master-weights", "touched-in-half"): (_jax_master_touched,
                                            _torch_master_touched),
    ("unsafe-exp", "no-max-subtracted"): (_jax_exp, _torch_exp),
    ("cast-churn", "round-trip"): (_jax_churn, _torch_churn),
    ("loss-scale-bypass", "scaled-grads"): (_jax_bypass, _torch_bypass),
    ("fp8-unscaled", "raw-cast"): (_jax_fp8_unscaled, _torch_fp8_unscaled),
    ("fp8-stale-amax", "scale-without-history"): (_jax_stale, _torch_stale),
}


@pytest.mark.parametrize("clean", [False, True], ids=["hazard", "clean"])
@pytest.mark.parametrize("check,case", sorted(PAIRS))
def test_aligned_pair(jax_graph_compat, reduced_precision, check, case,
                      clean):
    jax_prog, torch_prog = PAIRS[(check, case)]
    want = [] if clean else [check]
    assert _ids(jax_prog(clean)) == want
    assert _ids(torch_prog(clean)) == want


def test_every_precision_id_has_a_pair():
    assert {c for c, _ in PAIRS} == set(port.PRECISION_CHECKS) == \
        set(ref.PRECISION_CHECKS)


def test_half_gemm_is_clean_where_cublas_sums_in_fp32(monkeypatch):
    """The torch form of lowprec-accum: ATen's bf16 mm sums in fp32 and
    rounds once unless the reduced-precision flag is set."""
    m = torch.backends.cuda.matmul
    monkeypatch.setattr(m, "allow_bf16_reduced_precision_reduction", False)
    assert _torch_dot(clean=False) == []
    assert port.reduced_precision_flags()["bfloat16"] is False
    # ATen's half sum accumulates in fp32 too: never flagged
    (x,) = _fake(((64,), BF16))
    assert port.analyze_precision(torch.sum, x) == []


def test_fp8_kernel_cast_under_a_history_scale_is_clean_and_raw_is_not():
    """The kernel node applies its scale input: a raw .to(float8) into a
    GEMM is flagged, the kernel's cast under the ring's scale is not."""
    a, b, state = _fake(((8, 16), BF16), ((16, 8), BF16), ((4,), F32))

    def kernel_path(a, b, state):
        s = 448.0 / torch.clamp(torch.amax(state), min=1e-6)
        a8, _ = fp8_cast_kernel.cast_and_scale_stats(a, s, F8, 448.0)
        b8, _ = fp8_cast_kernel.cast_and_scale_stats(b, s, F8, 448.0)
        return torch.mm(a8.float(), b8.float())

    found = port.analyze_precision(kernel_path, a, b, state,
                                   roles={2: ("fp8_scale", "amax_hist")})
    assert found == []
    raw = port.analyze_precision(
        lambda a, b: torch.mm(a.to(F8).float(), b.to(F8).float()), a, b)
    assert _ids(raw) == ["fp8-unscaled"] and len(raw) == 2


def test_master_output_slot_in_half_is_flagged_and_model_copy_is_not():
    m, g = _fake(((8,), F32), ((8,), F32))

    def step(m, g):
        new = m - 0.1 * g
        return new.to(BF16), new

    assert _ids(port.analyze_precision(step, m, g, roles={0: "master"},
                                       master_outs=(0,))) == [
        "master-weights"]
    assert port.analyze_precision(step, m, g, roles={0: "master"},
                                  master_outs=(1,)) == []


def test_unknown_precision_check_raises():
    with pytest.raises(ValueError, match="unknown precision check"):
        port.analyze_precision(lambda x: x, torch.ones(2), checks=("nope",))


def test_report_to_registry_counts():
    reg = MetricRegistry()
    found = _torch_exp(clean=False) + _torch_churn(clean=False)
    counts = port.report_to_registry(found, registry=reg)
    assert counts["unsafe-exp"] == 1 and counts["cast-churn"] == 1
    assert sum(counts.values()) == 2 and set(counts) == set(
        port.PRECISION_CHECKS)
