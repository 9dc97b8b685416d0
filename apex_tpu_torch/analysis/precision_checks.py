"""Precision-flow checks over ATen graphs (port of
``apex_tpu/analysis/precision_checks.py``): client analyses over
:mod:`.dataflow`.

The reference's seven ids, each in its PyTorch form where the hazard has
another shape there (ROADMAP, "Deliberate differences"):

- ``lowprec-accum``      a bf16/fp16 contraction (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``, ``matmul``, ``dot``, ``mv``) with a half result
  while ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_
  reduction`` (or its fp16 twin) lets cuBLAS reduce split-K partial sums
  in half precision; and a half ``index_add``, ``scatter_add`` or
  accumulating ``index_put``, whose CUDA kernels add in the buffer's
  dtype. ATen's ``sum``, ``mean`` and ``cumsum`` accumulate a half
  operand in fp32 and round once, as the hand-written kernels do, so
  neither is flagged: the reference's "half in, half out" rule would flag
  every one of them.
- ``master-weights``     a "master"-tainted value (params, m, v on an
  update path) born half, touched by arithmetic (a kernel node too) while
  half, or stored half in a designated output slot.
- ``unsafe-exp``         ``exp`` on a half value with no subtracted max;
  ``log``/``log1p`` on fp16.
- ``cast-churn``         consecutive casts that round-trip with no compute
  between.
- ``loss-scale-bypass``  a "grad" value meeting "master"/"param" state in
  arithmetic (the fused Adam kernel's node too) without the scaler's
  unscale.
- ``fp8-unscaled``       an E4M3/E5M2 operand (or one a pure cast from
  fp8) of a contraction (``_scaled_mm`` included) with no delayed scale
  applied before its cast.
- ``fp8-stale-amax``     a cast to fp8 (``_to_copy``, ``copy``, or the fp8
  cast kernel's node) under a scale that does not derive from the
  amax-history state.

Entry point: :func:`analyze_precision` (``roles`` and ``master_outs`` as
the reference's); the registered customers live in :mod:`.targets`.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.analysis import interp
from apex_tpu_torch.analysis.dataflow import (
    ARITH_OPS,
    CAST_OPS,
    CONTRACTIONS,
    FP8_DTYPES,
    HALF_DTYPES,
    AbsVal,
    base_op,
    dtype_name,
    interpret,
    itemsize,
)
from apex_tpu_torch.analysis.findings import Finding

PRECISION_CHECKS = (
    "lowprec-accum", "master-weights", "unsafe-exp", "cast-churn",
    "loss-scale-bypass", "fp8-unscaled", "fp8-stale-amax",
)

# contractions whose kernels always sum in fp32, whatever the flags
_FP32_ACC_CONTRACTIONS = frozenset({"aten::_scaled_mm", "aten::convolution"})
# ops that add into a buffer in its own dtype (CUDA atomics)
_HALF_ACCUMULATING = frozenset({"aten::index_add", "aten::scatter_add",
                                "aten::index_put", "aten::_index_put_impl"})


def reduced_precision_flags() -> dict:
    """{half dtype name: may cuBLAS reduce its GEMMs' partial sums in half
    precision}, as torch's flags stand now."""
    m = torch.backends.cuda.matmul
    return {"bfloat16": bool(m.allow_bf16_reduced_precision_reduction),
            "float16": bool(m.allow_fp16_reduced_precision_reduction)}


class _Ctx:
    """Shared state for one analyze_precision run."""

    def __init__(self, name, path, checks):
        self.name = name
        self.path = path
        self.checks = checks
        self.findings = []
        self.seen = set()
        self.bypass_fired = False
        self.reduced = reduced_precision_flags()

    def add(self, check, severity, message, dedup_key=None):
        if dedup_key is not None:
            key = (check,) + tuple(dedup_key)
            if key in self.seen:
                return
            self.seen.add(key)
        self.findings.append(Finding(
            check, severity, self.path, 0, self.name, message))


def _present(ins) -> list:
    out = []
    for v in ins:
        if isinstance(v, list):
            out.extend(x for x in v if isinstance(x, AbsVal))
        elif isinstance(v, AbsVal):
            out.append(v)
    return out


def _first(outs):
    if isinstance(outs, tuple):
        return outs[0] if outs else None
    return outs


def _operands(op, ins):
    return [(side, ins[i]) for side, i in zip(("lhs", "rhs"),
                                              CONTRACTIONS[op])
            if i < len(ins) and isinstance(ins[i], AbsVal)]


def _accumulates(node) -> bool:
    if base_op(node) in ("aten::index_put", "aten::_index_put_impl"):
        acc = node.args[3] if len(node.args) > 3 else node.kwargs.get(
            "accumulate", False)
        return bool(acc)
    return True


def _visit_lowprec_accum(ctx, node, ins, outs):
    op = base_op(node)
    out = _first(outs)
    if op in CONTRACTIONS and op not in _FP32_ACC_CONTRACTIONS:
        half_in = sorted({v.dtype for _, v in _operands(op, ins)
                          if v.dtype in HALF_DTYPES})
        if half_in and out is not None and out.dtype in HALF_DTYPES \
                and ctx.reduced.get(out.dtype):
            flag = ("allow_bf16_reduced_precision_reduction"
                    if out.dtype == "bfloat16"
                    else "allow_fp16_reduced_precision_reduction")
            ctx.add(
                "lowprec-accum", "error",
                f"'{op}' contracts {'/'.join(half_in)} operands into a "
                f"{out.dtype} result while torch.backends.cuda.matmul."
                f"{flag} lets cuBLAS reduce split-K partial sums in "
                f"{out.dtype} — clear the flag, or multiply in fp32 "
                f"(ops.precision.matmul_fp32acc) and downcast after",
                dedup_key=(op, out.dtype))
    elif op in _HALF_ACCUMULATING and out is not None \
            and out.dtype in HALF_DTYPES and _accumulates(node):
        ctx.add(
            "lowprec-accum", "error",
            f"'{op}' accumulates into a {out.dtype} buffer: its CUDA "
            f"kernel adds each contribution in {out.dtype}, so every "
            f"partial sum rounds — accumulate into an fp32 buffer and "
            f"downcast after",
            dedup_key=(op, out.dtype))


def _touches(node) -> bool:
    op = base_op(node)
    return interp.is_kernel_node(node) or (op in ARITH_OPS
                                           and op not in CAST_OPS)


def _visit_master_weights(ctx, node, ins, outs):
    if not _touches(node):
        return
    for v in _present(ins):
        if "master" in v.taints and v.dtype in HALF_DTYPES:
            op = interp.op_name(node)
            ctx.add(
                "master-weights", "error",
                f"master-weight/optimizer-state value is touched in "
                f"{v.dtype} by '{op}': O2 discipline keeps params, m "
                f"and v in fp32 through the whole update path",
                dedup_key=(op, v.dtype))


def _visit_unsafe_exp(ctx, node, ins, outs):
    op = base_op(node)
    x = ins[0] if ins and isinstance(ins[0], AbsVal) else None
    if x is None:
        return
    if op == "aten::exp" and x.dtype in HALF_DTYPES \
            and not x.max_subtracted:
        ctx.add(
            "unsafe-exp", "error",
            f"'exp' on a {x.dtype} value with no subtracted running "
            f"max: a softmax built this way overflows "
            f"({'x > ~11' if x.dtype == 'float16' else 'x > ~88'}) — "
            f"subtract the row max first (or upcast to fp32 and use "
            f"torch.softmax)",
            dedup_key=(x.dtype,))
    elif op in ("aten::log", "aten::log1p") and x.dtype == "float16":
        ctx.add(
            "unsafe-exp", "warning",
            f"'{op}' on a float16 value: fp16's 10-bit mantissa and "
            f"6e-5 normal floor make log unstable near 0/1 — compute "
            f"it in fp32",
            dedup_key=(op,))


def _visit_cast_churn(ctx, node, ins, outs):
    out = _first(outs)
    if base_op(node) not in CAST_OPS or out is None:
        return
    chain = out.cast_chain
    if len(chain) < 3:
        return
    a, b, c = chain[-3:]
    try:
        ia, ib = itemsize(a), itemsize(b)
    except AttributeError:
        return
    # as the reference: N -> W -> N recovers nothing; a down-up-down
    # cycle keeps bouncing through the narrow dtype; a single lossy
    # W -> N -> W is the normal storage-dtype boundary
    noop_round_trip = c == a and ib > ia
    cycle = (len(chain) >= 4 and chain[-1] == chain[-3]
             and chain[-2] == chain[-4])
    if noop_round_trip or cycle:
        shown = chain[-4:] if cycle and not noop_round_trip \
            else chain[-3:]
        ctx.add(
            "cast-churn", "warning",
            f"cast churn: {' -> '.join(shown)} with no compute in "
            f"between — the round trip burns bandwidth for nothing"
            + ("" if noop_round_trip
               else " and silently rounds through the narrow dtype"),
            dedup_key=(shown,))


def _visit_loss_scale_bypass(ctx, node, ins, outs):
    if ctx.bypass_fired or not _touches(node):
        return
    present = _present(ins)
    raw_grads = [v for v in present
                 if "grad" in v.taints and not v.unscaled]
    state = [v for v in present
             if {"master", "param"} & v.taints and "grad" not in v.taints]
    if raw_grads and state:
        ctx.bypass_fired = True
        ctx.add(
            "loss-scale-bypass", "error",
            f"gradients reach '{interp.op_name(node)}' together with "
            f"param/optimizer state without passing through the "
            f"scaler's unscale: the update applies loss-SCALED "
            f"gradients (effective lr multiplied by the loss scale)")


def _visit_fp8_unscaled(ctx, node, ins, outs):
    op = base_op(node)
    if op not in CONTRACTIONS:
        return
    for side, v in _operands(op, ins):
        if not v.touches_fp8() or v.fp8_scaled:
            continue
        ctx.add(
            "fp8-unscaled", "error",
            f"fp8 ({v.dtype if v.dtype in FP8_DTYPES else 'fp8-cast'}) "
            f"{side} operand reaches '{op}' without a live delayed "
            f"scale: values outside ±448 (E4M3) / ±57344 (E5M2) "
            f"saturate and small tails flush to zero — cast through "
            f"ops.precision.matmul_fp8 (the scale, the cast kernel, the "
            f"fp8 GEMM), never a raw .to(float8)",
            dedup_key=(side, v.dtype))


def _visit_fp8_stale_amax(ctx, node, ins, outs):
    out = _first(outs)
    if out is None or out.dtype not in FP8_DTYPES:
        return
    if base_op(node) not in CAST_OPS and not interp.is_kernel_node(node):
        return
    if out.fp8_scaled and not out.fp8_scale_hist:
        ctx.add(
            "fp8-stale-amax", "error",
            f"cast to {out.dtype} under a scale that does not derive "
            f"from the amax-history state threaded into this step: a "
            f"constant or stashed factor stops tracking the tensor's "
            f"range the moment the loss landscape moves — compute the "
            f"scale from the carried Fp8ScalingState "
            f"(Fp8DelayedScaler.scales) every step",
            dedup_key=(out.dtype,))


_VISITORS = {
    "lowprec-accum": _visit_lowprec_accum,
    "master-weights": _visit_master_weights,
    "unsafe-exp": _visit_unsafe_exp,
    "cast-churn": _visit_cast_churn,
    "loss-scale-bypass": _visit_loss_scale_bypass,
    "fp8-unscaled": _visit_fp8_unscaled,
    "fp8-stale-amax": _visit_fp8_stale_amax,
}


def _taints_of(role):
    if role is None:
        return frozenset()
    if isinstance(role, str):
        return frozenset({role})
    return frozenset(role)


def analyze_precision(fn, *example_args, name=None, roles=None,
                      master_outs=(), checks=None):
    """Trace ``fn`` (functional form) and run the precision-flow checks.

    ``roles``: {argnum: taint | taints} on every tensor leaf of that
    positional argument (the reference's vocabulary: "grad", "scale",
    "master", "param", "fp8_scale", "amax_hist"). ``master_outs``: flat
    output indices that must not be half precision. Returns a list of
    :class:`Finding`."""
    name = name or getattr(fn, "__name__", "fn")
    path = f"<graph:{name}>"
    run = set(checks or PRECISION_CHECKS)
    unknown = run - set(PRECISION_CHECKS)
    if unknown:
        raise ValueError(
            f"unknown precision check(s) {sorted(unknown)}; valid: "
            f"{list(PRECISION_CHECKS)}")

    gm = interp.trace(fn, *example_args)

    roles = roles or {}
    ctx = _Ctx(name, path, run)
    in_vals = []
    for argnum, arg in enumerate(example_args):
        taints = _taints_of(roles.get(argnum))
        for leaf in interp.flat_inputs(arg):
            if not isinstance(leaf, torch.Tensor):
                in_vals.append(None)
                continue
            dtype = dtype_name(leaf.dtype)
            in_vals.append(AbsVal(dtype=dtype, origin=dtype, taints=taints))
            if "master-weights" in run and "master" in taints \
                    and dtype in HALF_DTYPES:
                ctx.add(
                    "master-weights", "error",
                    f"master-weight/optimizer-state input (arg {argnum}) "
                    f"arrives in {dtype}: the optimizer must hold fp32 "
                    f"master copies (amp O2)",
                    dedup_key=("input", argnum, dtype))

    visitors = [_VISITORS[c] for c in PRECISION_CHECKS if c in run]

    def visit(node, ins, outs):
        for v in visitors:
            v(ctx, node, ins, outs)

    result = interpret(gm, in_vals, visit=visit)
    out_vals = result.outs

    if "master-weights" in run:
        for idx in master_outs:
            if idx < len(out_vals) and out_vals[idx] is not None \
                    and out_vals[idx].dtype in HALF_DTYPES:
                ctx.add(
                    "master-weights", "error",
                    f"output {idx} is a master-weight/optimizer-state "
                    f"slot but is stored in {out_vals[idx].dtype}: the "
                    f"fp32 master copy is being narrowed between steps",
                    dedup_key=("output", idx))

    return ctx.findings


def report_to_registry(findings, registry=None):
    """Publish the precision finding counts as the
    ``analysis/precision_findings{check=}`` counters and the
    ``analysis/precision_findings_total`` gauge. Returns {check: count}
    over all seven checks."""
    from apex_tpu_torch.observability import get_registry

    reg = registry if registry is not None else get_registry()
    counts = {c: 0 for c in PRECISION_CHECKS}
    for f in findings:
        if f.check in counts:
            counts[f.check] += 1
    for check, n in counts.items():
        if n:
            reg.counter("analysis/precision_findings", check=check).inc(n)
    reg.gauge("analysis/precision_findings_total").set(
        sum(counts.values()))
    return counts
