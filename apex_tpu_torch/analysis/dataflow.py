"""Forward abstract interpretation of precision over ATen graphs (port of
``apex_tpu/analysis/dataflow.py``): the value lattice under the precision
checks.

Per graph value it tracks, as the reference does per jaxpr ``Var``:

- ``dtype`` / ``origin``    the dtype now and the dtype it was born with;
- ``cast_chain``            the run of consecutive casts it just went
  through (any compute op resets it): the cast-churn signal;
- ``reduction_depth``       the accumulating ops on its history;
- ``taints``                the caller's labels ("grad", "master",
  "scale", "param", "fp8_scale", "amax_hist"), carried through every op;
- ``unscaled``              a "grad" value multiplied or divided by a
  "scale" value (the loss scaler's unscale);
- ``from_max`` / ``max_subtracted``  a running max, and a value a max
  was subtracted from (the softmax-stability signal);
- ``fp8_scaled`` / ``fp8_scale_hist``  a delayed fp8 scale multiplied in,
  and whether it derives from the amax-history state.

The transfer function over ATen (:func:`_transfer`): ``_to_copy`` and
``copy`` (the value of ``src`` in ``dst``'s dtype) are casts; views, reshapes, ``clone``, ``cat`` and their
functionalized ``*_copy`` forms preserve the value; ``amax``, ``max`` and
``cummax`` set ``from_max``; ``sub`` (and ``rsub``) by a max sets
``max_subtracted``; ``mul``/``div`` apply scales; ``sum``, ``mean``,
``cumsum`` and the contractions (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
``convolution``, ``_scaled_mm``, ...) deepen the reduction. A kernel node
(:mod:`apex_tpu_torch.ops.kernel_nodes`, the counterpart of an opaque
``pallas_call``) rebuilds its outputs from their dtypes with the union of
its inputs' taints; an fp8 cast kernel applies its scale input as a
``mul`` would. ``_foreach_*`` ops map element by element.

:mod:`.precision_checks` builds the seven analyses on top; this module
emits no finding. The walk is :mod:`.interp`'s.
"""

from __future__ import annotations

import dataclasses

import torch

from apex_tpu_torch.analysis import interp

__all__ = [
    "ADDITIVE_REDUCTIONS", "ARITH_OPS", "AbsVal", "CAST_OPS",
    "CONTRACTIONS", "FP8_DTYPES", "HALF_DTYPES", "PRECISION_LATTICE",
    "PrecisionLattice", "abs_val_for", "base_op", "dtype_name",
    "interpret", "itemsize",
]

HALF_DTYPES = frozenset({"bfloat16", "float16"})

#: fp8 formats: their safety is their scale's provenance, not an
#: accumulator (the fp8 GEMM always sums in fp32)
FP8_DTYPES = frozenset({"float8_e4m3fn", "float8_e5m2"})

FLOAT_DTYPES = frozenset({"bfloat16", "float16", "float32", "float64",
                          "float8_e4m3fn", "float8_e5m2"})

#: casts: the value of their source in the output's dtype (``make_fx``
#: decomposes ``to`` and ``type_as`` into ``_to_copy``)
CAST_OPS = frozenset({"aten::_to_copy", "aten::copy", "aten::copy_"})

#: contractions: (operand positions) of each (``matmul`` and ``linear``
#: decompose into these)
CONTRACTIONS = {
    "aten::mm": (0, 1), "aten::bmm": (0, 1), "aten::dot": (0, 1),
    "aten::mv": (0, 1), "aten::addmm": (1, 2), "aten::baddbmm": (1, 2),
    "aten::convolution": (0, 1), "aten::_scaled_mm": (0, 1),
}

#: accumulating ops: a value's reduction depth grows through them
ADDITIVE_REDUCTIONS = frozenset(set(CONTRACTIONS) | {
    "aten::sum", "aten::mean", "aten::cumsum", "aten::index_add",
    "aten::scatter_add", "aten::index_put", "aten::_index_put_impl",
    "aten::embedding_dense_backward"})

# ops that keep the value's identity (layout moves, copies, gradient
# stops; ``reshape``, ``contiguous``, ``narrow`` and ``chunk`` decompose
# into these): from_max / max_subtracted flow through, the cast chain
# resets
_PRESERVE_OPS = frozenset({
    "view", "_unsafe_view", "expand", "permute", "transpose", "t",
    "squeeze", "unsqueeze", "slice", "select", "clone", "alias", "detach",
    "cat", "stack", "split", "split_with_sizes", "unbind", "as_strided",
    "neg", "flip", "roll", "_reshape_alias", "lift_fresh", "index_select",
    "gather", "repeat", "diagonal", "unfold", "constant_pad_nd"})

#: arithmetic in the sense of "touches the value's bits" (the
#: master-weight and loss-scale checks)
ARITH_OPS = frozenset({
    "aten::add", "aten::sub", "aten::rsub", "aten::mul", "aten::div",
    "aten::pow", "aten::sqrt", "aten::rsqrt", "aten::exp", "aten::log",
    "aten::log1p", "aten::tanh", "aten::sigmoid", "aten::maximum",
    "aten::minimum", "aten::square", "aten::abs", "aten::erf",
    "aten::expm1", "aten::addcmul", "aten::addcdiv", "aten::lerp",
    "aten::reciprocal", "aten::clamp", "aten::where",
} | set(CONTRACTIONS) | {
    "aten::_foreach_add", "aten::_foreach_sub", "aten::_foreach_mul",
    "aten::_foreach_div", "aten::_foreach_addcmul",
    "aten::_foreach_addcdiv", "aten::_foreach_sqrt", "aten::_foreach_lerp",
    "aten::_foreach_pow", "aten::_foreach_maximum"})

_MAX_OPS = frozenset({"aten::amax", "aten::max", "aten::cummax"})

_FP8_CAST_KERNELS = frozenset({"fp8_cast_scale", "fp8_cast_scale_t"})


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def itemsize(dtype: str) -> int:
    return getattr(torch, dtype).itemsize


def base_op(node) -> str:
    """``namespace::name`` of a node's op, a functionalized view's
    ``*_copy`` form read as the view (``aten::view_copy`` ->
    ``aten::view``) and an in-place op's trailing underscore dropped."""
    name = interp.op_name(node)
    ns, _, op = name.partition("::")
    if not op:
        return name
    if op.endswith("_copy") and op[:-5] in _PRESERVE_OPS:
        op = op[:-5]
    elif op.endswith("_") and op != "copy_":
        op = op[:-1]
    return f"{ns}::{op}"


def _is_float(dtype: str) -> bool:
    return dtype in FLOAT_DTYPES


@dataclasses.dataclass(frozen=True)
class AbsVal:
    """One point of the value lattice (module docstring)."""

    dtype: str
    origin: str
    cast_chain: tuple = ()
    reduction_depth: int = 0
    taints: frozenset = frozenset()
    unscaled: bool = False
    from_max: bool = False
    max_subtracted: bool = False
    fp8_scaled: bool = False
    fp8_scale_hist: bool = False

    def with_(self, **kw) -> "AbsVal":
        return dataclasses.replace(self, **kw)

    def touches_fp8(self) -> bool:
        """In an fp8 dtype, or a pure cast away from one."""
        return self.dtype in FP8_DTYPES or \
            any(d in FP8_DTYPES for d in self.cast_chain)


def abs_val_for(val, taints=frozenset()) -> AbsVal:
    """A fresh value for a fake tensor (or a non-tensor: fp32)."""
    dtype = dtype_name(val.dtype) if isinstance(val, torch.Tensor) \
        else "float32"
    return AbsVal(dtype=dtype, origin=dtype, taints=frozenset(taints))


def _flat(ins) -> list:
    out = []
    for v in ins:
        if isinstance(v, list):
            out.extend(x for x in v if x is not None)
        elif v is not None:
            out.append(v)
    return out


def _join(vals, out_val) -> AbsVal:
    """Default transfer: merge the float inputs into the output value."""
    dtype = dtype_name(out_val.dtype) if isinstance(out_val, torch.Tensor) \
        else "float32"
    floats = [v for v in vals if _is_float(v.dtype)]
    origin = floats[0].origin if floats else dtype
    taints = frozenset().union(*(v.taints for v in vals)) if vals \
        else frozenset()
    return AbsVal(dtype=dtype, origin=origin,
                  reduction_depth=max((v.reduction_depth for v in vals),
                                      default=0),
                  taints=taints, unscaled=any(v.unscaled for v in vals),
                  fp8_scaled=any(v.fp8_scaled for v in vals),
                  fp8_scale_hist=any(v.fp8_scale_hist for v in vals))


def _outs(out_val):
    return list(out_val) if isinstance(out_val, (tuple, list)) \
        else [out_val]


def _shape(vals, out_val, fn):
    """``fn`` over each output, as a tuple for a multi-output node."""
    got = [fn(o) for o in _outs(out_val)]
    return tuple(got) if isinstance(out_val, (tuple, list)) else got[0]


def _scaled(base: AbsVal, present) -> AbsVal:
    """Apply a mul/div's scales: the loss scaler's unscale, and an fp8
    delayed scale (a value of the fp8 scale state, not itself fp8)."""
    has_grad = any("grad" in v.taints for v in present)
    has_scale = any("scale" in v.taints and "grad" not in v.taints
                    for v in present)
    if has_grad and has_scale:
        base = base.with_(unscaled=True)
    fp8_scales = [v for v in present if "fp8_scale" in v.taints
                  and v.dtype not in FP8_DTYPES]
    if fp8_scales:
        base = base.with_(
            fp8_scaled=True,
            fp8_scale_hist=base.fp8_scale_hist or any(
                "amax_hist" in v.taints for v in fp8_scales))
    return base


def _transfer_one(op, node, ins, out_val):
    present = _flat(ins)
    if op in CAST_OPS:
        src_pos = 1 if op in ("aten::copy", "aten::copy_") else 0
        src = ins[src_pos] if len(ins) > src_pos else None
        new = dtype_name(out_val.dtype) if isinstance(out_val, torch.Tensor) \
            else "float32"
        if src is None:
            return AbsVal(dtype=new, origin=new)
        chain = src.cast_chain or (src.dtype,)
        if src.dtype == new and op in ("aten::copy", "aten::copy_"):
            return src.with_(cast_chain=())
        return src.with_(dtype=new, cast_chain=chain + (new,))
    name = op.split("::", 1)[-1]
    if name in _PRESERVE_OPS:
        src = ins[0] if ins and not isinstance(ins[0], list) else (
            ins[0][0] if ins and ins[0] else None)
        if src is None:
            src = present[0] if present else None

        def keep(o):
            dtype = dtype_name(o.dtype) if isinstance(o, torch.Tensor) \
                else "float32"
            if src is None:
                return AbsVal(dtype=dtype, origin=dtype)
            if name in ("cat", "stack"):
                return _join(present, o).with_(
                    from_max=any(v.from_max for v in present),
                    max_subtracted=all(v.max_subtracted for v in present))
            return src.with_(dtype=dtype, cast_chain=())
        return _shape(present, out_val, keep)
    if op in _MAX_OPS or (op == "aten::maximum" and any(
            v.from_max for v in present)):
        return _shape(present, out_val,
                      lambda o: _join(present, o).with_(from_max=True))
    if op in ("aten::sub", "aten::rsub"):
        base = _join(present, out_val)
        subtracted = ins[1] if op == "aten::sub" and len(ins) > 1 \
            else (ins[0] if op == "aten::rsub" else None)
        if isinstance(subtracted, AbsVal) and subtracted.from_max:
            base = base.with_(max_subtracted=True)
        return base
    if op in ("aten::mul", "aten::div"):
        return _scaled(_join(present, out_val), present)
    if op in ADDITIVE_REDUCTIONS:
        return _shape(present, out_val, lambda o: _join(present, o).with_(
            reduction_depth=max((v.reduction_depth for v in present),
                                default=0) + 1))
    return _shape(present, out_val, lambda o: _join(present, o))


def _transfer_kernel(node, ins, out_val):
    """A kernel node: its outputs from their dtypes with the union of the
    inputs' taints; an fp8 cast kernel applies its scale input."""
    present = _flat(ins)
    taints = frozenset().union(*(v.taints for v in present)) if present \
        else frozenset()
    entry = node.meta.get("kernel", "")
    base = AbsVal(dtype="float32", origin="float32", taints=taints,
                  unscaled=any(v.unscaled for v in present),
                  fp8_scaled=any(v.fp8_scaled for v in present),
                  fp8_scale_hist=any(v.fp8_scale_hist for v in present))
    if entry in _FP8_CAST_KERNELS:
        kernel_ins = ins[0] if ins and isinstance(ins[0], list) else []
        scale = kernel_ins[1] if len(kernel_ins) > 1 else None
        base = _scaled(base, [scale] if scale is not None else [])

    def one(o):
        dtype = dtype_name(o.dtype) if isinstance(o, torch.Tensor) \
            else "float32"
        return base.with_(dtype=dtype, origin=dtype)
    return _shape(present, out_val, one)


def _transfer(node, ins, out_val):
    """Abstract transfer: ``ins`` aligned with ``node.args`` (AbsVal, a
    list of them, or None) -> the node's AbsVal (a tuple of them for a
    multi-output node)."""
    if interp.is_kernel_node(node):
        return _transfer_kernel(node, ins, out_val)
    op = base_op(node)
    if op.startswith("aten::_foreach_") and isinstance(out_val,
                                                        (list, tuple)):
        per = []
        for i, o in enumerate(out_val):
            row = tuple((v[i] if i < len(v) else None)
                        if isinstance(v, list) else v for v in ins)
            per.append(_transfer_one("aten::" + op[len("aten::_foreach_"):],
                                     node, row, o))
        return tuple(per)
    return _transfer_one(op, node, ins, out_val)


class PrecisionLattice(interp.Lattice):
    """The dtype/taint value semantics over the unified walk."""

    name = "precision"

    def for_val(self, val):
        return abs_val_for(val)

    def transfer(self, node, ins, out_val, ctx):
        return _transfer(node, ins, out_val)


PRECISION_LATTICE = PrecisionLattice()


def interpret(gm, in_vals, visit=None):
    """Run the precision walk over ``gm`` (a functional graph of
    :func:`.interp.trace`): ``in_vals`` one AbsVal (or None) a
    placeholder; ``visit(node, ins, outs)`` after each node's transfer.
    Returns the :class:`.interp.WalkResult`."""
    wrapped = None if visit is None else (
        lambda node, ins, outs, ctx: visit(node, ins, outs))
    (result,) = interp.interpret_lattices(
        gm, [interp.LatticeRun(PRECISION_LATTICE, in_vals, wrapped)])
    return result
