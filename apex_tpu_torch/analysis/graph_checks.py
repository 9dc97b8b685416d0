"""ATen-graph checks: the port of ``apex_tpu/analysis/jaxpr_checks.py``.

Traces a function with fake tensors (:func:`.interp.trace`: no data, no
device work; the port's kernels are one node a launch) and walks the
graph for three of the reference's four check ids, in their PyTorch
forms (ROADMAP, "Deliberate differences"):

- ``donation``      an argument the caller donates (``donate_argnums``:
                    the caller lets ``fn`` overwrite it) that is read
                    again after ``fn`` wrote it in place (an in-place op,
                    or a kernel's output copied into it): the read sees the
                    overwritten buffer where the program may have meant
                    the value it was given; or a donated argument that is
                    never written and matches no output's shape and dtype
                    (a wasted donation).
- ``recompile``     a Python number among the arguments, which the trace
                    bakes into the graph as a constant (a new value is a
                    new trace or a CUDA graph's recapture), and a tensor
                    the function closes over baked in as a constant of at
                    least the reference's 256 elements.
- ``pallas-block``  every kernel node's launch plan against what its
                    kernel needs: threads a block a whole number of warps
                    and at most 1024, threads a row a whole number of
                    warps, the head dims and row widths its wrapper's
                    checks demand, rows of whole 16-byte vectors (else
                    the loop or scalar path), and dynamic shared memory
                    within the card's (``kernel_config.device_smem_bytes``
                    on the card; off it the H100's opt-in, since the
                    kernels are built for ``sm_90a`` only).

``collective-axis`` needs a model of a world of ranks and waits for the
sharding engines. Entry point: :func:`analyze_fn`.
"""

from __future__ import annotations

import operator
from typing import Optional

import torch

from apex_tpu_torch.analysis import interp
from apex_tpu_torch.analysis.findings import Finding

GRAPH_CHECKS = ("donation", "recompile", "pallas-block")

# constants of at least this many elements baked into a trace are flagged
# (the reference's _CONST_CAPTURE_MIN_ELEMS)
_CONST_CAPTURE_MIN_ELEMS = 256

_WARP = 32
_MAX_BLOCK_THREADS = 1024


# ------------------------------------------------------------- aliasing

def _schema(node):
    return getattr(node.target, "_schema", None)


def written_args(node) -> list:
    """The arguments ``node`` writes in place (its schema's ``(a!)``)."""
    sch = _schema(node)
    if sch is None:
        return []
    out = []
    for i, arg in enumerate(sch.arguments):
        info = arg.alias_info
        if info is None or not info.is_write:
            continue
        val = node.args[i] if i < len(node.args) else node.kwargs.get(
            arg.name)
        if isinstance(val, torch.fx.Node):
            out.append(val)
    return out


def aliased_arg(node) -> Optional[torch.fx.Node]:
    """The argument ``node``'s output aliases (a view, or an in-place op's
    return), or None."""
    if node.target is operator.getitem:
        return node.args[0]
    sch = _schema(node)
    if sch is None or not sch.returns:
        return None
    sets = set()
    for ret in sch.returns:
        if ret.alias_info is not None:
            sets |= set(ret.alias_info.before_set)
    if not sets:
        return None
    for i, arg in enumerate(sch.arguments):
        info = arg.alias_info
        if info is not None and set(info.before_set) & sets:
            val = node.args[i] if i < len(node.args) else None
            if isinstance(val, torch.fx.Node):
                return val
    return None


def _reads(node) -> set:
    import torch.utils._pytree as pytree

    return {a for a in pytree.tree_leaves((node.args, node.kwargs))
            if isinstance(a, torch.fx.Node)}


# ------------------------------------------------------------ the checks

def donated_inputs(example_args, donate_argnums) -> dict:
    """{flat placeholder index: (argnum, leaf)} of the donated tensor
    leaves."""
    donate = ({donate_argnums} if isinstance(donate_argnums, int)
              else set(donate_argnums))
    out, idx = {}, 0
    for argnum, arg in enumerate(example_args):
        leaves = interp.flat_inputs(arg)
        for k, leaf in enumerate(leaves):
            if argnum in donate and isinstance(leaf, torch.Tensor):
                out[idx + k] = (argnum, k)
        idx += len(leaves)
    return out


def _writer_text(node) -> str:
    src = node.args[1] if interp.op_name(node) == "aten::copy_" and len(
        node.args) > 1 else None
    if isinstance(src, torch.fx.Node) and src.target is operator.getitem \
            and interp.is_kernel_node(src.args[0]):
        return (f"kernel {interp.op_name(src.args[0]).split('::')[1]}'s "
                f"output, copied into it")
    return f"in-place '{interp.op_name(node)}'"


def check_donation(gm, donated, name, path):
    """``gm``: the unfunctionalized graph (in-place ops in order);
    ``donated``: :func:`donated_inputs`."""
    findings = []
    nodes = list(gm.graph.nodes)
    placeholders = interp.placeholder_nodes(gm)
    outs = [n for n in interp.output_nodes(gm) if n is not None]
    out_sigs = {(tuple(n.meta["val"].shape), n.meta["val"].dtype)
                for n in outs if isinstance(n.meta.get("val"),
                                            torch.Tensor)}
    for flat_idx, (argnum, leaf) in sorted(donated.items()):
        if flat_idx >= len(placeholders):
            continue
        ph = placeholders[flat_idx]
        val = ph.meta.get("val")
        if not isinstance(val, torch.Tensor):
            continue
        where = (f"arg {argnum} leaf {leaf} "
                 f"{str(val.dtype).replace('torch.', '')}{list(val.shape)}")
        buffer = {ph}
        first_write = None
        read_after = None
        for pos, node in enumerate(nodes):
            if node.op != "call_function":
                continue
            src = aliased_arg(node)
            hits = _reads(node) & buffer
            wrote = [a for a in written_args(node) if a in buffer]
            if src is not None and src in buffer:
                buffer.add(node)
            if wrote and first_write is None:
                first_write = node
                continue
            if first_write is not None and hits and not wrote and (
                    src is None or src not in buffer):
                read_after = node
                break
        if first_write is None:
            sig = (tuple(val.shape), val.dtype)
            if sig not in out_sigs:
                findings.append(Finding(
                    "donation", "warning", path, 0, name,
                    f"donated {where} is never written in place and "
                    f"matches no output shape/dtype: the caller gives the "
                    f"buffer up for nothing (no update reuses it), so the "
                    f"donation is wasted"))
            continue
        if read_after is not None:
            findings.append(Finding(
                "donation", "error", path, 0, name,
                f"donated {where} is overwritten by "
                f"{_writer_text(first_write)} and read again by "
                f"'{interp.op_name(read_after)}' afterwards — the read "
                f"sees the clobbered buffer, not the value the caller "
                f"passed in (copy it first, or read it before the write)"))
    return findings


def check_recompile(gm, name, path, example_args=()):
    findings = []
    for argnum, arg in enumerate(example_args):
        for leaf in interp.flat_inputs(arg):
            if isinstance(leaf, bool) or not isinstance(leaf, (int, float)):
                continue
            findings.append(Finding(
                "recompile", "warning", path, 0, name,
                f"argument {argnum} is a Python {type(leaf).__name__} "
                f"({leaf!r}) that the trace bakes into the graph as a "
                f"constant: a new value is a new trace (or a CUDA graph's "
                f"recapture) — pass it as a 0-dim tensor on the card"))
    for node in gm.graph.nodes:
        if node.op != "get_attr":
            continue
        const = getattr(gm, node.target, None)
        if not isinstance(const, torch.Tensor):
            continue
        size = const.numel()
        if size >= _CONST_CAPTURE_MIN_ELEMS:
            dtype = str(const.dtype).replace("torch.", "")
            findings.append(Finding(
                "recompile", "warning", path, 0, name,
                f"trace closes over a {dtype}{list(const.shape)} tensor "
                f"({size} elements) baked in as a constant: a captured "
                f"graph holds a stale copy when it changes, and it can "
                f"be neither donated nor resharded — pass it as an "
                f"argument"))
    return findings


def smem_budget(smem_bytes=None) -> int:
    """Shared memory a block may use: ``smem_bytes``, else the card's
    opt-in, else (off the card) the H100's."""
    from apex_tpu_torch.ops import kernel_config

    if smem_bytes is not None:
        return int(smem_bytes)
    if torch.cuda.is_available():
        return kernel_config.device_smem_bytes()
    return kernel_config.device_smem_bytes("h100")


def _plan_problems(entry, plan, dtype):
    """(severity, text) for each way ``plan`` fails its kernel."""
    from apex_tpu_torch.ops import flash_attention, layer_norm
    from apex_tpu_torch.transformer.functional import fused_softmax

    out = []
    threads, row_threads = plan["threads"], plan["row_threads"]
    width, vec = plan["width"], plan["vec"]
    if threads < _WARP or threads % _WARP or threads > _MAX_BLOCK_THREADS:
        out.append(("error", f"a block of {threads} threads: a block "
                    f"takes whole warps of {_WARP}, at most "
                    f"{_MAX_BLOCK_THREADS}"))
    if row_threads and row_threads % _WARP:
        out.append(("error", f"{row_threads} threads a row: a row's "
                    f"shuffles need whole warps of {_WARP}"))
    if entry.startswith("flash_"):
        if width > flash_attention.MAX_HEAD_DIM:
            out.append(("error", f"head dim {width} over the kernels' "
                        f"{flash_attention.MAX_HEAD_DIM}"))
        elif dtype is not None and width != flash_attention._padded_dim(
                width, dtype):
            out.append(("warning", f"head dim {width} pads to the "
                        f"{flash_attention._padded_dim(width, dtype)}-"
                        f"column tile: the padding is loaded and "
                        f"multiplied for nothing"))
    if entry in ("fused_softmax_causal", "fused_softmax_masked") and \
            width > fused_softmax._WHOLE_ROW_MAX_SK:
        out.append(("error", f"a whole row of {width} keys: the kernel "
                    f"holds at most {fused_softmax._WHOLE_ROW_MAX_SK}"))
    if entry.endswith("norm_bwd") and plan["smem_bytes"] > \
            layer_norm.SMEM_FLOATS * 4:
        out.append(("error", f"{plan['smem_bytes']} bytes of column sums "
                    f"in shared memory: at most "
                    f"{layer_norm.SMEM_FLOATS * 4}"))
    if vec and (entry.startswith(("rms_norm", "layer_norm",
                                  "fused_softmax_causal",
                                  "fused_softmax_masked"))
                and width % vec):
        out.append(("warning", f"rows of {width} elements are not whole "
                    f"16-byte vectors of {vec}: the kernel takes its "
                    f"loop (or scalar) path, element by element"))
    return out


def check_kernel_plans(gm, name, path, smem_bytes=None):
    budget = smem_budget(smem_bytes)
    findings = []
    for node in interp.kernel_nodes_of(gm):
        entry = node.meta.get("kernel") or interp.op_name(node).split(
            "::")[1]
        plan = node.meta.get("plan")
        if plan is None:
            continue
        ins = node.args[0]
        first = next((a for a in ins if isinstance(a, torch.fx.Node)), None)
        val = first.meta.get("val") if first is not None else None
        dtype = val.dtype if isinstance(val, torch.Tensor) else None
        problems = _plan_problems(entry, plan, dtype)
        if plan["smem_bytes"] > budget:
            problems.append((
                "error", f"{plan['smem_bytes']} bytes of dynamic shared "
                f"memory a block exceed the card's {budget}: the launch "
                f"fails"))
        for severity, text in problems:
            findings.append(Finding(
                "pallas-block", severity, path, 0, name,
                f"[{entry}] launch plan {plan}: {text}"))
    return findings


# ---------------------------------------------------------------- entry

def analyze_fn(fn, *example_args, donate_argnums=(), name=None,
               checks=None, smem_bytes=None):
    """Trace ``fn(*example_args)`` and run the graph checks.

    ``donate_argnums``: the positional arguments the caller donates.
    ``checks`` restricts to a subset of :data:`GRAPH_CHECKS`;
    ``smem_bytes`` overrides the shared-memory budget
    (:func:`smem_budget`). Returns a list of :class:`Finding`."""
    name = name or getattr(fn, "__name__", "fn")
    path = f"<graph:{name}>"
    run = set(checks or GRAPH_CHECKS)
    unknown = run - set(GRAPH_CHECKS)
    if unknown:
        raise ValueError(f"unknown graph check(s) {sorted(unknown)}; "
                         f"valid: {list(GRAPH_CHECKS)}")
    gm = interp.trace(fn, *example_args, functional=False)
    findings = []
    if "donation" in run:
        donated = donated_inputs(example_args, donate_argnums)
        if donated:
            findings += check_donation(gm, donated, name, path)
    if "recompile" in run:
        findings += check_recompile(gm, name, path, example_args)
    if "pallas-block" in run:
        findings += check_kernel_plans(gm, name, path, smem_bytes)
    return findings
