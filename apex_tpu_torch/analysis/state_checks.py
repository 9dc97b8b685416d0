"""Checkpoint/state-flow checks over ATen graphs (port of
``apex_tpu/analysis/state_checks.py``): static resume compatibility.

The engine derives the expected state schema from code, as the
reference's does:

- a **step-carry walk** over the step's functional graph
  (:func:`.interp.trace`): :class:`StateFlowLattice` tracks, per value,
  the set of state leaves it derives from. A state leaf whose value
  reaches any output, or the new value of any input the step writes in
  place (a ``FusedOptimizer.step``, the flat Adam's m and v, the
  serving decode step's KV pages), is *step-carried*: it must round-trip
  through the checkpoint. ``make_fx`` unrolls loops, so no carry
  fixpoint is needed;
- **joined with the registered state constructors** (the port's
  ``LossScaleState``, ``Fp8ScalingState``, ``AmaxHistoryState``,
  ``Zero1AdamState``), so a finding names the field
  (``Fp8ScalingState.fwd``), in the port's format-2 schema
  (:func:`apex_tpu_torch.checkpoint.state_schema_of`).

Five checks (:data:`STATE_CHECKS`), in their PyTorch forms:

- ``unsaved-train-state``  a step-carried leaf that never reaches the
  save tree.
- ``ckpt-schema-drift``  the code-derived schema (treedef, path, shape,
  dtype, spec) disagrees with a manifest's ``state_schema``; with no
  manifest the code schema round-trips through the JSON encoding.
- ``dtype-narrowing-restore``  a saved dtype wider than its restore
  slot: ``restore_checkpoint`` copies into the slot's dtype silently.
- ``reshard-illegal``  arithmetic over a saved manifest and candidate
  shard counts: dim-0 divisibility of each sharded leaf and the ZeRO-1
  bucket quantum (``parallel.zero``'s ``_pad_up``) for every candidate,
  with no collective traced.
- ``restore-donation-hazard``  the resume path's step writes a restored
  buffer in place (the torch form of donating it) and the restored
  reference is returned beside the step's new state (the loop's held
  fallback): it holds the overwritten buffer, not the restored one. A
  traced graph has no call boundary, so a read after the step cannot be
  told from the step's own reads of its new state: the held reference
  is what the check reads.

Entry point: :func:`analyze_state`; the registered targets live in
:mod:`.targets`, and :func:`report_to_registry` publishes the
``analysis/state_*`` family, every id zero-filled.
"""

from __future__ import annotations

import dataclasses
import json

import torch

from apex_tpu_torch.analysis import interp
from apex_tpu_torch.analysis.findings import Finding

STATE_CHECKS = (
    "unsaved-train-state", "ckpt-schema-drift",
    "dtype-narrowing-restore", "reshard-illegal",
    "restore-donation-hazard",
)


# ------------------------------------------------------- origin lattice


@dataclasses.dataclass(frozen=True)
class OriginVal:
    """The set of state leaves (schema indices) a value derives from."""

    origins: frozenset = frozenset()


_EMPTY = OriginVal()


def _members(ins) -> list:
    out = []
    for v in ins:
        if isinstance(v, list):
            out.extend(x for x in v if isinstance(x, OriginVal))
        elif isinstance(v, OriginVal):
            out.append(v)
    return out


def _join(vals) -> OriginVal:
    if not vals:
        return _EMPTY
    return OriginVal(origins=frozenset().union(*(v.origins for v in vals)))


class StateFlowLattice(interp.Lattice):
    """Origin provenance: which state leaves can influence each value.
    Union everywhere, except that a copy's value is its source's (the
    destination is overwritten) and a ``_foreach_*`` op maps element by
    element."""

    name = "state"

    def for_val(self, val):
        return _EMPTY

    def transfer(self, node, ins, out_val, ctx):
        op = interp.op_name(node)
        if op in ("aten::copy", "aten::copy_"):
            src = ins[1] if len(ins) > 1 else None
            return src if isinstance(src, OriginVal) else _EMPTY
        if op.startswith("aten::_foreach_") and isinstance(
                out_val, (list, tuple)):
            per = []
            for i in range(len(out_val)):
                row = [(v[i] if i < len(v) else None)
                       if isinstance(v, list) else v for v in ins]
                per.append(_join(_members(row)))
            return tuple(per)
        base = _join(_members(ins))
        if isinstance(out_val, (list, tuple)):
            return tuple(base for _ in out_val)
        return base


STATE_LATTICE = StateFlowLattice()


# ----------------------------------------------------- schema derivation

#: the port's state constructors: leaves under one are tagged
#: ``Kind.field``; imports are lazy, and a missing module only loses the
#: tag (recorded in :data:`_MISSING_CONSTRUCTORS`), never the check
_CONSTRUCTOR_IMPORTS = (
    ("apex_tpu_torch.amp.scaler", "LossScaleState"),
    ("apex_tpu_torch.amp.scaler", "Fp8ScalingState"),
    ("apex_tpu_torch.observability.numerics.history", "AmaxHistoryState"),
    ("apex_tpu_torch.parallel.zero", "Zero1AdamState"),
)

_MISSING_CONSTRUCTORS = set()


def _constructor_classes():
    import importlib

    out = []
    for mod, cls in _CONSTRUCTOR_IMPORTS:
        try:
            out.append(getattr(importlib.import_module(mod), cls))
        except Exception:  # noqa: BLE001 — optional tags only
            _MISSING_CONSTRUCTORS.add((mod, cls))
    return tuple(out)


def leaf_kinds(tree) -> tuple:
    """Per-leaf constructor tag (``"Zero1AdamState.mu"`` or None) in the
    schema's leaf order (``_tree``'s, the reference's)."""
    classes = _constructor_classes()
    kinds = []

    def walk(node, tag):
        if node is None:
            return
        if isinstance(node, classes):
            for field, child in zip(type(node)._fields, node):
                walk(child, f"{type(node).__name__}.{field}")
            return
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], tag)
            return
        if isinstance(node, (list, tuple)):
            for child in node:
                walk(child, tag)
            return
        kinds.append(tag)

    walk(tree, None)
    return tuple(kinds)


@dataclasses.dataclass(frozen=True)
class StateLeaf:
    """One leaf of the derived schema."""

    path: str
    shape: tuple
    dtype: str
    spec: object
    kind: object = None
    carried: bool = False


@dataclasses.dataclass(frozen=True)
class StateSchema:
    """Code-derived expected state schema (treedef + typed leaves)."""

    treedef: str
    leaves: tuple

    def to_manifest(self) -> dict:
        """The commit marker's ``state_schema`` this schema expects on
        disk (:func:`apex_tpu_torch.checkpoint.state_schema_of`'s
        encoding)."""
        from apex_tpu_torch.checkpoint import schema_fingerprint

        body = {
            "treedef": self.treedef,
            "leaves": [
                {"path": lf.path, "shape": list(lf.shape),
                 "dtype": lf.dtype, "spec": lf.spec, "kind": lf.kind}
                for lf in self.leaves],
        }
        body["fingerprint"] = schema_fingerprint(body)
        return body


def _dtype_name(leaf) -> str:
    from apex_tpu_torch.checkpoint import _dtype_name as name

    return name(leaf)


def _flatten_with_paths(tree):
    from apex_tpu_torch import _tree

    flat, treedef = _tree.flatten_with_path(tree)
    return (tuple(p for p, _ in flat), tuple(leaf for _, leaf in flat),
            treedef)


def _spec_leaves(specs, n, context):
    """``n`` encoded specs (None: unknown) from a per-leaf spec sequence
    in the schema's leaf order; loud on a length mismatch."""
    if specs is None:
        return (None,) * n
    from apex_tpu_torch.checkpoint import encode_spec

    if len(specs) != n:
        raise ValueError(
            f"{context}: {len(specs)} specs, state has {n} leaves — spec "
            f"and state trees diverged")
    return tuple(encode_spec(s) for s in specs)


def _placeholder_index(args, leaves) -> list:
    """For each schema leaf, its placeholder's index in a trace of
    ``args`` (the tracer flattens dicts in insertion order, the schema in
    key order: matched by identity), or None."""
    by_id = {}
    for i, leaf in enumerate(interp.flat_inputs(args)):
        by_id.setdefault(id(leaf), i)
    return [by_id.get(id(leaf)) for leaf in leaves]


def _origin_walk(fn, args, leaves):
    """Trace ``fn(*args)`` (functional) and run the origin lattice with
    each schema leaf as its own origin. Returns (outputs' origins, the
    written inputs' origins)."""
    gm = interp.trace(fn, *args)
    index = _placeholder_index(args, leaves)
    n_in = len(interp.flat_inputs(args))
    in_vals = [None] * n_in
    for j, i in enumerate(index):
        if i is not None:
            prev = in_vals[i].origins if in_vals[i] is not None \
                else frozenset()
            in_vals[i] = OriginVal(origins=prev | {j})
    (result,) = interp.interpret_lattices(
        gm, [interp.LatticeRun(STATE_LATTICE, in_vals)])
    return result, gm


def derive_state_schema(step_fn, state, *args, specs=None,
                        name=None) -> StateSchema:
    """Trace ``step_fn(state, *args)`` and derive the expected schema:
    each leaf's path, shape, dtype, spec and constructor kind, and
    whether it is step-carried (its value reaches an output or an input
    the step writes in place)."""
    name = name or getattr(step_fn, "__name__", "step")
    paths, leaves, treedef = _flatten_with_paths(state)
    result, _ = _origin_walk(step_fn, (state, *args), leaves)
    live = set()
    for v in list(result.outs) + list(result.writes.values()):
        if isinstance(v, OriginVal):
            live |= v.origins
    spec_flat = _spec_leaves(specs, len(leaves),
                             f"derive_state_schema ({name})")
    kinds = leaf_kinds(state)
    schema_leaves = tuple(
        StateLeaf(path=paths[j], shape=tuple(getattr(leaves[j], "shape",
                                                     ())),
                  dtype=_dtype_name(leaves[j]), spec=spec_flat[j],
                  kind=kinds[j] if j < len(kinds) else None,
                  carried=j in live)
        for j in range(len(leaves)))
    return StateSchema(treedef=str(treedef), leaves=schema_leaves)


def trace_save_coverage(save_tree_of, state):
    """Origin-trace the save fn: which state leaves reach the saved tree,
    and each saved slot's origins. Returns ``(covered, saved_paths,
    saved_leaves, saved_treedef, slot_origins)``, the saved slots in the
    schema's order."""
    paths, leaves, _ = _flatten_with_paths(state)
    result, _ = _origin_walk(save_tree_of, (state,), leaves)
    saved = save_tree_of(state)
    saved_paths, saved_leaves, saved_treedef = _flatten_with_paths(saved)
    # the graph's outputs follow the tracer's order: map them by identity
    out_index = _placeholder_index((saved,), saved_leaves)
    slot_origins = tuple(
        (result.outs[i].origins if i is not None and i < len(result.outs)
         and isinstance(result.outs[i], OriginVal) else frozenset())
        for i in out_index)
    covered = frozenset().union(*slot_origins) if slot_origins \
        else frozenset()
    return covered, saved_paths, saved_leaves, saved_treedef, slot_origins


# ------------------------------------------------------------- findings


class _Ctx:
    def __init__(self, name, path, checks=frozenset(STATE_CHECKS)):
        self.name = name
        self.path = path
        self.checks = frozenset(checks)
        self.findings = []
        self.seen = set()

    def add(self, check, severity, message, dedup_key=None):
        if check not in self.checks:
            return
        if dedup_key is not None:
            key = (check,) + tuple(dedup_key)
            if key in self.seen:
                return
            self.seen.add(key)
        self.findings.append(Finding(
            check, severity, self.path, 0, self.name, message))


def _check_unsaved(ctx, schema, covered):
    for j, lf in enumerate(schema.leaves):
        if not lf.carried or j in covered:
            continue
        kind = f" ({lf.kind})" if lf.kind else ""
        ctx.add(
            "unsaved-train-state", "error",
            f"state leaf {lf.path}{kind} is step-carried (its value "
            f"flows into the step's outputs or in-place writes) but never "
            f"reaches the checkpoint save tree: on resume it silently "
            f"re-initializes and the run is no longer the run that "
            f"was saved — add the leaf to the save tree, or prove it "
            f"derivable and drop it from the carry",
            dedup_key=(lf.path,))


def _manifest_leaves(manifest_schema):
    return {lf.get("path", "?"): lf
            for lf in manifest_schema.get("leaves", ())}


def _check_schema_drift(ctx, code_manifest, disk_manifest):
    code_by = _manifest_leaves(code_manifest)
    disk_by = _manifest_leaves(disk_manifest)
    if code_manifest.get("treedef") != disk_manifest.get("treedef"):
        ctx.add(
            "ckpt-schema-drift", "error",
            f"saved treedef does not match the code-derived save "
            f"tree: manifest has {disk_manifest.get('treedef')!r}, "
            f"code expects {code_manifest.get('treedef')!r} — the "
            f"checkpoint on disk is not the state this step restores",
            dedup_key=("treedef",))
    for path in sorted(set(code_by) - set(disk_by)):
        ctx.add(
            "ckpt-schema-drift", "error",
            f"save-tree leaf {path} is missing from the manifest's "
            f"state_schema — the checkpoint predates (or dropped) "
            f"this field and restore will not populate it",
            dedup_key=("missing", path))
    for path in sorted(set(disk_by) - set(code_by)):
        ctx.add(
            "ckpt-schema-drift", "warning",
            f"manifest carries leaf {path} the code-derived save "
            f"tree no longer has — stale state rides every restore "
            f"(or the save tree silently shrank)",
            dedup_key=("extra", path))
    for path in sorted(set(code_by) & set(disk_by)):
        want, got = code_by[path], disk_by[path]
        for field in ("shape", "dtype", "spec"):
            w, g = want.get(field), got.get(field)
            if field == "shape":
                w, g = list(w or ()), list(g or ())
            if w != g:
                ctx.add(
                    "ckpt-schema-drift", "error",
                    f"leaf {path} {field} drifted: manifest has "
                    f"{g!r}, code expects {w!r} — restore would "
                    f"reinterpret the saved bytes",
                    dedup_key=(path, field))


_FLOAT_WIDTH = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
                "float8_e4m3fn": 1, "float8_e5m2": 1}


def _check_dtype_narrowing(ctx, saved_manifest, template_paths,
                           template_leaves):
    slot_by_path = dict(zip(template_paths, template_leaves))
    for lf in saved_manifest.get("leaves", ()):
        path = lf.get("path", "?")
        slot = slot_by_path.get(path)
        if slot is None:
            continue
        saved_dt = str(lf.get("dtype"))
        slot_dt = _dtype_name(slot)
        sw, tw = _FLOAT_WIDTH.get(saved_dt), _FLOAT_WIDTH.get(slot_dt)
        if sw is None or tw is None or sw <= tw:
            continue
        kind = f" ({lf.get('kind')})" if lf.get("kind") else ""
        ctx.add(
            "dtype-narrowing-restore", "error",
            f"leaf {path}{kind} was saved as {saved_dt} but the "
            f"restore slot is {slot_dt}: restore_checkpoint copies into "
            f"the slot's dtype silently and the wide master copy is lost "
            f"on resume — restore into a {saved_dt} slot",
            dedup_key=(path,))


def _pad_up(total, k):
    from apex_tpu_torch.parallel.overlap import _pad_up as pad_up

    return pad_up(total, max(1, k))


def _spec_dim0_axes(spec):
    if not spec:
        return ()
    dim0 = spec[0]
    if dim0 is None:
        return ()
    if isinstance(dim0, (list, tuple)):
        return tuple(str(a) for a in dim0)
    return (str(dim0),)


def _check_reshard(ctx, saved_manifest, layout, candidates):
    candidates = tuple(int(n) for n in candidates)
    axis = (layout or {}).get("axis")
    for lf in saved_manifest.get("leaves", ()):
        axes = _spec_dim0_axes(lf.get("spec"))
        if not axes or (axis is not None and axis not in axes):
            continue
        shape = tuple(lf.get("shape") or ())
        if not shape:
            continue
        for n in candidates:
            if n > 0 and shape[0] % n == 0:
                continue
            ctx.add(
                "reshard-illegal", "error",
                f"leaf {lf.get('path', '?')} is saved dim-0-sharded "
                f"over {'/'.join(axes)} with shape[0]={shape[0]}, "
                f"which does not divide into {n} shards — the "
                f"candidate group ({'/'.join(axes)}={n}) cannot re-lay "
                f"this buffer out; re-pad the saved buffer or drop {n} "
                f"from the elastic candidate set",
                dedup_key=(lf.get("path", "?"), n))
    for k, bucket in enumerate((layout or {}).get("buckets", ())):
        total = int(bucket.get("total", 0))
        padded = int(bucket.get("padded", 0))
        for n in candidates:
            if n <= 0:
                continue
            if padded % n != 0:
                ctx.add(
                    "reshard-illegal", "error",
                    f"ZeRO-1 bucket {k} ({bucket.get('dtype')}) has "
                    f"padded length {padded}, not divisible by "
                    f"candidate shard count {n} — the saved moment "
                    f"shards cannot be re-scattered onto that group",
                    dedup_key=("bucket-div", k, n))
            elif _pad_up(total, n) != padded:
                ctx.add(
                    "reshard-illegal", "error",
                    f"ZeRO-1 bucket {k} ({bucket.get('dtype')}) was "
                    f"padded to {padded} for "
                    f"{(layout or {}).get('num_shards')} shards, but "
                    f"re-planning for {n} shards pads {total} -> "
                    f"{_pad_up(total, n)}: the saved flat buffer and the "
                    f"new plan disagree on the shard quantum — only shard "
                    f"counts with _pad_up(total, n) == {padded} are pure "
                    f"reshards",
                    dedup_key=("bucket-quantum", k, n))


def check_restore_donation(resume_fn, state, *resume_args, name=None,
                           checks=None):
    """Trace the resume path ``resume_fn(restored_state, *args)`` (in-place
    ops kept) and flag a restored buffer the step writes in place that is
    returned more than once: the step's new state and the held restored
    reference are then one overwritten buffer. A copy (``clone``) before
    the step, or a step that returns new tensors, leaves the restored
    reference intact."""
    from apex_tpu_torch.analysis.graph_checks import (
        aliased_arg,
        written_args,
    )

    name = name or getattr(resume_fn, "__name__", "resume")
    ctx = _Ctx(name, f"<graph:{name}>", checks=_validate_checks(checks))
    if "restore-donation-hazard" not in ctx.checks:
        return ctx.findings
    gm = interp.trace(resume_fn, state, *resume_args, functional=False)
    n_state = len(interp.flat_inputs(state))
    placeholders = interp.placeholder_nodes(gm)[:n_state]
    outs = interp.output_nodes(gm)
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"]
    for ph in placeholders:
        if not isinstance(ph.meta.get("val"), torch.Tensor):
            continue
        buffer = {ph}
        first_write = None
        for node in nodes:
            src = aliased_arg(node)
            if src is not None and src in buffer:
                buffer.add(node)
            if first_write is None and any(
                    a in buffer for a in written_args(node)):
                first_write = node
        if first_write is None or sum(1 for o in outs if o in buffer) < 2:
            continue
        ctx.add(
            "restore-donation-hazard", "error",
            f"a restored buffer ({ph.name}) is written in place by "
            f"'{interp.op_name(first_write)}' on the first post-resume "
            f"step and then returned beside the step's new state, which "
            f"is the same overwritten buffer: the held restored reference "
            f"(the ResilientTrainLoop fallback_state) no longer holds the "
            f"restored values — clone the restored state before an "
            f"in-place step, or make the step return new tensors",
            dedup_key=(ph.name,))
    return ctx.findings


# ----------------------------------------------------------------- entry


def analyze_state(step_fn, state, *args, name=None, save_tree_of=None,
                  restore_template=None, specs=None, manifest=None,
                  reshard_layout=None, reshard_candidates=None,
                  resume_fn=None, resume_args=None, checks=None,
                  stats_out=None):
    """Run the checkpoint/state-flow checks over one train step (the
    reference's arguments; ``specs`` a per-leaf sequence in the schema's
    leaf order, as :func:`apex_tpu_torch.checkpoint.state_schema_of`
    takes it). Returns a list of :class:`Finding`."""
    name = name or getattr(step_fn, "__name__", "step")
    run = _validate_checks(checks)
    ctx = _Ctx(name, f"<graph:{name}>", checks=run)

    schema = derive_state_schema(step_fn, state, *args, specs=specs,
                                 name=name)
    save_fn = save_tree_of if save_tree_of is not None \
        else (lambda s: s)
    covered, saved_paths, saved_leaves, saved_treedef, slot_origins = \
        trace_save_coverage(save_fn, state)

    if "unsaved-train-state" in run:
        _check_unsaved(ctx, schema, covered)

    saved_schema_leaves = []
    for i, (path, leaf) in enumerate(zip(saved_paths, saved_leaves)):
        spec = kind = None
        origins = slot_origins[i] if i < len(slot_origins) else frozenset()
        if len(origins) == 1:
            (j,) = origins
            if j < len(schema.leaves):
                spec = schema.leaves[j].spec
                kind = schema.leaves[j].kind
        saved_schema_leaves.append(StateLeaf(
            path=path, shape=tuple(getattr(leaf, "shape", ())),
            dtype=_dtype_name(leaf), spec=spec, kind=kind))
    code_saved = StateSchema(treedef=str(saved_treedef),
                             leaves=tuple(saved_schema_leaves))
    code_manifest = code_saved.to_manifest()

    disk_manifest = _resolve_manifest(manifest)
    if "ckpt-schema-drift" in run:
        _check_schema_drift(
            ctx, code_manifest,
            disk_manifest if disk_manifest is not None
            else json.loads(json.dumps(code_manifest)))

    if "dtype-narrowing-restore" in run:
        saved_for_narrowing = disk_manifest if disk_manifest is not None \
            else code_manifest
        if restore_template is not None:
            tpaths, tleaves, _ = _flatten_with_paths(restore_template)
        else:
            tpaths, tleaves = saved_paths, saved_leaves
        _check_dtype_narrowing(ctx, saved_for_narrowing, tpaths, tleaves)

    if "reshard-illegal" in run and reshard_candidates:
        _check_reshard(ctx, code_manifest, reshard_layout,
                       reshard_candidates)

    if "restore-donation-hazard" in run and resume_fn is not None:
        ctx.findings.extend(check_restore_donation(
            resume_fn, state, *(resume_args or ()), name=name,
            checks=("restore-donation-hazard",)))

    if stats_out is not None:
        stats_out.update({
            "carried": sum(1 for lf in schema.leaves if lf.carried),
            "saved_leaves": len(saved_leaves),
            "reshard_candidates": len(tuple(reshard_candidates or ())),
        })
    return ctx.findings


def _resolve_manifest(manifest):
    """A ``state_schema`` dict (or None) from the schema itself, a whole
    commit-marker payload, or a checkpoint step dir; a format-1 dir (no
    schema) is None: back-compat, not drift."""
    if manifest is None:
        return None
    if isinstance(manifest, str):
        from apex_tpu_torch.checkpoint import manifest_state_schema

        return manifest_state_schema(manifest)
    if isinstance(manifest, dict):
        if "leaves" in manifest:
            return manifest
        return manifest.get("state_schema")
    raise TypeError(
        f"manifest must be a dict or checkpoint dir path, got "
        f"{type(manifest).__name__}")


def _validate_checks(checks):
    run = set(checks or STATE_CHECKS)
    unknown = run - set(STATE_CHECKS)
    if unknown:
        raise ValueError(
            f"unknown state check(s) {sorted(unknown)}; valid: "
            f"{list(STATE_CHECKS)}")
    return run


def report_to_registry(results, registry=None):
    """Publish state findings and per-target carry/save stats:
    ``analysis/state_findings{check=}`` zero-filled over every id,
    ``analysis/state_findings_total``, ``analysis/state_carried_leaves
    {target=}`` and ``analysis/state_saved_leaves{target=}``.
    ``results``: {target: (findings, stats)}. Returns {check: count}."""
    from apex_tpu_torch.observability import get_registry

    reg = registry if registry is not None else get_registry()
    counts = {c: 0 for c in STATE_CHECKS}
    for target, (findings, stats) in sorted(results.items()):
        for f in findings:
            if f.check in counts:
                counts[f.check] += 1
        if stats:
            reg.gauge("analysis/state_carried_leaves",
                      target=target).set(stats.get("carried", 0))
            reg.gauge("analysis/state_saved_leaves",
                      target=target).set(stats.get("saved_leaves", 0))
    for check, n in counts.items():
        reg.counter("analysis/state_findings", check=check).inc(n)
    reg.gauge("analysis/state_findings_total").set(sum(counts.values()))
    return counts
