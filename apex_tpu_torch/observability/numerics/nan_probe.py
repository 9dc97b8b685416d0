"""NaN/Inf provenance: which op went non-finite first, and where in the
source it lives (port of ``apex_tpu/observability/numerics/nan_probe.py``).

When the resilience ladder trips on a non-finite step, "the state has
NaNs" is no answer: the question is which tensor drifted and which op
first produced a non-finite value. The reference replays the step's
jaxpr under its analysis interpreter; the port replays the step eagerly
under a ``TorchDispatchMode`` that sees every ATen op, and the first op
whose output is non-finite is classified

- ``origin``: its inputs were finite, so this op created the NaN/Inf (an
  exp overflow, a 0/0), reported with its name (``exp``, ``div``) and
  the innermost source frame outside ``torch`` and this module;
- ``inherited``: a non-finite value already entered through an input (an
  injected ``nan_grads`` corruption, a poisoned checkpoint): the op is
  the first to touch it, and the offending input paths are named.

The hand-written CUDA kernels run through ctypes, out of ATen's sight:
each wrapper reports its launch to the probe
(``kernel_config.note_launch``), so a kernel that makes a non-finite
value from finite inputs is the ``origin`` under its own name
(``flash_fwd``, ``rms_norm_fwd``), as the reference names an opaque
region. An in-place kernel reports its in-place operands as outputs only.

The non-finite flags stay on the device, one pair an op, and are read
once after the replay. The replay runs on a copy of the state, never on
the caller's tensors, with the RNG state restored afterwards.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _disable_current_modes,
)
from torch.utils._pytree import tree_leaves

__all__ = ["Provenance", "probe_fn", "probe_tree", "step_provenance"]

_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__)) + os.sep
# frames that are the probe's machinery, never a source: this module and
# the launch hook's
_OWN_FILES = {os.path.abspath(__file__),
              os.path.join(os.path.dirname(os.path.dirname(
                  os.path.dirname(os.path.abspath(__file__)))),
                  "ops", "kernel_config.py")}

# ops whose outputs hold whatever memory held (never a finding)
_UNINITIALISED = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "resize_", "set_"}
# in-place ops that overwrite their first argument without reading it
_OVERWRITES = {"copy_", "fill_", "zero_", "normal_", "uniform_",
               "bernoulli_", "random_", "exponential_", "index_fill_"}


@dataclasses.dataclass
class Provenance:
    """The post-mortem verdict a ``TrainAborted`` report carries."""

    ok: bool                          # True = nothing non-finite found
    kind: Optional[str] = None        # "origin" | "inherited"
    primitive: Optional[str] = None   # first offending op
    source: Optional[str] = None      # user source location
    input_paths: tuple = ()           # non-finite probe inputs
    output_paths: tuple = ()          # non-finite tensors (state/outs)
    message: str = ""

    def as_dict(self) -> dict:
        return {
            "ok": self.ok, "kind": self.kind,
            "primitive": self.primitive, "source": self.source,
            "input_paths": list(self.input_paths),
            "output_paths": list(self.output_paths),
            "message": self.message,
        }


def probe_tree(tree) -> Provenance:
    """Paths-only provenance: name the non-finite tensors of ``tree``
    (one stats pass and one fetch; no replay)."""
    from apex_tpu_torch.observability.numerics import stats

    paths = stats.nonfinite_paths(tree)
    if not paths:
        return Provenance(ok=True, message="all tensors finite")
    return Provenance(
        ok=False, output_paths=paths,
        message=f"{len(paths)} non-finite tensor(s)")


def _floating(t) -> bool:
    return isinstance(t, torch.Tensor) and (
        t.is_floating_point() or t.is_complex()) and t.numel() > 0


def _nonfinite(tensors):
    """One 0-dim bool tensor on the first tensor's device: whether any
    of ``tensors`` holds a NaN or Inf (None when there is none)."""
    flags = []
    for t in tensors:
        if t.element_size() == 1:  # fp8: isfinite takes no such dtype
            t = t.float()
        flags.append(torch.logical_not(torch.isfinite(t)).any())
    if not flags:
        return None
    dev = flags[0].device
    return torch.stack([f.to(dev) for f in flags]).any()


def _source() -> Optional[str]:
    """The innermost frame outside torch and the probe, as
    ``file:line (function)``."""
    frame = sys._getframe(1)
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if not (path.startswith(_TORCH_DIR) or path in _OWN_FILES):
            return f"{path}:{frame.f_lineno} ({frame.f_code.co_name})"
        frame = frame.f_back
    return None


class _Replay(TorchDispatchMode):
    """Records, for every ATen op and every reported kernel launch, its
    name, its source and two device flags: any input non-finite, any
    output non-finite."""

    def __init__(self):
        super().__init__()
        self.ops: list = []  # (name, source, in_flag, out_flag)

    def _record(self, name, in_flag, outputs):
        out_flag = _nonfinite([t for t in outputs if _floating(t)])
        if out_flag is not None:
            self.ops.append((name, _source(), in_flag, out_flag))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        # a view (detach, reshape, transpose) computes nothing: it can be
        # no origin and is not what consumes a poisoned input
        if name in _UNINITIALISED or func.is_view:
            return func(*args, **kwargs)
        reads = args[1:] if name in _OVERWRITES else args
        inputs = [t for t in tree_leaves(
            (reads, {k: v for k, v in kwargs.items() if k != "out"}))
            if _floating(t)]
        # the inputs' flags before the op: an in-place op overwrites them
        in_flag = _nonfinite(inputs)
        out = func(*args, **kwargs)
        self._record(name, in_flag, tree_leaves(out))
        return out

    def note_launch(self, kernel, inputs, outputs):
        # outside __torch_dispatch__ the mode is live: the flags' own ops
        # must not be recorded
        with _disable_current_modes():
            self._record(kernel, _nonfinite(
                [t for t in inputs if _floating(t)]), outputs)

    def first(self):
        """(name, source, inherited) of the first op with a non-finite
        output, or None: the flags fetched in one read a device."""
        if not self.ops:
            return None
        by_device: dict = {}
        for i, (_, _, inf, outf) in enumerate(self.ops):
            for j, f in ((2 * i, inf), (2 * i + 1, outf)):
                if f is not None:
                    by_device.setdefault(f.device, []).append((j, f))
        flags = [False] * (2 * len(self.ops))
        for items in by_device.values():
            values = torch.stack([f for _, f in items]).cpu().tolist()
            for (j, _), v in zip(items, values):
                flags[j] = bool(v)
        for i, (name, src, _, _) in enumerate(self.ops):
            if flags[2 * i + 1]:
                return name, src, flags[2 * i]
        return None


def _leaves_with_paths(args):
    from apex_tpu_torch.observability.numerics import stats

    tree = args if len(args) != 1 else args[0]
    return stats._path_leaves(tree)


def _is_nonfinite_leaf(leaf) -> bool:
    import numpy as np

    if isinstance(leaf, torch.Tensor):
        return _floating(leaf) and bool(
            _nonfinite([leaf.detach()]).item())
    if isinstance(leaf, (np.ndarray, np.generic)) and np.issubdtype(
            np.asarray(leaf).dtype, np.inexact):
        return not bool(np.all(np.isfinite(leaf)))
    if isinstance(leaf, float):
        return not (leaf == leaf and abs(leaf) != float("inf"))
    return False


def probe_fn(fn, *args) -> Provenance:
    """Run ``fn(*args)`` under the replay mode and report the first op
    (or reported kernel) whose output is non-finite (module docstring).
    Raises whatever ``fn`` raises: callers probing arbitrary functions
    should catch. ``fn`` runs on ``args`` as given; :func:`step_provenance`
    hands it copies."""
    from apex_tpu_torch.ops import kernel_config

    bad_inputs = tuple(p for p, leaf in _leaves_with_paths(args)
                       if _is_nonfinite_leaf(leaf))
    mode = _Replay()
    prev_hook = kernel_config._LAUNCH_HOOK
    kernel_config._LAUNCH_HOOK = mode.note_launch
    try:
        with mode:
            outs = fn(*args)
    finally:
        kernel_config._LAUNCH_HOOK = prev_hook
    first = mode.first()
    if first is not None:
        prim, src, inherited = first
        kind = "inherited" if inherited else "origin"
        msg = (f"first non-finite value produced by primitive '{prim}'"
               if kind == "origin" else
               f"non-finite input first consumed by primitive '{prim}'")
        if src:
            msg += f" at {src}"
        return Provenance(ok=False, kind=kind, primitive=prim, source=src,
                          input_paths=bad_inputs, message=msg)
    if bad_inputs:
        return Provenance(
            ok=False, kind="inherited", input_paths=bad_inputs,
            message="non-finite inputs never consumed by a replayable "
                    "primitive")
    if any(_is_nonfinite_leaf(t) for t in tree_leaves(outs)):
        return Provenance(
            ok=False, kind="origin",
            message="non-finite output from an unreplayable region "
                    "(opaque kernel)")
    return Provenance(ok=True, message="replay stayed finite")


def _copy(tree):
    """``tree`` with every tensor leaf copied (requires_grad kept)."""
    from apex_tpu_torch import _tree

    leaves, treedef = _tree.flatten(tree)
    return treedef.unflatten([
        leaf.detach().clone().requires_grad_(leaf.requires_grad)
        if isinstance(leaf, torch.Tensor) else leaf for leaf in leaves])


def versions(tree) -> list:
    """The version counters of ``tree``'s tensors: an in-place update of
    one (an ATen op, or a hand-written kernel whose wrapper bumps it)
    moves its counter."""
    from apex_tpu_torch import _tree

    return [leaf._version for leaf in _tree.flatten(tree)[0]
            if isinstance(leaf, torch.Tensor)]


def _replay(step_fn, state, step: int) -> Provenance:
    """:func:`probe_fn` of ``step_fn(copy of state, step)``, the RNG
    state (the CPU's and the state's CUDA devices') restored after."""
    from apex_tpu_torch import _tree

    devices = sorted({leaf.device.index for leaf in _tree.flatten(state)[0]
                      if isinstance(leaf, torch.Tensor) and leaf.is_cuda})
    with torch.random.fork_rng(devices=devices):
        return probe_fn(lambda s: step_fn(s, step), _copy(state))


def step_provenance(step_fn, prev_state, bad_state,
                    step: int) -> Provenance:
    """The resilience ladder's hook: provenance for a step whose output
    ``bad_state`` failed the finite check.

    1. The offending tensor paths come from one stats pass over
       ``bad_state`` (always works).
    2. When a pre-step state is at hand, replay the step on a copy of
       it: a NaN born inside the step is reported as ``origin`` with its
       op and source. ``prev_state`` None (the caller had no pre-step
       values: the step updated its state in place) skips this stage,
       and the report says so.
    3. Otherwise (or when that replay stays finite) replay on a copy of
       ``bad_state`` and name the first op that consumes the poison
       (``inherited``).

    Never raises: any probe failure degrades to the paths-only report.
    """
    try:
        base = probe_tree(bad_state)
    except Exception as e:  # noqa: BLE001 - provenance must never mask
        # the original training failure
        return Provenance(ok=False, message=f"probe failed: {e!r:.200}")
    try:
        have_prev = prev_state is not None
        if have_prev:
            # runs even when the state is finite: a NaN loss with finite
            # params still has an in-step origin worth naming
            prov = _replay(step_fn, prev_state, step)
            if not prov.ok:
                prov.output_paths = base.output_paths
                return prov
        if base.ok:
            return base
        prov = _replay(step_fn, bad_state, step)
        if not prov.ok:
            prov.output_paths = base.output_paths
            prov.message += (" (step replay on the pre-step state was "
                             "clean)" if have_prev else
                             " (no pre-step state was available: the step "
                             "updates its state in place)")
            return prov
        base.message += ("; step replay stayed finite — the non-finite "
                         "values entered outside the replayed step")
    except Exception as e:  # noqa: BLE001 - an unreplayable step_fn
        base.message += f"; step replay unavailable ({e!r:.120})"
    return base
