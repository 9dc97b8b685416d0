"""Deterministic fault injection (port of
``apex_tpu/resilience/faults.py:54-200``).

A :class:`FaultPlan` is a seeded schedule of simulated failures, in the
reference's spec language and with the reference's draws, so one spec
fires at the same steps in both packages:

- ``preempt``      a maintenance-event/SIGTERM-style preemption signal
                   (the serving engine drains, dumps and exits on it);
- ``ckpt_torn``    a checkpoint write killed after the data, before the
                   commit marker;
- ``ckpt_enospc``  a checkpoint write refused at open (disk full);
- ``step_exc``     a transient exception out of the train step;
- ``nan_grads``    a NaN/overflow storm poisoning the step's output;
- ``stall``        a step that hangs far past its normal duration;
- ``oom``          a step that dies out of memory (:class:`InjectedOom`).

Faults fire at fixed steps (``kind@7``) or at seeded per-step draws
(``kind~0.05``); both are deterministic in (seed, kind, step). Each
planned fault fires *once per process* (:meth:`FaultPlan.should_fire`
spends it).

:func:`corrupt_tree` (``faults.py:204``) poisons a training state the
way a NaN storm would, and :func:`inject_checkpoint_failures`
(``:228``) arms :mod:`apex_tpu_torch.checkpoint`'s fault hook with a
plan's torn-write and disk-full schedule.
"""

from __future__ import annotations

import contextlib
import errno
import random
from typing import Optional

__all__ = [
    "KINDS", "FaultInjected", "TornWrite", "DiskFull",
    "TransientStepError", "InjectedOom", "INJECTED_OOM_BYTES", "FaultPlan",
    "corrupt_tree", "inject_checkpoint_failures",
]

KINDS = ("preempt", "ckpt_torn", "ckpt_enospc", "step_exc", "nan_grads",
         "stall", "oom")


class FaultInjected(Exception):
    """Base of every injected fault (so tests can tell simulated
    failures from real ones)."""


class TornWrite(FaultInjected, OSError):
    """A checkpoint write killed between data and commit marker."""


class DiskFull(FaultInjected, OSError):
    """An injected ENOSPC at checkpoint-write open."""

    def __init__(self, path: str):
        super().__init__(errno.ENOSPC,
                         "injected: no space left on device", path)


class TransientStepError(FaultInjected):
    """A transient train-step failure (retryable by design)."""


#: the simulated allocation an injected OOM asks for (1 GiB — big
#: enough to be unmistakably an allocation, stable for chaos asserts).
INJECTED_OOM_BYTES = 1 << 30


class InjectedOom(FaultInjected, RuntimeError):
    """A simulated out-of-memory step death, with the reference's
    message (``RESOURCE_EXHAUSTED: Out of memory while trying to
    allocate N bytes``), so one parser reads both packages' faults."""

    def __init__(self, step: int,
                 requested_bytes: int = INJECTED_OOM_BYTES):
        super().__init__(
            f"RESOURCE_EXHAUSTED: Out of memory while trying to "
            f"allocate {int(requested_bytes)} bytes. "
            f"(injected oom fault at step {step})")
        self.step = step
        self.requested_bytes = int(requested_bytes)


class FaultPlan:
    """A seeded, deterministic fault schedule.

    ``steps``: {kind: set of step indices} for fixed firings;
    ``probs``: {kind: p} for per-step seeded draws. Query with
    :meth:`should_fire` (spends the fault for this process) or
    :meth:`scheduled` (pure read).
    """

    def __init__(self, seed: int = 0, steps: Optional[dict] = None,
                 probs: Optional[dict] = None):
        self.seed = int(seed)
        self._steps = {k: frozenset(int(s) for s in v)
                       for k, v in (steps or {}).items()}
        self._probs = {k: float(p) for k, p in (probs or {}).items()}
        for kind in list(self._steps) + list(self._probs):
            if kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r}; valid: {list(KINDS)}")
        for kind, p in self._probs.items():
            if not 0.0 <= p <= 1.0:
                raise ValueError(
                    f"fault prob for {kind!r} must be in [0, 1], got {p}")
        self._spent: set = set()

    # ------------------------------------------------------------ spec

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse a compact spec: comma-separated tokens of ``seed=N``,
        ``kind@step`` (multiple steps join with ``+``: ``preempt@4+9``)
        and ``kind~prob`` (seeded per-step draw). Example::

            "seed=3,preempt@12,ckpt_torn@4,step_exc~0.02"
        """
        seed, steps, probs = 0, {}, {}
        for token in (text or "").split(","):
            token = token.strip()
            if not token:
                continue
            if token.startswith("seed="):
                seed = int(token[5:])
            elif "@" in token:
                kind, _, at = token.partition("@")
                try:
                    fired = {int(s) for s in at.split("+")}
                except ValueError:
                    raise ValueError(
                        f"bad fault step list in token {token!r}")
                steps.setdefault(kind, set()).update(fired)
            elif "~" in token:
                kind, _, p = token.partition("~")
                probs[kind] = float(p)
            else:
                raise ValueError(
                    f"bad fault token {token!r}: expected seed=N, "
                    f"kind@step[+step...], or kind~prob")
        return cls(seed=seed, steps=steps, probs=probs)

    def spec(self) -> str:
        """Canonical spec string (parse(spec()) round-trips)."""
        parts = [f"seed={self.seed}"]
        for kind in KINDS:
            if kind in self._steps and self._steps[kind]:
                at = "+".join(str(s) for s in sorted(self._steps[kind]))
                parts.append(f"{kind}@{at}")
            if kind in self._probs:
                parts.append(f"{kind}~{self._probs[kind]}")
        return ",".join(parts)

    def __repr__(self):
        return f"FaultPlan({self.spec()!r})"

    # ----------------------------------------------------------- draws

    def scheduled(self, kind: str, step: int) -> bool:
        """Pure read: does the plan place ``kind`` at ``step``?
        Probabilistic kinds draw deterministically from
        (seed, kind, step) — any process asking gets the same answer."""
        if step in self._steps.get(kind, ()):
            return True
        p = self._probs.get(kind)
        if p is None:
            return False
        return random.Random(f"{self.seed}:{kind}:{step}").random() < p

    def should_fire(self, kind: str, step: int, spend: bool = True) -> bool:
        """Scheduled AND not already fired this process. ``spend=True``
        marks it fired — a retry/rollback replay of the same step sees
        the fault as past, like a real transient."""
        if (kind, step) in self._spent or not self.scheduled(kind, step):
            return False
        if spend:
            self._spent.add((kind, step))
        return True

    def faults_at(self, step: int) -> tuple:
        """All kinds scheduled at ``step`` (pure read)."""
        return tuple(k for k in KINDS if self.scheduled(k, step))

    def reset(self) -> None:
        """Forget spent faults (a fresh process would)."""
        self._spent.clear()


def corrupt_tree(tree):
    """The injected numeric storm: a tree of NEW NaN-filled tensors (and
    numpy arrays) where the leaf is floating point; integer and bool
    leaves (step counters, seeds) and python scalars pass through. The
    input is left as it was."""
    import numpy as np
    import torch

    from apex_tpu_torch import _tree

    def poison(leaf):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() or leaf.is_complex():
                return torch.full_like(leaf, float("nan"))
            return leaf
        if isinstance(leaf, (np.ndarray, np.generic)) and np.issubdtype(
                leaf.dtype, np.inexact):
            return np.full_like(leaf, np.nan)
        return leaf

    leaves, treedef = _tree.flatten(tree)
    return treedef.unflatten([poison(leaf) for leaf in leaves])


def _count(registry, kind: str) -> None:
    reg = registry
    if reg is None:
        from apex_tpu_torch.observability import get_registry
        reg = get_registry()
    reg.counter("resilience/faults_injected", kind=kind).inc()


@contextlib.contextmanager
def inject_checkpoint_failures(plan: FaultPlan, registry=None):
    """Arm ``apex_tpu_torch.checkpoint``'s fault hook with this plan's
    ``ckpt_torn`` (at ``pre_commit``) / ``ckpt_enospc`` (at
    ``pre_write``) schedule. Saves without a step index key as step
    ``-1``."""
    from apex_tpu_torch import checkpoint as ckpt

    def hook(stage, step, path):
        s = -1 if step is None else int(step)
        if stage == "pre_write" and plan.should_fire("ckpt_enospc", s):
            _count(registry, "ckpt_enospc")
            raise DiskFull(path)
        if stage == "pre_commit" and plan.should_fire("ckpt_torn", s):
            _count(registry, "ckpt_torn")
            raise TornWrite(
                f"injected: write of {path} killed before commit marker")

    prev = ckpt._FAULT_HOOK
    ckpt._FAULT_HOOK = hook
    try:
        yield plan
    finally:
        ckpt._FAULT_HOOK = prev
