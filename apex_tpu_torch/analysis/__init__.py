"""apex_tpu_torch.analysis — the static lint of the port, and the
calibration priors half of ``apex_tpu.analysis.memory_checks``.

Two path-driven engines, one CLI, one gate:

- **AST engine** (:mod:`.ast_checks`): the reference's thirteen check
  ids over the port's sources. Five are framework-neutral and keep the
  reference's logic (``mutable-default``, ``raw-clock``,
  ``swallowed-exception-in-step-loop``, ``unclosed-span``,
  ``rank-unsafe-artifact-path``); eight name the device runtime and take
  their PyTorch forms: a device synchronize timed by a wall clock, host
  pulls and Python RNG inside ``torch.compile`` bodies and CUDA graph
  captures, ``torch.isnan`` pulls in step loops, raw fp8 casts, launch
  geometry hardcoded beside a kernel launch, allocator introspection
  outside the memory tier, and unordered loops that decide collective
  order.
- **host-concurrency engine** (:mod:`.concurrency_checks`): the
  reference's five checks and class-scoped model over the threaded host
  runtime (span tracer, flight recorder, registry, checkpoint writer,
  preemption watcher, compile listener, prefetch loader, fleet
  collector, kernel build lock).

Four graph engines over ATen graphs, the single-device half of the
reference's, each with the reference's check ids in their PyTorch forms:

- the **walk** (:mod:`.interp`): ``trace`` makes a function's ATen
  ``GraphModule`` with fake tensors (autograd included, every
  hand-written kernel one node with its launch plan), and
  ``interpret_lattices`` runs several lattices over it in one pass;
- **graph checks** (:mod:`.graph_checks`, the counterpart of
  ``jaxpr_checks``): ``donation``, ``recompile``, ``pallas-block``;
- **precision** (:mod:`.dataflow`, :mod:`.precision_checks`): the seven
  precision-flow ids;
- **state** (:mod:`.state_checks`): the five checkpoint/state-flow ids.

:mod:`.targets` registers the port's entry points at the reference
targets' sizes; the gate runs them by default.

Findings, suppressions (``# apex-lint: disable=<id>``), baselines and
snippet fingerprints (:mod:`.findings`) are the reference's format, so
each package reads the other's. CLI: ``python -m
apex_tpu_torch.analysis`` (:mod:`.cli`); the gate is
``apex_tpu_torch/analysis/baseline.json`` over the default paths
(``apex_tpu_torch``, ``chip_smoke.py`` and the port's driver scripts)
and the registered targets. The reference's sharding, spmd and memory
liveness engines, ``collective-axis`` and its planner are not ported
yet.
"""

from apex_tpu_torch.analysis.ast_checks import (
    AST_CHECKS,
    lint_paths,
    lint_source,
)
from apex_tpu_torch.analysis.concurrency_checks import CONCURRENCY_CHECKS
from apex_tpu_torch.analysis.findings import (
    Finding,
    load_baseline,
    new_findings,
    save_baseline,
)
from apex_tpu_torch.analysis.graph_checks import GRAPH_CHECKS, analyze_fn
from apex_tpu_torch.analysis.interp import (
    Lattice,
    LatticeRun,
    interpret_lattices,
    trace,
)
from apex_tpu_torch.analysis.memory_checks import (  # noqa: F401
    HBM_PRIORS_PATH,
    PRIORS_SCHEMA_VERSION,
    load_hbm_priors,
    prior_for,
    prior_ratio_of,
)

from apex_tpu_torch.analysis.precision_checks import (
    PRECISION_CHECKS,
    analyze_precision,
)
from apex_tpu_torch.analysis.state_checks import STATE_CHECKS, analyze_state

__all__ = ["AST_CHECKS", "CONCURRENCY_CHECKS", "Finding", "GRAPH_CHECKS",
           "HBM_PRIORS_PATH", "Lattice", "LatticeRun", "PRECISION_CHECKS",
           "PRIORS_SCHEMA_VERSION", "STATE_CHECKS", "analyze_fn",
           "analyze_precision", "analyze_state", "interpret_lattices",
           "lint_paths", "lint_source", "load_baseline", "load_hbm_priors",
           "new_findings", "prior_for", "prior_ratio_of", "save_baseline",
           "trace"]
