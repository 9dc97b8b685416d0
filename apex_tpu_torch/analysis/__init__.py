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

Findings, suppressions (``# apex-lint: disable=<id>``), baselines and
snippet fingerprints (:mod:`.findings`) are the reference's format, so
each package reads the other's. CLI: ``python -m
apex_tpu_torch.analysis`` (:mod:`.cli`); the gate is
``apex_tpu_torch/analysis/baseline.json`` over the default paths
(``apex_tpu_torch``, ``chip_smoke.py`` and the port's driver scripts).
The reference's graph engines (jaxpr, dataflow, sharding, spmd, state,
memory liveness) and its planner are not ported yet.
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
from apex_tpu_torch.analysis.memory_checks import (  # noqa: F401
    HBM_PRIORS_PATH,
    PRIORS_SCHEMA_VERSION,
    load_hbm_priors,
    prior_for,
    prior_ratio_of,
)

__all__ = ["AST_CHECKS", "CONCURRENCY_CHECKS", "Finding", "HBM_PRIORS_PATH",
           "PRIORS_SCHEMA_VERSION", "lint_paths", "lint_source",
           "load_baseline", "load_hbm_priors", "new_findings", "prior_for",
           "prior_ratio_of", "save_baseline"]
