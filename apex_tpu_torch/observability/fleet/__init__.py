"""Cross-rank telemetry (counterpart of ``apex_tpu.observability.fleet``):
the identity half.

:mod:`~apex_tpu_torch.observability.fleet.identity` gives each process
its ``(process_index, process_count, run_id)`` from the environment and
:func:`rank_path`, the automatic ``.rank{i}`` suffix every shared
artifact write goes through; the registry, the span tracer, the flight
recorder and the StepReporter stamp their records with it. The
straggler probe, the desync fingerprints and the fleet readers are not
ported yet (ROADMAP.md, Queue 1 item 7).
"""

from apex_tpu_torch.observability.fleet.identity import (
    ENV_COUNT,
    ENV_INDEX,
    ENV_RUN_ID,
    FleetIdentity,
    identity_fields,
    is_fleet_member,
    process_identity,
    rank_of_path,
    rank_path,
    stamp_environ,
)

__all__ = [
    "FleetIdentity", "process_identity", "identity_fields",
    "is_fleet_member", "rank_path", "rank_of_path", "stamp_environ",
    "ENV_INDEX", "ENV_COUNT", "ENV_RUN_ID",
]
