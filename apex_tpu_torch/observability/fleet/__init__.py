"""Cross-rank telemetry (counterpart of ``apex_tpu.observability.fleet``).

- **identity** (:mod:`~apex_tpu_torch.observability.fleet.identity`) -
  env-driven ``(process_index, process_count, run_id)`` plus
  :func:`rank_path`, the automatic ``.rank{i}`` suffix every shared
  artifact write goes through; the registry, the span tracer, the flight
  recorder and the StepReporter stamp their records with it.
- **straggler detection** (:mod:`~.probe` + :mod:`~.straggler`) - a
  per-step pre-collective wait probe around the grad-sync call sites
  (off by default; on, it marks each rank's enter and exit once the
  tensor is ready on the card) feeding a trailing-median cross-rank skew
  detector that emits ``fleet/straggler`` events naming the slow rank.
- **desync detection** (:mod:`~.desync`) - per-leaf ``(sum, |sum|)``
  fingerprints on the card (max vs mean over the group is the
  one-scalar flag, the gathered matrix the attributing form) with a
  host detector naming the offending rank, step and tensor path;
  ``ResilientTrainLoop`` trips the rollback ladder on a verdict.
- **fleet readers** (:mod:`~.merge` + :mod:`~.collector`) -
  ``merge_fleet`` joins per-rank metrics shards into one report
  (per-rank and cross-rank p50/p99, skew, straggler pass, rank -> pid
  Perfetto export); ``merge_flight_records`` joins ``flightrec_*``
  shards into the fleet post-mortem naming the stuck rank and the last
  collective each rank entered.

CLI: ``python -m apex_tpu_torch.observability fleet <shards...>`` /
``... fleet --flight DIR``.
"""

from apex_tpu_torch.observability.fleet import probe
from apex_tpu_torch.observability.fleet.collector import (
    find_flight_records,
    merge_flight_records,
    write_fleet_record,
)
from apex_tpu_torch.observability.fleet.desync import (
    DesyncDetector,
    fingerprint,
    fingerprint_delta,
    fingerprint_gather,
    leaf_paths,
)
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
from apex_tpu_torch.observability.fleet.merge import (
    fleet_metric_records,
    fleet_shards,
    fleet_trace_events,
    merge_fleet,
)
from apex_tpu_torch.observability.fleet.straggler import (
    StragglerDetector,
)

__all__ = [
    "FleetIdentity", "process_identity", "identity_fields",
    "is_fleet_member", "rank_path", "rank_of_path", "stamp_environ",
    "ENV_INDEX", "ENV_COUNT", "ENV_RUN_ID",
    "probe", "StragglerDetector",
    "DesyncDetector", "fingerprint", "fingerprint_delta",
    "fingerprint_gather", "leaf_paths",
    "fleet_shards", "merge_fleet", "fleet_metric_records",
    "fleet_trace_events",
    "find_flight_records", "merge_flight_records", "write_fleet_record",
]
