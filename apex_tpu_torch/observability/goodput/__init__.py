"""Goodput accounting + unified run ledger (port of
``apex_tpu/observability/goodput``, copied: host code over record
dicts, with the same causes and the same ``goodput/*`` gauges).

:mod:`.ledger` normalizes every artifact family a run produces into
one ordered, rank-aware timeline; :mod:`.accounting` classifies the
wall-clock into causes and reduces it to the goodput ratio and
lost-seconds-by-cause. ``python -m apex_tpu_torch.observability
goodput`` is the CLI face; the 3-D example publishes the ``goodput/*``
gauge family before its metrics dump.
"""

from .ledger import (
    INTERVAL_KINDS,
    LEDGER_KIND,
    LEDGER_SCHEMA_VERSION,
    RunLedger,
    ledger_from_records,
)
from .accounting import (
    ACCOUNTING_KIND,
    ACCOUNTING_SCHEMA_VERSION,
    CAUSES,
    FAULT_CAUSES,
    MIN_STEP_HISTORY,
    STALL_FACTOR,
    account,
    classify,
    publish,
    render,
    to_trace_events,
)

__all__ = [
    "INTERVAL_KINDS", "LEDGER_KIND", "LEDGER_SCHEMA_VERSION",
    "RunLedger", "ledger_from_records",
    "ACCOUNTING_KIND", "ACCOUNTING_SCHEMA_VERSION", "CAUSES",
    "FAULT_CAUSES", "MIN_STEP_HISTORY", "STALL_FACTOR",
    "account", "classify", "publish", "render", "to_trace_events",
]
