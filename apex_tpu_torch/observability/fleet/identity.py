"""Fleet identity (port of ``apex_tpu/observability/fleet/identity.py``,
with the same environment names): which rank is this process, and where
may it write?

- :func:`process_identity` - ``(process_index, process_count, run_id)``
  for this process, read from ``APEX_TPU_PROCESS_INDEX`` /
  ``APEX_TPU_PROCESS_COUNT`` / ``APEX_TPU_RUN_ID``. The
  :mod:`apex_tpu_torch.parallel.multiproc` launcher exports them for
  each worker, and ``initialize_distributed`` back-fills them from the
  process group once it is up. Reading the environment keeps every
  telemetry write free of device and process-group calls.
- :func:`rank_path` - the collision-free per-rank artifact path: a
  fleet member writing to a shared path gets an automatic ``.rank{i}``
  suffix before the extension (``metrics.jsonl`` ->
  ``metrics.rank3.jsonl``); a solo process writes the path unchanged,
  so single-process dumps stay byte- and name-stable.
- :func:`identity_fields` - the ``{process_index, process_count,
  run_id}`` stamp every registry JSONL record, span dump, step record
  and flight-record artifact carries.
"""

from __future__ import annotations

import os
import re
from typing import NamedTuple, Optional

__all__ = [
    "FleetIdentity", "process_identity", "identity_fields",
    "is_fleet_member", "rank_path", "rank_of_path", "stamp_environ",
    "ENV_INDEX", "ENV_COUNT", "ENV_RUN_ID",
]

ENV_INDEX = "APEX_TPU_PROCESS_INDEX"
ENV_COUNT = "APEX_TPU_PROCESS_COUNT"
ENV_RUN_ID = "APEX_TPU_RUN_ID"

_RANK_RE = re.compile(r"\.rank(\d+)(?=\.|$)")


class FleetIdentity(NamedTuple):
    process_index: int
    process_count: int
    run_id: Optional[str]


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not an integer — the fleet identity "
            f"env vars are set by apex_tpu_torch.parallel.multiproc; a "
            f"malformed override would silently mis-route every "
            f"per-rank artifact")


def process_identity() -> FleetIdentity:
    """This process's fleet coordinates, env-first.

    With neither env var set this is a solo process:
    ``(0, 1, run_id-or-None)``. Setting ``APEX_TPU_PROCESS_INDEX``
    alone marks the process a fleet member of unknown size (count
    defaults to ``index + 1`` so the pair stays consistent).
    """
    index = _env_int(ENV_INDEX)
    count = _env_int(ENV_COUNT)
    if index is None:
        index = 0
        if count is None:
            count = 1
    elif count is None:
        count = index + 1
    if index < 0 or count < 1 or index >= count:
        raise ValueError(
            f"inconsistent fleet identity: {ENV_INDEX}={index} "
            f"{ENV_COUNT}={count} (need 0 <= index < count)")
    return FleetIdentity(index, count, os.environ.get(ENV_RUN_ID) or None)


def is_fleet_member(ident: Optional[FleetIdentity] = None) -> bool:
    """True when this process is one rank of a fleet — i.e. shared
    artifact paths must be rank-suffixed. A solo process (no identity
    env, count 1) is not a member, keeping legacy single-process
    artifact names unchanged."""
    if os.environ.get(ENV_INDEX) not in (None, ""):
        return True
    ident = ident if ident is not None else process_identity()
    return ident.process_count > 1


def identity_fields(ident: Optional[FleetIdentity] = None) -> dict:
    """The per-record stamp: ``{process_index, process_count, run_id}``
    (``run_id`` omitted when unset — readers treat absence as the
    anonymous local run)."""
    ident = ident if ident is not None else process_identity()
    fields = {"process_index": ident.process_index,
              "process_count": ident.process_count}
    if ident.run_id:
        fields["run_id"] = ident.run_id
    return fields


def rank_path(path: str, ident: Optional[FleetIdentity] = None) -> str:
    """Collision-free per-rank variant of a (possibly shared) path.

    Fleet members get ``.rank{i}`` inserted before the final extension
    (``out/metrics.jsonl`` → ``out/metrics.rank3.jsonl``;
    extensionless paths get the suffix appended). Solo processes and
    paths that already carry a ``.rank{n}`` component pass through
    unchanged, so the function is idempotent and safe to apply at
    every write site."""
    ident = ident if ident is not None else process_identity()
    if not is_fleet_member(ident):
        return path
    head, tail = os.path.split(path)
    if _RANK_RE.search(tail):
        return path
    root, ext = os.path.splitext(tail)
    return os.path.join(head, f"{root}.rank{ident.process_index}{ext}")


def rank_of_path(path: str) -> Optional[int]:
    """The rank a ``.rank{i}``-suffixed shard path belongs to, or None
    for a legacy un-suffixed file."""
    m = _RANK_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else None


def stamp_environ(env: dict, index: int, count: int,
                  run_id: Optional[str] = None) -> dict:
    """Write the fleet identity into an environment dict (the launcher
    helper): returns ``env`` with the three identity vars set."""
    env[ENV_INDEX] = str(int(index))
    env[ENV_COUNT] = str(int(count))
    if run_id:
        env[ENV_RUN_ID] = str(run_id)
    return env
