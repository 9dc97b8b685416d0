"""Finding a run's per-rank shards (from
``apex_tpu/observability/fleet/merge.py``): :func:`fleet_shards`, which
the run ledger reads a metrics family through. The fleet merge itself
(``merge_fleet`` and its trace export) comes with the rest of the fleet
tier.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

from apex_tpu_torch.observability.fleet.identity import rank_of_path

__all__ = ["fleet_shards"]


def fleet_shards(base: str) -> List[Tuple[Optional[int], str]]:
    """(rank, path) pairs for the shard family behind ``base``.

    ``base`` may be a shared path (its ``.rank*`` siblings are
    globbed; a legacy un-suffixed file at ``base`` itself joins as
    rank None), an existing shard (resolved to its family), or a
    directory (every ``*.rank*.jsonl`` inside). Sorted by rank,
    legacy-unsuffixed last."""
    if os.path.isdir(base):
        paths = sorted(glob.glob(os.path.join(base, "*.rank*.jsonl")))
    else:
        head, tail = os.path.split(base)
        root, ext = os.path.splitext(tail)
        # strip an existing .rank{i} so any shard names its family
        if rank_of_path(base) is not None:
            root = root.rsplit(".rank", 1)[0]
        pattern = os.path.join(head, f"{root}.rank*{ext}")
        paths = sorted(glob.glob(pattern))
        legacy = os.path.join(head, root + ext)
        if os.path.isfile(legacy):
            paths.append(legacy)
    out = []
    for path in paths:
        out.append((rank_of_path(path), path))
    out.sort(key=lambda rp: (rp[0] is None, rp[0] if rp[0] is not None
                             else -1, rp[1]))
    return out
