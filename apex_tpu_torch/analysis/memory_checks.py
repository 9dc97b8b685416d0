"""Device-memory calibration priors (port of the priors half of
``apex_tpu/analysis/memory_checks.py:190-240``, with ``prior_ratio_of``
from ``apex_tpu/analysis/sharding_flow.py:899``).

A prior is a measured/modeled ratio of device bytes for one target: the
model prices a workload's memory, the prior corrects it. The port keeps
its own ``hbm_priors.json`` (the reference's schema, version 1), whose
ratios were measured on the GPU; the reference's were taken on another
backend and do not carry over. The file says how each ratio is measured
and on which card.
"""

from __future__ import annotations

import json
import math
import os

__all__ = ["HBM_PRIORS_PATH", "PRIORS_SCHEMA_VERSION", "load_hbm_priors",
           "prior_for", "prior_ratio_of"]

PRIORS_SCHEMA_VERSION = 1

HBM_PRIORS_PATH = os.path.join(os.path.dirname(__file__),
                               "hbm_priors.json")


def prior_ratio_of(priors) -> float:
    """A prior as a positive finite float ratio. Accepts a bare number or
    a priors-file row (``{"ratio": ...}``); raises on anything else."""
    ratio = priors.get("ratio") if isinstance(priors, dict) else priors
    try:
        ratio = float(ratio)
    except (TypeError, ValueError):
        raise ValueError(
            f"HBM prior must be a number or a {{'ratio': ...}} row, "
            f"got {priors!r}")
    if not math.isfinite(ratio) or ratio <= 0:
        raise ValueError(
            f"HBM prior ratio must be positive and finite, got "
            f"{ratio!r} (from {priors!r})")
    return ratio


def load_hbm_priors(path=None) -> dict:
    """Load and validate the committed calibration priors; raises on a
    schema drift or a malformed ratio. Returns the whole document
    (``priors`` maps target -> row with ``ratio``)."""
    path = path or HBM_PRIORS_PATH
    with open(path) as f:
        data = json.load(f)
    ver = data.get("schema_version")
    if ver != PRIORS_SCHEMA_VERSION:
        raise ValueError(
            f"{path}: hbm_priors schema_version {ver!r} != expected "
            f"{PRIORS_SCHEMA_VERSION}; refusing to price device memory "
            f"on a drifted prior file")
    priors = data.get("priors")
    if not isinstance(priors, dict) or not priors:
        raise ValueError(
            f"{path}: 'priors' must be a non-empty "
            f"{{target: {{'ratio': ...}}}} map, got {priors!r}")
    for name, row in priors.items():
        try:
            prior_ratio_of(row)
        except ValueError as e:
            raise ValueError(f"{path}: prior for {name!r}: {e}") from e
    if "default_ratio" in data:
        prior_ratio_of(data["default_ratio"])
    return data


def prior_for(name, priors=None, default=False):
    """The calibration ratio for target ``name``, or None when the file
    has none. ``priors``: a loaded priors document (default: the
    committed file). ``default=True`` falls back to the document's
    ``default_ratio`` instead of None."""
    data = priors if priors is not None else load_hbm_priors()
    row = (data.get("priors") or {}).get(name)
    if row is not None:
        return prior_ratio_of(row)
    if default and "default_ratio" in data:
        return prior_ratio_of(data["default_ratio"])
    return None
