"""Persistent per-device tuning cache (counterpart of
``apex_tpu/tuning/cache.py``).

One JSON file (default ``~/.cache/apex_tpu_torch/tuning_cache.json``;
``APEX_TPU_TUNING_CACHE`` overrides it, as in the reference) holding every
tuned launch plan and race verdict, keyed by ``(device_kind, kernel,
shape-bucket)``:

.. code-block:: json

    {"schema_version": 1, "kind": "apex_tpu_torch.tuning",
     "entries": {"NVIDIA H100 80GB HBM3": {"flat_adam": {"n~268435456": {
         "params": {"threads": 256, "blocks": 4096},
         "kernel_ms": 1.68, "plain_ms": 9.84, "use_kernel": true,
         "source": "measured", "dims": {"n": 203716608}}}}}}

The kind header differs from the reference's (``apex_tpu.tuning``): the
two packages' params differ, so each refuses the other's file. A
malformed or version-mismatched file is refused loudly (a silently
ignored cache would pin stale plans forever). ``source`` says whether the
entry came from a race on the card (``measured``) or the deterministic
roofline (``roofline``); the device kind is the card's name
(``torch.cuda.get_device_name``) or ``"cpu"``, the device the tuner ran
on, so a roofline entry made off the card never serves one.

Dispatch reads this module through :mod:`apex_tpu_torch.tuning.geometry`,
for launch plans only. An entry's ``use_kernel`` records which side won
its race and changes no dispatch: on the card a kernel always launches
(``ops/kernel_config.py``).
"""

from __future__ import annotations

import json
import os
import tempfile

SCHEMA_VERSION = 1
KIND = "apex_tpu_torch.tuning"

# process-level memo: resolved path -> parsed cache (invalidate with
# clear_memo after writes or in tests that repoint the env override)
_MEMO: dict = {}
# device index -> its name (a property query a launch would otherwise pay)
_KINDS: dict = {}


def cache_path() -> str:
    """Resolved cache file location (env override wins)."""
    env = os.environ.get("APEX_TPU_TUNING_CACHE")
    if env:
        return os.path.abspath(os.path.expanduser(env))
    return os.path.join(os.path.expanduser("~"), ".cache", "apex_tpu_torch",
                        "tuning_cache.json")


def empty() -> dict:
    return {"schema_version": SCHEMA_VERSION, "kind": KIND, "entries": {}}


def _validate(data, path):
    if not isinstance(data, dict) or data.get("kind") != KIND:
        raise ValueError(
            f"tuning cache {path} is not an {KIND} file (missing kind "
            f"header) — refusing to guess at its layout")
    version = data.get("schema_version")
    if version != SCHEMA_VERSION:
        raise ValueError(
            f"tuning cache {path} has schema_version {version}; this "
            f"reader knows [{SCHEMA_VERSION}] — re-tune (python -m "
            f"apex_tpu_torch.tuning) or delete the stale cache")
    if not isinstance(data.get("entries"), dict):
        raise ValueError(f"tuning cache {path} has no entries object")
    return data


def load(path=None) -> dict:
    """Parse the cache at ``path`` (default :func:`cache_path`); an
    absent file is an empty cache, a malformed or version-mismatched one
    raises ValueError."""
    path = path or cache_path()
    if not os.path.exists(path):
        return empty()
    with open(path) as f:
        try:
            data = json.load(f)
        except ValueError as e:
            raise ValueError(f"tuning cache {path} is not JSON: {e}")
    return _validate(data, path)


def save(cache: dict, path=None) -> str:
    """Atomically write ``cache`` (validated first: a writer bug must not
    corrupt the dispatch-time artifact) and invalidate the memo."""
    path = path or cache_path()
    _validate(cache, "<in-memory cache>")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=".tuning_cache.")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    clear_memo()
    return path


def clear_memo() -> None:
    """Forget the parsed files and the plans resolved from them (after a
    write, a change of ``APEX_TPU_TUNING_CACHE`` or of the current
    device)."""
    from apex_tpu_torch.tuning import geometry

    _MEMO.clear()
    geometry._RESOLVED.clear()
    geometry._PLANS.clear()


def _loaded(path=None) -> dict:
    path = path or cache_path()
    if path not in _MEMO:
        _MEMO[path] = load(path)
    return _MEMO[path]


def current_device_kind() -> str:
    """Cache key for the running process: the current CUDA device's name
    on the card, ``"cpu"`` elsewhere."""
    import torch

    # once CUDA is up (every kernel launch) the device count is not asked
    # again: on the card that query costs microseconds a launch
    if not (torch.cuda.is_initialized() or torch.cuda.is_available()):
        return "cpu"
    index = torch.cuda.current_device()
    if index not in _KINDS:
        _KINDS[index] = torch.cuda.get_device_name(index)
    return _KINDS[index]


def lookup(kernel: str, bucket: str, device_kind=None, path=None):
    """The tuned entry for ``(device_kind, kernel, bucket)`` or None.
    Ticks ``tuning/cache_hit`` or ``tuning/cache_miss``, so a run records
    how much of its dispatch was tuned (``geometry`` looks each bucket up
    once a process)."""
    if device_kind is None:
        device_kind = current_device_kind()
    entry = (_loaded(path).get("entries", {})
             .get(device_kind, {}).get(kernel, {}).get(bucket))
    from apex_tpu_torch.observability import get_registry

    get_registry().counter(
        "tuning/cache_hit" if entry is not None else "tuning/cache_miss",
        kernel=kernel).inc()
    return entry


def put(cache: dict, device_kind: str, kernel: str, bucket: str,
        entry: dict) -> dict:
    """Insert or replace one entry in an in-memory cache dict."""
    cache.setdefault("entries", {}).setdefault(
        device_kind, {}).setdefault(kernel, {})[bucket] = entry
    return cache


def merge(dst: dict, src: dict) -> dict:
    """Fold every entry of ``src`` into ``dst`` (src wins per bucket):
    the tuner merges into the file on disk, so a CPU roofline run never
    destroys a card's measured entries."""
    for device_kind, kernels in src.get("entries", {}).items():
        for kernel, buckets in kernels.items():
            for bucket, entry in buckets.items():
                put(dst, device_kind, kernel, bucket, entry)
    return dst


def entries_for(device_kind=None, path=None) -> dict:
    """All tuned entries for one device kind."""
    if device_kind is None:
        device_kind = current_device_kind()
    return dict(_loaded(path).get("entries", {}).get(device_kind, {}))

