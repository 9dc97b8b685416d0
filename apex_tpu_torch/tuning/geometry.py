"""Dispatch-time launch-plan resolution: override > tuned cache > default
(counterpart of ``apex_tpu/tuning/geometry.py``).

Every kernel wrapper asks these helpers for its launch plan where it
builds one. Resolution order:

1. an active :func:`override` context: how the tuner races one candidate
   at a time through the real dispatch path without touching the cache;
2. the persistent tuning cache (:mod:`apex_tpu_torch.tuning.cache`),
   keyed by ``(device_kind, kernel, shape_bucket)``;
3. the untuned default of :mod:`apex_tpu_torch.tuning.search_space`.

A plan from (1) or (2) that does not fit the shape at hand (a norm plan
tuned for another width, threads the kernel is not compiled for) is
clamped to the default, as the reference clamps an over-padded slab: a
launch never fails for a tuned plan. The cache file is read once a
process, and each kernel's shape is looked up in it once, as the
reference looks a kernel up once a trace: its ``tuning/cache_hit`` or
``cache_miss`` ticks then, and later launches read the result from a
dict keyed by the kernel and its dims alone; each helper's plan is kept
by its arguments outside an override. After a change of
``APEX_TPU_TUNING_CACHE`` or of the current device,
``kernel_config.refresh_tuning`` (``cache.clear_memo``) forgets both.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from apex_tpu_torch.tuning import cache, search_space

# kernel -> params dict pinned by the innermost active override()
_OVERRIDES: dict = {}
# (kernel, dims) -> (params, source) of the cache, and (helper, args) ->
# the plan a helper gave outside any override; emptied with the cache's
# memo (cache.clear_memo)
_RESOLVED: dict = {}
_PLANS: dict = {}
# dynamic shared memory a block takes without opting in
_SMEM_NO_OPT_IN = 48 << 10


@contextlib.contextmanager
def override(kernel: str, params: dict):
    """Pin ``kernel``'s plan to ``params`` within the context: the tuner
    races candidates through exactly the dispatch path production uses."""
    if kernel not in search_space.KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; valid: "
                         f"{list(search_space.KERNELS)}")
    prev = _OVERRIDES.get(kernel)
    _OVERRIDES[kernel] = dict(params)
    try:
        yield
    finally:
        if prev is None:
            _OVERRIDES.pop(kernel, None)
        else:
            _OVERRIDES[kernel] = prev


def _resolve(kernel: str, **dims):
    """(params, source) for ``kernel`` at ``dims``; params None when
    neither an override nor a tuned entry exists."""
    ov = _OVERRIDES.get(kernel)
    if ov is not None:
        return ov, "override"
    key = (kernel, *dims.items())
    found = _RESOLVED.get(key)
    if found is None:
        entry = cache.lookup(kernel, search_space.shape_bucket(kernel, **dims))
        found = ((entry["params"], "tuned") if entry is not None
                 and isinstance(entry.get("params"), dict)
                 else (None, "default"))
        _RESOLVED[key] = found
    return found


def source(kernel: str, **dims) -> str:
    """Where ``kernel``'s plan at ``dims`` comes from: ``"override"``,
    ``"tuned"`` or ``"default"``."""
    return _resolve(kernel, **dims)[1]


def _memoised(helper):
    """A plan helper whose result, outside an override, is kept by its
    arguments: a launch after the first pays one dict lookup."""
    @functools.wraps(helper)
    def plan(*args, **kw):
        if _OVERRIDES:
            return helper(*args, **kw)
        key = (helper, args, *kw.items())
        got = _PLANS.get(key)
        if got is None:
            got = _PLANS[key] = helper(*args, **kw)
        return got
    return plan


def _ints(params: dict, *names):
    """The named params as ints, or None when one is missing or not an
    int."""
    try:
        return tuple(int(params[n]) for n in names)
    except (KeyError, TypeError, ValueError):
        return None


def _pow2(t: int) -> bool:
    return t >= 32 and t & (t - 1) == 0


@_memoised
def norm_plan(kernel: str, rows: int, h: int, dtype: torch.dtype,
              aligned: bool = True):
    """The row-norm forward's plan (``layer_norm.FwdPlan``) for
    ``kernel`` ("rms_norm" or "layer_norm") at [rows, h] of ``dtype``.
    A tuned plan keeps its threads a row and rows a block where the
    register path takes them, its block count at most the row groups."""
    from apex_tpu_torch.ops import layer_norm as ln

    default = ln._fwd_plan(rows, h, dtype, aligned)
    params, _ = _resolve(kernel, rows=rows, h=h)
    if params is None or not default.registers:
        return default
    got = _ints(params, "row_threads", "rows_per_block", "blocks")
    if got is None:
        return default
    threads, per_block, blocks = got
    fit = search_space._norm_fewest(h, dtype)
    if (fit is None or not _pow2(threads) or threads < fit[1]
            or threads > ln.MAX_ROW_THREADS or per_block < 1
            or per_block * threads > ln.MAX_ROW_THREADS or blocks < 1):
        return default
    return ln.FwdPlan(threads, per_block,
                      min(blocks, -(-rows // per_block)), True)


@_memoised
def norm_bwd_plan(kernel: str, rows: int, h: int, dtype: torch.dtype,
                  aligned: bool = True, affine: bool = True):
    """The row-norm backward's plan (``layer_norm.BwdPlan``): the
    default's, with the tuned forward's threads a row where the register
    path takes them. Its block count stays at most ``DW_PARTS``, so the
    order of the dw sum never depends on the device."""
    from apex_tpu_torch.ops import layer_norm as ln

    default = ln._bwd_plan(rows, h, dtype, aligned)
    params, _ = _resolve(kernel, rows=rows, h=h)
    if params is None or not default.registers:
        return default
    got = _ints(params, "row_threads")
    fit = search_space._norm_fewest(h, dtype)
    if got is None or fit is None:
        return default
    (threads,) = got
    if not _pow2(threads) or threads < fit[1] or \
            threads > ln.MAX_ROW_THREADS:
        return default
    per_block = max(1, ln.ROW_BLOCK // threads)
    acc = (2 if kernel == "layer_norm" else 1) * h * 4
    if affine and per_block > 1 and acc > _SMEM_NO_OPT_IN:
        return default
    return ln.BwdPlan(threads, per_block,
                      min(-(-rows // per_block), ln.DW_PARTS), True)


@_memoised
def softmax_threads(sk: int) -> int:
    """Threads a block of the long-row softmax passes."""
    params, _ = _resolve("fused_softmax", sk=sk)
    got = None if params is None else _ints(params, "threads")
    if got is None or got[0] not in search_space.BLOCK_THREADS:
        return search_space.default_softmax_params(sk)["threads"]
    return got[0]


@_memoised
def flat_adam_geometry(n: int) -> tuple:
    """(threads, blocks) of the flat Adam kernel over ``n`` elements;
    the kernel launches no more blocks than its grid-stride loop needs."""
    params, _ = _resolve("flat_adam", n=n)
    got = None if params is None else _ints(params, "threads", "blocks")
    if got is None or got[0] not in search_space.BLOCK_THREADS or \
            got[1] < 1:
        d = search_space.default_flat_adam_params(n)
        return d["threads"], d["blocks"]
    return got


@_memoised
def fp8_cast_geometry(n: int) -> tuple:
    """(threads, blocks_per_sm) of the row-major fp8 cast over ``n``
    elements."""
    params, _ = _resolve("fp8_cast", n=n)
    got = (None if params is None
           else _ints(params, "threads", "blocks_per_sm"))
    if got is None or got[0] not in search_space.BLOCK_THREADS or \
            got[1] not in search_space.FP8_BLOCKS_PER_SM:
        d = search_space.default_fp8_cast_params(n)
        return d["threads"], d["blocks_per_sm"]
    return got

