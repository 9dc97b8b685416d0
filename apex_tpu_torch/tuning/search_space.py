"""Per-kernel launch-plan search spaces and the untuned default plans
(counterpart of ``apex_tpu/tuning/search_space.py``).

Every hand-written kernel's candidate launch plans are declared here,
bounded by what the kernel accepts: threads a block a multiple of 32 and
at most 1024, and each kernel's own limits (the row norms' register path,
the fp8 cast's amax slots).
No candidate takes more shared memory than its untuned plan: the
reductions' arrays are sized for 32 warps, and the row-norm backward's
column sums are held to the 48 KiB a block takes without opting in where
a plan is resolved (:mod:`~apex_tpu_torch.tuning.geometry`). The same
tables serve the dispatch defaults, the
tuner's sweep and the tests that run every candidate against the plain
version. The ``default_*`` helpers return the plans the wrappers used
before any tuning, exactly.

Shape buckets are the reference's: ceil-power-of-2 on the data-volume
dims, exact on the dims a plan depends on directly (:func:`shape_bucket`,
the same strings as the reference's for the same dims).

The reference's ``flash_attention_fwd`` and ``_bwd`` keys have no
counterpart: the port's flash kernels run the one tile compiled for each
dtype (``ops/flash_attention.py``), so there is no plan to race until a
second tile is compiled.
"""

from __future__ import annotations

import torch

KERNELS = ("flat_adam", "layer_norm", "rms_norm", "fused_softmax",
           "fp8_cast")

# SMs of the card the spaces are sized for (an H100 SXM): block counts of
# the grid-stride kernels are multiples of it
SMS = 132
# threads a block the port's kernels are compiled for (templates of
# csrc/fused_adam.cu, csrc/fp8_cast.cu and the long-row passes of
# csrc/fused_softmax.cu)
BLOCK_THREADS = (128, 256, 512, 1024)
# the flat Adam kernel's blocks, as multiples of the SMs, and its untuned
# plan (csrc/fused_adam.cu before tuning: 256 threads, at most 4096 blocks)
ADAM_SM_MULTIPLES = (1, 2, 4, 8, 16, 32)
ADAM_DEFAULT = {"threads": 256, "blocks": 4096}
# the fp8 cast's blocks an SM, and its untuned plan (256 threads, at most
# 8 blocks an SM); its grid never exceeds the amax scratch's slots
FP8_BLOCKS_PER_SM = (1, 2, 4, 8, 16)
FP8_DEFAULT = {"threads": 256, "blocks_per_sm": 8}
FP8_AMAX_SLOTS = 2048  # ops/fp8_cast_kernel.AMAX_SLOTS
# the long-row softmax passes' threads a block (a block a row), untuned
SOFTMAX_DEFAULT = {"threads": 256}
# keys a block of the plain long-row softmax covers (the reference's
# default_softmax_block_k)
SOFTMAX_BLOCK_K = 2048
# the row norms' blocks, from all row groups down to these caps: 8, 4
# and 2 blocks an SM
NORM_BLOCK_CAPS = (8 * SMS, 4 * SMS, 2 * SMS)


def _ceil_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def shape_bucket(kernel: str, **dims) -> str:
    """Deterministic cache-key bucket for ``kernel`` at ``dims``: the
    reference's strings. flat_adam and fp8_cast bucket by ceil-pow2
    buffer size; the norms by ceil-pow2 rows with exact h; fused_softmax
    by ceil-pow2 sk."""
    if kernel in ("flat_adam", "fp8_cast"):
        return f"n~{_ceil_pow2(dims['n'])}"
    if kernel in ("layer_norm", "rms_norm"):
        return f"rows~{_ceil_pow2(dims['rows'])},h={dims['h']}"
    if kernel == "fused_softmax":
        return f"sk~{_ceil_pow2(dims['sk'])}"
    raise ValueError(f"unknown kernel {kernel!r}; valid: {list(KERNELS)}")


def dtype_of(dims) -> torch.dtype:
    """The dtype a sweep's dims name (``"dtype"``, default bf16)."""
    name = dims.get("dtype", "bfloat16")
    return getattr(torch, name) if isinstance(name, str) else name


# --------------------------------------------------------- the row norms


def _norm_fewest(h: int, dtype: torch.dtype):
    """(vectors a row, fewest threads a row on the register path), or
    None when rows of h elements of dtype cannot take it."""
    from apex_tpu_torch.ops import layer_norm as ln

    v = 16 // dtype.itemsize
    nvec = h // v
    if h % v or nvec > ln.MAX_ROW_THREADS * ln.ROW_VECS:
        return None
    fewest = 32
    while fewest * ln.ROW_VECS < nvec:
        fewest *= 2
    return nvec, fewest


def norm_candidates(kernel: str, rows: int, h: int,
                    dtype: torch.dtype = torch.bfloat16,
                    device_kind=None) -> list:
    """Every register-path plan of the row-norm forward for [rows, h] of
    ``dtype`` (aligned): threads a row a power of two from the fewest
    that hold a row at ``ROW_VECS`` vectors a thread to a vector a
    thread (at most ``MAX_ROW_THREADS``), rows a block (a power of two,
    or all the rows) while the block has at most ``MAX_ROW_THREADS``
    threads, blocks from all the row
    groups down to a quarter of ``8 * SMS``. A shape off the register
    path has its default plan alone."""
    del kernel, device_kind
    from apex_tpu_torch.ops import layer_norm as ln

    fit = _norm_fewest(h, dtype)
    if fit is None:
        return [default_norm_params(rows, h, dtype)]
    nvec, fewest = fit
    out = []
    threads = fewest
    while threads <= min(ln.MAX_ROW_THREADS, max(fewest, nvec)):
        per_block = 1
        while per_block * threads <= ln.MAX_ROW_THREADS:
            # a block holds no more rows than there are
            slots = min(per_block, rows)
            groups = -(-rows // slots)
            for blocks in sorted({groups, *(min(groups, cap)
                                            for cap in NORM_BLOCK_CAPS)}):
                out.append({"row_threads": threads,
                            "rows_per_block": slots, "blocks": blocks})
            if per_block >= rows:
                break
            per_block *= 2
        threads *= 2
    return out


def default_norm_params(rows: int, h: int,
                        dtype: torch.dtype = torch.bfloat16) -> dict:
    """The forward's untuned plan (``layer_norm._fwd_plan``) as params."""
    from apex_tpu_torch.ops import layer_norm as ln

    plan = ln._fwd_plan(rows, h, dtype)
    return {"row_threads": plan.row_threads,
            "rows_per_block": plan.rows_per_block, "blocks": plan.blocks}


# ------------------------------------------------- grid-stride kernels


def _flat_adam_want(n: int, threads: int) -> int:
    """Blocks that give every thread one group of 4 elements."""
    return max(1, -(-(-(-n // 4)) // threads))


def flat_adam_candidates(n: int, device_kind=None) -> list:
    """(threads, blocks) of the flat Adam kernel on an ``n``-element
    slab: threads in ``BLOCK_THREADS``; blocks from one to 32 blocks an
    SM and the untuned 4096, never more than the grid-stride loop needs
    (the kernel launches min(blocks, that need))."""
    del device_kind
    out = []
    for threads in BLOCK_THREADS:
        want = _flat_adam_want(n, threads)
        caps = {SMS * k for k in ADAM_SM_MULTIPLES} | {
            ADAM_DEFAULT["blocks"]}
        for blocks in sorted({min(cap, want) for cap in caps}):
            out.append({"threads": threads, "blocks": blocks})
    return out


def default_flat_adam_params(n: int) -> dict:
    threads = ADAM_DEFAULT["threads"]
    return {"threads": threads,
            "blocks": min(ADAM_DEFAULT["blocks"], _flat_adam_want(n, threads))}


def fp8_cast_candidates(n: int, device_kind=None) -> list:
    """(threads, blocks_per_sm) of the row-major fp8 cast: threads in
    ``BLOCK_THREADS``, 1 to 16 blocks an SM (the grid is also held to
    the ``FP8_AMAX_SLOTS`` slots of the amax scratch and to what ``n``
    needs)."""
    del n, device_kind
    return [{"threads": t, "blocks_per_sm": b}
            for t in BLOCK_THREADS for b in FP8_BLOCKS_PER_SM]


def default_fp8_cast_params(n: int = 0) -> dict:
    del n
    return dict(FP8_DEFAULT)


def softmax_candidates(sk: int, device_kind=None) -> list:
    """Threads a block (a block a row) of the long-row stats and apply
    passes; their shared memory is 32 fp32 pairs whatever the count."""
    del sk, device_kind
    return [{"threads": t} for t in BLOCK_THREADS]


def default_softmax_params(sk: int = 0) -> dict:
    del sk
    return dict(SOFTMAX_DEFAULT)


def default_softmax_block_k() -> int:
    """Keys a block of the plain long-row two-pass softmax covers."""
    return SOFTMAX_BLOCK_K


def candidates(kernel: str, device_kind=None, **dims) -> list:
    """The full candidate list for ``kernel`` at ``dims``: the one
    enumeration the tuner sweeps and the tests replay."""
    if kernel == "flat_adam":
        return flat_adam_candidates(dims["n"], device_kind)
    if kernel in ("layer_norm", "rms_norm"):
        return norm_candidates(kernel, dims["rows"], dims["h"],
                               dtype_of(dims), device_kind)
    if kernel == "fused_softmax":
        return softmax_candidates(dims["sk"], device_kind)
    if kernel == "fp8_cast":
        return fp8_cast_candidates(dims["n"], device_kind)
    raise ValueError(f"unknown kernel {kernel!r}; valid: {list(KERNELS)}")


def default_params(kernel: str, **dims) -> dict:
    """The untuned plan of ``kernel`` at ``dims``, as params."""
    if kernel == "flat_adam":
        return default_flat_adam_params(dims["n"])
    if kernel in ("layer_norm", "rms_norm"):
        return default_norm_params(dims["rows"], dims["h"], dtype_of(dims))
    if kernel == "fused_softmax":
        return default_softmax_params(dims["sk"])
    if kernel == "fp8_cast":
        return default_fp8_cast_params(dims["n"])
    raise ValueError(f"unknown kernel {kernel!r}; valid: {list(KERNELS)}")
