"""The hand-written kernels as nodes of a traced graph (the counterpart of
a ``pallas_call`` equation in a jaxpr).

On the card a kernel wrapper launches its kernel through ``ctypes`` on raw
pointers, out of any tracer's sight. Under the analysis tracer
(:func:`apex_tpu_torch.analysis.interp.trace`) the wrapper takes the same
path and computes the same launch plan, then calls
``torch.ops.apex_tpu_torch.<entry>`` in place of the launch: one node of
the graph a launch, named by the kernel's C entry point, whose arguments
are the kernel's input tensors, its launch plan (:data:`PLAN_FIELDS`),
its scalar arguments and the shapes of its outputs. The op has only a
fake implementation: on a real tensor it raises, so the card path never
reaches it and has no new fallback. A kernel that writes an input in
place (the flat Adam's m and v) returns the new values, and the wrapper
copies them into the input with ``copy_``: the write is an ATen node of
the graph, as an in-place op's is.

A wrapper asks :func:`traced` whether its tensors are fake (the tracer's);
only then does it call :func:`node`. The launch counters do not move:
nothing is launched.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Sequence

import torch

__all__ = ["ENTRIES", "H100_SMS", "KernelPlan", "NAMESPACE",
           "PLAN_FIELDS", "aligned16", "node", "plan_of", "sm_count",
           "traced"]

NAMESPACE = "apex_tpu_torch"

# every kernel's C entry point: its node's op name
ENTRIES = ("rms_norm_fwd", "rms_norm_bwd", "layer_norm_fwd",
           "layer_norm_bwd", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
           "adam_flat", "fp8_cast_scale", "fp8_cast_scale_t",
           "fused_softmax_causal", "fused_softmax_masked",
           "fused_softmax_stats", "fused_softmax_apply")


class KernelPlan(NamedTuple):
    """One launch's plan: ``threads`` a block, ``row_threads`` threads a
    row and ``rows_per_block`` rows (or tiles) a block (0 where the kernel
    has no rows), ``blocks``, dynamic ``smem_bytes`` a block, the
    ``width`` the kernel's checks constrain (a row's elements, a head's
    dim, a slab's length) and ``vec`` elements a 16-byte load of its
    input (0 where it loads no rows)."""

    threads: int
    row_threads: int
    rows_per_block: int
    blocks: int
    smem_bytes: int
    width: int
    vec: int


PLAN_FIELDS = KernelPlan._fields

# output dtypes by code, for the op's out-spec argument
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.float8_e4m3fn, torch.float8_e5m2, torch.int32,
           torch.int64, torch.bool, torch.uint8)
_CODES = {dt: i for i, dt in enumerate(_DTYPES)}

_DEFINED = False
_DEFINE_LOCK = threading.Lock()
# the ops' Library: the definitions last while it is referenced
_LIBRARY = None


def traced(*tensors) -> bool:
    """Are any of ``tensors`` fake (a tracer's, with no data)?"""
    from torch._subclasses.fake_tensor import is_fake

    return any(isinstance(t, torch.Tensor) and is_fake(t) for t in tensors)


def aligned16(t: torch.Tensor) -> bool:
    """Does ``t``'s data start on 16 bytes? A real tensor's pointer says;
    a fake one has none, and its storage offset says (a new allocation
    starts on 512 bytes)."""
    if traced(t):
        return t.storage_offset() * t.element_size() % 16 == 0
    return t.data_ptr() % 16 == 0


# SMs of the card a plan is made for off it (an H100 SXM)
H100_SMS = 132


def sm_count(device) -> int:
    """The SMs of ``device``'s card, or an H100's off the card."""
    if device.type == "cuda" and torch.cuda.is_available():
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        return torch.cuda.get_device_properties(index).multi_processor_count
    return H100_SMS


def _raise_off_tracer(ins, plan, scalars, outs):
    raise RuntimeError(
        "an apex_tpu_torch kernel node runs only under the analysis "
        "tracer: on a real tensor its wrapper launches the kernel")


def _fake(ins, plan, scalars, outs):
    """Empty outputs from the out spec: a code, a rank, the dims and a
    transposed flag (a 2-D column-major output) a tensor."""
    device = next(t.device for t in ins if t is not None)
    got, i = [], 0
    while i < len(outs):
        dtype, rank = _DTYPES[outs[i]], outs[i + 1]
        shape = list(outs[i + 2:i + 2 + rank])
        transposed = bool(outs[i + 2 + rank])
        i += 3 + rank
        if transposed:
            got.append(torch.empty(shape[::-1], dtype=dtype,
                                   device=device).t())
        else:
            got.append(torch.empty(shape, dtype=dtype, device=device))
    return got


def _define() -> None:
    global _DEFINED, _LIBRARY
    with _DEFINE_LOCK:
        if _DEFINED:
            return
        lib = torch.library.Library(NAMESPACE, "FRAGMENT")
        for entry in ENTRIES:
            lib.define(f"{entry}(Tensor?[] ins, int[] plan, float[] "
                       f"scalars, int[] outs) -> Tensor[]")
            lib.impl(entry, _raise_off_tracer, "CompositeExplicitAutograd")
            torch.library.register_fake(f"{NAMESPACE}::{entry}",
                                        _fake, lib=lib)
        _LIBRARY = lib
        _DEFINED = True


def _out_spec(outs: Sequence[torch.Tensor]) -> list:
    spec = []
    for t in outs:
        transposed = (t.dim() == 2 and t.shape[0] > 1 and t.stride(0) == 1
                      and t.stride(1) == t.shape[0])
        spec += [_CODES[t.dtype], t.dim(), *t.shape, int(transposed)]
    return spec


def node(entry: str, ins: Sequence[Optional[torch.Tensor]],
         plan: KernelPlan, outs: Sequence[torch.Tensor],
         scalars: Sequence[float] = ()) -> list:
    """One graph node for a launch of ``entry`` on fake ``ins``, with the
    launch's ``plan``: new tensors like ``outs`` (the wrapper's empty
    outputs), in order."""
    if entry not in ENTRIES:
        raise ValueError(f"no kernel entry {entry!r}; known: {ENTRIES}")
    _define()
    op = getattr(getattr(torch.ops, NAMESPACE), entry)
    return list(op(list(ins), [int(v) for v in plan],
                   [float(s) for s in scalars], _out_spec(outs)))


def plan_of(fx_node) -> Optional[dict]:
    """The launch plan of a kernel node of a traced graph, by field, or
    None for any other node."""
    target = getattr(fx_node, "target", None)
    name = getattr(target, "name", None)
    if fx_node.op != "call_function" or not callable(name):
        return None
    qual = name()
    if not qual.startswith(f"{NAMESPACE}::"):
        return None
    return dict(zip(PLAN_FIELDS, fx_node.args[1]))
