"""The kernel dispatch switch (counterpart of
``apex_tpu/ops/pallas_config.py``).

Every kernel wrapper of the port asks :func:`use_kernel` whether to
launch its CUDA kernel or take its plain PyTorch version, instead of
testing ``x.is_cuda`` itself. The answer depends on the mode, set by
:func:`force` and read by :func:`mode`:

- ``"auto"`` (the default): a CUDA tensor launches the kernel, a CPU
  tensor takes the plain versions, in the kernel path's structure (the
  long-row softmax in its two passes);
- ``"off"``: the plain version on any device (the whole-row softmax);
- ``"on"``: the kernel; a CPU tensor raises RuntimeError;
- ``"interpret"``: the kernel path's structure carried out by the plain
  versions on any device. Tests use it where the reference's tests use
  ``force("interpret")``: the port has no interpreter of its kernels.

The mode is process-wide: ``force`` switches every wrapper on every
thread (the autograd engine's too) while its context is open, so tests
and the tuner's races wrap it round work that runs alone. A caller that
wants one call's path passes ``mode=`` to :func:`dispatch`
(``FusedScaleMaskSoftmax.forward_torch_softmax`` does).

There are no pinned verdicts: under ``"auto"`` a CUDA tensor always
launches its kernel. The reference pins a per-kernel verdict (from code,
``APEX_TPU_KERNEL_AUTO`` or a tuning cache's races) that can move the
device off a kernel; the port's tuning cache records its races
(``use_kernel``) as data and changes launch plans only
(:mod:`apex_tpu_torch.tuning.geometry`). A CUDA tensor that a mode sends
to the plain version ticks the registry's
``kernels/plain_dispatch{kernel=...}`` counter, so the choice is never
silent.

Flash attention runs the tiles compiled into its kernels, (64, 64) for
bf16 on ``wgmma`` and (64, 32) for the fp32 FMA kernels: the reference's
``flash_blocks`` and its overrides have no counterpart until a second
tile is compiled.

Not ported: ``out_struct`` and ``interpret()``, which only serve
``pl.pallas_call``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import torch

_MODE = "auto"  # auto | off | on | interpret
_MODES = ("auto", "off", "on", "interpret")

# the hook a NaN provenance probe installs (observability.numerics.
# nan_probe): called by every kernel wrapper next to its launch counter
_LAUNCH_HOOK: Optional[Callable] = None

# the analysis tracer's stand-in for the card (analysis.interp.trace): a
# build without CUDA cannot run autograd on fake CUDA tensors, so there
# the tracer traces fake CPU tensors and marks them, while it runs, as the
# card's
_TRACE_AS_CARD = False


def refresh_tuning() -> None:
    """Forget the parsed tuning cache (after an in-process tune wrote new
    entries, or a test repointed ``APEX_TPU_TUNING_CACHE``): the next
    plan lookup reads the file again."""
    from apex_tpu_torch.tuning import cache as tuning_cache

    tuning_cache.clear_memo()


def on_card(x: torch.Tensor) -> bool:
    """Does ``x`` lie on the card: a CUDA tensor, or a fake tensor of the
    analysis tracer's stand-in (:func:`tracing_as_card`)?"""
    if x.is_cuda:
        return True
    if not _TRACE_AS_CARD:
        return False
    from apex_tpu_torch.ops import kernel_nodes

    return kernel_nodes.traced(x)


@contextlib.contextmanager
def tracing_as_card():
    """Within the context, fake tensors off the card dispatch as CUDA
    tensors do (the analysis tracer's stand-in on a build without CUDA);
    real tensors are unaffected."""
    global _TRACE_AS_CARD
    prev = _TRACE_AS_CARD
    _TRACE_AS_CARD = True
    try:
        yield
    finally:
        _TRACE_AS_CARD = prev


def dispatch(kernel: str, x: torch.Tensor, count: bool = True,
             mode: Optional[str] = None) -> str:
    """``"kernel"``, ``"interpret"`` (the plain versions in the kernel
    path's structure) or ``"plain"`` for the named kernel on ``x`` under
    ``mode`` (default: the current mode; module docstring). With
    ``count``, a CUDA tensor that does not take the kernel ticks
    ``kernels/plain_dispatch{kernel=...}``. Raises RuntimeError under
    ``"on"`` for a tensor off the card."""
    if mode is None:
        mode = _MODE
    elif mode not in _MODES:
        raise ValueError(f"unknown kernel dispatch mode {mode!r}; "
                         f"valid: {list(_MODES)}")
    if mode == "off":
        path = "plain"
    elif mode == "interpret":
        path = "interpret"
    elif mode == "on":
        if not on_card(x):
            raise RuntimeError(
                f"kernel dispatch mode 'on' launches the CUDA kernel of "
                f"{kernel}: the input lies on {x.device}")
        path = "kernel"
    else:
        path = "kernel" if on_card(x) else "interpret"
    if count and path != "kernel" and x.is_cuda:
        from apex_tpu_torch.observability import get_registry

        get_registry().counter("kernels/plain_dispatch",
                               kernel=kernel).inc()
    return path


def use_kernel(kernel: str, x: torch.Tensor) -> bool:
    """Should the named kernel's wrapper launch its CUDA kernel on ``x``
    (True), or take its plain version (False)? See :func:`dispatch`."""
    return dispatch(kernel, x) == "kernel"


def note_launch(kernel: str, inputs: Sequence, outputs: Sequence) -> None:
    """Report one launch of a hand-written kernel (named as its C entry
    point) with its input and output tensors to an active NaN provenance
    probe; a no-op without one. The kernels run out of ATen's sight, so
    this is how a probe sees them."""
    hook = _LAUNCH_HOOK
    if hook is not None:
        hook(kernel, tuple(t for t in inputs if t is not None),
             tuple(t for t in outputs if t is not None))


# Shared memory a block may opt into, by device name (matched by
# substring, lowercase), for planning off the card; on the card the
# device's own property is read. 48 KiB is what any CUDA device gives a
# block without opting in.
_SMEM_BYTES_DEFAULT = 48 << 10
_SMEM_BYTES = (("h100", 232448), ("h200", 232448), ("h800", 232448),
               ("a100", 166912))


def device_smem_bytes(kind: Optional[str] = None) -> int:
    """Shared memory a block may use, in bytes, on ``kind`` (a device
    name; default: the current CUDA device's
    ``shared_memory_per_block_optin``, or 48 KiB with no card)."""
    if kind is None:
        if not torch.cuda.is_available():
            return _SMEM_BYTES_DEFAULT
        props = torch.cuda.get_device_properties(torch.cuda.current_device())
        return int(props.shared_memory_per_block_optin)
    kind = kind.lower()
    for key, nbytes in _SMEM_BYTES:
        if key in kind:
            return nbytes
    return _SMEM_BYTES_DEFAULT


def device_hbm_bytes(device=None) -> int:
    """The device memory's total in bytes (``_device.memory``:
    ``torch.cuda.mem_get_info``'s total, or ``APEX_TPU_HBM_BYTES``)."""
    from apex_tpu_torch import _device

    return _device.memory(device)[0]


def mode() -> str:
    return _MODE


@contextlib.contextmanager
def force(new_mode: str):
    """Force kernel dispatch within the context: 'auto', 'off', 'on' or
    'interpret' (module docstring)."""
    global _MODE
    if new_mode not in _MODES:
        raise ValueError(f"unknown kernel dispatch mode {new_mode!r}; "
                         f"valid: {list(_MODES)}")
    prev = _MODE
    _MODE = new_mode
    try:
        yield
    finally:
        _MODE = prev

