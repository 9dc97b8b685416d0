"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, under
``build/torch_kernels/`` at the repository root, at first use. The file
name carries a hash of the sources, so an edited kernel is rebuilt and a
stale library is never loaded. Libraries are loaded with ``ctypes``.

Which path a call takes is :mod:`apex_tpu_torch.ops.kernel_config`'s
(the counterpart of ``apex_tpu/ops/pallas_config.py``): by default a CUDA
tensor launches the kernel (or raises) and a CPU tensor takes the plain
PyTorch version. Every C entry point returns ``cudaGetLastError()``
after its launch, and :func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("rms_norm", "flash_fwd", "flash_bwd", "fused_adam",
           "layer_norm", "fused_softmax", "fp8_cast")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or in /usr/local/cuda/bin: the CUDA "
            "kernels are built from source at first use")
    return path


def _sources(name: str) -> Sequence[Path]:
    """The kernel's .cu file plus every shared header it may include."""
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    digest = hashlib.sha1()
    for src in _sources(name):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list:
    return [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel that has no up-to-date library, one
    ``nvcc`` process per source, all started together. Returns
    ``{name: compiler output}`` for the ones it built (``-Xptxas -v``
    lists registers, shared memory and spills per kernel).

    Processes that build at once (the ranks of one host) take turns on
    an exclusive lock of the build directory, so each library is
    compiled once; the lock goes with the process that holds it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_locked(names)


def _build_locked(names: Iterable[str]) -> Dict[str, str]:
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: "
                           + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed.

    The build runs outside ``_LOCK`` (:func:`build`'s file lock makes
    concurrent builders take turns), so a thread launching a kernel that
    is loaded already never waits behind a compile."""
    with _LOCK:
        lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        build([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def dtype_code(dtype: torch.dtype, what: str) -> int:
    code = DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {dtype} not supported by the "
                        f"CUDA kernel (float32, bfloat16, float16)")
    return code
