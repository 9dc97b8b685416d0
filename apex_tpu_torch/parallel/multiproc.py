"""Launcher: one process per rank (port of
``apex_tpu/parallel/multiproc.py``)::

    python -m apex_tpu_torch.parallel.multiproc --nprocs N \\
        [--backend gloo|nccl] [--cpu] script.py [args...]

spawns N workers on this host, each a fresh interpreter (``subprocess``:
never a fork of a process that may have initialised CUDA), with
``MASTER_ADDR``/``MASTER_PORT`` (a free localhost port), ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` set, and the
fleet identity (``APEX_TPU_PROCESS_INDEX``/``APEX_TPU_PROCESS_COUNT``,
ref ``:150``), so every telemetry artifact a rank writes to a shared
path lands at its ``.rank{i}`` variant. Without
``--nprocs`` this module is the worker: :func:`initialize_distributed`
starts the process group (the backend from the launcher, ``nccl`` by
default), then the script runs as ``__main__``. The launcher waits for
every worker and exits with the first non-zero exit code.

Each rank runs on ``cuda:LOCAL_RANK % device_count``, or on the CPU
under ``--cpu`` only: without ``--cpu`` and without a GPU a worker
raises. NCCL takes one rank per GPU; ranks sharing a GPU need
``--backend gloo``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Optional, Sequence

from apex_tpu_torch.observability.fleet.identity import (
    ENV_COUNT,
    ENV_INDEX,
    stamp_environ,
)

# what the launcher tells its workers beside torch.distributed's own
# variables
BACKEND_ENV = "APEX_TPU_TORCH_BACKEND"
CPU_ENV = "APEX_TPU_TORCH_CPU"


def initialize_distributed(backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           cpu: Optional[bool] = None):
    """Start this rank's process group (ref ``:31``) and pick its device.

    Arguments left None come from the launcher's environment: the backend
    (else ``"nccl"``), ``--cpu``, ``RANK``/``WORLD_SIZE`` (through
    ``env://`` when ``init_method`` is None). The device is
    ``cuda:LOCAL_RANK % device_count`` (made current), or the CPU when
    ``cpu``. Idempotent. Returns ``(rank, world_size, device)``."""
    import torch

    from apex_tpu_torch.distributed import backend as dist_backend

    if backend is None:
        backend = os.environ.get(BACKEND_ENV, "nccl")
    if cpu is None:
        cpu = os.environ.get(CPU_ENV) == "1"
    if cpu:
        if backend != "gloo":
            raise ValueError(f"--cpu needs backend 'gloo', got {backend!r}")
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the ranks run on the GPU unless launched "
                "with --cpu")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist_backend.is_initialized():
        dist_backend.init_process_group(backend, init_method=init_method,
                                        world_size=world_size, rank=rank)
    rank, world = dist_backend.get_rank(), dist_backend.get_world_size()
    # back-fill the fleet identity (ref :71) for ranks started some other
    # way, so telemetry is rank-suffixed from here on; an identity the
    # launcher exported wins, and a solo process keeps its plain names
    if world > 1:
        os.environ.setdefault(ENV_INDEX, str(rank))
        os.environ.setdefault(ENV_COUNT, str(world))
    return rank, world, device


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(script_args: Sequence[str], nprocs: int, backend: str = "nccl",
           cpu: bool = False, env=None, timeout: Optional[float] = None
           ) -> int:
    """Run ``nprocs`` workers of ``python -m
    apex_tpu_torch.parallel.multiproc <script_args>`` on this host (ref
    ``:118``); returns the first non-zero exit code, 0 when all succeed.
    A worker that fails ends the launch: the others, which would wait
    for it in their next collective, are killed. With ``timeout``
    (seconds for the whole launch) the workers still running then are
    killed and the call raises ``TimeoutError``."""
    base = dict(os.environ if env is None else env)
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                WORLD_SIZE=str(nprocs), LOCAL_WORLD_SIZE=str(nprocs))
    # every rank is on this host: gloo connects over loopback, whatever
    # the host's name resolves to
    base.setdefault("GLOO_SOCKET_IFNAME", "lo")
    base[BACKEND_ENV] = backend
    if cpu:
        base[CPU_ENV] = "1"
    else:
        base.pop(CPU_ENV, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
         *script_args],
        env=stamp_environ(dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                          r, nprocs))
        for r in range(nprocs)]
    # the launcher's deadline: host scheduling, no device work timed
    # apex-lint: disable=raw-clock
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            rcs = [p.poll() for p in procs]
            failed = next((rc for rc in rcs if rc), 0)
            if failed or all(rc is not None for rc in rcs):
                return failed
            # the same deadline
            # apex-lint: disable=raw-clock
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} workers still running after "
                                   f"{timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def run_simulated(argv: Sequence[str], n: int = 8, timeout: float = 600.0,
                  env=None) -> "subprocess.CompletedProcess":
    """Run the script ``argv`` (path and arguments) as ``n`` CPU ranks
    over gloo, through the launcher in a subprocess, and return the
    completed process with its output captured as text (ref ``:105``,
    which runs one process over ``n`` simulated devices: the port's
    ranks are processes)."""
    return subprocess.run(
        [sys.executable, "-m", "apex_tpu_torch.parallel.multiproc",
         "--nprocs", str(n), "--backend", "gloo", "--cpu", *argv],
        capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ if env is None else env))


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI (ref ``:161``): ``[--nprocs N] [--backend gloo|nccl] [--cpu]
    script.py [args...]``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    nprocs, backend, cpu = None, None, None
    while argv and argv[0].startswith("--"):
        flag = argv.pop(0)
        if flag == "--nprocs":
            nprocs = int(argv.pop(0))
        elif flag == "--backend":
            backend = argv.pop(0)
        elif flag == "--cpu":
            cpu = True
        else:
            print(f"unknown flag {flag}", file=sys.stderr)
            return 2
    if not argv:
        print("usage: python -m apex_tpu_torch.parallel.multiproc "
              "[--nprocs N] [--backend gloo|nccl] [--cpu] <script> "
              "[args...]", file=sys.stderr)
        return 1
    if nprocs is not None:
        return launch(argv, nprocs, backend=backend or "nccl",
                      cpu=bool(cpu))

    import torch.distributed as dist

    from apex_tpu_torch.distributed import backend as dist_backend

    initialize_distributed(backend=backend, cpu=cpu)
    if dist.get_backend() == "gloo":
        # gloo connects every pair of ranks inside init_process_group: a
        # rank that returned from it first could run its script and exit
        # while a peer still connects, failing the peer's init ("Connection
        # closed by peer") in place of reporting the script's exit code
        dist.barrier()
    script = argv[0]
    sys.argv = argv
    sys.path.insert(0, os.path.dirname(os.path.abspath(script)))
    with open(script) as f:
        code = compile(f.read(), script, "exec")
    try:
        exec(code, {"__name__": "__main__", "__file__": script})
    finally:
        dist_backend.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
