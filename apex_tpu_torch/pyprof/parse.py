"""Trace parsing: ``torch.profiler`` trace -> per-op records (port of
``apex_tpu/pyprof/parse.py``).

The reference reads a ``jax.profiler`` xplane capture and emits one
record per HLO-op execution with its exclusive (self) time. Here the
capture is what ``torch.profiler`` writes: a Chrome-trace JSON
(``profile.export_chrome_trace``, or :func:`apex_tpu_torch.pyprof.stop`),
a ``tensorboard_trace_handler`` directory of ``*.pt.trace.json`` files,
or either gzipped. :func:`parse_trace` and :func:`find_trace_paths` are
the counterparts of the reference's ``parse_xspace`` and
``find_xplane_paths``.

- Device records come from the trace's ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset`` events, one plane per card (``/device:GPU:<i>``), one
  line per kind (``Kernels``, ``Memcpy``, ``Memset``); self time comes
  from nesting on each stream, where kernels do not nest, so it is the
  event's duration.
- A trace with no device event (a CPU-only run) gives host records:
  the ``cpu_op`` events (``aten::mm``, ...) on ``/host:CPU``, self time
  by nesting on each thread. Python frames and annotations stay out, as
  the reference keeps TraceMe spans out.
- ``flops`` and ``bytes_accessed`` are None wherever the trace measured
  none (the reference's rule): a kernel carries neither; a copy or a
  fill carries the bytes the trace records for it. The flops the
  profiler estimates for an op (``with_flops=True``) are a formula on
  the host, not a measurement of the kernel, and are not read.
- :func:`step_times_us` reads the ``ProfilerStep#N`` annotations, the
  step markers ``profile.step()`` writes (the reference's device
  ``Steps`` line).

:func:`classify` keeps every reference pattern (over HLO names) and adds
the CUDA name families a ``torch.profiler`` trace carries: cuBLAS,
cuBLASLt and CUTLASS GEMMs, cuDNN convolutions, NCCL kernels, copies and
fills, ATen's index, scatter, RNG and reduce kernels, and the port's own
kernels (``apex_tpu_torch/ops/csrc``), matched by their demangled names,
namespace and template arguments included, so that an ATen kernel of a
similar name does not land there.
"""

from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "OpRecord", "classify", "short_name", "is_container", "port_kernel",
    "find_trace_paths", "parse_trace", "step_times_us", "load_trace",
    "CATEGORIES", "CUDA_CATEGORIES", "PORT_KERNELS",
]


@dataclasses.dataclass
class OpRecord:
    """One op or kernel execution (the reference's record)."""

    name: str            # kernel name as the trace prints it, or an op
    program: str         # HLO module in the reference; "" in a torch trace
    plane: str           # "/device:GPU:<i>" or "/host:CPU"
    category: str        # see CATEGORIES / CUDA_CATEGORIES
    duration_ps: int     # inclusive span
    self_ps: int         # exclusive time (minus nested children)
    # None = the trace measured no flops for this record
    flops: Optional[float] = None
    # None = the trace measured no bytes for this record (a kernel);
    # never a fabricated 0.0
    bytes_accessed: Optional[float] = None
    line: str = ""       # "Kernels", "Memcpy", "Memset", or a host thread


# Category -> regexes over HLO op names (the reference's table, whole).
CATEGORIES: Tuple[Tuple[str, str], ...] = (
    ("collective",
     r"^(all-reduce|all-gather|all-to-all|reduce-scatter|"
     r"collective-permute|collective-broadcast|partition-id|replica-id|"
     r"psum|pmax|pmin|all_gather|all_to_all|reduce_scatter|ppermute|"
     r"ragged-all-to-all)"),
    ("matmul", r"^(dot|cublas|gemm|matmul|dot_general)"),
    ("convolution", r"^(conv|convolution)"),
    ("attention-kernel", r"(flash|attention)"),
    ("custom-kernel", r"custom-call"),
    ("rng", r"^(rng|threefry|random)"),
    ("gather-scatter", r"^(gather|scatter|dynamic-slice|dynamic-update)"),
    ("data-movement",
     r"^(copy|bitcast|transpose|slice|concatenate|pad|reshape|broadcast|"
     r"reverse|tuple|get-tuple-element|wrapped_slice|wrapped_broadcast)"),
    ("host-transfer", r"^(infeed|outfeed|send|recv|host)"),
    ("control", r"^(while|call|conditional|async|done|start)"),
    ("reduction", r"^(reduce|wrapped_reduce|sort|top-k|topk|cumsum)"),
)
_COMPILED = [(cat, re.compile(pat)) for cat, pat in CATEGORIES]

# The port's hand-written kernels, by the demangled name a trace prints
# (``void tc::flash_fwd_tc_kernel<128, false>(...)``): the flash kernels
# are attention, every other kernel is a custom kernel, as the reference
# sends a Pallas custom-call. Anchored at the namespace, so ATen's
# ``at::native::...`` kernels never match.
PORT_KERNELS: Tuple[Tuple[str, str], ...] = (
    ("attention-kernel",
     r"^(void )?(tc::flash_(fwd|bwd_dq|bwd_dkv)_tc_kernel|"
     r"\(anonymous namespace\)::flash_(fwd|bwd_dq|bwd_dkv)_fp32_kernel)<"),
    ("custom-kernel",
     r"^(void )?(row_norm::(fwd_rows|bwd_rows|column_sum|fwd|bwd)_kernel|"
     r"\(anonymous namespace\)::(adam|cast_scale|cast_scale_t|softmax_rows"
     r"|softmax_stats|softmax_apply)_kernel)<"),
)

# CUDA name families (library and ATen kernels, copies, ATen host ops),
# in the order they are tried. ``name`` patterns see the name without
# its parameter list; ``base`` patterns see the kernel's own identifier
# (``at::native::reduce_kernel<...>`` -> ``reduce_kernel``), so a
# template argument never decides.
CUDA_CATEGORIES: Tuple[Tuple[str, str, str], ...] = (
    ("collective", "name", r"(?i)\bnccl|^c10d::|^gloo:"),
    ("host-transfer", "name", r"^Memcpy (HtoD|DtoH)"),
    ("data-movement", "name", r"^(Memcpy|Memset)\b"),
    ("convolution", "name",
     r"(?i)(fprop|dgrad|wgrad|convolve|conv2d|winograd|"
     r"^aten::(cudnn_)?conv)"),
    ("matmul", "name",
     r"(?i)(gemm|gemv|sm\d+_xmma|nvjet|cutlass|cublas|"
     r"^aten::(mm|bmm|addmm|baddbmm|matmul|linear)$)"),
    ("attention-kernel", "name", r"(?i)(flash|attention|fmha)"),
    ("rng", "base",
     r"(?i)(philox|distribution_|curand|dropout|^aten::(normal_|uniform_|"
     r"bernoulli_|randn|rand|randint))"),
    ("gather-scatter", "base",
     r"(?i)(index|gather|scatter|embedding)"),
    ("data-movement", "base",
     r"(?i)(copy|CatArray|transpose|^aten::(cat|to|_to_copy|contiguous"
     r"|clone)$)"),
    ("reduction", "base",
     r"(?i)(reduce|^aten::(sum|mean|amax|amin|max|min|norm|argmax|sort"
     r"|topk|cumsum)$)"),
)
_PORT_COMPILED = [(cat, re.compile(pat)) for cat, pat in PORT_KERNELS]
_CUDA_COMPILED = [(cat, on, re.compile(pat))
                  for cat, on, pat in CUDA_CATEGORIES]

# containers whose time is their children's — excluded from self-time
# rollups entirely (their exclusive remainder is scheduler overhead)
_CONTAINER = re.compile(r"^(while|call|conditional)")


def _is_cuda_name(name: str) -> bool:
    """A kernel, copy or host op as a torch trace names it, not an HLO
    op: HLO names have no parameter list outside ``%x = ...`` text."""
    base = name.strip()
    if base.startswith("%"):
        return False
    return (base.startswith(("void ", "Memcpy", "Memset", "aten::",
                             "c10d::", "nccl"))
            or base.endswith(")"))


def _strip_params(name: str) -> str:
    """``void ns::k<T>(int, float*)`` -> ``ns::k<T>``: the leading
    ``void`` and the last top-level parenthesised list go (``(anonymous
    namespace)::`` at the front is kept)."""
    base = name.strip()
    if base.startswith("void "):
        base = base[5:]
    if base.startswith(("Memcpy", "Memset")) or not base.endswith(")"):
        return base
    depth = 0
    for i in range(len(base) - 1, -1, -1):
        c = base[i]
        if c == ")":
            depth += 1
        elif c == "(":
            depth -= 1
            if depth == 0:
                return base[:i] if i > 0 else base
    return base


def _base_identifier(name: str) -> str:
    """The kernel's own identifier: the last ``::`` component outside
    template brackets, its template arguments dropped."""
    depth = 0
    out = []
    for c in name:
        if c == "<":
            depth += 1
        elif c == ">":
            depth = max(depth - 1, 0)
        elif depth == 0:
            out.append(c)
    plain = "".join(out)
    if plain.startswith("aten::"):
        return plain
    return plain.rsplit("::", 1)[-1]


def classify(name: str) -> str:
    """The category of an op or kernel name: the port's kernels first,
    then (for an HLO name) the reference's patterns, then the CUDA
    families, which also take the library kernels whose names carry no
    parameter list (``nvjet_tst_...``, ``sm90_xmma_gemm_...``)."""
    for cat, pat in _PORT_COMPILED:
        if pat.search(name.strip()):
            return cat
    if not _is_cuda_name(name):
        base = short_name(name).lower()
        for cat, pat in _COMPILED:
            if pat.search(base):
                return cat
    full = _strip_params(name)
    ident = _base_identifier(full)
    for cat, on, pat in _CUDA_COMPILED:
        if pat.search(full if on == "name" else ident):
            return cat
    # everything else is an elementwise chain: XLA names them
    # "<op>_<op>_fusion" / "fusion.N" / "wrapped_<op>" / bare op names;
    # a CUDA elementwise kernel lands here too
    return "fusion-elementwise"


def port_kernel(name: str) -> Optional[Tuple[str, Tuple[str, ...]]]:
    """The port's own kernel a trace name is, as :data:`PORT_KERNELS`
    decides: ``(its identifier, its template arguments)``, e.g.
    ``("fwd_rows_kernel", ("false", "__nv_bfloat16", ...))``; None for
    any other name."""
    if not any(pat.search(name.strip()) for _, pat in _PORT_COMPILED):
        return None
    full = _strip_params(name)
    start = full.find("<")
    args, depth, cur = [], 0, []
    for c in full[start + 1:full.rfind(">")] if start >= 0 else "":
        if c == "<":
            depth += 1
        elif c == ">":
            depth -= 1
        elif c == "," and depth == 0:
            args.append("".join(cur).strip())
            cur = []
            continue
        cur.append(c)
    if cur:
        args.append("".join(cur).strip())
    return _base_identifier(full), tuple(args)


def short_name(name: str) -> str:
    """Normalize an event name to the bare op name.

    HLO text (``%slice-start.73 = (...) async-start(...)``) keeps the
    reference's rule: the sigil goes and the lhs identifier stays. A
    torch trace's kernel name loses its leading ``void`` and its
    parameter list, keeping namespace and template arguments, so two
    instantiations of a kernel stay apart; a copy or a fill keeps its
    whole name (``Memcpy HtoD (Pageable -> Device)``)."""
    if _is_cuda_name(name):
        return _strip_params(name)
    base = name.strip()
    if base.startswith("%"):
        base = base[1:]
    for sep in (" = ", " "):
        cut = base.find(sep)
        if cut > 0:
            base = base[:cut]
            break
    return base


def is_container(name: str) -> bool:
    return bool(_CONTAINER.match(name.lower()))


_TRACE_GLOBS = ("*.pt.trace.json", "*.pt.trace.json.gz")


def find_trace_paths(path: str) -> List[str]:
    """Resolve a trace file (``.json`` or ``.json.gz``) or a directory
    (as given to ``tensorboard_trace_handler`` or
    :func:`apex_tpu_torch.pyprof.init`) to trace paths; for a directory
    holding several captures, the newest wins, as the reference takes a
    logdir's newest run."""
    if os.path.isfile(path):
        return [path]
    found = []
    for pattern in _TRACE_GLOBS:
        found.extend(glob.glob(os.path.join(path, pattern)))
    if not found:
        raise FileNotFoundError(f"no torch.profiler trace under {path!r}")
    return [max(found, key=lambda p: (os.path.getmtime(p), p))]


def load_trace(path: str) -> dict:
    """One trace file's JSON (gzip read when the name ends in ``.gz``)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        payload = json.load(f)
    if not isinstance(payload, dict) or "traceEvents" not in payload:
        raise ValueError(f"{path}: not a Chrome trace (no traceEvents)")
    return payload


_DEVICE_CATS = {"kernel": "Kernels", "gpu_memcpy": "Memcpy",
                "gpu_memset": "Memset"}


def _records(events, plane_of, line_of, nbytes_of) -> List[OpRecord]:
    """Self time by interval nesting on each track: events on one
    (pid, tid) form a forest (a child lies within its parent's span);
    exclusive = inclusive minus the children's inclusive sums."""
    tracks: Dict[tuple, list] = {}
    for ev in events:
        start = int(round(float(ev.get("ts", 0.0)) * 1e6))
        dur = int(round(float(ev.get("dur", 0.0)) * 1e6))
        tracks.setdefault((ev.get("pid"), ev.get("tid")), []).append(
            (start, start + dur, dur, ev))
    out = []
    for items in tracks.values():
        items.sort(key=lambda t: (t[0], -t[1]))
        stack: List[Tuple[int, int, list]] = []
        rows = []
        for start, end, dur, ev in items:
            while stack and start >= stack[-1][1]:
                stack.pop()
            if stack:
                stack[-1][2][0] += dur
            child_box = [0]
            stack.append((start, end, child_box))
            rows.append((dur, ev, child_box))
        for dur, ev, child_box in rows:
            name = str(ev.get("name", "?"))
            out.append(OpRecord(
                name=name, program="", plane=plane_of(ev),
                category=classify(name), duration_ps=dur,
                self_ps=max(dur - child_box[0], 0), flops=None,
                bytes_accessed=nbytes_of(ev), line=line_of(ev)))
    return out


def _device_bytes(ev) -> Optional[float]:
    nbytes = (ev.get("args") or {}).get("bytes")
    return None if nbytes is None else float(nbytes)


def _device_plane(ev) -> str:
    args = ev.get("args") or {}
    return f"/device:GPU:{args.get('device', ev.get('pid'))}"


def parse_trace(paths: Iterable[str]) -> List[OpRecord]:
    """Every device record of the traces, or, where a trace holds no
    device event, its host ``cpu_op`` records (see the module doc)."""
    records: List[OpRecord] = []
    for path in paths:
        events = [ev for ev in load_trace(path)["traceEvents"]
                  if isinstance(ev, dict) and ev.get("ph") == "X"]
        device = [ev for ev in events if ev.get("cat") in _DEVICE_CATS]
        if device:
            records.extend(_records(
                device, _device_plane,
                lambda ev: _DEVICE_CATS[ev["cat"]], _device_bytes))
        else:
            host = [ev for ev in events if ev.get("cat") == "cpu_op"]
            records.extend(_records(
                host, lambda ev: "/host:CPU",
                lambda ev: f"thread {ev.get('tid')}", lambda ev: None))
    return records


_STEP = re.compile(r"^ProfilerStep#\d+$")


def step_times_us(paths: Iterable[str]) -> List[float]:
    """Step durations (us) from the ``ProfilerStep#N`` annotations that
    ``profile.step()`` writes, in step order: the host's step markers
    (``user_annotation``); where a trace has none, their device
    projection (``gpu_user_annotation``)."""
    steps: List[float] = []
    for path in paths:
        marks: Dict[str, list] = {}
        for ev in load_trace(path)["traceEvents"]:
            if (isinstance(ev, dict) and ev.get("ph") == "X"
                    and _STEP.match(str(ev.get("name", "")))):
                marks.setdefault(ev.get("cat"), []).append(ev)
        chosen = marks.get("user_annotation") or marks.get(
            "gpu_user_annotation") or []
        chosen.sort(key=lambda ev: int(ev["name"].split("#")[1]))
        steps.extend(float(ev.get("dur", 0.0)) for ev in chosen)
    return steps
