"""The port's AST and concurrency engines (``apex_tpu_torch.analysis``)
held against the reference's (``apex_tpu.analysis``) on the CPU.

Corpus parity: every .py file of ``apex_tpu/`` and ``examples/`` is read
as text, ``apex_tpu`` is renamed ``apex_tpu_torch`` in its import
statements only (line numbers stay), and its path is mapped into the
port's layout (``examples/x`` -> ``apex_tpu_torch/examples/x``). The
reference engine runs on the original, the port's on the mapped copy:
for the five framework-neutral AST checks and the five concurrency
checks the two give the same multiset of (check, mapped path, line,
symbol), with the suppression comments as written and with every one of
them switched off (the reference's own code is clean, so the second run
is the one that finds something to compare).

Aligned pairs: for each of the eight rules that name the device runtime,
a JAX snippet and its PyTorch form on the same lines. The reference
engine runs on the JAX form, the port's on the torch form, each at its
package's path (library, examples, driver code, allow-listed files), and
the two give the same (check, line, symbol).
"""

import ast
import collections
import os
import pathlib
import re

import pytest

from apex_tpu.analysis import ast_checks as ref_ast
from apex_tpu.analysis import concurrency_checks as ref_conc
from apex_tpu_torch.analysis import ast_checks as port_ast
from apex_tpu_torch.analysis import concurrency_checks as port_conc

ROOT = pathlib.Path(__file__).resolve().parents[1]

NEUTRAL_AST = ("mutable-default", "raw-clock",
               "swallowed-exception-in-step-loop", "unclosed-span",
               "rank-unsafe-artifact-path")
VOCABULARY = ("sync-timing", "host-in-jit", "rng-in-jit",
              "host-isnan-in-step-loop", "raw-fp8-cast",
              "hardcoded-tile-size", "raw-memory-introspection",
              "nondeterministic-collective-order")

# Findings of the neutral and concurrency checks that differ between the
# two runs because of a JAX name, by (check, mapped path, line): none.
# (The concurrency engine's one JAX name, block_until_ready under a
# lock, does not occur in the reference's code.)
JAX_NAME_DIFFERENCES = {}


def test_check_ids_are_the_reference_ids():
    assert port_ast.AST_CHECKS == ref_ast.AST_CHECKS
    assert port_conc.CONCURRENCY_CHECKS == ref_conc.CONCURRENCY_CHECKS
    assert set(NEUTRAL_AST) | set(VOCABULARY) == set(ref_ast.AST_CHECKS)


def _rename_imports(src: str) -> str:
    """``apex_tpu`` -> ``apex_tpu_torch`` on the lines of import
    statements only."""
    lines = src.splitlines(keepends=True)
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            for i in range(node.lineno - 1, node.end_lineno):
                lines[i] = re.sub(r"\bapex_tpu\b", "apex_tpu_torch",
                                  lines[i])
    return "".join(lines)


def _mapped(rel: str) -> str:
    if rel.startswith("apex_tpu/"):
        return "apex_tpu_torch/" + rel[len("apex_tpu/"):]
    return "apex_tpu_torch/" + rel


@pytest.fixture(scope="module")
def corpus():
    files = []
    for path in ref_ast.iter_python_files([str(ROOT / "apex_tpu"),
                                           str(ROOT / "examples")]):
        rel = os.path.relpath(path, ROOT).replace(os.sep, "/")
        files.append((rel, os.path.abspath(path),
                      pathlib.Path(path).read_text(encoding="utf-8")))
    return files


@pytest.mark.parametrize("suppressions", ["as_written", "off"])
def test_corpus_parity(corpus, suppressions):
    assert len(corpus) >= 200
    ref, port = collections.Counter(), collections.Counter()
    for rel, abspath, src in corpus:
        if suppressions == "off":
            src = src.replace("apex-lint:", "apex-lint-off:")
        mapped = _mapped(rel)
        port_src = _rename_imports(src)
        for f in (ref_ast.lint_source(src, rel, NEUTRAL_AST, abspath)
                  + ref_conc.lint_source(src, rel, abspath=abspath)):
            ref[(f.check, mapped, f.line, f.symbol)] += 1
        for f in (port_ast.lint_source(port_src, mapped, NEUTRAL_AST)
                  + port_conc.lint_source(port_src, mapped)):
            port[(f.check, mapped, f.line, f.symbol)] += 1
    diff = {k[:3]: v for k, v in ((ref - port) + (port - ref)).items()}
    assert diff == JAX_NAME_DIFFERENCES
    if suppressions == "off":
        # the comparison has findings to compare: each of these checks
        # fires somewhere in the reference once its comments are off
        assert {k[0] for k in ref} >= {"raw-clock", "unclosed-span",
                                       "blocking-call-under-lock"}
    else:
        assert not ref and not port


# ------------------------------------------------------------ aligned pairs
#
# (id, case, (JAX path, JAX source), (port path, torch source)). Paths
# put each side at its package's place: library code, examples, driver
# code or an allow-listed file.

LIB = ("apex_tpu/mod.py", "apex_tpu_torch/mod.py")
EX = ("examples/ex.py", "apex_tpu_torch/examples/ex.py")
DRIVER = ("tools/drive.py", "flash_ab.py")

PAIRS = [
    # ---------------------------------------------------- sync-timing
    ("sync-timing", "method", DRIVER, """\
import time
import jax


def bench(f, x):
    t0 = time.perf_counter()
    y = f(x)
    y.block_until_ready()
    return time.perf_counter() - t0
""", """\
import time
import torch


def bench(f, x):
    t0 = time.perf_counter()
    y = f(x)
    torch.cuda.synchronize()
    return time.perf_counter() - t0
"""),
    ("sync-timing", "function_and_event", EX, """\
import time
import jax


def bench(f, x, end):
    t0 = time.monotonic()
    y = f(x)
    jax.block_until_ready(y)
    dt = time.monotonic() - t0
    y.block_until_ready()
    return dt
""", """\
import time
import torch


def bench(f, x, end):
    t0 = time.monotonic()
    y = f(x)
    end.synchronize()
    dt = time.monotonic() - t0
    torch.cuda.current_stream().synchronize()
    return dt
"""),
    ("sync-timing", "aliased_and_timing_sync", DRIVER, """\
from time import perf_counter
import jax


def bench(f, x):
    t0 = perf_counter()
    y = f(x)
    y.block_until_ready()
    z = f(y)
    z.block_until_ready()
    return perf_counter() - t0
""", """\
from time import perf_counter
import torch.cuda as tc
from apex_tpu_torch.runtime import timing

def bench(f, x):
    t0 = perf_counter()
    y = f(x)
    tc.synchronize()
    z = f(y)
    timing.sync(z)
    return perf_counter() - t0
"""),
    ("sync-timing", "closure_and_module", DRIVER, """\
import time

t0 = time.time()


def outer(f, x):
    t = time.perf_counter()

    def inner():
        f(x).block_until_ready()
    inner()
    return time.perf_counter() - t


f(x).block_until_ready()
""", """\
import time

t0 = time.time()


def outer(f, x):
    t = time.perf_counter()

    def inner():
        torch.cuda.synchronize()
    inner()
    return time.perf_counter() - t


torch.cuda.synchronize()
"""),
    ("sync-timing", "clean_siblings", DRIVER, """\
import time


def clock():
    return time.perf_counter()


def fence(y):
    y.block_until_ready()
""", """\
import time


def clock():
    return time.perf_counter()


def fence(y):
    torch.cuda.synchronize()
"""),
    ("sync-timing", "suppressed", DRIVER, """\
import time


def bench(f, x):
    t0 = time.perf_counter()
    # apex-lint: disable=sync-timing
    f(x).block_until_ready()
    return time.perf_counter() - t0
""", """\
import time


def bench(f, x):
    t0 = time.perf_counter()
    # apex-lint: disable=sync-timing
    torch.cuda.synchronize()
    return time.perf_counter() - t0
"""),
    ("sync-timing", "allow_listed", ("apex_tpu/runtime/timing.py",
                                     "apex_tpu_torch/runtime/timing.py"),
     """\
import time


def time_fn(f, x):
    t0 = time.perf_counter()
    f(x).block_until_ready()
    return time.perf_counter() - t0
""", """\
import time


def time_fn(f, x):
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    return time.perf_counter() - t0
"""),
    # ---------------------------------------------------- host-in-jit
    ("host-in-jit", "decorator", LIB, """\
import jax


@jax.jit
def f(x):
    return float(x.sum()) + int(x.shape[0])
""", """\
import torch


@torch.compile
def f(x):
    return float(x.sum()) + int(x.size(0))
"""),
    ("host-in-jit", "partial_and_numpy", EX, """\
import functools
import numpy as np
import jax


@functools.partial(jax.jit, static_argnums=1)
def f(x, n):
    a = np.asarray(x)
    return x.tolist(), a
""", """\
import functools
import numpy as np
import torch


@functools.partial(torch.compile, fullgraph=True)
def f(x, n):
    a = np.asarray(x)
    return x.cpu(), a
"""),
    ("host-in-jit", "graph_capture", LIB, """\
import jax


@jax.jit
def f(x, g):
    if True:
        y = x.item()
    return y
""", """\
import torch


# captured once, replayed every step
def f(x, g):
    with torch.cuda.graph(g):
        y = x.item()
    return y
"""),
    ("host-in-jit", "aliased_graph_and_nested_def", LIB, """\
from jax import jit


@jit
def f(x, g):
    def inner(y):
        return y.tolist(), float(y)
    return inner(x)
""", """\
from torch.cuda import graph


def f(x, g):
    with graph(g):
        def inner(y):
            return y.numpy(), float(y)
    return inner(x)
"""),
    ("host-in-jit", "clean_outside", LIB, """\
import jax


def f(x):
    return float(x.sum()), x.item()


@jax.jit
def g(x):
    return x * 2
""", """\
import torch


def f(x):
    return float(x.sum()), x.item()


@torch.compile
def g(x):
    return x * 2
"""),
    ("host-in-jit", "suppressed", LIB, """\
import jax


@jax.jit
def f(x):
    return x.item()  # apex-lint: disable=host-in-jit
""", """\
import torch


@torch.compile
def f(x):
    return x.item()  # apex-lint: disable=host-in-jit
"""),
    # ----------------------------------------------------- rng-in-jit
    ("rng-in-jit", "python_random", LIB, """\
import random
import jax


@jax.jit
def f(x):
    return x * random.random()
""", """\
import random
import torch


@torch.compile
def f(x):
    return x * random.random()
"""),
    ("rng-in-jit", "numpy_random_in_capture", EX, """\
import numpy as np
import jax


@jax.jit
def f(x, g):
    if x is not None:
        return x + np.random.normal()
""", """\
import numpy as np
import torch


# captured once, replayed every step
def f(x, g):
    with torch.cuda.graph(g):
        return x + np.random.normal()
"""),
    ("rng-in-jit", "clean_framework_rng", LIB, """\
import jax


@jax.jit
def f(x, key):
    return x + jax.random.normal(key, x.shape)
""", """\
import torch


@torch.compile
def f(x, gen):
    return x + torch.randn(x.shape, generator=gen)
"""),
    # ------------------------------------------ host-isnan-in-step-loop
    ("host-isnan-in-step-loop", "if_condition", LIB, """\
import jax.numpy as jnp


def run(steps):
    for step in steps:
        loss = step()
        if jnp.isnan(loss):
            break
""", """\
import torch


def run(steps):
    for step in steps:
        loss = step()
        if torch.isnan(loss):
            break
"""),
    ("host-isnan-in-step-loop", "methods_and_pulls", EX, """\
import jax.numpy as jnp


def run(steps):
    for step in steps:
        x = step()
        bad = bool(jnp.isinf(x).any())
        flags = jnp.isnan(x).any().item()
    while jnp.isnan(x).any():
        x = step()
""", """\
import torch


def run(steps):
    for step in steps:
        x = step()
        bad = bool(x.isinf().any())
        flags = torch.isnan(x).any().item()
    while x.float().isnan().any():
        x = step()
"""),
    ("host-isnan-in-step-loop", "aliased", LIB, """\
from jax.numpy import isnan


def run(steps):
    for step in steps:
        if isnan(step()).any():
            break
""", """\
from torch import isnan


def run(steps):
    for step in steps:
        if isnan(step()).any():
            break
"""),
    ("host-isnan-in-step-loop", "clean_host_values", LIB, """\
import math
import numpy as np
import jax.numpy as jnp


def run(steps):
    for step in steps:
        if np.isnan(step()) or math.isnan(step()):
            break
    if jnp.isnan(step()):
        return
""", """\
import math
import numpy as np
import torch


def run(steps):
    for step in steps:
        if np.isnan(step()) or math.isnan(step()):
            break
    if torch.isnan(step()):
        return
"""),
    ("host-isnan-in-step-loop", "numerics_exempt",
     ("apex_tpu/observability/numerics/stats.py",
      "apex_tpu_torch/observability/numerics/stats.py"), """\
import jax.numpy as jnp


def run(xs):
    for x in xs:
        if jnp.isnan(x):
            break
""", """\
import torch


def run(xs):
    for x in xs:
        if torch.isnan(x):
            break
"""),
    ("host-isnan-in-step-loop", "driver_code", DRIVER, """\
import jax.numpy as jnp


def run(xs):
    for x in xs:
        if jnp.isnan(x):
            break
""", """\
import torch


def run(xs):
    for x in xs:
        if torch.isnan(x):
            break
"""),
    # ---------------------------------------------------- raw-fp8-cast
    ("raw-fp8-cast", "positional_and_keyword", LIB, """\
import jax.numpy as jnp


def q(x):
    a = x.astype(jnp.float8_e4m3fn)
    b = x.astype(dtype=jnp.float8_e5m2)
    c = x.astype(jnp.bfloat16)
    return a, b, c
""", """\
import torch


def q(x):
    a = x.to(torch.float8_e4m3fn)
    b = x.to(dtype=torch.float8_e5m2)
    c = x.to(torch.bfloat16)
    return a, b, c
"""),
    ("raw-fp8-cast", "aliases_type_and_device_first", EX, """\
from jax.numpy import float8_e4m3fn as F8
import jax.numpy as jnp


def q(x, dev):
    a = x.astype(F8)
    b = x.astype(jnp.float8_e5m2)
    c = x.astype("float8_e4m3fn")
    return a, b, c
""", """\
from torch import float8_e4m3fn as F8
import torch


def q(x, dev):
    a = x.to(F8)
    b = x.type(torch.float8_e5m2)
    c = x.to(dev, torch.float8_e4m3fn)
    return a, b, c
"""),
    ("raw-fp8-cast", "driver_code_too", DRIVER, """\
import jax.numpy as jnp


def q(x):
    return x.astype(jnp.float8_e4m3fn)
""", """\
import torch


def q(x):
    return x.to(torch.float8_e4m3fn)
"""),
    ("raw-fp8-cast", "owner_precision", ("apex_tpu/ops/precision.py",
                                         "apex_tpu_torch/ops/precision.py"),
     """\
import jax.numpy as jnp


def q(x):
    return x.astype(jnp.float8_e4m3fn)
""", """\
import torch


def q(x):
    return x.to(torch.float8_e4m3fn)
"""),
    ("raw-fp8-cast", "owner_amp", ("apex_tpu/amp/fp8.py",
                                   "apex_tpu_torch/amp/fp8.py"), """\
import jax.numpy as jnp


def q(x):
    return x.astype(jnp.float8_e5m2)
""", """\
import torch


def q(x):
    return x.to(torch.float8_e5m2)
"""),
    ("raw-fp8-cast", "suppressed", LIB, """\
import jax.numpy as jnp


def q(x):
    # apex-lint: disable=raw-fp8-cast
    return x.astype(jnp.float8_e4m3fn)
""", """\
import torch


def q(x):
    # apex-lint: disable=raw-fp8-cast
    return x.to(torch.float8_e4m3fn)
"""),
    # --------------------------------------------- hardcoded-tile-size
    ("hardcoded-tile-size", "literals_at_launch", LIB, """\
from jax.experimental import pallas as pl


def f(x):
    spec = pl.BlockSpec((256, 128, 4), lambda i: (i, 0))
    return spec
""", """\
from apex_tpu_torch.ops import _build


def f(x):
    rc = _build.library("k").kernel(x, 256, 128, 4)
    return rc
"""),
    ("hardcoded-tile-size", "module_constants_and_factory", LIB, """\
from jax.experimental import pallas as pl

_BLOCK_ROWS = 512
_TILE = 4
_MAX_ROWS = 1024


def _spec(h):
    return pl.BlockSpec((_BLOCK_ROWS, h), lambda i: (i, 0))


def f(x):
    return pl.BlockSpec(block_shape=(1024, x), index_map=None)
""", """\
from apex_tpu_torch.ops import _build

_BLOCK_ROWS = 512
_TILE = 4
_MAX_ROWS = 1024


def _lib():
    return _build.library("k")


def f(x):
    return _lib().kernel(x, threads=1024)
"""),
    ("hardcoded-tile-size", "relative_import_and_bound_name", LIB, """\
from jax.experimental import pallas as pl

ROW_BLOCK = 256


def f(x):
    lib = x
    return pl.BlockSpec((8, 2), None), lib
""", """\
from ._build import library

ROW_BLOCK = 256


def f(x):
    lib = library("k")
    return lib.kernel(8, 2), lib
"""),
    ("hardcoded-tile-size", "clean_without_launch", LIB, """\
_BLOCK_ROWS = 512


def f(x):
    return x.reshape(256, 128)
""", """\
_BLOCK_ROWS = 512


def f(x):
    return x.reshape(256, 128)
"""),
    ("hardcoded-tile-size", "allow_listed",
     ("apex_tpu/tuning/search_space.py",
      "apex_tpu_torch/tuning/search_space.py"), """\
from jax.experimental import pallas as pl

_BLOCK = 256


def f(x):
    return pl.BlockSpec((256, 128), None)
""", """\
from apex_tpu_torch.ops import _build

_BLOCK = 256


def f(x):
    return _build.library("k").kernel(256, 128)
"""),
    ("hardcoded-tile-size", "suppressed_mirror", LIB, """\
from jax.experimental import pallas as pl

ROW_BLOCK = 256  # apex-lint: disable=hardcoded-tile-size


def f(x):
    return pl.BlockSpec((x, 1), None)
""", """\
from apex_tpu_torch.ops import _build

ROW_BLOCK = 256  # apex-lint: disable=hardcoded-tile-size


def f(x):
    return _build.library("k").kernel(x, 1)
"""),
    # ---------------------------------------- raw-memory-introspection
    ("raw-memory-introspection", "functions", LIB, """\
import jax
import jax.profiler


def peek():
    a = jax.live_arrays()
    b = jax.devices()[0].memory_stats()
    c = jax.profiler.device_memory_profile()
    return a, b, c
""", """\
import gc
import torch


def peek():
    a = torch.cuda.memory_allocated()
    b = torch.cuda.memory_stats(0)
    c = gc.get_objects()
    return a, b, c
"""),
    ("raw-memory-introspection", "aliases", EX, """\
from jax import live_arrays
import jax


def peek(client):
    a = live_arrays()
    b = client.live_executables()
    return a, b
""", """\
import torch.cuda as tc
from torch.cuda import max_memory_allocated


def peek(client):
    a = tc.mem_get_info()
    b = max_memory_allocated()
    return a, b
"""),
    ("raw-memory-introspection", "owner_memory_tier",
     ("apex_tpu/observability/memory/hbm.py",
      "apex_tpu_torch/observability/memory/hbm.py"), """\
import jax


def peek():
    return jax.live_arrays()
""", """\
import torch


def peek():
    return torch.cuda.memory_snapshot()
"""),
    ("raw-memory-introspection", "owner_budget_read",
     ("apex_tpu/ops/pallas_config.py", "apex_tpu_torch/_device.py"), """\
import jax


def budget():
    return jax.devices()[0].memory_stats()["bytes_limit"]
""", """\
import torch


def budget():
    return torch.cuda.mem_get_info()[1]
"""),
    ("raw-memory-introspection", "owner_dispatch_switch",
     ("apex_tpu/ops/pallas_config.py", "apex_tpu_torch/ops/kernel_config.py"),
     """\
import jax


def budget():
    return jax.devices()[0].memory_stats()
""", """\
import torch


def budget():
    return torch.cuda.memory_reserved()
"""),
    ("raw-memory-introspection", "driver_code", DRIVER, """\
import jax


def peek():
    return jax.live_arrays()
""", """\
import torch


def peek():
    return torch.cuda.max_memory_allocated()
"""),
    # ------------------------------- nondeterministic-collective-order
    ("nondeterministic-collective-order", "set_loops",
     ("apex_tpu/parallel/plan.py", "apex_tpu_torch/parallel/plan.py"), """\
import os
import jax
from jax import lax


def sync(grads, names, d):
    for name in set(names):
        grads[name] = lax.psum(grads[name], "dp")
    for f in os.listdir(d):
        buckets.append(f)
    for k in names.union(grads):
        lax.ppermute(grads[k], "pp", perm=[(0, 1)])
    for k in {"a", "b"}:
        out = lax.all_gather(grads[k], "tp")
    for k in sorted(set(names)):
        grads[k] = lax.psum(grads[k], "dp")
""", """\
import os
import torch.distributed as dist
from apex_tpu_torch.distributed import backend


def sync(grads, names, d):
    for name in set(names):
        dist.all_reduce(grads[name])
    for f in os.listdir(d):
        buckets.append(f)
    for k in names.union(grads):
        dist.batch_isend_irecv([grads[k]])
    for k in {"a", "b"}:
        out = backend.all_gather_into(grads[k], grads[k], "tp")
    for k in sorted(set(names)):
        dist.all_reduce(grads[k])
"""),
    ("nondeterministic-collective-order", "runtime_and_distributed",
     ("apex_tpu/runtime/host.py", "apex_tpu_torch/runtime/host.py"), """\
from jax import lax


def plan(groups):
    for g in frozenset(groups):
        plan_buckets(g)
    for g in set(groups):
        print(g)
""", """\
import torch.distributed as dist


def plan(groups):
    for g in frozenset(groups):
        plan_buckets(g)
    for g in set(groups):
        print(g)
"""),
    ("nondeterministic-collective-order", "outside_comms_code", LIB, """\
from jax import lax


def sync(grads, names):
    for name in set(names):
        grads[name] = lax.psum(grads[name], "dp")
""", """\
import torch.distributed as dist


def sync(grads, names):
    for name in set(names):
        dist.all_reduce(grads[name])
"""),
    ("nondeterministic-collective-order", "suppressed",
     ("apex_tpu/distributed/x.py", "apex_tpu_torch/distributed/x.py"), """\
from jax import lax


def sync(grads, names):
    # apex-lint: disable=nondeterministic-collective-order
    for name in set(names):
        lax.psum(grads[name], "dp")
""", """\
import torch.distributed as dist


def sync(grads, names):
    # apex-lint: disable=nondeterministic-collective-order
    for name in set(names):
        dist.all_reduce(grads[name])
"""),
]


def _triples(findings):
    return sorted((f.check, f.line, f.symbol) for f in findings)


@pytest.mark.parametrize("check,case,paths,jax_src,torch_src", PAIRS,
                         ids=[f"{p[0]}-{p[1]}" for p in PAIRS])
def test_aligned_pair(check, case, paths, jax_src, torch_src):
    ref_path, port_path = paths
    assert len(jax_src.splitlines()) == len(torch_src.splitlines())
    ref = ref_ast.lint_source(jax_src, ref_path, {check})
    port = port_ast.lint_source(torch_src, port_path, {check})
    assert _triples(port) == _triples(ref)


def test_every_vocabulary_rule_has_positive_and_clean_pairs():
    for check in VOCABULARY:
        counts = collections.Counter()
        for c, _case, (ref_path, _), jax_src, _ in PAIRS:
            if c == check:
                hit = bool(ref_ast.lint_source(jax_src, ref_path, {check}))
                counts[hit] += 1
        assert counts[True] >= 2 and counts[False] >= 1, (check, counts)


def test_blocking_sync_under_lock_is_the_torch_form():
    """The concurrency engine's one JAX name: block_until_ready under a
    lock in the reference, a device synchronize (torch.cuda.synchronize,
    an Event's or Stream's .synchronize(), timing.sync) in the port."""
    jax_src = """\
import threading


class W:
    def __init__(self):
        self._lock = threading.Lock()

    def wait(self, out):
        with self._lock:
            out.block_until_ready()
            out.block_until_ready()
            out.block_until_ready()
"""
    torch_src = """\
import threading


class W:
    def __init__(self):
        self._lock = threading.Lock()

    def wait(self, out):
        with self._lock:
            torch.cuda.synchronize()
            self._event.synchronize()
            timing.sync(out)
"""
    ref = ref_conc.lint_source(jax_src, "apex_tpu/w.py")
    port = port_conc.lint_source(torch_src, "apex_tpu_torch/w.py")
    assert _triples(port) == _triples(ref)
    assert len(port) == 3
    assert port_conc.lint_source(torch_src, "chip_smoke.py") == []
