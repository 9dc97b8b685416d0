"""AST-level lint for host-sync and trace-hygiene anti-patterns.

Runs over ``apex_tpu_torch/`` (its examples live at
``apex_tpu_torch/examples/``), ``chip_smoke.py`` and the port's driver
scripts — the code that drives the card. Thirteen checks, the ids of
``apex_tpu.analysis.ast_checks``; five are framework-neutral and keep the
reference's logic, eight name the device runtime and take its PyTorch
forms:

- ``sync-timing``     ``torch.cuda.synchronize()``, an Event's or a
                      Stream's ``.synchronize()`` or
                      ``runtime.timing.sync`` inside a function (or a
                      module body) that also reads a wall clock, outside
                      ``runtime/timing.py``: a wall clock around a
                      synchronised call times the host's launch overhead
                      and the sync itself, not the device (a synchronised
                      decode RMSNorm reads 0.054 ms on the wall against
                      0.0034 ms on the card). Time device work with
                      ``apex_tpu_torch.runtime.timing`` (CUDA events).
- ``host-in-jit``     ``float()``/``int()``/``np.asarray``/``.item()``/
                      ``.tolist()``/``.cpu()``/``.numpy()`` inside a
                      ``torch.compile``-decorated function (also through
                      ``functools.partial``) or lexically inside
                      ``with torch.cuda.graph(...)``: a host pull that
                      breaks the compiled graph, or fails the capture.
                      Only the lexical body of a capture counts: a
                      function called from it (a step held in a
                      variable, as the serving ``DecodeGraph`` does) is
                      out of sight.
- ``rng-in-jit``      Python/numpy RNG in the same regions: the sample is
                      drawn once, at compile or capture time, and every
                      replay reuses it. Pass a ``torch.Generator``.
- ``mutable-default`` mutable default argument (list/dict/set): shared
                      across calls.
- ``raw-clock``       a direct wall-clock read (``time.perf_counter`` &
                      co) in library code under ``apex_tpu_torch/``
                      outside ``runtime/timing.py``, ``observability/``,
                      ``resilience/`` and ``serving/``: timing flows
                      through the CUDA-event helpers or the observability
                      Timer, or the next hand-rolled timer measures
                      dispatch again. Driver code (``chip_smoke.py``, the
                      A/B scripts, ``apex_tpu_torch/examples/``) may read
                      clocks — sync-timing still polices HOW it times.
- ``swallowed-exception-in-step-loop``
                      ``except Exception/BaseException/bare: pass`` (or
                      ``continue``) inside a ``for``/``while`` body under
                      ``apex_tpu_torch/``: a step loop that silently eats
                      per-iteration failures hides NaN storms, torn
                      checkpoint writes and dying collectives. Retry
                      transient classes via
                      ``apex_tpu_torch.resilience.retry.Policy``, or at
                      least count/log before continuing.
- ``unclosed-span``   an observability ``span(...)``/``scope(...)`` call
                      under ``apex_tpu_torch/`` that is not the context
                      expression of a ``with`` (or an
                      ``ExitStack.enter_context`` argument): the open-span
                      stack keeps the entry forever, the flight recorder
                      reports a phantom region on every dump, and the
                      NVTX range never pops. Manual
                      ``__enter__``/``__exit__`` pairing inside another
                      context manager's protocol is the one sanctioned
                      shape (suppress with a justification).
- ``host-isnan-in-step-loop``
                      a ``torch.isnan``/``torch.isinf`` result (or the
                      ``.isnan()``/``.isinf()`` methods) pulled to host
                      (``bool()``/``float()``/``.item()``/``.tolist()``,
                      or used directly as an ``if``/``while`` condition)
                      inside a loop body under ``apex_tpu_torch/``: one
                      device round-trip per tensor per step. Route
                      finiteness checks through
                      ``apex_tpu_torch.observability.numerics``, which is
                      exempt — it IS the fused, decimated implementation.
- ``rank-unsafe-artifact-path``
                      a write-mode ``open()`` under ``apex_tpu_torch/``
                      whose path bakes in a fixed artifact filename with
                      no rank component: two ranks handed the same path
                      clobber each other's telemetry. Route shared paths
                      through ``observability.fleet.rank_path`` (exempt).
- ``hardcoded-tile-size``
                      launch geometry hardcoded beside a kernel launch:
                      an int literal >= 8 passed to a kernel library's
                      entry point (the C entries take threads, blocks and
                      rows a block as ints; shapes arrive as variables,
                      dtype codes and flags are below 8), or a
                      module-level ``*BLOCK*``/``*TILE*``/``*_ROWS``/
                      ``*_THREADS`` int constant in a file that loads a
                      kernel library (``ops/_build.library``). The right
                      plan is a per-card, per-shape search result — route
                      it through ``apex_tpu_torch.tuning``. Allowed in
                      ``tuning/search_space.py``, ``tuning/geometry.py``
                      and ``ops/kernel_config.py``; a constant that
                      mirrors a compiled instance of ``ops/csrc/`` stays,
                      suppressed with the CUDA constant it copies named.
- ``raw-fp8-cast``    ``.to(torch.float8_e4m3fn / float8_e5m2)`` (also as
                      ``dtype=`` or a later positional argument) or
                      ``.type(...)`` to an fp8 dtype outside
                      ``ops/precision.py``, ``ops/fp8_cast_kernel.py`` and
                      ``amp/``: an unscaled, unsaturated cast overflows
                      past the format's edge (E4M3 has no inf).
- ``raw-memory-introspection``
                      ``torch.cuda.memory_stats/memory_allocated/
                      max_memory_allocated/memory_reserved/mem_get_info/
                      memory_snapshot`` (and their siblings) or the
                      ``gc.get_objects()`` live walk under
                      ``apex_tpu_torch/`` outside
                      ``observability/memory/``, ``_device.py`` (the
                      card's memory read) and ``ops/kernel_config.py``:
                      ad-hoc reads in a step loop serialise the pipeline
                      and bypass the watermark/top-k accounting the OOM
                      forensics depend on.
- ``nondeterministic-collective-order``
                      a ``for`` loop over an unordered iterable (set
                      literal/comprehension, ``set()``/``frozenset()`` or
                      a set-method call, ``os.listdir``) whose body builds
                      buckets or issues ``torch.distributed`` collectives
                      (or the wrappers of ``distributed/backend.py``), in
                      ``parallel/``, ``runtime/`` and ``distributed/``:
                      ranks disagree on the order and the fleet
                      deadlocks or pairs the wrong buffers. Iterate
                      ``sorted(...)``.

Suppress with ``# apex-lint: disable=<id>`` on (or above) the line.
"""

from __future__ import annotations

import ast
import os
import re

from apex_tpu_torch.analysis.findings import Finding, is_suppressed

AST_CHECKS = ("sync-timing", "host-in-jit", "rng-in-jit",
              "mutable-default", "raw-clock",
              "swallowed-exception-in-step-loop",
              "hardcoded-tile-size", "unclosed-span",
              "host-isnan-in-step-loop", "rank-unsafe-artifact-path",
              "raw-fp8-cast", "nondeterministic-collective-order",
              "raw-memory-introspection")

PACKAGE = "apex_tpu_torch"

# Modules whose job is the corrected sync itself.
_SYNC_ALLOW = f"{PACKAGE}/runtime/timing.py"

# raw-clock applies only to library code under apex_tpu_torch/ (not its
# examples, which are driver code); these own the sanctioned clocks
# (timing.py implements the CUDA-event timing, the observability layer's
# Timer/StepReporter are built on it; resilience/ reads wall time for
# retry backoff/deadlines and serving/ stamps request lifecycle times —
# host-side scheduling, not device phase timing).
_EXAMPLES_PREFIX = f"{PACKAGE}/examples/"
_RAW_CLOCK_ALLOW_FILES = {f"{PACKAGE}/runtime/timing.py"}
_RAW_CLOCK_ALLOW_PREFIXES = (f"{PACKAGE}/observability/",
                             f"{PACKAGE}/resilience/",
                             f"{PACKAGE}/serving/")


def _port_tail(path: str):
    """``path`` from its last ``apex_tpu_torch`` DIRECTORY segment on, or
    None when no such segment exists — the shared scoping idiom for
    package-code checks (matching from the LAST segment keeps checkouts
    that live under a directory of that name correct)."""
    norm = path.replace("\\", "/")
    if PACKAGE not in norm.split("/")[:-1]:
        return None
    return norm[norm.rindex(f"{PACKAGE}/"):]


def _raw_clock_applies(path: str) -> bool:
    """Library code under apex_tpu_torch/, minus its examples and the
    allowlisted clock owners."""
    tail = _port_tail(path)
    if tail is None or tail in _RAW_CLOCK_ALLOW_FILES:
        return False
    return not tail.startswith(_EXAMPLES_PREFIX) and not any(
        tail.startswith(p) for p in _RAW_CLOCK_ALLOW_PREFIXES)


def _in_package(path: str) -> bool:
    """Is ``path`` under an ``apex_tpu_torch`` package dir (its examples
    included)? The ground of the step-loop, span, artifact-path and
    memory checks — where step loops and instrumented hot paths live.
    Driver plumbing (chip_smoke.py, the A/B scripts) may legitimately
    blanket-continue over secondary work."""
    return _port_tail(path) is not None


# unclosed-span: span/scope names must resolve (through the module's
# imports) into the observability package — a local helper that happens
# to be called `span` is not a tracer span.
_SPAN_NAMES = ("span", "scope")

# host-isnan-in-step-loop: the package minus the numerics package — it
# IS the sanctioned decimated/fused implementation of these checks.
_ISNAN_EXEMPT_PREFIX = f"{PACKAGE}/observability/numerics/"


def _host_isnan_applies(path: str) -> bool:
    tail = _port_tail(path)
    return tail is not None and not tail.startswith(_ISNAN_EXEMPT_PREFIX)


_ISNAN_NAMES = frozenset({"isnan", "isinf"})

# rank-unsafe-artifact-path: the package minus the fleet identity
# module, the sanctioned suffixing implementation.
_RANK_PATH_EXEMPT_PREFIX = f"{PACKAGE}/observability/fleet/"

# filename extensions that mean "telemetry/artifact write"
_ARTIFACT_EXTS = (".json", ".jsonl", ".csv", ".log", ".txt", ".pb",
                  ".tsv")

# an identifier anywhere in the path expression that smells like a
# per-rank/per-process component clears the finding
_RANK_COMPONENT_RE = re.compile(
    r"rank|process_index|getpid|\bpid\b|worker|shard|proc_?id",
    re.IGNORECASE)

_WRITE_MODES = {"w", "a", "wb", "ab", "w+", "a+", "wt", "at", "x",
                "xb"}


def _rank_unsafe_applies(path: str) -> bool:
    tail = _port_tail(path)
    return tail is not None and not tail.startswith(
        _RANK_PATH_EXEMPT_PREFIX)


# raw-memory-introspection: the owners are the memory observability
# package (MemoryMonitor's decimated snapshots, the compiled-graph
# capture), _device.py (the card's memory read the page budget takes)
# and ops/kernel_config.py.
_MEMORY_INTROSPECT_EXEMPT_PREFIX = f"{PACKAGE}/observability/memory/"
_MEMORY_INTROSPECT_ALLOW_FILES = {f"{PACKAGE}/_device.py",
                                  f"{PACKAGE}/ops/kernel_config.py"}

#: torch.cuda functions that ARE allocator introspection
_MEMORY_INTROSPECT_TORCH_NAMES = frozenset({
    "memory_stats", "memory_allocated", "max_memory_allocated",
    "memory_reserved", "max_memory_reserved", "mem_get_info",
    "memory_snapshot", "memory_summary",
})


def _memory_introspect_applies(path: str) -> bool:
    tail = _port_tail(path)
    return (tail is not None
            and not tail.startswith(_MEMORY_INTROSPECT_EXEMPT_PREFIX)
            and tail not in _MEMORY_INTROSPECT_ALLOW_FILES)


# raw-fp8-cast: a bare cast to an fp8 dtype anywhere but the sanctioned
# quantization owners. fp8 casts are only safe behind a delayed
# per-tensor scale + saturation (ops/precision.quantize_fp8 / matmul_fp8,
# fed by amp's Fp8DelayedScaler); a raw cast overflows (E4M3 has no inf
# encoding) the first time an activation leaves +-448.
_FP8_CAST_ALLOW_FILES = {f"{PACKAGE}/ops/precision.py",
                         f"{PACKAGE}/ops/fp8_cast_kernel.py"}
_FP8_CAST_ALLOW_PREFIXES = (f"{PACKAGE}/amp/",)

# a cast argument that IS an fp8 dtype: torch's float8_* members, the
# precision module's F8_* aliases (an alias is still a raw cast), or a
# dtype string
_FP8_DTYPE_NAME_RE = re.compile(r"^(float8_e4m3fn|float8_e5m2|"
                                r"F8_E4M3|F8_E5M2)$")
_FP8_CAST_METHODS = frozenset({"to", "type"})


def _raw_fp8_applies(path: str) -> bool:
    tail = _port_tail(path)
    if tail is not None:
        if tail in _FP8_CAST_ALLOW_FILES:
            return False
        if any(tail.startswith(p) for p in _FP8_CAST_ALLOW_PREFIXES):
            return False
    return True


# nondeterministic-collective-order: comms scheduling code — parallel/
# (bucket plans, collective issue chains), runtime/ (plan_buckets) and
# distributed/. Every rank must build the SAME bucket list and issue
# collectives in the SAME order; a loop over a set (hash-randomized for
# strings across processes) or os.listdir (filesystem order) deciding
# either is a cross-rank deadlock/desync seed.
_NONDET_ORDER_PREFIXES = (f"{PACKAGE}/parallel/", f"{PACKAGE}/runtime/",
                          f"{PACKAGE}/distributed/")

#: loop bodies that "issue comms / build buckets": a torch.distributed
#: collective, a wrapper of distributed/backend.py, plan_buckets, or any
#: bucket-named identifier
_ORDER_COLLECTIVE_NAMES = frozenset({
    "all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
    "all_to_all_single", "broadcast", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "all_gather", "reduce_scatter", "all_to_all",
    "all_gather_into", "reduce_scatter_into", "barrier", "plan_buckets",
})

#: set-producing call tails a for-loop must not iterate unsorted
_SET_CALL_NAMES = frozenset({"set", "frozenset"})
_SET_METHOD_NAMES = frozenset({"difference", "union", "intersection",
                               "symmetric_difference"})


def _nondet_order_applies(path: str) -> bool:
    tail = _port_tail(path)
    return tail is not None and any(
        tail.startswith(p) for p in _NONDET_ORDER_PREFIXES)


# hardcoded-tile-size: the modules launch-plan numbers are ALLOWED to
# live in — the tuner's search space and geometry tables and the
# dispatch switch.
_TILE_SIZE_ALLOW = (f"{PACKAGE}/tuning/search_space.py",
                    f"{PACKAGE}/tuning/geometry.py",
                    f"{PACKAGE}/ops/kernel_config.py")

# Below 8: dtype codes, flags and small counts are plumbing, not a
# tunable plan.
_TILE_LITERAL_MIN = 8

# Module-constant names that read as launch geometry (matched against
# the upper-cased name): ROW_BLOCK, _TILE_N, FWD_ROWS, MAX_ROW_THREADS.
_TILE_NAME_RE = re.compile(r"(?:^|_)(?:BLOCK|TILE)|_(?:ROWS|THREADS)$"
                           r"|^(?:ROWS|THREADS)$")


def _tile_size_applies(path: str) -> bool:
    norm = path.replace("\\", "/")
    return not any(norm.endswith(allow) for allow in _TILE_SIZE_ALLOW)


_BROAD_EXC = {"Exception", "BaseException"}


def _is_broad_handler(type_node) -> bool:
    """Bare ``except:``, ``except Exception``, ``except BaseException``
    — including inside a tuple of classes."""
    if type_node is None:
        return True
    if isinstance(type_node, ast.Tuple):
        return any(_is_broad_handler(e) for e in type_node.elts)
    chain = _attr_chain(type_node)
    return bool(chain) and chain[-1] in _BROAD_EXC


def _body_only_swallows(body) -> bool:
    """True when the handler body does nothing but pass/continue/... —
    no logging, no counter, no re-raise, no fallback value."""
    if not body:
        return True
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(
                stmt.value, ast.Constant) and stmt.value.value is ...:
            continue
        return False
    return True


_CLOCK_CALLS = {("time", "perf_counter"), ("time", "time"),
                ("time", "monotonic"), ("time", "perf_counter_ns"),
                ("timeit", "default_timer")}

_HOST_PULL_NAMES = {"float", "int"}
_HOST_PULL_NP = {"asarray", "array", "copyto"}
_HOST_PULL_METHODS = {"item", "tolist", "cpu", "numpy"}


def _attr_chain(node):
    """Dotted name parts of an Attribute/Name chain, outermost first."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return None


_STATIC_ATTRS = {"shape", "ndim", "size", "dtype", "itemsize"}
_STATIC_FNS = {"len", "min", "max", "abs", "int", "float", "round"}
# tensor methods that return host ints (or tuples of them) even under
# torch.compile: shape metadata, not a device value
_STATIC_METHODS = {"size", "dim", "ndimension", "numel", "element_size",
                   "stride"}


def _is_static_expr(node):
    """True when the WHOLE expression derives from static shape metadata
    (``x.shape[0] * 2``, ``x.size(0)``, ``len(xs)``): int()/float() on
    these is not a host pull. One static leaf is not enough —
    ``x.mean() / x.shape[0]`` still pulls the mean."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Attribute):
        return node.attr in _STATIC_ATTRS
    if isinstance(node, ast.Subscript):
        return _is_static_expr(node.value)
    if isinstance(node, ast.BinOp):
        return _is_static_expr(node.left) and _is_static_expr(node.right)
    if isinstance(node, ast.UnaryOp):
        return _is_static_expr(node.operand)
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(_is_static_expr(e) for e in node.elts)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        return node.func.attr in _STATIC_METHODS
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        if node.func.id == "len":
            return True  # len() is a host int
        return (node.func.id in _STATIC_FNS
                and all(_is_static_expr(a) for a in node.args))
    return False


def _int_literal(node) -> bool:
    return (isinstance(node, ast.Constant) and isinstance(node.value, int)
            and not isinstance(node.value, bool))


class _Visitor(ast.NodeVisitor):
    def __init__(self, relpath, checks, library_factories=()):
        self.relpath = relpath
        self.checks = checks
        self.findings = []
        # stack of (symbol, in_compiled); module scope counts as one frame
        self.stack = [("<module>", False)]
        # per-function-frame call records for sync-timing
        self.frames = [{"clock": [], "block": []}]
        # per-function-frame lexical loop depth (a handler inside a def
        # nested in a loop is NOT per-iteration code — depth resets)
        self.loop_depth = [0]
        # per-function-frame depth of `with torch.cuda.graph(...)` bodies
        self.graph_depth = [0]
        # local name -> imported dotted module, so `from torch import
        # float8_e4m3fn` resolves to torch's dtype
        self.imports = {}
        # relative imports, kept apart (`from . import _build`): they
        # locate the kernel build module, and no other check reads them
        self.rel_imports = {}
        # hardcoded-tile-size state: module-level geometry-named int
        # constants only become findings when the file also loads a
        # kernel library (lint_source pairs the two after the walk)
        self.library_seen = False
        self.tile_consts = []  # (lineno, name, value)
        # module functions that return a loaded kernel library, and the
        # names bound to one: `lib.<entry>(...)` is a kernel launch
        self.library_factories = set(library_factories)
        self.library_names = set()
        # unclosed-span: Call nodes sanctioned as context-manager uses
        # (a with item's context expression, an enter_context argument)
        self._cm_calls: set = set()
        # host-isnan-in-step-loop: Call nodes already reported through
        # an enclosing pull — one finding per pull site
        self._isnan_handled: set = set()

    def visit_Import(self, node):
        for alias in node.names:
            if alias.asname:
                self.imports[alias.asname] = alias.name
            else:
                # `import numpy.random` binds the ROOT name `numpy`
                root = alias.name.split(".")[0]
                self.imports[root] = root
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        if node.module and node.level == 0:
            for alias in node.names:
                self.imports[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"
        elif node.level > 0:
            prefix = f"{node.module}." if node.module else ""
            for alias in node.names:
                self.rel_imports[alias.asname or alias.name] = \
                    f"{prefix}{alias.name}"
        self.generic_visit(node)

    def _resolve(self, chain):
        """Expand the chain's root through the module's imports:
        ['tc','synchronize'] under `import torch.cuda as tc` resolves to
        ['torch','cuda','synchronize']."""
        root = self.imports.get(chain[0])
        if root is None:
            return chain
        return root.split(".") + chain[1:]

    def _origin(self, name: str) -> str:
        """The dotted origin of an imported name (absolute or relative
        import), or the name itself."""
        return self.imports.get(name) or self.rel_imports.get(name) or name

    def _is_library_call(self, node) -> bool:
        """Does ``node`` load a kernel library: ``_build.library(...)``
        (however ``_build`` or ``library`` was imported), or a call of a
        module function that returns one?"""
        if not isinstance(node, ast.Call):
            return False
        chain = _attr_chain(node.func)
        if not chain:
            return False
        if chain[-1] == "library":
            full = self._origin(chain[0]).split(".") + chain[1:]
            return len(full) >= 2 and full[-2] == "_build"
        return len(chain) == 1 and chain[0] in self.library_factories

    def _sym(self):
        return self.stack[-1][0]

    def _in_jit(self):
        return self.stack[-1][1] or self.graph_depth[-1] > 0

    def _emit(self, check, severity, line, message):
        if check in self.checks:
            self.findings.append(Finding(
                check, severity, self.relpath, line, self._sym(), message))

    # ------------------------------------------------- compiled regions

    def _is_compile(self, node) -> bool:
        chain = _attr_chain(node)
        if not chain:
            return False
        res = self._resolve(chain)
        return res[0] == "torch" and res[-1] == "compile"

    def _is_compile_decorator(self, dec) -> bool:
        """torch.compile / torch.compile(...) /
        functools.partial(torch.compile, ...)."""
        if self._is_compile(dec):
            return True
        if isinstance(dec, ast.Call):
            if self._is_compile(dec.func):
                return True
            chain = _attr_chain(dec.func)
            if chain and chain[-1] == "partial" and dec.args:
                return self._is_compile(dec.args[0])
        return False

    def _is_graph_capture(self, expr) -> bool:
        """``torch.cuda.graph(...)`` as a with item (aliases resolved)."""
        if not isinstance(expr, ast.Call):
            return False
        chain = _attr_chain(expr.func)
        if not chain:
            return False
        res = self._resolve(chain)
        return res in (["torch", "cuda", "graph"],
                       ["torch", "cuda", "graphs", "graph"])

    # ------------------------------------------------- function frames

    def _enter_function(self, node):
        jit = self._in_jit() or any(
            self._is_compile_decorator(d)
            for d in getattr(node, "decorator_list", ()))
        name = getattr(node, "name", "<lambda>")
        if "mutable-default" in self.checks and hasattr(node, "args"):
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]
            for d in defaults:
                if isinstance(d, (ast.List, ast.Dict, ast.Set)) or (
                        isinstance(d, ast.Call)
                        and isinstance(d.func, ast.Name)
                        and d.func.id in ("list", "dict", "set")):
                    self.findings.append(Finding(
                        "mutable-default", "warning", self.relpath,
                        d.lineno, name,
                        f"mutable default argument in '{name}': shared "
                        f"across calls; default to None and build "
                        f"inside"))
        self.stack.append((name, jit))
        self.frames.append({"clock": [], "block": []})
        self.loop_depth.append(0)
        self.graph_depth.append(0)

    def _exit_function(self):
        frame = self.frames.pop()
        if frame["clock"] and frame["block"]:
            for line in frame["block"]:
                self._emit(
                    "sync-timing", "error", line,
                    "device synchronize in a function that also reads a "
                    "wall clock: the clock pair times the host's launch "
                    "overhead and the sync, not the device (a "
                    "synchronised decode RMSNorm reads 16x its device "
                    "time this way) — time device work with "
                    "apex_tpu_torch.runtime.timing (CUDA events: time_fn "
                    "/ time_chained)")
        elif len(self.frames) > 1:
            # an unpaired NESTED def usually runs inside its enclosing
            # function's timed region — propagate its records up so a
            # clock in the parent still pairs with a sync in a closure.
            # Top-level functions do NOT propagate into the module frame:
            # pairing a clock in one sibling with a sync in another
            # would flag unrelated correctness-sync helpers.
            self.frames[-1]["block"] += frame["block"]
            self.frames[-1]["clock"] += frame["clock"]
        self.stack.pop()
        self.loop_depth.pop()
        self.graph_depth.pop()

    def visit_FunctionDef(self, node):
        self._enter_function(node)
        self.generic_visit(node)
        self._exit_function()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._enter_function(node)
        self.generic_visit(node)
        self._exit_function()

    # ------------------------------------------------- loops / handlers

    def visit_For(self, node):
        if "nondeterministic-collective-order" in self.checks:
            self._check_nondet_order(node)
        self.loop_depth[-1] += 1
        self.generic_visit(node)
        self.loop_depth[-1] -= 1

    visit_AsyncFor = visit_For

    # --------------------------- nondeterministic collective order

    def _nondet_iterable(self, node):
        """A human-readable description when ``node`` (a for-loop's
        iter expression) has no deterministic order: a set
        literal/comprehension, a set()/frozenset()/set-method call, or
        os.listdir. ``sorted(...)`` around any of these never matches
        — that IS the fix."""
        if isinstance(node, (ast.Set, ast.SetComp)):
            return "a set literal"
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Name) and \
                    node.func.id in _SET_CALL_NAMES:
                return f"{node.func.id}(...)"
            chain = _attr_chain(node.func)
            if chain:
                if chain[-1] == "listdir":
                    return "os.listdir(...)"
                if chain[-1] in _SET_METHOD_NAMES and len(chain) >= 2:
                    return f".{chain[-1]}(...) (a set)"
        return None

    def _body_issues_comms(self, node) -> bool:
        """Does the loop body contain a collective/plan_buckets call or
        a bucket-named identifier?"""
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call):
                    chain = _attr_chain(sub.func)
                    if chain and chain[-1] in _ORDER_COLLECTIVE_NAMES:
                        return True
                if isinstance(sub, ast.Name) and \
                        "bucket" in sub.id.lower():
                    return True
                if isinstance(sub, ast.Attribute) and \
                        "bucket" in sub.attr.lower():
                    return True
        return False

    def _check_nondet_order(self, node):
        how = self._nondet_iterable(node.iter)
        if how is None or not self._body_issues_comms(node):
            return
        self._emit(
            "nondeterministic-collective-order", "error",
            node.iter.lineno,
            f"loop over {how} — an unordered iterable — decides bucket "
            f"construction or collective issue order: set iteration "
            f"order differs across processes (string hash "
            f"randomization) and os.listdir follows filesystem order, "
            f"so two ranks build different bucket lists / issue "
            f"collectives in different orders and the group deadlocks "
            f"or pairs the wrong buffers — iterate sorted(...) so "
            f"every rank sees the same order")

    def visit_While(self, node):
        # the While TEST re-evaluates every iteration: an isnan there
        # is a per-step host pull even when the loop itself is
        # top-level
        self._check_isnan_condition(node.test)
        self.loop_depth[-1] += 1
        self.generic_visit(node)
        self.loop_depth[-1] -= 1

    def visit_If(self, node):
        if self.loop_depth[-1] > 0:
            self._check_isnan_condition(node.test)
        self.generic_visit(node)

    # ---------------------------------------------- host isnan pulls

    def _isnan_call_in(self, node):
        """First torch isnan/isinf Call in the subtree: ``torch.isnan``
        (resolved through the module's imports) or the tensor method
        ``x.isnan()``. ``math.isnan``/``np.isnan`` on host values never
        match."""
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            func = sub.func
            chain = _attr_chain(func)
            if chain:
                if chain[-1] not in _ISNAN_NAMES:
                    continue
                res = self._resolve(chain)
                if res[0] == "torch":
                    return sub
                # a method on a local value, never on an imported module
                if len(chain) >= 2 and chain[0] not in self.imports and \
                        chain[0] not in self.rel_imports:
                    return sub
            elif isinstance(func, ast.Attribute) and \
                    func.attr in _ISNAN_NAMES:
                return sub  # x.float().isnan(): a tensor method
        return None

    def _emit_isnan_pull(self, container, line, via):
        for sub in ast.walk(container):
            if isinstance(sub, ast.Call):
                self._isnan_handled.add(id(sub))
        self._emit(
            "host-isnan-in-step-loop", "error", line,
            f"torch isnan/isinf result pulled to host ({via}) inside a "
            f"step loop: one device round-trip per tensor per "
            f"iteration, serializing the launch queue — use "
            f"apex_tpu_torch.observability.numerics (tensor_stats / "
            f"StatsCollector: one fused on-device reduction for the "
            f"whole tree, host pull decimated to every N steps)")

    def _check_isnan_condition(self, test):
        if "host-isnan-in-step-loop" not in self.checks:
            return
        if self._isnan_call_in(test) is not None:
            self._emit_isnan_pull(test, test.lineno,
                                  "used as a branch condition")

    def visit_With(self, node):
        graph = False
        for item in node.items:
            if isinstance(item.context_expr, ast.Call):
                self._cm_calls.add(id(item.context_expr))
            graph = graph or self._is_graph_capture(item.context_expr)
        if not graph:
            self.generic_visit(node)
            return
        for item in node.items:
            self.visit(item)
        self.graph_depth[-1] += 1
        for stmt in node.body:
            self.visit(stmt)
        self.graph_depth[-1] -= 1

    visit_AsyncWith = visit_With

    def visit_Try(self, node):
        if self.loop_depth[-1] > 0:
            for handler in node.handlers:
                if _is_broad_handler(handler.type) and \
                        _body_only_swallows(handler.body):
                    caught = "except:" if handler.type is None else \
                        f"except {ast.unparse(handler.type)}:"
                    self._emit(
                        "swallowed-exception-in-step-loop", "error",
                        handler.lineno,
                        f"'{caught} pass/continue' inside a loop body "
                        f"silently swallows per-step failures (NaN "
                        f"storms, torn checkpoint writes, dying "
                        f"collectives) — retry transient classes via "
                        f"apex_tpu_torch.resilience.retry.Policy, or "
                        f"count/log the failure before continuing")
        self.generic_visit(node)

    visit_TryStar = visit_Try

    # ------------------------------------------------------ call sites

    def visit_Assign(self, node):
        if len(self.stack) == 1 and "hardcoded-tile-size" in self.checks:
            for target in node.targets:
                if isinstance(target, ast.Name) and \
                        _TILE_NAME_RE.search(target.id.upper()) and \
                        _int_literal(node.value) and \
                        node.value.value >= _TILE_LITERAL_MIN:
                    self.tile_consts.append(
                        (node.lineno, target.id, node.value.value))
        if self._is_library_call(node.value):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    self.library_names.add(target.id)
        self.generic_visit(node)

    def _is_kernel_entry(self, func) -> bool:
        """``lib.<entry>`` where ``lib`` holds a loaded kernel library,
        or ``_build.library(...).<entry>`` / ``factory().<entry>``."""
        if not isinstance(func, ast.Attribute):
            return False
        recv = func.value
        if isinstance(recv, ast.Name):
            return recv.id in self.library_names
        return self._is_library_call(recv)

    def _check_launch_geometry(self, node):
        """Flag tile-sized int literals among a kernel entry's
        arguments."""
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if _int_literal(arg) and arg.value >= _TILE_LITERAL_MIN:
                self._emit(
                    "hardcoded-tile-size", "error", arg.lineno,
                    f"launch geometry {arg.value} hardcoded at a kernel "
                    f"launch: the right plan (threads, blocks, rows a "
                    f"block) is a per-card, per-shape search result — "
                    f"take it from apex_tpu_torch.tuning (search space + "
                    f"cache) or ops/kernel_config, the only modules "
                    f"launch numbers may live in")

    # --------------------------------------- rank-unsafe artifact paths

    def _open_write_mode(self, node) -> bool:
        """Is this ``open(...)`` call a write? (positional or ``mode=``
        kwarg; a missing mode is the default read)."""
        mode = node.args[1] if len(node.args) >= 2 else next(
            (kw.value for kw in node.keywords if kw.arg == "mode"),
            None)
        return (isinstance(mode, ast.Constant)
                and isinstance(mode.value, str)
                and mode.value in _WRITE_MODES)

    def _check_rank_unsafe_open(self, node):
        if not node.args:
            return
        if not self._open_write_mode(node):
            return
        path_expr = node.args[0]
        fixed_artifact = None
        has_rank_component = False
        for sub in ast.walk(path_expr):
            if isinstance(sub, ast.Constant) and \
                    isinstance(sub.value, str):
                text = sub.value
                if text.lower().endswith(_ARTIFACT_EXTS):
                    fixed_artifact = text
                if _RANK_COMPONENT_RE.search(text):
                    has_rank_component = True
            elif isinstance(sub, ast.Name):
                if _RANK_COMPONENT_RE.search(sub.id):
                    has_rank_component = True
            elif isinstance(sub, ast.Attribute):
                if _RANK_COMPONENT_RE.search(sub.attr):
                    has_rank_component = True
        if fixed_artifact is None or has_rank_component:
            return
        self._emit(
            "rank-unsafe-artifact-path", "error", node.lineno,
            f"write-mode open() of a fixed artifact path "
            f"({fixed_artifact!r}) in code multiproc workers execute: "
            f"two ranks handed this path clobber or interleave each "
            f"other's telemetry — route it through "
            f"apex_tpu_torch.observability.fleet.rank_path (automatic "
            f".rank{{i}} suffix) or build the name from the "
            f"rank/pid")

    def _fp8_name(self, arg):
        chain = _attr_chain(arg)
        if chain:
            return self._resolve(chain)[-1]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value.rsplit(".", 1)[-1]
        return None

    def _check_raw_fp8_cast(self, node):
        """``x.to(<fp8 dtype>)`` / ``x.type(<fp8 dtype>)`` outside the
        sanctioned owners — any positional argument (``.to(device,
        dtype)``) or ``dtype=``: a raw cast has neither the delayed scale
        nor the saturation clamp — quantization must go through
        ops.precision."""
        args = list(node.args) + [kw.value for kw in node.keywords
                                  if kw.arg == "dtype"]
        name = next((n for n in map(self._fp8_name, args)
                     if n is not None and _FP8_DTYPE_NAME_RE.match(n)),
                    None)
        if name is None:
            return
        self._emit(
            "raw-fp8-cast", "error", node.lineno,
            f"raw fp8 cast '.{node.func.attr}({name})': an unscaled, "
            f"unsaturated cast overflows past the format edge (E4M3 has "
            f"no inf) and flushes small tails to zero — quantize through "
            f"apex_tpu_torch.ops.precision (quantize_fp8 / matmul_fp8) "
            f"under amp's Fp8DelayedScaler's delayed scales; only "
            f"ops/precision.py, ops/fp8_cast_kernel.py and amp/ may cast "
            f"to fp8")

    def _check_memory_introspection(self, node, chain, res):
        if not chain:
            return
        if res[0] == "torch" and res[-1] in _MEMORY_INTROSPECT_TORCH_NAMES:
            what = "the allocator's counters"
        elif res == ["gc", "get_objects"]:
            what = "the live-object walk"
        else:
            return
        self._emit(
            "raw-memory-introspection", "error", node.lineno,
            f"direct '{'.'.join(chain)}(...)' read ({what}): in a step "
            f"loop it serializes the pipeline, and its numbers bypass "
            f"the watermark + top-k accounting the OOM forensics depend "
            f"on — route through apex_tpu_torch.observability.memory "
            f"(MemoryMonitor's decimated snapshots, device_memory_stats) "
            f"or _device.memory for the budget; only those modules may "
            f"read it directly")

    def _is_sync(self, node, chain, res) -> bool:
        """A device synchronize: ``torch.cuda.synchronize()``, any
        ``.synchronize()`` method (an Event, a Stream) or
        ``runtime.timing.sync``."""
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr == "synchronize":
            return True
        if not res:
            return False
        if res[-1] == "synchronize" and res[0] == "torch":
            return True
        return res[-2:] == ["timing", "sync"]

    def visit_Call(self, node):
        chain = _attr_chain(node.func)
        tail = chain[-1] if chain else None
        # resolve through the import map so `from time import time` and
        # `import torch.cuda as tc` still resolve
        res = self._resolve(chain) if chain else None

        if "raw-memory-introspection" in self.checks:
            self._check_memory_introspection(node, chain, res)

        if "rank-unsafe-artifact-path" in self.checks and \
                isinstance(node.func, ast.Name) and \
                node.func.id == "open":
            self._check_rank_unsafe_open(node)

        if "host-isnan-in-step-loop" in self.checks and \
                self.loop_depth[-1] > 0 and \
                id(node) not in self._isnan_handled:
            if isinstance(node.func, ast.Name) and \
                    node.func.id in ("bool", "float") and node.args and \
                    self._isnan_call_in(node.args[0]) is not None:
                self._emit_isnan_pull(node, node.lineno,
                                      f"via {node.func.id}()")
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in ("item", "tolist") and \
                    self._isnan_call_in(node.func.value) is not None:
                self._emit_isnan_pull(node, node.lineno,
                                      f"via .{node.func.attr}()")

        if self._is_library_call(node):
            self.library_seen = True
        if "hardcoded-tile-size" in self.checks and \
                self._is_kernel_entry(node.func):
            self._check_launch_geometry(node)

        if "raw-fp8-cast" in self.checks and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _FP8_CAST_METHODS:
            self._check_raw_fp8_cast(node)

        if tail == "enter_context":
            # stack.enter_context(span(...)) closes at stack exit —
            # sanction the argument before visiting it
            for arg in node.args:
                if isinstance(arg, ast.Call):
                    self._cm_calls.add(id(arg))
        if tail in _SPAN_NAMES and "unclosed-span" in self.checks and \
                id(node) not in self._cm_calls:
            if "observability" in res:
                self._emit(
                    "unclosed-span", "error", node.lineno,
                    f"'{'.'.join(chain)}(...)' opened outside a 'with' "
                    f"(or ExitStack.enter_context): a span without its "
                    f"guaranteed close leaks an open-span stack entry "
                    f"the flight recorder reports forever and corrupts "
                    f"later spans' nesting — use 'with "
                    f"{'.'.join(chain)}(...):' around the region")

        if self._is_sync(node, chain, res):
            self.frames[-1]["block"].append(node.lineno)
        is_clock = (res and len(res) >= 2
                    and (res[-2], res[-1]) in _CLOCK_CALLS) or (
            tail in ("perf_counter", "perf_counter_ns", "monotonic",
                     "default_timer"))
        if is_clock:
            self.frames[-1]["clock"].append(node.lineno)
            self._emit(
                "raw-clock", "error", node.lineno,
                f"direct wall-clock read ('{'.'.join(chain or [tail])}') "
                f"in apex_tpu_torch library code: time through "
                f"apex_tpu_torch.runtime.timing (CUDA events) or an "
                f"apex_tpu_torch.observability Timer instead — a bare "
                f"clock pair measures dispatch, not device time")

        if self._in_jit():
            self._check_compiled_region(node, chain, res)
        self.generic_visit(node)

    def _check_compiled_region(self, node, chain, res):
        where = ("inside a torch.compile body or a CUDA graph capture")
        if isinstance(node.func, ast.Name) and \
                node.func.id in _HOST_PULL_NAMES and node.args and \
                not isinstance(node.args[0], ast.Constant) and \
                not _is_static_expr(node.args[0]):
            self._emit(
                "host-in-jit", "error", node.lineno,
                f"'{node.func.id}(...)' {where} forces a host pull: it "
                f"breaks the compiled graph or fails the capture — keep "
                f"the value on the device or hoist it out")
        if res and len(res) >= 2 and \
                res[0] in ("np", "numpy", "onp") and \
                res[-1] in _HOST_PULL_NP:
            self._emit(
                "host-in-jit", "error", node.lineno,
                f"'{'.'.join(chain)}(...)' {where}: numpy materializes "
                f"on host — use torch ops on the device, or hoist the "
                f"constant out")
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _HOST_PULL_METHODS:
            self._emit(
                "host-in-jit", "error", node.lineno,
                f"'.{node.func.attr}()' {where} is a device sync (a "
                f"graph break, or an error during capture)")
        if res and (
                res[0] == "random"
                or (len(res) >= 2 and res[0] in ("np", "numpy")
                    and res[1] == "random")):
            self._emit(
                "rng-in-jit", "error", node.lineno,
                f"'{'.'.join(chain)}(...)' {where}: the sample is drawn "
                f"once, at compile or capture time, and every replay "
                f"reuses it — draw on the device from a torch.Generator "
                f"passed in")


def _library_factories(tree) -> set:
    """Module-level functions whose body loads a kernel library
    (``def _lib(): return _build.library("x")``): calling one yields a
    library whose attributes are kernel entries."""
    probe = _Visitor("", set())
    for stmt in tree.body:
        if isinstance(stmt, (ast.Import, ast.ImportFrom)):
            probe.visit(stmt)
    out = set()
    for stmt in tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                any(probe._is_library_call(sub) for sub in ast.walk(stmt)):
            out.add(stmt.name)
    return out


def lint_source(source: str, relpath: str, checks=None, abspath=None,
                suppressed=None):
    """Lint one file's source text; returns a list of Findings.

    ``abspath``: the file's absolute path when known (lint_paths passes
    it) — path-scoped checks like raw-clock must not depend on what cwd
    the relpath happened to be computed against. ``suppressed``: an
    optional list that receives the findings an inline
    ``# apex-lint: disable`` comment silenced."""
    checks = set(checks or AST_CHECKS)
    unknown = checks - set(AST_CHECKS)
    if unknown:
        raise ValueError(f"unknown AST check(s) {sorted(unknown)}; "
                         f"valid: {list(AST_CHECKS)}")
    scope = abspath or relpath
    if relpath.replace("\\", "/").endswith(_SYNC_ALLOW):
        checks = checks - {"sync-timing"}
    for check, applies in (
            ("raw-clock", _raw_clock_applies),
            ("swallowed-exception-in-step-loop", _in_package),
            ("unclosed-span", _in_package),
            ("host-isnan-in-step-loop", _host_isnan_applies),
            ("rank-unsafe-artifact-path", _rank_unsafe_applies),
            ("hardcoded-tile-size", _tile_size_applies),
            ("raw-fp8-cast", _raw_fp8_applies),
            ("nondeterministic-collective-order", _nondet_order_applies),
            ("raw-memory-introspection", _memory_introspect_applies)):
        if not applies(scope):
            checks = checks - {check}
    try:
        tree = ast.parse(source, filename=relpath)
    except SyntaxError as e:
        return [Finding("syntax", "error", relpath, e.lineno or 0,
                        "<module>", f"does not parse: {e.msg}")]
    visitor = _Visitor(relpath, checks,
                       library_factories=_library_factories(tree))
    visitor.visit(tree)
    # geometry-named module constants are only launch geometry when the
    # file actually loads a kernel library (a _ROWS in a data loader is
    # not a launch plan)
    if "hardcoded-tile-size" in checks and visitor.library_seen:
        for lineno, name, value in visitor.tile_consts:
            visitor.findings.append(Finding(
                "hardcoded-tile-size", "error", relpath, lineno,
                "<module>",
                f"module launch constant {name} = {value} in a file that "
                f"loads a kernel library: launch plans must come from "
                f"apex_tpu_torch.tuning (per-card search + cache) or "
                f"ops/kernel_config — a hardcoded plan outlives the card "
                f"it was guessed for (a mirror of a compiled instance of "
                f"ops/csrc stays, suppressed with the CUDA constant it "
                f"copies named)"))
    # close the module-level frame (module-scope timing code, e.g. a
    # script body, gets the same sync-timing treatment)
    frame = visitor.frames[0]
    if "sync-timing" in checks and frame["clock"] and frame["block"]:
        for line in frame["block"]:
            visitor.findings.append(Finding(
                "sync-timing", "error", relpath, line, "<module>",
                "device synchronize in module-level timing code — time "
                "device work with apex_tpu_torch.runtime.timing (CUDA "
                "events)"))
    lines = source.splitlines()
    kept = []
    for f in visitor.findings:
        if is_suppressed(f, lines):
            if suppressed is not None:
                suppressed.append(f)
        else:
            kept.append(f)
    return kept


def iter_python_files(paths):
    """Expand files/dirs into .py files, skipping caches and build dirs."""
    skip_dirs = {"__pycache__", ".git", "build", ".eggs", "node_modules"}
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d not in skip_dirs
                                 and not d.endswith(".egg-info"))
                for fname in sorted(files):
                    if fname.endswith(".py"):
                        yield os.path.join(root, fname)


def lint_paths(paths, root=None, checks=None, suppressed=None):
    """Lint every .py under ``paths``; paths in findings are relative to
    ``root`` (default: cwd)."""
    root = os.path.abspath(root or os.getcwd())
    findings = []
    for fpath in iter_python_files(paths):
        ap = os.path.abspath(fpath)
        rel = os.path.relpath(ap, root) if ap.startswith(root) else fpath
        with open(ap, encoding="utf-8") as f:
            source = f.read()
        findings.extend(lint_source(source, rel, checks, abspath=ap,
                                    suppressed=suppressed))
    return findings
