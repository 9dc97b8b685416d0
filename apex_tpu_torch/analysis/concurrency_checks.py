"""Host-concurrency engine: race/signal/callback safety for the
threaded host runtime.

The host side of the port (``SpanTracer``, ``FlightRecorder`` with its
signal handler, ``MetricRegistry``, ``AsyncCheckpointWriter``,
``PreemptionWatcher``, the compile listener, ``PrefetchLoader``, the
fleet collector, the kernel build lock) is plain threaded Python where an
unlocked shared mutation or a lock taken inside a signal handler only
ever surfaces as an unexplained hang. This engine is the AST-level check
of it: one pass builds a class-scoped model — lock attributes
(``self._lock = threading.Lock()``, Lock vs RLock distinguished),
module-level locks, lock-held regions (``with lock:`` bodies plus linear
``acquire``/``release`` pairing), thread/signal entry points
(``threading.Thread(target=self.m)``, ``signal.signal(sig, self.m)``),
per-method shared-attribute writes tagged with the lockset held at the
write, intra-class call edges, and blocking-call sites — and five checks
evaluate it:

``unlocked-shared-mutation``
    Inconsistent lockset (Eraser-lite): an attribute written under a
    lock in one method and written lock-free in a different method of
    a concurrent class (one with thread/signal entries, thread
    creation, or a lock attribute) — plus the read-modify-write case:
    ``self.x += 1`` outside any lock is a lost update even under the
    GIL. ``__init__`` writes are publication, never flagged.

``lock-in-signal-handler``
    A signal handler's intra-class call closure reaches a
    non-reentrant ``threading.Lock`` acquisition. The handler runs ON
    TOP of whatever frame the interrupted thread holds — if that frame
    holds the lock, the process deadlocks. RLock passes (reentrant);
    the sanctioned pattern is an Event/plain-attribute flag serviced
    by a polling thread (see FlightRecorder._on_signal).

``blocking-call-under-lock``
    File I/O (``open``, ``os.replace``/``makedirs``/…,
    ``shutil.rmtree``, ``json.dump``/``load``), ``subprocess``,
    ``time.sleep`` or a device synchronize (``torch.cuda.synchronize``,
    an Event's or Stream's ``.synchronize()``, ``runtime.timing.sync``)
    while a lock is held — directly or through an intra-class call —
    turns every other thread's fast-path acquire into an I/O (or
    device) wait. Snapshot under the lock, do the slow work outside.

``callback-reentry``
    Stored callbacks (``for cb in self._observers: cb(...)``, or a
    copied alias of such a collection, or ``self._observers[i](...)``)
    invoked while holding the registry's own lock: a callback that
    calls back into ``add_observer``/``remove_observer`` deadlocks.
    The clean shape copies the list under the lock and invokes
    outside it (RecompileListener._notify).

``fork-unsafe-state``
    Threads started at import time (``parallel.multiproc`` children
    re-import every module — each import would silently start the
    thread again), or ``os.fork()``/default-context
    ``multiprocessing.Process`` in a module that also creates threads
    or locks (the child inherits locks in whatever state the fork
    caught them, and none of the threads that would release them).
    Module-level *locks* alone are fine under the re-exec/spawn model
    multiproc.launch uses — they are reinitialized fresh per child.

Scope: ``apex_tpu_torch/``, its examples included (where the threaded
host surface lives); driver plumbing (``chip_smoke.py``, the A/B
scripts) is exempt. Known limitations, on purpose: the model is
class-scoped (module-global mutation under a module lock is tracked for
lock *regions* but not for check 1), thread targets that are local
closures or other objects' bound methods are invisible, and a method
calling a module-level function does not propagate lock context into
it. Suppression uses the shared ``# apex-lint: disable=<id>`` comment
syntax.
"""

from __future__ import annotations

import ast
import collections
import os
import re

from apex_tpu_torch.analysis.ast_checks import (
    _attr_chain as _attr_chain_list,
    _in_package,
    iter_python_files,
)
from apex_tpu_torch.analysis.findings import Finding, is_suppressed

__all__ = ["CONCURRENCY_CHECKS", "lint_source", "lint_paths"]

CONCURRENCY_CHECKS = (
    "unlocked-shared-mutation",
    "lock-in-signal-handler",
    "blocking-call-under-lock",
    "callback-reentry",
    "fork-unsafe-state",
)

# lock constructors -> reentrancy kind. "lockish" primitives define a
# held region (blocking/reentry checks) but are not policed by the
# signal-handler check (Condition wraps a lock whose reentrancy we
# cannot see; Semaphores are not mutexes).
_LOCK_FACTORIES = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "multiprocessing.Lock": "lock",
    "multiprocessing.RLock": "rlock",
    "threading.Condition": "lockish",
    "threading.Semaphore": "lockish",
    "threading.BoundedSemaphore": "lockish",
}

# attribute names that read as locks even when the constructor is out
# of sight (inherited from a base in another module, injected): the
# held-region checks honor them; reentrancy stays unknown.
_LOCKISH_NAME = re.compile(r"(^|_)(lock|mutex)$")

# calls that block the holder: anything here (or a device synchronize,
# matched in _FnWalker._call) under a held lock turns every contending
# thread's acquire into an I/O wait
_BLOCKING_CALLS = {
    "time.sleep", "subprocess.run", "subprocess.Popen",
    "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "os.makedirs", "os.replace",
    "os.rename", "os.remove", "os.unlink", "shutil.rmtree",
    "shutil.copytree", "shutil.copy", "shutil.copyfile", "shutil.move",
    "json.dump", "json.load", "socket.create_connection",
}

# a call of one of these methods on self.X mutates X (container write)
_MUTATING_METHODS = frozenset({
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "popitem", "remove", "discard", "add", "clear", "update",
    "setdefault", "sort", "reverse",
})

_INIT_METHODS = frozenset({"__init__", "__new__", "__post_init__"})


def _chain(node):
    """ast_checks._attr_chain as a hashable tuple (or None)."""
    parts = _attr_chain_list(node)
    return tuple(parts) if parts else None


def _concurrency_applies(path: str) -> bool:
    """The package, its examples included — where the threaded host
    surface lives."""
    return _in_package(path)


# ------------------------------------------------------------- model


class _MethodInfo:
    __slots__ = ("name", "lineno", "writes", "calls", "blocking",
                 "acquires", "cb_calls")

    def __init__(self, name, lineno):
        self.name = name
        self.lineno = lineno
        # (attr, lineno, frozenset[lockkey], style in assign|aug|mut)
        self.writes = []
        self.calls = []      # (callee, lineno, frozenset[lockkey])
        self.blocking = []   # (desc, lineno, frozenset[lockkey])
        self.acquires = []   # (lockkey, kind, lineno, via_with)
        self.cb_calls = []   # (lineno, frozenset[lockkey], src_attr)


class _ClassInfo:
    __slots__ = ("name", "lineno", "bases", "methods", "lock_attrs",
                 "thread_entries", "signal_entries", "creates_thread")

    def __init__(self, name, lineno, bases):
        self.name = name
        self.lineno = lineno
        self.bases = bases
        self.methods = {}     # name -> _MethodInfo
        self.lock_attrs = {}  # attr -> kind
        self.thread_entries = set()
        self.signal_entries = set()
        self.creates_thread = False

    def all_methods(self, classes, _seen=None):
        """Methods including same-module base classes (child wins)."""
        _seen = _seen or set()
        if self.name in _seen:
            return {}
        _seen.add(self.name)
        out = {}
        for base in self.bases:
            parent = classes.get(base)
            if parent is not None:
                out.update(parent.all_methods(classes, _seen))
        out.update(self.methods)
        return out


class _ModuleModel:
    def __init__(self):
        self.imports = {}          # alias -> dotted module/name
        self.classes = {}          # name -> _ClassInfo
        self.functions = {}        # name -> _MethodInfo (module level)
        self.module_locks = {}     # name -> kind
        self.global_instances = {} # name -> class name
        self.fn_thread_entries = set()
        self.fn_signal_entries = set()
        self.import_thread_sites = []  # (lineno, desc)
        self.fork_sites = []           # (lineno, symbol)

    def resolve(self, chain):
        if not chain:
            return None
        head = self.imports.get(chain[0], chain[0])
        return ".".join((head,) + tuple(chain[1:]))

    def uses_threads(self) -> bool:
        return bool(
            self.module_locks
            or any(c.lock_attrs or c.creates_thread or c.thread_entries
                   for c in self.classes.values())
            or self.import_thread_sites)


def _lock_kind_of_call(model, node):
    """threading.Lock() -> 'lock' etc, else None."""
    if not isinstance(node, ast.Call):
        return None
    chain = _chain(node.func)
    return _LOCK_FACTORIES.get(model.resolve(chain)) if chain else None


class _FnWalker:
    """Walk one callable, recording writes/calls/blocking with the
    lockset held at each site."""

    def __init__(self, model, method, cls=None, selfname=None,
                 at_module_scope=False):
        self.model = model
        self.m = method
        self.cls = cls
        self.selfname = selfname
        self.at_module_scope = at_module_scope
        self.cb_aliases = {}  # local var -> self attr it copies
        self.cb_vars = {}     # loop var -> source self attr

    # ------------------------------------------------ lock resolution

    def _lock_key(self, expr):
        """(key, kind) when ``expr`` names a known lock, else None."""
        chain = _chain(expr)
        if not chain:
            return None
        if (self.selfname and len(chain) == 2
                and chain[0] == self.selfname):
            attr = chain[1]
            if self.cls is not None and attr in self.cls.lock_attrs:
                return ("self", attr), self.cls.lock_attrs[attr]
            if _LOCKISH_NAME.search(attr):
                return ("self", attr), "unknown"
            return None
        if len(chain) == 1 and chain[0] in self.model.module_locks:
            return ("mod", chain[0]), self.model.module_locks[chain[0]]
        if len(chain) == 2 and chain[0] in self.model.global_instances:
            cls = self.model.classes.get(
                self.model.global_instances[chain[0]])
            if cls is not None and chain[1] in cls.lock_attrs:
                return (("g", chain[0], chain[1]),
                        cls.lock_attrs[chain[1]])
        if _LOCKISH_NAME.search(chain[-1]):
            return ("unk",) + tuple(chain), "unknown"
        return None

    # ------------------------------------------------------ statements

    def walk(self, stmts, held=frozenset()):
        held = set(held)
        for stmt in stmts:
            held = self._stmt(stmt, held)
        return frozenset(held)

    def _stmt(self, stmt, held):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def runs later, on whatever thread calls it —
            # never under the locks held at its definition site
            self.walk(stmt.body, frozenset())
            return held
        if isinstance(stmt, ast.ClassDef):
            return held
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = set(held)
            for item in stmt.items:
                lk = self._lock_key(item.context_expr)
                if lk is not None:
                    key, kind = lk
                    inner.add(key)
                    self.m.acquires.append(
                        (key, kind, item.context_expr.lineno))
                else:
                    self._expr(item.context_expr, held)
            self.walk(stmt.body, inner)
            return held
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
            fn = call.func
            if isinstance(fn, ast.Attribute) and \
                    fn.attr in ("acquire", "release"):
                lk = self._lock_key(fn.value)
                if lk is not None:
                    key, kind = lk
                    if fn.attr == "acquire":
                        held.add(key)
                        self.m.acquires.append((key, kind, call.lineno))
                    else:
                        held.discard(key)
                    for a in call.args:
                        self._expr(a, held)
                    return held
            self._expr(call, held)
            return held
        if isinstance(stmt, ast.Assign):
            for tgt in stmt.targets:
                self._target(tgt, held, "assign", stmt.lineno)
            self._track_alias(stmt)
            self._expr(stmt.value, held)
            return held
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._target(stmt.target, held, "assign", stmt.lineno)
                self._expr(stmt.value, held)
            return held
        if isinstance(stmt, ast.AugAssign):
            self._target(stmt.target, held, "aug", stmt.lineno)
            self._expr(stmt.value, held)
            return held
        if isinstance(stmt, ast.Try):
            after = set(self.walk(stmt.body, held))
            for handler in stmt.handlers:
                self.walk(handler.body, after)
            self.walk(stmt.orelse, after)
            return set(self.walk(stmt.finalbody, after))
        if isinstance(stmt, ast.If):
            if self.at_module_scope and _is_main_guard(stmt.test):
                return held  # script entry, not import time
            self._expr(stmt.test, held)
            self.walk(stmt.body, held)
            self.walk(stmt.orelse, held)
            return held
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter, held)
            self._track_loop_target(stmt.target, stmt.iter)
            self.walk(stmt.body, held)
            self.walk(stmt.orelse, held)
            return held
        if isinstance(stmt, ast.While):
            self._expr(stmt.test, held)
            self.walk(stmt.body, held)
            self.walk(stmt.orelse, held)
            return held
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._expr(child, held)
            elif isinstance(child, ast.stmt):
                held = self._stmt(child, held)
        return held

    # ----------------------------------------------- write / cb model

    def _target(self, tgt, held, style, lineno):
        if isinstance(tgt, ast.Attribute):
            chain = _chain(tgt)
            if (self.selfname and chain and len(chain) == 2
                    and chain[0] == self.selfname):
                self.m.writes.append(
                    (chain[1], lineno, frozenset(held), style))
        elif isinstance(tgt, ast.Subscript):
            chain = _chain(tgt.value)
            if (self.selfname and chain and len(chain) == 2
                    and chain[0] == self.selfname):
                self.m.writes.append(
                    (chain[1], lineno, frozenset(held), "mut"))
            self._expr(tgt.slice, held)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                self._target(elt, held, style, lineno)

    def _self_attr_of(self, expr):
        """The X of ``self.X`` / ``list(self.X)`` / ``self.X.copy()`` /
        ``self.X[:]``, else None — tracks callback-collection copies."""
        if not self.selfname:
            return None
        chain = _chain(expr)
        if chain and len(chain) == 2 and chain[0] == self.selfname:
            return chain[1]
        if isinstance(expr, ast.Call):
            fc = _chain(expr.func)
            if fc in (("list",), ("tuple",)) and len(expr.args) == 1:
                return self._self_attr_of(expr.args[0])
            if (fc and len(fc) == 3 and fc[0] == self.selfname
                    and fc[2] == "copy"):
                return fc[1]
        if isinstance(expr, ast.Subscript) and \
                isinstance(expr.slice, ast.Slice):
            return self._self_attr_of(expr.value)
        return None

    def _track_alias(self, assign):
        if len(assign.targets) == 1 and \
                isinstance(assign.targets[0], ast.Name):
            src = self._self_attr_of(assign.value)
            if src is not None:
                self.cb_aliases[assign.targets[0].id] = src

    def _track_loop_target(self, target, iter_expr):
        src = self._self_attr_of(iter_expr)
        if src is None and isinstance(iter_expr, ast.Name):
            src = self.cb_aliases.get(iter_expr.id)
        if src is None:
            return
        names = [target] if isinstance(target, ast.Name) else (
            target.elts if isinstance(target, (ast.Tuple, ast.List))
            else [])
        for name in names:
            if isinstance(name, ast.Name):
                self.cb_vars[name.id] = src

    # ----------------------------------------------------- expressions

    def _expr(self, node, held):
        if node is None:
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._call(sub, held)

    def _call(self, call, held):
        func = call.func
        chain = _chain(func)
        resolved = self.model.resolve(chain) if chain else None
        line = call.lineno

        if resolved in ("threading.Thread", "multiprocessing.Process"):
            self._thread_create(call, resolved, line)
        elif resolved == "signal.signal" and len(call.args) >= 2:
            self._signal_register(call.args[1])
        elif resolved == "os.fork":
            self.model.fork_sites.append((line, self._symbol()))
        elif resolved in ("multiprocessing.Pool",):
            self.model.fork_sites.append((line, self._symbol()))

        desc = None
        if chain == ("open",):
            desc = "open()"
        elif resolved in _BLOCKING_CALLS:
            desc = resolved
        elif isinstance(func, ast.Attribute) and \
                func.attr == "synchronize":
            desc = f"{resolved}()" if resolved else ".synchronize()"
        elif resolved == "torch.cuda.synchronize" or (
                resolved and resolved.split(".")[-2:] == ["timing", "sync"]):
            desc = f"{resolved}()"
        if desc is not None:
            self.m.blocking.append((desc, line, frozenset(held)))

        if (self.selfname and chain and len(chain) == 2
                and chain[0] == self.selfname):
            if chain[1] in _MUTATING_METHODS:
                pass  # self.append? not a method call we model
            else:
                self.m.calls.append((chain[1], line, frozenset(held)))
        elif (not self.selfname and chain and len(chain) == 1
                and chain[0] in self.model.functions):
            self.m.calls.append((chain[0], line, frozenset(held)))

        # self.X.append(...) and friends: container mutation of X
        if (self.selfname and chain and len(chain) == 3
                and chain[0] == self.selfname
                and chain[2] in _MUTATING_METHODS):
            self.m.writes.append(
                (chain[1], line, frozenset(held), "mut"))

        # stored-callback invocation
        if isinstance(func, ast.Name) and func.id in self.cb_vars:
            self.m.cb_calls.append(
                (line, frozenset(held), self.cb_vars[func.id]))
        elif isinstance(func, ast.Subscript):
            sub_chain = _chain(func.value)
            if (self.selfname and sub_chain and len(sub_chain) == 2
                    and sub_chain[0] == self.selfname):
                self.m.cb_calls.append(
                    (line, frozenset(held), sub_chain[1]))

    def _symbol(self):
        if self.cls is not None:
            return f"{self.cls.name}.{self.m.name}"
        return self.m.name

    def _thread_create(self, call, resolved, line):
        if self.cls is not None:
            self.cls.creates_thread = True
        if self.at_module_scope:
            self.model.import_thread_sites.append((line, resolved))
        target = None
        for kw in call.keywords:
            if kw.arg == "target":
                target = kw.value
        if target is None and len(call.args) >= 2:
            target = call.args[1]
        if target is None:
            return
        chain = _chain(target)
        if (self.selfname and chain and len(chain) == 2
                and chain[0] == self.selfname and self.cls is not None):
            self.cls.thread_entries.add(chain[1])
        elif chain and len(chain) == 1 and \
                chain[0] in self.model.functions:
            self.model.fn_thread_entries.add(chain[0])

    def _signal_register(self, handler):
        chain = _chain(handler)
        if not chain:
            return
        if (self.selfname and len(chain) == 2
                and chain[0] == self.selfname and self.cls is not None):
            self.cls.signal_entries.add(chain[1])
        elif len(chain) == 1 and chain[0] in self.model.functions:
            self.model.fn_signal_entries.add(chain[0])


def _is_main_guard(test) -> bool:
    """``if __name__ == "__main__":`` — script entry, not import time."""
    return (isinstance(test, ast.Compare)
            and isinstance(test.left, ast.Name)
            and test.left.id == "__name__")


# ---------------------------------------------------------- build pass


def _first_arg_name(fndef):
    args = fndef.args.posonlyargs + fndef.args.args
    return args[0].arg if args else None


def _scan_lock_attrs(model, cls, body):
    """Phase 1: find ``self.X = threading.Lock()`` (any method) and
    class-body ``X = threading.Lock()`` before walking bodies — with
    blocks need the full lock-attr set up front."""
    for stmt in body:
        if isinstance(stmt, ast.Assign):
            kind = _lock_kind_of_call(model, stmt.value)
            if kind is not None:
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        cls.lock_attrs[tgt.id] = kind
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            selfname = _first_arg_name(stmt)
            if selfname is None:
                continue
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.Assign):
                    continue
                kind = _lock_kind_of_call(model, sub.value)
                if kind is None:
                    continue
                for tgt in sub.targets:
                    chain = _chain(tgt)
                    if chain and len(chain) == 2 and \
                            chain[0] == selfname:
                        cls.lock_attrs[chain[1]] = kind


def _build_model(tree) -> _ModuleModel:
    model = _ModuleModel()
    class_defs, fn_defs, module_stmts = [], [], []
    for stmt in tree.body:
        if isinstance(stmt, ast.Import):
            for alias in stmt.names:
                model.imports[alias.asname or
                              alias.name.split(".")[0]] = \
                    alias.name if alias.asname else \
                    alias.name.split(".")[0]
        elif isinstance(stmt, ast.ImportFrom):
            if stmt.module and stmt.level == 0:
                for alias in stmt.names:
                    model.imports[alias.asname or alias.name] = \
                        f"{stmt.module}.{alias.name}"
        elif isinstance(stmt, ast.ClassDef):
            class_defs.append(stmt)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn_defs.append(stmt)
        else:
            module_stmts.append(stmt)

    # phase 1: class skeletons + lock attrs (with-bodies need them)
    for cdef in class_defs:
        bases = [b.id for b in cdef.bases if isinstance(b, ast.Name)]
        cls = _ClassInfo(cdef.name, cdef.lineno, bases)
        model.classes[cdef.name] = cls
        _scan_lock_attrs(model, cls, cdef.body)
    for cdef in class_defs:  # inherit lock attrs within the module
        cls = model.classes[cdef.name]
        merged, stack, seen = {}, list(cls.bases), set()
        while stack:
            base = stack.pop()
            if base in seen or base not in model.classes:
                continue
            seen.add(base)
            parent = model.classes[base]
            for attr, kind in parent.lock_attrs.items():
                merged.setdefault(attr, kind)
            stack.extend(parent.bases)
        for attr, kind in merged.items():
            cls.lock_attrs.setdefault(attr, kind)

    # module-level locks and singleton instances (with _STATE.lock:)
    for stmt in module_stmts:
        if not isinstance(stmt, ast.Assign):
            continue
        kind = _lock_kind_of_call(model, stmt.value)
        inst = None
        if kind is None and isinstance(stmt.value, ast.Call) and \
                isinstance(stmt.value.func, ast.Name) and \
                stmt.value.func.id in model.classes:
            inst = stmt.value.func.id
        for tgt in stmt.targets:
            if not isinstance(tgt, ast.Name):
                continue
            if kind is not None:
                model.module_locks[tgt.id] = kind
            elif inst is not None:
                model.global_instances[tgt.id] = inst

    # register module function names before walking (call edges)
    for fdef in fn_defs:
        model.functions[fdef.name] = _MethodInfo(fdef.name, fdef.lineno)

    # phase 2: walk bodies
    for cdef in class_defs:
        cls = model.classes[cdef.name]
        for stmt in cdef.body:
            if not isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            method = _MethodInfo(stmt.name, stmt.lineno)
            cls.methods[stmt.name] = method
            is_static = any(
                isinstance(d, ast.Name) and d.id == "staticmethod"
                for d in stmt.decorator_list)
            selfname = None if is_static else _first_arg_name(stmt)
            _FnWalker(model, method, cls=cls,
                      selfname=selfname).walk(stmt.body)
    for fdef in fn_defs:
        _FnWalker(model, model.functions[fdef.name]).walk(fdef.body)

    # module scope (import time): check 5 + module-level registrations
    mod_info = _MethodInfo("<module>", 1)
    _FnWalker(model, mod_info, at_module_scope=True).walk(module_stmts)
    return model


# ----------------------------------------------------------- evaluate


def _lock_name(key) -> str:
    if key[0] == "self":
        return f"self.{key[1]}"
    if key[0] == "mod":
        return key[1]
    if key[0] == "g":
        return f"{key[1]}.{key[2]}"
    return ".".join(key[1:])


def _entry_desc(cls) -> str:
    bits = []
    if cls.thread_entries:
        bits.append("thread entry " + ", ".join(
            sorted(cls.thread_entries)))
    if cls.signal_entries:
        bits.append("signal handler " + ", ".join(
            sorted(cls.signal_entries)))
    if not bits:
        bits.append("its lock discipline")
    return " / ".join(bits)


def _check_unlocked_mutation(model, cls, relpath, out):
    concurrent = bool(cls.thread_entries or cls.signal_entries
                      or cls.creates_thread or cls.lock_attrs)
    if not concurrent:
        return
    methods = cls.all_methods(model.classes)
    locked_in = collections.defaultdict(set)   # attr -> {method}
    for m in methods.values():
        for attr, _line, held, _style in m.writes:
            if held:
                locked_in[attr].add(m.name)
    for m in methods.values():
        if m.name in _INIT_METHODS:
            continue  # publication: no other thread sees the object yet
        for attr, line, held, style in m.writes:
            if held:
                continue
            others = locked_in.get(attr, set()) - {m.name}
            if others:
                out.append(Finding(
                    "unlocked-shared-mutation", "error", relpath, line,
                    f"{cls.name}.{m.name}",
                    f"self.{attr} is written lock-free here but under "
                    f"a lock in {', '.join(sorted(others))}(): "
                    f"inconsistent lockset — a race given "
                    f"{_entry_desc(cls)}; hold the same lock at every "
                    f"write (reads of a single attribute may stay "
                    f"lock-free)"))
            elif style == "aug" and cls.lock_attrs:
                out.append(Finding(
                    "unlocked-shared-mutation", "error", relpath, line,
                    f"{cls.name}.{m.name}",
                    f"self.{attr} += ... outside any lock: "
                    f"read-modify-write is not atomic (GIL or not) — "
                    f"concurrent increments lose updates; wrap it in "
                    f"the class lock"))


def _closure(methods, start, pick):
    """DFS the intra-class/module call graph from ``start``; returns
    [(via_path, payload)] for every ``pick(method)`` payload found."""
    hits, seen = [], set()
    stack = [(start, ())]
    while stack:
        name, via = stack.pop()
        if name in seen:
            continue
        seen.add(name)
        m = methods.get(name)
        if m is None:
            continue
        for payload in pick(m):
            hits.append((via + (name,), payload))
        for callee, _line, _held in m.calls:
            stack.append((callee, via + (name,)))
    return hits


def _check_signal_handler(model, relpath, out):
    def scan(methods, handlers, owner):
        for handler in sorted(handlers):
            hits = _closure(
                methods, handler,
                lambda m: [a for a in m.acquires if a[1] == "lock"])
            for via, (key, _kind, line) in hits:
                path = " -> ".join(via)
                out.append(Finding(
                    "lock-in-signal-handler", "error", relpath, line,
                    f"{owner}{handler}",
                    f"signal handler {handler} reaches a non-reentrant "
                    f"threading.Lock acquisition of {_lock_name(key)} "
                    f"(via {path}): the handler runs on top of "
                    f"whatever frame the interrupted thread holds — "
                    f"if that frame holds the lock the process "
                    f"deadlocks; set a flag (plain attribute or "
                    f"Event.set) and service it on a polling thread"))

    for cls in model.classes.values():
        if cls.signal_entries:
            scan(cls.all_methods(model.classes), cls.signal_entries,
                 f"{cls.name}.")
    if model.fn_signal_entries:
        scan(model.functions, model.fn_signal_entries, "")


def _check_blocking(model, relpath, out):
    def scan(methods, owner):
        # per-method transitive "reaches a blocking call" summary
        for m in methods.values():
            for desc, line, held in m.blocking:
                if held:
                    locks = ", ".join(sorted(map(_lock_name, held)))
                    out.append(Finding(
                        "blocking-call-under-lock", "error", relpath,
                        line, f"{owner}{m.name}",
                        f"{desc} while holding {locks}: every "
                        f"contending thread's acquire becomes an I/O "
                        f"wait — snapshot state under the lock, do "
                        f"the slow work outside it"))
            for callee, line, held in m.calls:
                if not held or callee not in methods:
                    continue
                hits = _closure(methods, callee,
                                lambda mm: mm.blocking)
                if hits:
                    via, (desc, _bline, _bheld) = hits[0]
                    locks = ", ".join(sorted(map(_lock_name, held)))
                    out.append(Finding(
                        "blocking-call-under-lock", "error", relpath,
                        line, f"{owner}{m.name}",
                        f"calls {' -> '.join(via)} while holding "
                        f"{locks}, which reaches {desc}: the lock is "
                        f"held across blocking work — move the call "
                        f"outside the locked region"))

    for cls in model.classes.values():
        scan(cls.all_methods(model.classes), f"{cls.name}.")
    scan(model.functions, "")


def _check_callback_reentry(model, relpath, out):
    for cls in model.classes.values():
        for m in cls.all_methods(model.classes).values():
            for line, held, src in m.cb_calls:
                if not held:
                    continue
                locks = ", ".join(sorted(map(_lock_name, held)))
                out.append(Finding(
                    "callback-reentry", "error", relpath, line,
                    f"{cls.name}.{m.name}",
                    f"invokes callbacks stored in self.{src} while "
                    f"holding {locks}: a callback that re-enters this "
                    f"object (add/remove/observer APIs take the same "
                    f"lock) deadlocks — copy the list under the lock, "
                    f"invoke outside it"))


def _check_fork_unsafe(model, relpath, out):
    for line, desc in model.import_thread_sites:
        out.append(Finding(
            "fork-unsafe-state", "error", relpath, line, "<module>",
            f"{desc} created at import time: multiproc-launched "
            f"workers re-import this module, silently starting the "
            f"thread once per child — create threads from an "
            f"install()/main() entry point instead"))
    if model.uses_threads():
        for line, symbol in model.fork_sites:
            out.append(Finding(
                "fork-unsafe-state", "error", relpath, line, symbol,
                "os.fork/default-context multiprocessing in a module "
                "that also creates threads or locks: the child "
                "inherits every lock in whatever state the fork "
                "caught it, and none of the threads that would "
                "release them — use subprocess/spawn "
                "(parallel.multiproc) instead"))


# -------------------------------------------------------- entry points


def lint_source(source: str, relpath: str, checks=None, abspath=None,
                suppressed=None):
    """Lint one file's source text; returns a list of Findings.

    Mirrors :func:`ast_checks.lint_source`: ``abspath`` (when known)
    drives path scoping so verdicts never depend on the caller's cwd;
    ``suppressed`` (a list) receives the findings an inline comment
    silenced.
    """
    checks = set(checks or CONCURRENCY_CHECKS)
    unknown = checks - set(CONCURRENCY_CHECKS)
    if unknown:
        raise ValueError(
            f"unknown concurrency check(s) {sorted(unknown)}; valid: "
            f"{list(CONCURRENCY_CHECKS)}")
    if not _concurrency_applies(abspath or relpath):
        return []
    try:
        tree = ast.parse(source, filename=relpath)
    except SyntaxError:
        return []  # the AST engine already reports syntax errors
    model = _build_model(tree)
    out: list = []
    if "unlocked-shared-mutation" in checks:
        for cls in model.classes.values():
            _check_unlocked_mutation(model, cls, relpath, out)
    if "lock-in-signal-handler" in checks:
        _check_signal_handler(model, relpath, out)
    if "blocking-call-under-lock" in checks:
        _check_blocking(model, relpath, out)
    if "callback-reentry" in checks:
        _check_callback_reentry(model, relpath, out)
    if "fork-unsafe-state" in checks:
        _check_fork_unsafe(model, relpath, out)
    lines = source.splitlines()
    kept = []
    for f in out:
        if is_suppressed(f, lines):
            if suppressed is not None:
                suppressed.append(f)
        else:
            kept.append(f)
    return kept


def lint_paths(paths, root=None, checks=None, suppressed=None):
    """Lint every .py under ``paths``; findings relative to ``root``."""
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

