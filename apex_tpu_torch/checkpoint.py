"""Checkpoint/resume (port of ``apex_tpu/checkpoint.py``): save and
restore any state tree (params, optimizer state, the amp scaler's state)
with the reference's durability protocol.

Durability protocol, the reference's: every save is atomic. Data lands
in ``step_XXXXXXXX.tmp``, a commit marker (``_APEX_COMMIT.json``: a file
manifest with sizes and crc32 checksums, and in format 2 the state's
``state_schema``) is written inside, and the tmp dir is renamed to its
final name. A process killed mid-write leaves only a ``.tmp`` dir, which
:func:`latest_valid_step` ignores and :func:`gc_partial_checkpoints`
removes. :mod:`apex_tpu_torch.resilience` injects write failures through
the module-level ``_FAULT_HOOK``.

The marker and the schema are plain JSON, the same bytes the reference
writes for the same state (:func:`state_schema_of` describes the tree in
JAX's own notation, see :mod:`apex_tpu_torch._tree`), so each
package's validators judge the other's directories. The data is not
shared: the reference stores its arrays with orbax, which the port does
not read. The port stores each leaf as one ``.npy`` file
(``leaf_00000.npy``, ..., bf16 as ``|V2`` items holding its bits, see
:mod:`apex_tpu_torch._npy`) beside an ``index.json`` of paths, dtypes and
shapes, so numpy alone reads a port checkpoint.

Restore with a ``target`` copies each leaf IN PLACE into the target's
tensor, on that tensor's device and in its dtype (a leaf whose shape or
dtype differs raises, as orbax does). Without a target the leaves land
on the card unless the caller asks for the CPU.

Async saves (:class:`AsyncCheckpointWriter`, ``CheckpointManager(
async_save=True)``) must snapshot before ``save`` returns: the port's
train steps update params and optimizer slabs in place. The snapshot is
a device -> pinned host copy on a side stream, behind an event recorded
on the caller's stream; the caller's stream then waits for the copy's
completion event, so the next step's in-place writes queue behind the
copy without blocking the host. A writer thread serialises from the
pinned buffers, which are reused only once that write has committed; its
threads run at a lower CPU priority than the loop.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import io
import json
import os
import shutil
import threading
import zlib
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch import _device, _tree
from apex_tpu_torch._npy import dump_array, load_array

__all__ = [
    "COMMIT_MARKER", "TMP_SUFFIX", "INDEX", "build_manifest", "encode_spec",
    "schema_fingerprint", "state_schema_of", "write_commit_marker",
    "read_manifest", "manifest_state_schema", "validate_step_dir",
    "latest_step", "valid_steps", "latest_valid_step",
    "gc_partial_checkpoints", "save_checkpoint", "restore_checkpoint",
    "AsyncCheckpointWriter", "CheckpointManager",
]

#: Name of the commit marker written inside every committed step dir.
COMMIT_MARKER = "_APEX_COMMIT.json"

#: Suffix of in-flight (uncommitted) step dirs.
TMP_SUFFIX = ".tmp"

#: The port's index of leaves inside a step dir.
INDEX = "index.json"
INDEX_FORMAT = "apex_tpu_torch.npy_leaves/1"

# Fault-injection hook (set by apex_tpu_torch.resilience.faults):
# called as hook(stage, step, path) at "pre_write" (before any data is
# written: the ENOSPC point) and "pre_commit" (after the data, before the
# marker and the rename: the torn-write point).
_FAULT_HOOK = None

# parallel leaf writers (file writes and zlib.crc32 release the GIL): two
# outrun a disk of ~1 GB/s; more take host cores from the training loop
# while an async write is in flight
_WRITE_WORKERS = 2

# the CPU niceness of an async write's threads: below the loop that
# launches the next steps' kernels
_BACKGROUND_NICE = 10


def _fault_point(stage: str, step, path: str) -> None:
    hook = _FAULT_HOOK
    if hook is not None:
        hook(stage, step, path)


def _step_dirname(step: int) -> str:
    return f"step_{step:08d}"


# --------------------------------------------------------------- manifest

def _file_crc32(path: str, chunk: int = 1 << 20) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(chunk)
            if not buf:
                return crc
            crc = zlib.crc32(buf, crc)


def build_manifest(dirpath: str) -> dict:
    """File manifest of a checkpoint dir: relpath -> {size, crc32}. The
    commit marker itself is excluded (it is written after)."""
    files = {}
    for root, _dirs, names in os.walk(dirpath):
        for name in sorted(names):
            full = os.path.join(root, name)
            rel = os.path.relpath(full, dirpath)
            if rel == COMMIT_MARKER:
                continue
            files[rel] = {"size": os.path.getsize(full),
                          "crc32": _file_crc32(full)}
    return {"files": files}


def encode_spec(spec) -> Optional[list]:
    """JSON encoding of a partition spec (``checkpoint.py:100``): one
    entry per dim, each None, an axis name, or a list of axis names.
    None in, None out (spec unknown). The port shards nothing, so its
    own leaves carry None."""
    if spec is None:
        return None
    out = []
    for dim in tuple(spec):
        if dim is None:
            out.append(None)
        elif isinstance(dim, (tuple, list)):
            out.append([str(a) for a in dim])
        else:
            out.append(str(dim))
    return out


def schema_fingerprint(body: dict) -> str:
    """sha1 over the canonical JSON of the schema's treedef and leaves."""
    canon = json.dumps({"treedef": body.get("treedef"),
                        "leaves": body.get("leaves")},
                       sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(canon.encode()).hexdigest()


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).rsplit(".", 1)[-1]
    dt = getattr(leaf, "dtype", None)
    return np.dtype(dt if dt is not None else np.asarray(leaf).dtype).name


def _shape(leaf) -> list:
    return [int(d) for d in getattr(leaf, "shape", ())]


def state_schema_of(state: Any, specs: Optional[Sequence] = None) -> dict:
    """Semantic schema of a state tree, as stored in the format-2 commit
    marker: ``{"treedef", "leaves": [{path, shape, dtype, spec, kind}],
    "fingerprint"}``, equal to the reference's for the same state.

    ``specs``: optional per-leaf partition specs in leaf order (the
    reference takes a spec tree; the port shards nothing and has no
    spec type). ``kind`` tags the leaves of the reference's registered
    state constructors (``LossScaleState.loss_scale``, ...)."""
    tagged, treedef = _tree.flatten_with_kinds(state)
    if specs is not None and len(specs) != len(tagged):
        raise ValueError(
            f"state_schema_of: {len(specs)} specs, state has {len(tagged)} "
            f"leaves: the trees diverged")
    leaves = [{
        "path": path,
        "shape": _shape(leaf),
        "dtype": _dtype_name(leaf),
        "spec": None if specs is None else encode_spec(specs[i]),
        "kind": kind,
    } for i, (path, leaf, kind) in enumerate(tagged)]
    body = {"treedef": str(treedef), "leaves": leaves}
    body["fingerprint"] = schema_fingerprint(body)
    return body


def write_commit_marker(dirpath: str, step: Optional[int] = None,
                        state_schema: Optional[dict] = None,
                        manifest: Optional[dict] = None) -> str:
    """Write the manifest/commit marker into ``dirpath`` (marker.part,
    then rename). The marker is the LAST write of a checkpoint: its
    presence asserts every listed file landed. ``state_schema`` upgrades
    it to format 2. ``manifest``: the dir's :func:`build_manifest`,
    when the writer already computed it while writing (else it is built
    here by reading the files back)."""
    if manifest is None:
        manifest = build_manifest(dirpath)
    payload = {"format": 1, "step": step, **manifest}
    if state_schema is not None:
        payload["format"] = 2
        payload["state_schema"] = state_schema
    marker = os.path.join(dirpath, COMMIT_MARKER)
    part = marker + ".part"
    with open(part, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(part, marker)
    return marker


def read_manifest(dirpath: str) -> Optional[dict]:
    """The commit-marker payload of ``dirpath``, or None when the dir
    has no (parseable) marker."""
    marker = os.path.join(dirpath, COMMIT_MARKER)
    try:
        with open(marker) as f:
            payload = json.load(f)
    except (OSError, ValueError):
        return None
    return payload if isinstance(payload, dict) else None


def manifest_state_schema(dirpath: str) -> Optional[dict]:
    """The ``state_schema`` block of a step dir's marker, or None for
    format-1 checkpoints and unmarked dirs."""
    payload = read_manifest(dirpath)
    if payload is None:
        return None
    schema = payload.get("state_schema")
    return schema if isinstance(schema, dict) else None


def validate_step_dir(dirpath: str, deep: bool = False) -> bool:
    """Is ``dirpath`` a committed, intact checkpoint? The marker, and
    every manifest file present with its recorded size; ``deep=True``
    re-checksums the files too."""
    payload = read_manifest(dirpath)
    if payload is None:
        return False
    files = payload.get("files")
    if not isinstance(files, dict):
        return False
    for rel, meta in files.items():
        full = os.path.join(dirpath, rel)
        try:
            if os.path.getsize(full) != meta.get("size"):
                return False
            if deep and _file_crc32(full) != meta.get("crc32"):
                return False
        except OSError:
            return False
    return True


# ---------------------------------------------------------- dir scanning

def _committed_steps(path: str) -> dict:
    """{step: dirname} of committed (non-``.tmp``) step dirs."""
    steps = {}
    if not os.path.isdir(path):
        return steps
    for d in os.listdir(path):
        if not d.startswith("step_"):
            continue
        try:
            steps[int(d[5:])] = d
        except ValueError:
            continue  # .tmp dirs, orbax staging dirs, anything else
    return steps


def latest_step(path: str) -> Optional[int]:
    """Largest committed ``step_*`` subdirectory, or None (no validity
    claim: prefer :func:`latest_valid_step` for resume)."""
    steps = _committed_steps(path)
    return max(steps) if steps else None


def valid_steps(path: str, deep: bool = False) -> list:
    """Ascending list of committed steps whose dirs validate."""
    return sorted(s for s, d in _committed_steps(path).items()
                  if validate_step_dir(os.path.join(path, d), deep=deep))


def latest_valid_step(path: str, deep: bool = False) -> Optional[int]:
    """Largest committed step with an intact marker and manifest."""
    steps = valid_steps(path, deep=deep)
    return steps[-1] if steps else None


def gc_partial_checkpoints(path: str, keep=()) -> list:
    """Remove torn-write leftovers under ``path``: ``step_*.tmp`` dirs,
    orbax staging dirs, and committed step dirs whose marker exists but
    no longer validates. Marker-less dirs are left alone. ``keep``: path
    prefixes to spare (an in-flight async write). Returns the removed
    paths."""
    removed = []
    if not os.path.isdir(path):
        return removed
    keep = tuple(os.path.abspath(k) for k in keep)
    for d in sorted(os.listdir(path)):
        if not d.startswith("step_"):
            continue
        full = os.path.abspath(os.path.join(path, d))
        if any(full.startswith(k) for k in keep) or not os.path.isdir(full):
            continue
        is_tmp = d.endswith(TMP_SUFFIX) or ".orbax-checkpoint-tmp" in d
        has_marker = os.path.exists(os.path.join(full, COMMIT_MARKER))
        if is_tmp or (has_marker and not validate_step_dir(full)):
            shutil.rmtree(full, ignore_errors=True)
            removed.append(full)
    return removed


# ----------------------------------------------------------------- leaves

def _skeleton(treedef: _tree.TreeDef, counter: List[int]):
    """``treedef`` as JSON, leaves numbered in order (what a restore
    without a target rebuilds)."""
    if treedef.kind == "leaf":
        counter[0] += 1
        return {"leaf": counter[0] - 1}
    if treedef.kind == "none":
        return None
    kids = [_skeleton(c, counter) for c in treedef.children]
    if treedef.kind == "dict":
        return {"dict": [[k, kid] for k, kid in zip(treedef.meta, kids)]}
    if treedef.kind == "namedtuple":
        return {"namedtuple": treedef.meta.__name__,
                "fields": [[f, kid] for f, kid in
                           zip(treedef.meta._fields, kids)]}
    return {treedef.kind: kids}


def _from_skeleton(node, leaves: list):
    """A tree from :func:`_skeleton`'s JSON: NamedTuples come back as
    dicts of their fields (the class is not stored)."""
    if node is None:
        return None
    if "leaf" in node:
        return leaves[node["leaf"]]
    if "dict" in node:
        return {k: _from_skeleton(v, leaves) for k, v in node["dict"]}
    if "namedtuple" in node:
        return {f: _from_skeleton(v, leaves) for f, v in node["fields"]}
    if "list" in node:
        return [_from_skeleton(v, leaves) for v in node["list"]]
    return tuple(_from_skeleton(v, leaves) for v in node["tuple"])


def _leaf_kind(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return "tensor"
    if isinstance(leaf, np.ndarray):
        return "ndarray"
    if isinstance(leaf, (bool, int, float)):
        return type(leaf).__name__
    return "scalar"  # a numpy scalar


def _host_value(leaf):
    """A copy of a non-tensor leaf, taken at save time."""
    if isinstance(leaf, (bool, int, float)):
        return leaf
    return np.array(leaf)


def _write_npy(path: str, arr: np.ndarray) -> dict:
    """``np.save``'s bytes for ``arr``, written from a view of its data
    (no copy, the GIL released for the write and the checksum); returns
    the file's size and crc32."""
    if not arr.flags["C_CONTIGUOUS"]:
        arr = arr.copy(order="C")
    head = io.BytesIO()
    np.lib.format.write_array_header_1_0(
        head, np.lib.format.header_data_from_array_1_0(arr))
    header = head.getvalue()
    data = memoryview(arr.reshape(-1).view(np.uint8))
    crc = zlib.crc32(data, zlib.crc32(header))
    with open(path, "wb") as f:
        f.write(header)
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    return {"size": len(header) + data.nbytes, "crc32": crc}


def _background() -> None:
    """Lower the calling thread's CPU priority to :data:`_BACKGROUND_NICE`
    (Linux niceness is a thread's own)."""
    tid = threading.get_native_id()
    nice = os.getpriority(os.PRIO_PROCESS, tid)
    os.setpriority(os.PRIO_PROCESS, tid, max(nice, _BACKGROUND_NICE))


def _write_leaves(tmp: str, pairs, host: list, treedef,
                  background: bool = False) -> dict:
    """Write each host leaf as ``leaf_NNNNN.npy`` and the index into
    ``tmp``; returns the dir's manifest (sizes and crc32s computed while
    writing, equal to :func:`build_manifest`'s). ``background``: the
    writing threads run at a lower CPU priority."""
    os.makedirs(tmp, exist_ok=True)
    entries, jobs = [], []
    for i, ((path, leaf), value) in enumerate(zip(pairs, host)):
        name = f"leaf_{i:05d}.npy"
        entries.append({"path": path, "file": name, "kind": _leaf_kind(leaf),
                        "dtype": _dtype_name(leaf), "shape": _shape(leaf)})
        arr = (dump_array(value) if isinstance(value, torch.Tensor)
               else np.asarray(value))
        jobs.append((name, arr))
    files = {}
    workers = max(1, min(_WRITE_WORKERS, len(jobs)))
    with concurrent.futures.ThreadPoolExecutor(
            workers, initializer=_background if background else None) as pool:
        futures = {name: pool.submit(_write_npy, os.path.join(tmp, name), a)
                   for name, a in jobs}
        for name, fut in futures.items():
            files[name] = fut.result()
    index = json.dumps({"format": INDEX_FORMAT,
                        "tree": _skeleton(treedef, [0]),
                        "leaves": entries}).encode()
    with open(os.path.join(tmp, INDEX), "wb") as f:
        f.write(index)
        f.flush()
        os.fsync(f.fileno())
    files[INDEX] = {"size": len(index), "crc32": zlib.crc32(index)}
    return {"files": dict(sorted(files.items()))}


def _host_copies(leaves: list) -> list:
    """Blocking host copies of the leaves (the synchronous save)."""
    return [leaf.detach().to("cpu", copy=True)
            if isinstance(leaf, torch.Tensor) else _host_value(leaf)
            for leaf in leaves]


def _load_leaf(dirpath: str, meta: dict) -> np.ndarray:
    return np.load(os.path.join(dirpath, meta["file"]), allow_pickle=False)


def _as_torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"checkpoint leaf dtype {name!r} has no torch twin")
    return dtype


# ------------------------------------------------------------ save/restore

def _check_overwrite(final: str, overwrite: bool) -> None:
    """Fail before any data is written, with a non-retryable class: an
    existing checkpoint is a permanent condition, not I/O weather."""
    if not overwrite and os.path.isdir(final):
        raise ValueError(
            f"checkpoint already exists at {final} and overwrite=False")


def _commit(tmp: str, final: str, step, overwrite: bool,
            state_schema: Optional[dict] = None,
            manifest: Optional[dict] = None) -> str:
    """Marker + rename: the atomic tail of every save path."""
    _fault_point("pre_commit", step, tmp)
    write_commit_marker(tmp, step=step, state_schema=state_schema,
                        manifest=manifest)
    if os.path.isdir(final):
        _check_overwrite(final, overwrite)  # lost the entry-check race
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _schema_or_none(state: Any, specs: Optional[Sequence] = None
                    ) -> Optional[dict]:
    """Best-effort format-2 schema: a tree the encoder cannot describe
    degrades the marker to format 1 rather than failing the save. Given
    ``specs``, the schema with them: a list that does not match the
    state fails the save."""
    if specs is not None:
        return state_schema_of(state, specs)
    try:
        return state_schema_of(state)
    except Exception:  # noqa: BLE001 — the schema is advisory metadata
        return None


def _paths(path: str, step: Optional[int]):
    if step is not None:
        path = os.path.join(path, _step_dirname(step))
    final = os.path.abspath(path)
    return final, final + TMP_SUFFIX


def save_checkpoint(path: str, state: Any, step: Optional[int] = None,
                    overwrite: bool = True,
                    specs: Optional[Sequence] = None) -> str:
    """Save a state tree, blocking. ``step`` appends a step subdirectory
    (``path/step_00000010``). Atomic: data in ``<dir>.tmp``, the commit
    marker, then the rename. ``specs``: the partition spec of each leaf,
    in leaf order, for the schema (the reference reads each array's own
    sharding; a tensor has none), e.g. a gathered ZeRO-1 state's."""
    final, tmp = _paths(path, step)
    _check_overwrite(final, overwrite)
    if os.path.isdir(tmp):  # stale torn write from a previous crash
        shutil.rmtree(tmp, ignore_errors=True)
    _fault_point("pre_write", step, tmp)
    schema = _schema_or_none(state, specs)
    pairs, treedef = _tree.flatten_with_path(state)
    host = _host_copies([leaf for _, leaf in pairs])
    manifest = _write_leaves(tmp, pairs, host, treedef)
    return _commit(tmp, final, step, overwrite, state_schema=schema,
                   manifest=manifest)


def _resolve_step(path: str, step: Optional[int]) -> Optional[int]:
    if step is None:
        # resume semantics: the newest VALID step; a dir from a writer
        # without markers falls back to its newest step
        step = latest_valid_step(path)
        if step is None:
            step = latest_step(path)
    return step


@torch.no_grad()
def restore_checkpoint(path: str, target: Optional[Any] = None,
                       step: Optional[int] = None,
                       device: _device.DeviceLike = None):
    """Restore a checkpoint the port wrote.

    ``target``: a tree like the saved one. Each tensor leaf is
    overwritten in place (on its own device, in its own dtype) and the
    tree is returned; the structure, each path, shape and dtype must
    match, else ``ValueError``. Without a target the leaves land on
    ``device`` (default: the GPU, raising when there is none) and
    NamedTuples come back as dicts of their fields.

    ``step=None`` restores the newest valid step (or, when no step has a
    marker, the newest step dir)."""
    step = _resolve_step(path, step)
    if step is not None:
        path = os.path.join(path, _step_dirname(step))
    path = os.path.abspath(path)
    with open(os.path.join(path, INDEX)) as f:
        index = json.load(f)
    stored = index["leaves"]
    if target is None:
        dev = _device.resolve(device)
        leaves = []
        for meta in stored:
            arr = _load_leaf(path, meta)
            if meta["kind"] == "tensor":
                leaves.append(load_array(arr, _as_torch_dtype(
                    meta["dtype"])).to(dev))
            elif meta["kind"] in ("bool", "int", "float"):
                leaves.append(arr.item())
            else:
                leaves.append(arr)
        return _from_skeleton(index["tree"], leaves)
    pairs, treedef = _tree.flatten_with_path(target)
    # the skeleton as it reads back from JSON (tuples become lists)
    if json.loads(json.dumps(_skeleton(treedef, [0]))) != index["tree"]:
        raise ValueError(f"checkpoint at {path} holds another tree than "
                         f"the target's {treedef}: {index['tree']}")
    out = []
    for (leaf_path, leaf), meta in zip(pairs, stored):
        if (_shape(leaf) != meta["shape"]
                or _dtype_name(leaf) != meta["dtype"]):
            raise ValueError(
                f"checkpoint leaf {leaf_path} is {meta['dtype']}"
                f"{meta['shape']}, the target's is {_dtype_name(leaf)}"
                f"{_shape(leaf)}")
        arr = _load_leaf(path, meta)
        if isinstance(leaf, torch.Tensor):
            leaf.copy_(load_array(arr, leaf.dtype).reshape(leaf.shape))
            out.append(leaf)
        elif isinstance(leaf, (bool, int, float)):
            out.append(type(leaf)(arr.item()))
        elif isinstance(leaf, np.ndarray):
            out.append(np.array(arr))
        else:
            out.append(arr[()])
    return treedef.unflatten(out)


# ------------------------------------------------------------------ async

class _Snapshot:
    """Host copies of a state's leaves taken at ``save``: each CUDA
    tensor into a pinned buffer on a side stream, each CPU tensor copied
    at once, other leaves copied as values. ``ready()`` waits for the
    device copies."""

    def __init__(self, leaves: list, buffers: Optional[list], streams: dict):
        self.host = []
        self.events = []
        tensors = [leaf for leaf in leaves if isinstance(leaf, torch.Tensor)]
        if buffers is None or len(buffers) != len(tensors) or any(
                b.shape != t.shape or b.dtype != t.dtype
                for b, t in zip(buffers, tensors)):
            buffers = [torch.empty(t.shape, dtype=t.dtype,
                                   pin_memory=t.is_cuda) for t in tensors]
        self.buffers = buffers
        by_device: dict = {}
        it = iter(buffers)
        for leaf in leaves:
            if not isinstance(leaf, torch.Tensor):
                self.host.append(_host_value(leaf))
                continue
            buf = next(it)
            self.host.append(buf)
            if leaf.is_cuda:
                by_device.setdefault(leaf.device, []).append((leaf, buf))
            else:
                buf.copy_(leaf.detach())
        for device, copies in by_device.items():
            stream = streams.get(device)
            if stream is None:
                stream = streams[device] = torch.cuda.Stream(device)
            compute = torch.cuda.current_stream(device)
            start = torch.cuda.Event()
            start.record(compute)
            with torch.cuda.stream(stream):
                stream.wait_event(start)
                for leaf, buf in copies:
                    buf.copy_(leaf.detach(), non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            # the step after save() writes these tensors in place: its
            # kernels queue behind the copy, the host does not wait
            compute.wait_event(done)
            self.events.append(done)

    def ready(self) -> None:
        for event in self.events:
            event.synchronize()


class AsyncCheckpointWriter:
    """Background checkpoint writer.

    ``save`` returns once the state is snapshotted (the device copies
    queued, see the module docstring); the serialisation runs in a
    writer thread concurrently with later steps. A second ``save`` (or
    ``wait``) first waits for the previous write and commits it: at
    most one write is in flight, and its pinned buffers are reused only
    after it committed.

    Writes follow the atomic protocol: the thread writes ``<dir>.tmp``;
    ``wait()`` (or the fence in the next ``save``) commits it (marker,
    then rename). A process killed while a write is in flight leaves
    only the ``.tmp`` dir."""

    def __init__(self):
        self._pending = None  # (tmp, final, step, overwrite, schema)
        self._thread: Optional[threading.Thread] = None
        self._result: dict = {}
        self._buffers: Optional[list] = None
        self._streams: dict = {}
        # save/wait/close fence and commit through _pending; RLock:
        # save()'s fence re-enters wait()
        self._lock = threading.RLock()

    @property
    def in_flight_tmp(self) -> Optional[str]:
        """Abs path of the uncommitted ``.tmp`` dir of the write in
        flight, if any: GC must spare it."""
        return self._pending[0] if self._pending else None

    @property
    def writing(self) -> bool:
        """Is the writer thread still writing (not yet waiting for its
        commit)?"""
        return self._thread is not None and self._thread.is_alive()

    def save(self, path: str, state: Any, step: Optional[int] = None,
             overwrite: bool = True,
             specs: Optional[Sequence] = None) -> str:
        """``specs`` as in :func:`save_checkpoint`."""
        final, tmp = _paths(path, step)
        _check_overwrite(final, overwrite)
        with self._lock:
            # fence + finalize the previous write before issuing a new
            # one: holding the lock across the stale-tmp sweep and the
            # mkdir IS the point, as the lock serialises whole save/wait
            # transactions and guards no hot path
            self.wait()
            if os.path.isdir(tmp):
                # apex-lint: disable=blocking-call-under-lock
                shutil.rmtree(tmp, ignore_errors=True)
            _fault_point("pre_write", step, tmp)
            schema = _schema_or_none(state, specs)
            # made here, not by the writer thread: once save returns, the
            # write in flight's dir exists (``in_flight_tmp``)
            # apex-lint: disable=blocking-call-under-lock
            os.makedirs(tmp)
            pairs, treedef = _tree.flatten_with_path(state)
            snap = _Snapshot([leaf for _, leaf in pairs], self._buffers,
                             self._streams)
            self._buffers = snap.buffers
            result: dict = {}

            def write():
                try:
                    _background()
                    snap.ready()
                    result["manifest"] = _write_leaves(
                        tmp, pairs, snap.host, treedef, background=True)
                except BaseException as e:  # noqa: BLE001 — re-raised in wait
                    result["error"] = e

            self._result = result
            self._thread = threading.Thread(
                target=write, name="apex_tpu_torch-ckpt-writer", daemon=True)
            self._thread.start()
            self._pending = (tmp, final, step, overwrite, schema)
        return final

    def wait(self) -> None:
        """Block until the in-flight write (if any) is written AND
        committed (marker, then rename)."""
        with self._lock:
            if self._thread is not None:
                self._thread.join()
                self._thread = None
            if self._pending is None:
                return
            tmp, final, step, overwrite, schema = self._pending
            # clear first: a failed write or commit leaves a torn .tmp
            # behind (as a real crash would) rather than wedging later
            # saves
            self._pending = None
            if "error" in self._result:
                raise self._result["error"]
            _commit(tmp, final, step, overwrite, state_schema=schema,
                    manifest=self._result["manifest"])

    def close(self) -> None:
        with self._lock:
            self.wait()
            self._buffers = None


class CheckpointManager:
    """Rotation and bookkeeping over a checkpoint directory
    (``checkpoint.py:509``).

    Async mode (``async_save=True``): each ``save`` fences and commits
    the previous write before issuing the new one, so retention runs over
    committed dirs only; the in-flight ``.tmp`` dir is never GC'd. Call
    :meth:`wait_until_finished` at the end of a run: it commits the last
    write and applies retention.

    Retention never deletes the newest *valid* checkpoint, even when it
    has aged out of the ``max_to_keep`` window."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = False):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._writer = AsyncCheckpointWriter() if async_save else None

    def save(self, step: int, state: Any,
             specs: Optional[Sequence] = None) -> str:
        """Save ``state`` as ``step``; ``specs`` as in
        :func:`save_checkpoint` (a gathered ZeRO-1 state's, from
        :meth:`~apex_tpu_torch.parallel.Zero1FusedAdam.state_specs`)."""
        if self._writer is not None:
            p = self._writer.save(self.directory, state, step=step,
                                  specs=specs)
        else:
            p = save_checkpoint(self.directory, state, step=step,
                                specs=specs)
        self._gc()
        return p

    def wait_until_finished(self) -> None:
        """Async mode: block until the pending write lands and commits,
        then apply retention. No-op in blocking mode."""
        if self._writer is not None:
            self._writer.wait()
            self._gc()

    def restore(self, target: Optional[Any] = None,
                step: Optional[int] = None,
                device: _device.DeviceLike = None):
        step = _resolve_step(self.directory, step)
        if step is None:
            return None
        return restore_checkpoint(self.directory, target, step=step,
                                  device=device)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def latest_valid_step(self, deep: bool = False) -> Optional[int]:
        return latest_valid_step(self.directory, deep=deep)

    def _gc(self) -> None:
        in_flight = self._writer.in_flight_tmp if self._writer else None
        gc_partial_checkpoints(
            self.directory, keep=(in_flight,) if in_flight else ())
        steps = _committed_steps(self.directory)
        if not steps or self.max_to_keep <= 0:
            return  # max_to_keep <= 0 keeps everything
        keep = set(sorted(steps)[-self.max_to_keep:])
        valid = [s for s in sorted(steps)
                 if validate_step_dir(os.path.join(self.directory,
                                                   steps[s]))]
        if valid and not any(s in keep for s in valid):
            # every survivor would be invalid: spare the newest valid
            # checkpoint, never delete the only resumable state
            keep.add(valid[-1])
        for s, d in steps.items():
            if s not in keep:
                shutil.rmtree(os.path.join(self.directory, d),
                              ignore_errors=True)
