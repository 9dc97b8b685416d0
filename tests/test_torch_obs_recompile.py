"""The port's compile listener and compiled-memory capture
(``apex_tpu_torch.observability.recompile``, ``observability.memory.
compiled``) held against the JAX package's, and serving's zero-retrace
contract read through the listener.

The port compiles CUDA-graph captures (the serving decode step, which a
CPU device runs eagerly) and ``torch._dynamo`` compiles. Here a capture
is simulated with :func:`recompile.note_capture` on a stand-in graph
whose memory fields are fixed, and dynamo is driven by a
``torch.compile(backend="eager")`` toy (in this test only: no path of
the port compiles). The counting is host code: exact against the
reference's listener fed the same compile sequence.
"""

import json
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from apex_tpu.observability import recompile as ref_recompile
from apex_tpu.observability.memory import compiled as ref_compiled
from apex_tpu_torch import observability as obs
from apex_tpu_torch.models import llama
from apex_tpu_torch.observability import recompile
from apex_tpu_torch.observability.memory import compiled, hbm
from apex_tpu_torch.serving import ServingEngine


@pytest.fixture
def listener():
    recompile.uninstall()
    compiled.uninstall_compiled_capture()
    reg = obs.MetricRegistry()
    yield recompile.install(registry=reg)
    compiled.uninstall_compiled_capture()
    recompile.uninstall()


class _Graph:
    """A captured graph's stand-in: fixed memory fields."""

    def __init__(self, pool_bytes):
        self.pool_bytes = pool_bytes

    def compiled_memory_stats(self):
        return {"argument_bytes": 64, "output_bytes": 16,
                "temp_bytes": self.pool_bytes - 16, "alias_bytes": None,
                "generated_code_bytes": None,
                "total_bytes": 64 + self.pool_bytes,
                "pool_bytes": self.pool_bytes}


def test_snapshot_keys_are_the_reference_ones(listener):
    ref = ref_recompile.RecompileListener()
    assert set(listener.snapshot()) == set(ref.snapshot())
    recompile.note_capture("_decode_step", _Graph(4096), 0.25)
    snap = listener.snapshot()
    assert snap["compiles_by_fn"] == {"_decode_step": 1}
    assert snap["backend_compiles"] == snap["trace_events"] == 1
    assert snap["backend_compile_secs"] == 0.25
    assert listener.retraces() == {} and listener.total_retraces() == 0


@pytest.mark.parametrize("sequence,budget", [
    (["a"], 0), (["a", "a"], 0), (["a", "a"], 1), (["a", "b", "a"], 0),
    (["a", "a", "a", "b", "b"], 2), (["a", "a", "a", "b", "b"], 3)])
def test_retrace_guard_trips_where_the_reference_does(listener, sequence,
                                                     budget):
    """The same compile records, before and inside each package's guard:
    the same trip point and message."""
    ref = ref_recompile.RecompileListener()
    ref_recompile._STATE.listener, prev = ref, ref_recompile._STATE.listener
    graphs = {name: _Graph(1024) for name in set(sequence)}
    outcomes = []
    try:
        for feed, guard, exc in (
                (lambda n: recompile.note_capture(n, graphs[n], 0.0),
                 recompile.retrace_guard, recompile.RetraceBudgetExceeded),
                (ref._on_compile_record, ref_recompile.retrace_guard,
                 ref_recompile.RetraceBudgetExceeded)):
            feed(sequence[0])    # compiled once before the region
            try:
                with guard(budget=budget):
                    for name in sequence[1:]:
                        feed(name)
                outcomes.append(None)
            except exc as e:
                outcomes.append(str(e))
    finally:
        ref_recompile._STATE.listener = prev
    assert outcomes[0] == outcomes[1]


def test_dynamo_compiles_and_retraces_are_counted(listener):
    def toy(x):
        return torch.sin(x) * 2.0

    fn = torch.compile(toy, backend="eager", dynamic=False)
    fn(torch.ones(4))
    fn(torch.ones(4))                  # cached: no compile
    assert listener.compiles("toy") == 1 and listener.retraces("toy") == 0
    with pytest.raises(recompile.RetraceBudgetExceeded, match="toy x1"):
        with recompile.retrace_guard(budget=0, fns=["toy"]):
            fn(torch.ones(3, 5))       # a new shape: dynamo compiles again
    assert listener.retraces("toy") == 1
    assert listener.backend_compiles() >= 2
    recompile.uninstall()
    fn(torch.ones(2, 2, 2))            # after uninstall: not counted
    assert listener.compiles("toy") == 2


def test_memory_analysis_fields_follow_the_reference_rules():
    full = types.SimpleNamespace(
        argument_size_in_bytes=100, output_size_in_bytes=20,
        temp_size_in_bytes=300, alias_size_in_bytes=20,
        generated_code_size_in_bytes=7)
    partial = types.SimpleNamespace(argument_size_in_bytes=100)
    for analysis in (full, partial, None):
        assert compiled.memory_analysis_fields(analysis) == \
            ref_compiled.memory_analysis_fields(analysis)
    assert compiled.memory_analysis_fields(full)["total_bytes"] == 400
    assert compiled.COMPILED_STAT_FIELDS == ref_compiled.COMPILED_STAT_FIELDS


def test_capture_records_each_graph_once_under_its_step(listener, tmp_path):
    before = _Graph(1 << 20)
    recompile.note_capture("_decode_step", before, 0.1)   # before install
    reg = obs.MetricRegistry()
    cap = compiled.install_compiled_capture(registry=reg)
    assert compiled.current_capture() is cap
    assert cap.snapshot() == {}     # a graph alive at install is primed
    graph = _Graph(3 << 20)
    recompile.note_capture("_decode_step", graph, 0.1)
    row = cap.snapshot()["_decode_step"]
    assert row["compiles"] == 1
    assert row["total_bytes"] == 64 + (3 << 20)
    # fields the allocator cannot give stay None, never 0
    assert row["alias_bytes"] is None and row["generated_code_bytes"] is None
    assert cap.sweep() == 0         # nothing new
    gauges = {(r["name"], tuple(sorted((r.get("labels") or {}).items()))):
              r["value"] for r in reg.to_records() if r["type"] == "gauge"}
    assert gauges[("memory/compiled_total_bytes",
                   (("fn", "_decode_step"),))] == 64 + (3 << 20)
    mon = hbm.MemoryMonitor("t", registry=reg, device="cpu")
    path = mon.dump(str(tmp_path / "memrec.json"))
    assert json.load(open(path))["compiled"]["_decode_step"][
        "pool_bytes"] == 3 << 20
    compiled.uninstall_compiled_capture()
    assert compiled.current_capture() is None
    path = mon.dump(str(tmp_path / "memrec2.json"))
    assert json.load(open(path))["compiled"] is None
    del before


def test_capture_refuses_cpu_tensors():
    cap = compiled.CompiledMemoryCapture(registry=obs.MetricRegistry())
    with pytest.raises(ValueError, match="CUDA"):
        cap.capture(lambda x: x * 2, torch.ones(3))


def test_decode_retraces_read_through_the_listener(listener):
    """On the CPU the decode step runs eagerly: no capture, 0 retraces;
    the listener is what decode_retraces reads, and another scheduler's
    capture of the same step does not count as this one's retrace."""
    cfg = llama.tiny()
    params = llama.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    engine = ServingEngine(params, cfg, registry=obs.MetricRegistry(),
                           device="cpu", page_size=8, max_batch=2,
                           num_pages=16, max_prompt_len=16, max_new_cap=4)
    rng = np.random.default_rng(0)
    for n in (5, 9, 3):
        engine.submit(rng.integers(0, cfg.vocab_size, n).tolist(), 4)
    engine.run()
    sched = engine.scheduler
    assert sched.decode_captures() == 0 and sched.decode_retraces() == 0
    assert recompile.current() is listener
    # a capture of another scheduler's graph, then two of this one's
    recompile.note_capture("_decode_step", _Graph(1024), 0.0)
    assert sched.decode_retraces() == 0
    recompile.note_capture("_decode_step", sched._graph, 0.0)
    recompile.note_capture("_decode_step", sched._graph, 0.0)
    assert sched.decode_retraces() == 2
    assert listener.compiles("_decode_step") == 3
    # the listener's retraces are captures beyond each graph's first
    assert listener.retraces("_decode_step") == 1


def test_another_graphs_first_capture_is_no_retrace(listener):
    """Two schedulers each capture their own decode graph once (the card's
    native then fp8 engine): two compiles of ``_decode_step`` and no
    retrace, so a budget-0 guard around both holds; a second capture of
    one graph trips it. (The reference's listener counts compiles by
    name alone: each of its engines jits a function of its own, which
    the port's per-graph origin stands for.)"""
    first, second = _Graph(1024), _Graph(2048)
    with recompile.retrace_guard(budget=0, fns=["_decode_step"]):
        recompile.note_capture("_decode_step", first, 0.0)
        recompile.note_capture("_decode_step", second, 0.0)
    assert listener.compiles("_decode_step") == 2
    assert listener.retraces() == {} and listener.total_retraces() == 0
    assert listener.snapshot()["retraces_by_fn"] == {}
    with pytest.raises(recompile.RetraceBudgetExceeded,
                       match="_decode_step x1"):
        with recompile.retrace_guard(budget=0, fns=["_decode_step"]):
            recompile.note_capture("_decode_step", second, 0.0)
    assert listener.snapshot()["retraces_by_fn"] == {"_decode_step": 1}


def test_install_imports_no_dynamo_until_a_compile_does():
    """In a fresh process: installing the listener (as serving's first
    decode step does) leaves ``torch._dynamo`` unimported; a later
    ``torch.compile`` imports it and its compile is counted."""
    code = (
        "import sys, torch\n"
        "from apex_tpu_torch.observability import recompile\n"
        "listener = recompile.install()\n"
        "print('before', 'torch._dynamo' in sys.modules)\n"
        "def toy(x):\n"
        "    return x + 1\n"
        "torch.compile(toy, backend='eager')(torch.ones(2))\n"
        "print('after', 'torch._dynamo' in sys.modules,\n"
        "      listener.compiles('toy'), listener.backend_compiles())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.split("\n")[:2] == ["before False", "after True 1 1"]
