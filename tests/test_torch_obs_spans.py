"""Spans, step phases and the flight recorder against the JAX package's
(``apex_tpu.observability.profiling``, pure Python on the CPU).

The same synthetic span lists (integer nanoseconds, spans on two
threads, nesting three deep) give exactly equal ``compute_breakdown``
results and equal Chrome trace events; a span dump each package saved
loads in the other's reader; the flight recorder's stall dump has the
reference's keys.
"""

import json
import threading
import time

import numpy as np
import pytest

from apex_tpu.observability.profiling import flight_recorder as ref_fr
from apex_tpu.observability.profiling import spans as ref_spans
from apex_tpu.observability.profiling import step_phases as ref_phases
from apex_tpu_torch.observability import get_registry
from apex_tpu_torch.observability.profiling import flight_recorder as fr
from apex_tpu_torch.observability.profiling import spans
from apex_tpu_torch.observability.profiling import step_phases

NAMES = ("pp/forward", "pp/stage_compute", "tp/allreduce", "data/batch",
         "fused_adam/flat/cuda", "ddp/overlap/bwd_bucket0/float32",
         "misc/host_work", "pp/send_recv", "sp/all_gather", "loss_fn")


@pytest.fixture(autouse=True)
def _solo(monkeypatch):
    for name in ("APEX_TPU_PROCESS_INDEX", "APEX_TPU_PROCESS_COUNT",
                 "APEX_TPU_RUN_ID"):
        monkeypatch.delenv(name, raising=False)


def _synthetic(seed: int):
    """(records, step index): a step span on thread 11 over [0, 10^6) ns
    with nested spans under it, and spans on thread 22 crossing the
    window's edges; ``seq`` is commit order (by end, deeper first)."""
    rng = np.random.default_rng(seed)
    recs = []

    def fill(tid, lo, hi, depth):
        t = lo
        while t < hi and depth < 4:
            a = int(t + rng.integers(0, 20_000))
            b = int(min(hi, a + rng.integers(1, 200_000)))
            if a >= b:
                break
            recs.append([NAMES[rng.integers(len(NAMES))], tid, a, b, depth])
            if rng.random() < 0.6:
                fill(tid, a, b, depth + 1)
            t = b
    recs.append(["step", 11, 0, 1_000_000, 0])
    fill(11, 1_000, 999_000, 1)
    fill(22, -50_000, 1_100_000, 0)
    recs.sort(key=lambda r: (r[3], -r[4]))
    step = next(i for i, r in enumerate(recs) if r[0] == "step")
    return recs, step


def _spans(mod, recs):
    return [mod.Span(n, tid, a, b, d, seq)
            for seq, (n, tid, a, b, d) in enumerate(recs)]


@pytest.mark.parametrize("seed", range(6))
def test_breakdown_and_trace_events_equal_the_reference(seed):
    recs, i = _synthetic(seed)
    ours, ref = _spans(spans, recs), _spans(ref_spans, recs)
    assert step_phases.compute_breakdown(ours, ours[i]) == \
        ref_phases.compute_breakdown(ref, ref[i])
    names = {11: "MainThread", 22: "loader"}
    assert spans.to_trace_events(ours, names, pid=7) == \
        ref_spans.to_trace_events(ref, names, pid=7)
    for name in NAMES + ("", "Forward_pass", "x/allreduce"):
        assert step_phases.classify_span(name) == \
            ref_phases.classify_span(name)


def test_autograd_thread_spans_count_as_the_steps_own():
    """A CUDA backward runs its hooks on the autograd engine's thread:
    ``StepPhases`` takes those spans as the step's, nested under it, so
    their comms is not lost; the reference rule (no ``own_tids``) keeps
    them to the overlap figure."""
    recs = [["pp/stage_compute", 1, 100, 900, 1],
            ["ddp/overlap/bwd_bucket0/float32", 2, 400, 700, 0],
            ["step", 1, 0, 1000, 0]]
    ss = _spans(spans, recs)
    ref_rule = step_phases.compute_breakdown(ss, ss[2])
    assert ref_rule["phases"]["comms"] == 0.0
    own = step_phases.compute_breakdown(ss, ss[2], own_tids={2})
    assert own["phases"] == {"data": 0.0, "compute": 0.5, "comms": 0.3,
                             "host": 0.2}
    assert own["overlap_efficiency"] == ref_rule["overlap_efficiency"] == 1.0


def test_step_phases_reads_a_foreign_thread():
    """A thread Python's ``threading`` did not start (as the autograd
    engine's device threads are: ``current_thread()`` is a
    ``_DummyThread`` there) is marked foreign by the tracer and counted
    by ``StepPhases``."""
    import _thread

    tracer = spans.SpanTracer()
    prev = spans.set_tracer(tracer)
    done = threading.Event()

    def hook():
        with spans.span("tp/allreduce"):
            time.sleep(0.02)
        done.set()

    try:
        phases = step_phases.StepPhases(tracer=tracer)
        with phases.step():
            with spans.span("pp/stage_compute"):
                _thread.start_new_thread(hook, ())
                assert done.wait(10)
        assert tracer.foreign_tids()
        assert phases.last_fields()["phases"]["comms"] > 0.0
    finally:
        spans.set_tracer(prev)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_span_dumps_load_in_both_packages(tmp_path, writer):
    mod = spans if writer == "port" else ref_spans
    tracer = mod.SpanTracer(capacity=8)
    for k in range(12):  # wraps the ring: 4 dropped
        tracer.begin(f"pp/forward{k}")
        tracer.begin("tp/allreduce")
        tracer.end()
        tracer.end()
    path = str(tmp_path / "spans.json")
    assert tracer.save(path) == 8
    a, na = spans.load_spans(path)
    b, nb = ref_spans.load_spans(path)
    assert [s.to_dict() for s in a] == [s.to_dict() for s in b]
    assert na == nb
    assert json.load(open(path))["dropped"] == 16


def _drive_recorder(mod, tmp_path, reg):
    rec = mod.FlightRecorder(directory=str(tmp_path), registry=reg,
                             deadline_s=0.2, poll_s=0.05, signals=())
    rec.install()
    try:
        step = rec.wrap_step(lambda state, it: (time.sleep(0.5), None))
        step(None, 0)
    finally:
        rec.uninstall()
    assert len(rec.dumps) == 1, rec.dumps
    assert rec.sensor()().startswith("step 0 stalled")
    with open(rec.dumps[0]) as f:
        return json.load(f)


def test_flight_recorder_stall_dump_has_the_reference_keys(tmp_path):
    from apex_tpu import observability as ref_obs

    ours = _drive_recorder(fr, tmp_path / "port", get_registry())
    ref = _drive_recorder(ref_fr, tmp_path / "ref",
                          ref_obs.get_registry())
    assert set(ours) == set(ref)
    assert ours["kind"] == ref["kind"] == "apex_tpu.flight_record"
    assert ours["trigger"] == "stall" and ours["step"] == 0
    assert ours["threshold_s"] == 0.2 and ours["step_elapsed_s"] >= 0.2
    assert ours["last_collective"] is None
    assert any(t["thread"] == "MainThread"
               for t in ours["thread_stacks"].values())
