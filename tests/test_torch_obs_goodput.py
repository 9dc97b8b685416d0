"""Goodput accounting and the report CLI against the JAX package's.

One record list - a run written here with checkpoints, a preemption, a
restart, a rollback and its replayed steps, StepReporter records with
phases - gives an equal ledger and an equal ``account`` in both
packages (seconds within 1e-9), in memory and from a dump on disk with
post-mortem files beside it; the ``report``, ``goodput`` and ``trace``
commands print the same lines and write the same files as the
reference's CLI on the same inputs.
"""

import json

import pytest

from apex_tpu import observability as ref_obs
from apex_tpu.observability import cli as ref_cli
from apex_tpu.observability import goodput as ref_goodput
from apex_tpu_torch import observability as obs
from apex_tpu_torch.observability import cli
from apex_tpu_torch.observability import goodput


@pytest.fixture(autouse=True)
def _solo(monkeypatch):
    for name in ("APEX_TPU_PROCESS_INDEX", "APEX_TPU_PROCESS_COUNT",
                 "APEX_TPU_RUN_ID"):
        monkeypatch.delenv(name, raising=False)


def _run_records():
    """A port registry's records of a chaotic run: two attempts, a
    checkpoint every 2 steps, a slow step, a preemption after step 4, a
    resume, a rollback at step 6 replaying steps 5-6."""
    reg = obs.MetricRegistry()
    rep = obs.StepReporter("t", registry=reg, tokens_per_step=64,
                           device_kind="cpu")
    reg.event("attempt_start", start_step=0, num_steps=8, resumed=False,
              startup_s=0.75)
    durations = [0.9, 0.1, 0.11, 0.1, 0.6]
    for step, d in enumerate(durations):
        rep.step(d, loss=2.0 - 0.1 * step,
                 phases={"data": 0.05, "compute": 0.8, "comms": 0.1,
                         "host": 0.05})
        reg.event("step_done", step=step, duration_s=d)
        if step % 2 == 0:
            reg.event("checkpoint_saved", step=step, duration_s=0.2)
    reg.event("preemption", reason="sigterm")
    reg.event("preempt_exit", step=4, reason="sigterm", checkpoint=True,
              duration_s=1.5)
    reg.event("gc_partial_checkpoints", removed=1, duration_s=0.05)
    reg.event("resumed", step=4, duration_s=0.4)
    reg.event("attempt_start", start_step=5, num_steps=8, resumed=True,
              startup_s=1.0)
    for step in (5, 6):
        reg.event("step_done", step=step, duration_s=0.1)
    reg.event("rollback", step=6, attempt=1, error="ValueError('nan')")
    reg.event("resumed", step=4, duration_s=0.3, rollback=True)
    for step in (5, 6, 7):
        reg.event("step_done", step=step, duration_s=0.12)
    reg.event("checkpoint_failed", step=7, error="OSError()",
              duration_s=0.25)
    reg.event("flight_record", path="x", reason="stall", step=2)
    return reg, reg.to_records()


def _close(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, float):
        assert abs(a - b) <= 1e-9, (a, b)
    else:
        assert a == b


def test_ledger_and_accounting_equal_the_reference():
    _, records = _run_records()
    ours = goodput.ledger_from_records(records)
    ref = ref_goodput.ledger_from_records(records)
    assert ours.to_json() == ref.to_json()
    for wall in (None, 12.0):
        acc = goodput.account(ours, wall_s=wall)
        want = ref_goodput.account(ref, wall_s=wall)
        _close(acc, want)
    acc, segs = goodput.classify(ours)
    _, ref_segs = ref_goodput.classify(ref)
    _close(segs, ref_segs)
    assert goodput.to_trace_events(segs) == ref_goodput.to_trace_events(
        ref_segs)
    assert goodput.render(acc) == ref_goodput.render(
        ref_goodput.account(ref))
    assert acc["steps"] == {"completed": 8, "replayed": 2}
    assert acc["lost_s"]["preempt_drain"] == 1.5


def test_publish_sets_the_reference_gauges():
    _, records = _run_records()
    regs = []
    for mod, o in ((goodput, obs), (ref_goodput, ref_obs)):
        reg = o.MetricRegistry()
        mod.publish(mod.account(mod.ledger_from_records(records)), reg)
        regs.append(reg.to_records())
    assert regs[0] == regs[1]
    assert any(r["name"] == "goodput/ratio" for r in regs[0])


def _dump_run(tmp_path):
    reg, _ = _run_records()
    d = tmp_path / "run"
    d.mkdir()
    reg.dump(str(d / "metrics.jsonl"))
    tracer = obs.SpanTracer()
    for name in ("step", "tp/allreduce"):
        tracer.begin(name)
    tracer.end()
    tracer.end()
    rec = obs.FlightRecorder(directory=str(d), tracer=tracer,
                             registry=reg, signals=())
    rec.step_started(3)
    rec.dump(reason="step 3 stalled: 9s > threshold 1s", kind="stall")
    tracer.save(str(d / "spans.json"))
    return d


def test_ledgers_from_a_dump_directory_match(tmp_path):
    d = _dump_run(tmp_path)
    out = []
    for mod in (goodput, ref_goodput):
        ledger = mod.RunLedger()
        ledger.ingest_metrics(str(d / "metrics.jsonl"))
        ledger.ingest_record_dir(str(d))
        ledger.ingest_span_dump(str(d / "spans.json"))
        out.append(ledger)
    a, b = (json.loads(x.to_json()) for x in out)
    assert a == b
    assert any(iv["kind"] == "stall" for iv in a["intervals"])
    path = tmp_path / "ledger.json"
    out[0].save(str(path))
    assert ref_goodput.RunLedger.load(str(path)).to_json() == \
        path.read_text()


CLI_CASES = [
    ["report", "{d}/metrics.jsonl"],
    ["report", "{d}/metrics.jsonl", "--events", "0"],
    ["report", "{d}/metrics.jsonl", "--json"],
    ["goodput", "{d}/metrics.jsonl"],
    ["goodput", "{d}/metrics.jsonl", "--wall", "20", "--json"],
    ["goodput", "{d}"],
    ["report", "{d}/missing.jsonl"],
]


@pytest.mark.parametrize("argv", CLI_CASES, ids=lambda a: " ".join(a[:1] + a[2:]))
def test_cli_prints_what_the_reference_prints(tmp_path, capsys, argv):
    d = _dump_run(tmp_path)
    argv = [a.format(d=d) for a in argv]
    rc = cli.main(argv)
    ours = capsys.readouterr()
    ref_rc = ref_cli.main(argv)
    ref = capsys.readouterr()
    assert rc == ref_rc
    assert ours.out == ref.out
    assert bool(ours.err) == bool(ref.err)


@pytest.mark.parametrize("dump", ["spans.json", "flightrec"])
def test_trace_export_equals_the_reference(tmp_path, capsys, dump):
    d = _dump_run(tmp_path)
    src = str(d / dump) if dump == "spans.json" else str(
        next(d.glob("flightrec_*.json")))
    assert cli.main(["trace", src, "--out", str(tmp_path / "a.json")]) == 0
    assert ref_cli.main(["trace", src, "--out",
                         str(tmp_path / "b.json")]) == 0
    assert json.load(open(tmp_path / "a.json")) == json.load(
        open(tmp_path / "b.json"))


def test_unported_commands_exit_with_a_message(tmp_path, capsys,
                                               monkeypatch):
    import torch

    # an empty directory: no shard (1, as the reference), no trace (2)
    assert cli.main(["fleet", str(tmp_path)]) == 1
    assert "no fleet shards found" in capsys.readouterr().err
    assert cli.main(["trace", str(tmp_path)]) == 2
    assert "no torch.profiler trace" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["memory"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
