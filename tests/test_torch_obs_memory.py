"""The memory tier against the JAX package's: OOM classification and the
parse of PyTorch's CUDA out-of-memory messages, the ``memrec_*.json``
and snapshot schemas (CPU tensors stand in for the card's), the resilient
loop's OOM verdict on ``TrainAborted``, and the serving page budget
taking an attached monitor's watermark.
"""

import json
import os

import pytest
import torch

from apex_tpu.observability.memory import hbm as ref_hbm
from apex_tpu.observability.memory import oom as ref_oom
from apex_tpu_torch import observability as obs
from apex_tpu_torch.observability.memory import hbm, oom

GIB, MIB = 1 << 30, 1 << 20

# PyTorch's CUDA caching allocator's messages, as it formats them
# (c10/cuda/CUDACachingAllocator.cpp, format_size: bytes/KiB/MiB/GiB)
MESSAGES = [
    ("CUDA out of memory. Tried to allocate 81.00 GiB. GPU 0 has a total "
     "capacity of 79.19 GiB of which 78.54 GiB is free. Process 4242 has "
     "654.00 MiB memory in use. Of the allocated memory 0 bytes is "
     "allocated by PyTorch, and 0 bytes is reserved by PyTorch but "
     "unallocated. If reserved but unallocated memory is large try "
     "setting PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True to avoid "
     "fragmentation.  See documentation for Memory Management  "
     "(https://pytorch.org/docs/stable/notes/cuda.html#environment-"
     "variables)",
     81 * GIB, int(79.19 * GIB), int(78.54 * GIB)),
    ("CUDA out of memory. Tried to allocate 20.00 MiB. GPU 0 has a total "
     "capacity of 79.10 GiB of which 0 bytes is free. Including non-"
     "PyTorch memory, this process has 79.08 GiB memory in use. Of the "
     "allocated memory 78.54 GiB is allocated by PyTorch, and 57.26 MiB "
     "is reserved by PyTorch but unallocated.",
     20 * MIB, int(79.10 * GIB), 0),
    ("CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 15.78 GiB "
     "total capacity; 14.56 GiB already allocated; 3.44 MiB free; 14.73 "
     "GiB reserved in total by PyTorch) If reserved memory is >> "
     "allocated memory try setting max_split_size_mb to avoid "
     "fragmentation.",
     2 * GIB, int(15.78 * GIB), int(3.44 * MIB)),
]


@pytest.mark.parametrize("text,requested,capacity,free", MESSAGES)
def test_parse_pytorch_oom_messages(text, requested, capacity, free):
    got = oom.parse_resource_exhausted(text)
    assert got["matched"]
    assert (got["requested_bytes"], got["limit_bytes"],
            got["free_bytes"]) == (requested, capacity, free)
    assert set(got) == set(ref_oom.parse_resource_exhausted(text))
    assert oom.is_oom_error(RuntimeError(text))


def test_reference_messages_parse_alike():
    """The reference's own RESOURCE_EXHAUSTED formats (its chaos ``oom``
    fault among them) parse to the reference's figures."""
    texts = [
        "RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
        "1073741824 bytes. (injected oom fault at step 3)",
        "RESOURCE_EXHAUSTED: XLA:TPU compile permanent error. Ran out of "
        "memory in memory space hbm. Used 19.46G of 15.48G hbm. Exceeded "
        "hbm capacity by 3.98G.\n\nTotal hbm usage >= 19.98G:\n"
        "    reserved        530.00M \n    program          18.93G \n"
        "    arguments            0B \n\nLargest program allocations in "
        "hbm:\n\n  1. Size: 2.50G\n     Operator: op_name=\"jit(f)/dot\"\n"
        "  2. Size: 1.00G\n",
        "Attempting to allocate 1.17G. That was not possible. There are "
        "512.00M free.",
        "some other failure",
    ]
    for text in texts:
        assert oom.parse_resource_exhausted(text) == \
            ref_oom.parse_resource_exhausted(text)
        assert oom.is_oom_error(text) == ref_oom.is_oom_error(text)


def test_is_oom_error_classifies_torch_errors():
    assert oom.is_oom_error(torch.OutOfMemoryError("anything"))
    assert oom.is_oom_error(torch.cuda.OutOfMemoryError("x"))
    assert oom.is_oom_error(RuntimeError("CUDA error: out of memory"))
    for exc in (RuntimeError("shape mismatch"), ValueError("bad value"),
                KeyError("k"), TypeError("CUDA error: an illegal memory "
                                         "access was encountered")):
        assert not oom.is_oom_error(exc)


def test_device_reads_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: obs.MemoryMonitor(), hbm.device_memory_stats,
                 hbm.memory_snapshot, hbm.live_buffer_records):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert hbm.device_memory_stats("cpu") == {}  # absence, not zeros


def test_snapshot_schema_and_live_walk_on_cpu_tensors():
    big = torch.zeros(1 << 20, dtype=torch.float32)  # 4 MiB
    view = big[: 1 << 10]  # the same storage: counted once
    snap = hbm.memory_snapshot(top_k=3, device="cpu")
    assert set(snap) == set(ref_hbm.memory_snapshot(top_k=3))
    assert snap["memory_stats"] is None
    recs = hbm.live_buffer_records(device="cpu")
    assert set(recs[0]) == {"shape", "dtype", "nbytes", "devices",
                            "per_device"}
    mine = [r for r in recs if r["nbytes"] == big.untyped_storage().nbytes()
            and r["dtype"] == "float32" and r["shape"] in ([1 << 20],
                                                           [1 << 10])]
    assert len(mine) >= 1
    assert snap["live_bytes"] >= big.untyped_storage().nbytes()
    assert snap["per_device"] == {"cpu": snap["live_bytes"]}
    del view


def test_monitor_and_memrec_schema(tmp_path, monkeypatch):
    monkeypatch.setenv("APEX_TPU_FLIGHT_DIR", str(tmp_path))
    reg = obs.MetricRegistry()
    prev = hbm.active_monitor()
    try:
        mon = obs.MemoryMonitor("m", every=2, registry=reg, device="cpu")
        keep = torch.ones(1 << 18)
        assert mon.observe(1) is None
        snap = mon.observe(2)
        assert snap["watermark_bytes"] >= keep.nbytes
        assert mon.watermark_step == 2 and hbm.active_monitor() is mon
        assert {m.name for m in reg.metrics()} >= {
            "memory/snapshots", "memory/live_bytes",
            "memory/watermark_bytes", "memory/snapshot_pass"}
        path = oom.dump_memrec(MESSAGES[0][0], monitor=mon, registry=reg,
                               step=5)
        with open(path) as f:
            payload = json.load(f)
        ref_path = ref_oom.dump_memrec(MESSAGES[0][0],
                                       directory=str(tmp_path / "ref"),
                                       step=5)
        with open(ref_path) as f:
            ref_payload = json.load(f)
        assert set(payload) == set(ref_payload)
        assert payload["kind"] == "apex_tpu.memory_record"
        assert payload["oom"]["requested_bytes"] == 81 * GIB
        assert payload["monitor"]["watermark_bytes"] == mon.watermark_bytes
        assert payload["compiled"] is None
        dumped = mon.dump(str(tmp_path / "mon.json"))
        assert json.load(open(dumped))["kind"] == "apex_tpu.memory_record"
        section = hbm.flight_section()
        assert section["watermark_bytes"] == mon.watermark_bytes
        del keep
    finally:
        hbm.set_active_monitor(prev)


def test_loop_oom_ends_in_train_aborted_with_the_verdict(tmp_path):
    from apex_tpu_torch.resilience import ResilientTrainLoop, TrainAborted

    text = MESSAGES[0][0]
    prev = hbm.active_monitor()
    try:
        mon = obs.MemoryMonitor("loop", device="cpu",
                                registry=obs.MetricRegistry())
        keep = torch.ones(1 << 16)  # a live tensor for the walk to see
        mon.observe(0)

        def step_fn(state, step):
            if step == 1:
                raise torch.OutOfMemoryError(text)
            return state, {"loss": 1.0}

        reg = obs.MetricRegistry()
        loop = ResilientTrainLoop(step_fn, directory=str(tmp_path),
                                  save_every=1, max_rollbacks=1,
                                  registry=reg, memory_monitor=mon)
        with pytest.raises(TrainAborted) as ei:
            loop.run({"w": torch.zeros(3)}, 3)
        del keep
    finally:
        hbm.set_active_monitor(prev)
    verdict = ei.value.report["memory"]
    want = ref_oom.oom_forensics(text, directory=str(tmp_path / "ref"))
    assert set(verdict) == set(want)
    assert verdict["requested_bytes"] == 81 * GIB
    assert verdict["limit_bytes"] == int(79.19 * GIB)
    assert verdict["watermark_bytes"] == mon.watermark_bytes > 0
    assert verdict["largest_buffer"]["nbytes"] > 0
    assert os.path.basename(verdict["memrec"]).startswith("memrec_")
    names = [e["name"] for e in reg.events()]
    assert "memory_verdict" in names and "memory_record" in names
    assert reg.counter("memory/oom_probes").value == 2
    # a failure that is not an OOM gets no verdict
    loop2 = ResilientTrainLoop(
        lambda s, i: (_ for _ in ()).throw(ValueError("bad")),
        max_rollbacks=0, registry=obs.MetricRegistry())
    with pytest.raises(TrainAborted) as ei:
        loop2.run({"w": torch.zeros(1)}, 1)
    assert "memory" not in ei.value.report


def test_page_budget_takes_an_attached_monitors_watermark(monkeypatch):
    from apex_tpu_torch.models import llama
    from apex_tpu_torch.serving import derive_page_budget, page_hbm_bytes

    cfg = llama.tiny()
    page = page_hbm_bytes(cfg, 8)
    monkeypatch.setenv("APEX_TPU_HBM_BYTES", str(page * 10_000))
    prev = hbm.set_active_monitor(None)
    try:
        # none attached: the bytes in use (0 on the CPU's override)
        plain = derive_page_budget(cfg, 8, device="cpu")
        assert plain.watermark_bytes == 0
        mon = obs.MemoryMonitor(device="cpu",
                                registry=obs.MetricRegistry())
        keep = torch.ones(1 << 16)  # a live tensor for the walk to see
        mon.observe(0)
        got = derive_page_budget(cfg, 8, device="cpu")
        assert got.watermark_bytes == mon.watermark_bytes > 0
        assert got.pages < plain.pages
        # an explicit watermark still wins
        assert derive_page_budget(cfg, 8, watermark_bytes=0,
                                  device="cpu").pages == plain.pages
        del keep
    finally:
        hbm.set_active_monitor(prev)
