"""The port's trace analysis (``apex_tpu_torch.pyprof`` and
``observability.profiling.xplane``) held against the JAX package's.

The reference reads ``jax.profiler`` xplane captures; the port reads
``torch.profiler`` traces. What both share is held exactly: the
classification of every HLO name the reference's own tests use, and the
report and the phase attribution built from the same ``OpRecord`` lists
(numpy-seeded; sums and rounding are the same Python arithmetic, bytes
and flops None where no record measured them). The torch side is
exercised on a Chrome trace this file writes (kernels, copies, fills,
``ProfilerStep`` markers, as a CUDA capture carries them) and on one
CPU-only ``torch.profiler`` capture through ``pyprof.start/stop``. The
reference's own capture tests fail under jax 0.9.0 and are no oracle.
"""

import gzip
import json
import os

import numpy as np
import pytest
import torch

from apex_tpu.observability.profiling import step_phases as ref_phases
from apex_tpu.observability.profiling import xplane as ref_xplane
from apex_tpu.pyprof import parse as ref_parse
from apex_tpu.pyprof import prof as ref_prof
from apex_tpu_torch import pyprof
from apex_tpu_torch.observability import cli
from apex_tpu_torch.observability.profiling import (
    get_tracer,
    step_phases,
    xplane,
)
from apex_tpu_torch.pyprof import __main__ as pyprof_main
from apex_tpu_torch.pyprof import parse, prof

# every name of the reference's test_classify_categories and
# test_short_name_and_tpu_classify
HLO_NAMES = [
    "all-reduce.1", "psum_invariant.7", "ppermute.2", "dot_general.3",
    "convolution.4", "copy.16", "wrapped_reduce.2", "add_rsqrt_fusion",
    "fused_adam_custom-call", "custom-call.3", "flash_fwd_custom-call",
    "while.5", "dot.1", "%slice-start.73 = (...) async-start(...)",
    "fusion.2", "%dot.1 = bf16[8,8]{1,0} dot(...)",
    "%convolution_add_fusion.4 = ...",
]


@pytest.mark.parametrize("name", HLO_NAMES)
def test_hlo_names_classify_as_the_reference(name):
    assert parse.classify(name) == ref_parse.classify(name)
    assert parse.short_name(name) == ref_parse.short_name(name)
    assert parse.is_container(name) == ref_parse.is_container(name)


FLASH = "void tc::flash_fwd_tc_kernel<128, false>(tc::Params)"
CUDA_NAMES = [
    (FLASH, "attention-kernel"),
    ("void tc::flash_bwd_dq_tc_kernel<128, true>(tc::Params)",
     "attention-kernel"),
    ("void tc::flash_bwd_dkv_tc_kernel<128, false>(tc::Params)",
     "attention-kernel"),
    ("void (anonymous namespace)::flash_fwd_fp32_kernel<128>((anonymous "
     "namespace)::Params)", "attention-kernel"),
    ("void row_norm::fwd_rows_kernel<false, __nv_bfloat16, "
     "__nv_bfloat16>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16*, float*, float*, int, int, "
     "float)", "custom-kernel"),
    ("void row_norm::bwd_rows_kernel<false, __nv_bfloat16, "
     "__nv_bfloat16>(__nv_bfloat16 const*)", "custom-kernel"),
    ("void row_norm::column_sum_kernel<__nv_bfloat16>(float const*, "
     "__nv_bfloat16*, int, int)", "custom-kernel"),
    ("void (anonymous namespace)::adam_kernel<__nv_bfloat16, true>(float "
     "const*, __nv_bfloat16 const*, float const*, float const*)",
     "custom-kernel"),
    ("void (anonymous namespace)::cast_scale_t_kernel<__nv_bfloat16, "
     "(__nv_fp8_interpretation_t)0>(__nv_bfloat16 const*)",
     "custom-kernel"),
    ("void (anonymous namespace)::softmax_stats_kernel<__nv_bfloat16, 8, "
     "true>(__nv_bfloat16 const*)", "custom-kernel"),
    # ATen kernels of similar names: never the port's
    ("void at::native::(anonymous namespace)::adam_kernel<float>(float*)",
     "fusion-elementwise"),
    ("void at::native::fwd_kernel<float>(float*)", "fusion-elementwise"),
    ("void at::native::(anonymous namespace)::softmax_warp_forward<float, "
     "float, float, 10, false, false>(float*, float const*, int, int, "
     "int, bool const*, int, bool)", "fusion-elementwise"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256x64_"
     "warpgroupsize2x1x1_execute_segment_k_off_kernel__5x_cublas",
     "matmul"),
    ("nvjet_tst_192x192_64x4_2x1_v_bz_coopA_TNT", "matmul"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_"
     "16x16_128x2_tn_align8>(cutlass_80_wmma_tensorop_bf16_s161616gemm_"
     "bf16_16x16_128x2_tn_align8::Params)", "matmul"),
    ("ampere_bf16_s16816gemm_bf16_128x256_ldg8_f2f_stages_64x3_tn",
     "matmul"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
     "tilesize128x128x64_warpgroupsize1x1x1_g1_execute_segment_k_off_"
     "kernel__5x_cudnn", "convolution"),
    ("ncclDevKernel_AllReduce_Sum_bf16_RING_LL(ncclDevKernelArgsStorage"
     "<4096ul>)", "collective"),
    ("Memcpy HtoD (Pageable -> Device)", "host-transfer"),
    ("Memcpy DtoH (Device -> Pinned)", "host-transfer"),
    ("Memcpy DtoD (Device -> Device)", "data-movement"),
    ("Memset (Device)", "data-movement"),
    ("void at::native::index_elementwise_kernel<128, 4, "
     "at::native::gpu_index_kernel<...>(at::TensorIteratorBase&)::"
     "{lambda(int)#1}>(long, at::native::gpu_index_kernel<...>)",
     "gather-scatter"),
    ("void at::native::(anonymous namespace)::distribution_elementwise_"
     "grid_stride_kernel<float, 4>(long, at::PhiloxCudaState, float)",
     "rng"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::MeanOps<float, float, float, float>, unsigned int, "
     "float, 4> >(at::native::ReduceOp<float>)", "reduction"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::FillFunctor<float>, at::detail::Array<char*, 1> >(int, "
     "at::native::FillFunctor<float>, at::detail::Array<char*, 1>)",
     "fusion-elementwise"),
    ("aten::mm", "matmul"), ("aten::sum", "reduction"),
    ("aten::copy_", "data-movement"), ("aten::add", "fusion-elementwise"),
]


@pytest.mark.parametrize("name,category", CUDA_NAMES)
def test_cuda_name_families(name, category):
    assert parse.classify(name) == category


@pytest.mark.parametrize("name,category", CUDA_NAMES)
def test_port_kernel_reads_the_port_kernels_alone(name, category):
    """``port_kernel`` names exactly the kernels ``classify`` sends to
    the port's categories by ``PORT_KERNELS``, with the identifier and
    the template arguments of the name."""
    hit = parse.port_kernel(name)
    ours = name.startswith(("void tc::", "void row_norm::",
                            "void (anonymous namespace)::"))
    assert (hit is not None) == ours
    if ours:
        ident, args = hit
        assert category in ("attention-kernel", "custom-kernel")
        assert f"::{ident}<{', '.join(args)}>(" in name


def test_short_name_keeps_namespace_and_template_drops_params():
    assert parse.short_name(FLASH) == "tc::flash_fwd_tc_kernel<128, false>"
    assert parse.short_name(
        "void (anonymous namespace)::adam_kernel<float, true>(float*)") \
        == "(anonymous namespace)::adam_kernel<float, true>"
    assert parse.short_name("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD (Pageable -> Device)"


# ------------------------------------------ reports on the same records

def _records(seed, device: bool):
    """(port records, reference records) with the same fields."""
    rng = np.random.default_rng(seed)
    names = ["dot.1", "fusion.2", "all-reduce.3", "custom-call.4",
             "flash_fwd_custom-call", "gather.5", "copy.6", "while.7",
             "reduce.8"]
    rows = []
    for _ in range(40):
        name = names[rng.integers(len(names))]
        if device:
            plane = "/device:TPU:0"
            line = ["XLA Ops", "XLA Ops", "XLA Ops", "Async XLA Ops",
                    "Steps"][rng.integers(5)]
        else:
            plane, line = "/host:CPU", "thread 3"
        dur = int(rng.integers(1, 10_000)) * 1_000
        measured = device and rng.random() < 0.7
        rows.append(dict(
            name=name, program=["jit_step", "jit_opt"][rng.integers(2)],
            plane=plane, category=ref_parse.classify(name),
            duration_ps=dur, self_ps=dur - int(rng.integers(0, dur // 2)),
            flops=float(rng.integers(1, 1 << 30)) if measured else None,
            bytes_accessed=float(rng.integers(0, 1 << 20)) if measured
            else None, line=line))
    return ([parse.OpRecord(**r) for r in rows],
            [ref_parse.OpRecord(**r) for r in rows])


@pytest.mark.parametrize("seed,device", [(0, True), (1, True),
                                         (2, False)])
def test_report_and_attribution_equal_the_reference(seed, device):
    ours_recs, ref_recs = _records(seed, device)
    steps = [1.5e4, 1.7e4] if device else None
    ours = prof.Report.from_records(ours_recs, steps_us=steps)
    ref = ref_prof.Report.from_records(ref_recs, steps_us=steps)
    assert ours.to_dict() == ref.to_dict()
    assert ours.to_dict(top=3) == ref.to_dict(top=3)
    assert ours.by_category() == ref.by_category()
    assert ours.utilization(989.0, 3350.0) == ref.utilization(989.0, 3350.0)
    assert ours.format_table(top=5).replace("ProfilerStep markers", "") == \
        ref.format_table(top=5).replace("device wall, 'Steps' markers", "")
    a, b = xplane.attribute_report(ours), ref_xplane.attribute_report(ref)
    assert a.to_dict() == b.to_dict()
    assert a.fractions() == b.fractions()
    assert a.overlap_efficiency() == b.overlap_efficiency()
    assert step_phases.device_phase_fields(a) == \
        ref_phases.device_phase_fields(b)
    if not device:   # nothing measured bytes or flops: None, never 0.0
        for cat in ours.by_category().values():
            assert cat["bytes_accessed"] is None and cat["flops"] is None
        assert "hbm_util" not in ours.utilization(989.0, 3350.0)
    rows = [{"hlo_op_name": "fusion.2", "model_flop_rate": 12.5,
             "bound_by": "HBM"}]
    ours.merge_hlo_stats(rows)
    ref.merge_hlo_stats(rows)
    assert ours.to_dict() == ref.to_dict()
    assert prof.xprof_hlo_stats([]) is None


# --------------------------------------------------- a written trace

US = 1.0   # Chrome-trace times are microseconds


def _kernel(name, ts, dur, stream=7):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0,
            "tid": stream, "ts": ts, "dur": dur,
            "args": {"device": 0, "stream": stream, "correlation": 1}}


def _write_trace(path):
    events = [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#0",
         "pid": 900, "tid": 900, "ts": 0.0, "dur": 1000.0, "args": {}},
        {"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#1",
         "pid": 900, "tid": 900, "ts": 1000.0, "dur": 1200.0, "args": {}},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "ProfilerStep#0",
         "pid": 0, "tid": 7, "ts": 5.0, "dur": 900.0, "args": {}},
        # host ops: present beside device events, never counted then
        {"ph": "X", "cat": "cpu_op", "name": "aten::linear", "pid": 900,
         "tid": 900, "ts": 10.0, "dur": 50.0, "args": {}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 900,
         "tid": 900, "ts": 20.0, "dur": 30.0, "args": {}},
        _kernel(FLASH, 10.0, 100.0),
        _kernel(FLASH, 1010.0, 110.0),
        _kernel(CUDA_NAMES[4][0], 120.0, 20.0),
        _kernel(CUDA_NAMES[7][0], 150.0, 300.0),
        _kernel(CUDA_NAMES[13][0], 500.0, 250.0),
        _kernel(CUDA_NAMES[18][0], 600.0, 200.0, stream=13),
        _kernel(CUDA_NAMES[23][0], 760.0, 40.0),
        {"ph": "X", "cat": "gpu_memcpy", "name": CUDA_NAMES[19][0],
         "pid": 0, "tid": 7, "ts": 1, "dur": 5.0,
         "args": {"device": 0, "stream": 7, "bytes": 4096}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)",
         "pid": 0, "tid": 7, "ts": 900.0, "dur": 2.0,
         "args": {"device": 0, "stream": 7, "bytes": 512}},
    ]
    payload = {"schemaVersion": 1, "traceEvents": events}
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            json.dump(payload, f)
    else:
        with open(path, "w") as f:
            json.dump(payload, f)
    return path


@pytest.mark.parametrize("form", ["file", "gzip", "directory"])
def test_written_trace_parses_to_device_records(tmp_path, form):
    name = {"file": "t.json", "gzip": "t.pt.trace.json.gz",
            "directory": "host_1.123.pt.trace.json"}[form]
    path = _write_trace(str(tmp_path / name))
    src = str(tmp_path) if form == "directory" else path
    recs = parse.parse_trace(parse.find_trace_paths(src))
    assert len(recs) == 9   # 7 kernels, a copy, a fill; no host op
    assert all(r.plane == "/device:GPU:0" for r in recs)
    for r in recs:
        assert r.flops is None   # no record carries measured flops
        if r.line == "Kernels":
            assert r.bytes_accessed is None
            assert r.self_ps == r.duration_ps
    copy = next(r for r in recs if r.line == "Memcpy")
    assert (copy.category, copy.bytes_accessed) == ("host-transfer", 4096.0)
    assert parse.step_times_us(parse.find_trace_paths(src)) == [1000.0,
                                                               1200.0]
    report = prof.Report.from_capture(src)
    flash = next(o for o in report.ops if o.name.startswith("tc::flash"))
    assert flash.occurrences == 2 and flash.category == "attention-kernel"
    assert flash.self_us == pytest.approx(210.0)
    cats = report.by_category()
    assert cats["custom-kernel"]["occurrences"] == 2
    assert cats["matmul"]["self_us"] == pytest.approx(250.0)
    assert cats["custom-kernel"]["bytes_accessed"] is None
    assert cats["data-movement"]["bytes_accessed"] == 512.0
    att = xplane.attribute_capture(src)
    assert sum(att.fractions().values()) == pytest.approx(1.0, abs=1e-3)
    assert att.step_wall_us == 2200.0
    assert att.total_self_us <= att.step_wall_us
    assert att.phases["comms"]["occurrences"] == 2   # nccl + the H2D copy
    assert 0.0 <= att.overlap_efficiency() <= 1.0
    fields = step_phases.device_phase_fields(att)
    assert fields["device_phases"] == att.fractions()


def test_written_trace_through_the_clis(tmp_path, capsys):
    path = _write_trace(str(tmp_path / "t.pt.trace.json"))
    out = tmp_path / "perfetto.json"
    assert cli.main(["trace", path, "--out", str(out)]) == 0
    events = json.load(open(out))["traceEvents"]
    assert sum(ev["ph"] == "X" for ev in events) == 9
    assert "torch-profiler" in capsys.readouterr().out
    report_json = tmp_path / "report.json"
    assert pyprof_main.main([path, "--json", str(report_json)]) == 0
    text = capsys.readouterr().out
    assert "attention-kernel" in text and "TOTAL (exclusive)" in text
    payload = json.load(open(report_json))
    assert payload["attribution"]["steps"]["n"] == 2
    assert "utilization" not in payload   # no record carries flops
    assert pyprof_main.main([str(tmp_path / "missing")]) == 2


def test_cpu_capture_through_pyprof_start_stop(tmp_path):
    pyprof.init(trace_dir=str(tmp_path))
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    pyprof.start()
    for i in range(2):
        if i:
            pyprof.step()
        with pyprof.annotate("train/step"):
            (a @ a).sum()
    path = pyprof.stop()
    assert path and os.path.dirname(path) == str(tmp_path)
    assert parse.find_trace_paths(str(tmp_path)) == [path]
    report = prof.Report.from_capture(path)
    assert len(report.steps_us) == 2
    mm = next(o for o in report.ops if o.name == "aten::mm")
    assert (mm.occurrences, mm.category) == (2, "matmul")   # host records
    for o in report.ops:
        assert o.flops is None and o.bytes_accessed is None
        assert all(r.plane == "/host:CPU" for r in parse.parse_trace([path]))
    att = xplane.attribute_report(report)
    for rec in att.phases.values():
        assert rec["flops"] is None and rec["bytes_accessed"] is None
    assert pyprof.stop() is None   # no window open


def test_annotations_land_in_the_span_ring():
    tracer = get_tracer()
    mark = tracer.mark()
    pyprof.nvtx.range_push("outer")
    with pyprof.annotate("inner"):
        pass
    pyprof.nvtx.range_pop()
    pyprof.wrap(lambda: None, name="wrapped")()
    names = [s.name for s in tracer.completed(mark)]
    assert names == ["inner", "outer", "wrapped"]
