"""Per-op attribution report from a ``torch.profiler`` trace (the port of
``tools/trace_report.py``, with its flags and output).

    python -m apex_tpu_torch.pyprof TRACE [--top 30] [--json out.json]
        [--peak-tflops T] [--peak-hbm-gbps B]

``TRACE`` is a Chrome-trace JSON (``.json`` or ``.json.gz``) or a
directory of ``*.pt.trace.json`` files (the newest is read), as
:func:`apex_tpu_torch.pyprof.stop` or ``tensorboard_trace_handler``
write them. The report prints per-op, per-category and per-phase
exclusive time (:mod:`apex_tpu_torch.observability.profiling.xplane`),
and MFU when the records carry flops. The peaks default to one H100 SXM
(``PEAK_FLOPS_BY_KIND``'s 989 bf16 TFLOP/s, 3,350 GB/s of HBM). Bytes
and HBM utilization are reported only where the trace measured them (a
copy or a fill; a kernel carries none). For a Perfetto-loadable view:
``python -m apex_tpu_torch.observability trace TRACE``.
"""

from __future__ import annotations

import argparse
import json
import sys

from apex_tpu_torch.observability.step_report import peak_flops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m apex_tpu_torch.pyprof")
    ap.add_argument("logdir", help="trace .json(.gz) or a directory of "
                                   "*.pt.trace.json files")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--peak-tflops", type=float,
                    default=peak_flops("h100") / 1e12,
                    help="card peak for MFU (default: H100 bf16)")
    ap.add_argument("--peak-hbm-gbps", type=float, default=3350.0)
    ap.add_argument("--json", default="",
                    help="also write the full report as JSON")
    args = ap.parse_args(argv)

    from apex_tpu_torch.observability.profiling.xplane import (
        attribute_report,
    )
    from apex_tpu_torch.pyprof.prof import Report

    try:
        report = Report.from_capture(args.logdir)
    except (OSError, ValueError) as e:
        print(f"cannot read {args.logdir}: {e}", file=sys.stderr)
        return 2
    if not report.ops:
        print("no op events in the trace", file=sys.stderr)
        return 1
    print(report.format_table(top=args.top))

    attribution = attribute_report(report)
    print(f"\n{'phase':<16} {'self ms':>10} {'share':>7}")
    for ph, rec in attribution.phases.items():
        print(f"{ph:<16} {rec['self_us'] / 1e3:>10.3f} "
              f"{rec['share'] * 100:>6.1f}%")
    eff = attribution.overlap_efficiency()
    if eff is not None:
        print(f"compute<->comms overlap efficiency: {eff:.2f}")

    has_flops = any(o.flops for o in report.ops)
    if has_flops:
        util = report.utilization(args.peak_tflops, args.peak_hbm_gbps)
        line = (f"\nbusy {util['busy_s'] * 1e3:.2f} ms   "
                f"{util['total_flops'] / 1e9:.2f} GFLOP   "
                f"MFU {util['mfu'] * 100:.1f}%")
        # hbm_util is only present when the trace MEASURED bytes
        if "hbm_util" in util:
            line += f"   HBM util {util['hbm_util'] * 100:.1f}%"
        print(line)
    else:
        print("\n(no per-op flops in this trace: a torch.profiler trace "
              "measures kernel time, not flops)")

    if args.json:
        payload = report.to_dict()
        payload["attribution"] = attribution.to_dict()
        if has_flops:
            payload["utilization"] = report.utilization(
                args.peak_tflops, args.peak_hbm_gbps)
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
