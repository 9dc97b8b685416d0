"""``python -m apex_tpu_torch.tuning``: one-shot offline tune-all.

    python -m apex_tpu_torch.tuning                 # sweep every kernel,
                                                    # write + print the cache
    python -m apex_tpu_torch.tuning --kernel flat_adam
    python -m apex_tpu_torch.tuning --export TUNING_CACHE.json
    python -m apex_tpu_torch.tuning --json          # machine-readable

On a machine with a CUDA device every candidate races on the card;
elsewhere the deterministic roofline ranks them (entries keyed ``"cpu"``,
``source: "roofline"``). ``APEX_TPU_TUNING_CACHE`` names the cache file.
Exit 0 when every requested kernel tuned, 1 when any sweep failed.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys

from apex_tpu_torch.tuning import cache, search_space, tuner


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m apex_tpu_torch.tuning",
        description="apex_tpu_torch kernel launch-plan tuner (offline "
                    "tune-all)")
    ap.add_argument("--kernel", action="append", default=[],
                    choices=list(search_space.KERNELS),
                    help="tune only these kernels (repeatable; "
                         "default: all)")
    ap.add_argument("--export", default=None, metavar="PATH",
                    help="also copy the written cache to PATH")
    ap.add_argument("--no-write", dest="write", action="store_false",
                    help="sweep and report without touching the cache")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    results = tuner.tune_all(kernels=args.kernel or None, write=args.write)

    path = cache.cache_path()
    if args.export and args.write:
        shutil.copyfile(path, args.export)
        print(f"exported tuning cache to {args.export}", file=sys.stderr)

    failed = [r for r in results if "error" in r]
    if args.json:
        print(json.dumps({"cache_path": path if args.write else None,
                          "results": results}, indent=1))
    else:
        for r in results:
            if "error" in r:
                print(f"{r['kernel']}: ERROR {r['error']}")
            else:
                e = r["entry"]
                print(f"{r['kernel']:22s} {r['bucket']:28s} "
                      f"{json.dumps(e['params'])} "
                      f"kernel {e['kernel_ms']} ms / plain {e['plain_ms']} "
                      f"ms -> {'kernel' if e['use_kernel'] else 'plain'}"
                      f" [{e['source']}]")
        if args.write:
            print(f"cache: {path}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
