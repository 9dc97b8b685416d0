"""Time the row-norm forward kernel under candidate launch plans on one GPU.

    python norm_plan_sweep.py [--iters 20]

For each shape the paths run (LayerNorm at GPT-2's 8192 x 1024 and BERT's
4096 x 768; RMSNorm at Llama's 4096 x 4096, serving's 512-token prefill
512 x 4096 and its decode step 8 x 4096; bf16 x with bf16 params) every
candidate plan of ``apex_tpu_torch.tuning.search_space`` (the tuner's own
enumeration: a power of two of threads a row from the fewest that hold
the row at 4 vectors a thread to a vector a thread, rows a block up to 512
threads, and block counts from all the row groups down to a quarter of
1056) is run once against the plain version through the real dispatch
path (``tuning.geometry.override``) and timed by ``chip_smoke.time_ms``
(device ms, inputs rotated past the L2). One JSON line a shape lists the
plans fastest first beside ``_fwd_plan``'s choice; the first line is the
card's ``nvidia-smi`` line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = ((8192, 1024, True), (4096, 768, True), (4096, 4096, False),
          (512, 4096, False), (8, 4096, False))


def plans(rows: int, h: int, centred: bool) -> list:
    """The tuner's candidate plans (params dicts) for bf16 rows of h."""
    from apex_tpu_torch.tuning import search_space

    kernel = "layer_norm" if centred else "rms_norm"
    return search_space.candidates(kernel, rows=rows, h=h)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from apex_tpu_torch.ops import layer_norm as ln
    from apex_tpu_torch.tuning import geometry

    if not torch.cuda.is_available():
        print("norm_plan_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for rows, h, centred in SHAPES:
        w = (1 + 0.1 * torch.randn(h, generator=g, device="cuda")).to(
            torch.bfloat16)
        b = (0.1 * torch.randn(h, generator=g, device="cuda")).to(
            torch.bfloat16) if centred else None
        sets = [(a,) for a in cs.copies(
            lambda: torch.randn(rows, h, generator=g, device="cuda").to(
                torch.bfloat16), 2 * rows * h * 2)]

        def call(x):
            return ln._norm_fwd_cuda(x, w, b, 1e-5, centred)

        ref = (ln._ln_fwd_plain(sets[0][0], w, b, 1e-5)[0] if centred
               else ln._rms_fwd_plain(sets[0][0], w, 1e-5)[0])
        kernel = "layer_norm" if centred else "rms_norm"
        timed = []
        for plan in plans(rows, h, centred):
            with geometry.override(kernel, plan):
                cs.max_err(call(sets[0][0])[0], ref, 8e-3, f"plan {plan}")
                timed.append((cs.time_ms(call, sets, args.iters), plan))
        timed.sort(key=lambda t: t[0])
        print(json.dumps({
            "shape": [rows, h], "norm": "layer" if centred else "rms",
            "chosen": ln._fwd_plan(rows, h, torch.bfloat16)._asdict(),
            "chosen_ms": cs.time_ms(call, sets, args.iters),
            "plans": [dict(p, ms=ms) for ms, p in timed]}),
            flush=True)
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
