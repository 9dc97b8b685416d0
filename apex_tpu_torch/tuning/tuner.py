"""Launch-plan sweep tuner: race every candidate, persist the winners
(counterpart of ``apex_tpu/tuning/tuner.py``).

``tune_kernel`` sweeps one kernel's search space at one shape, races the
best candidate against the plain version and writes the result into the
persistent cache: the plan, and the race's verdict as a record
(``use_kernel``; it changes no dispatch). ``tune_all`` is the offline
tune-everything entry point behind ``python -m apex_tpu_torch.tuning``.

Telemetry: every race ticks ``tuning/race_won_kernel`` or
``tuning/race_won_plain`` (labelled by kernel) and sets the
``tuning/best_kernel_ms`` and ``tuning/plain_ms`` gauges; a candidate
that fails ticks ``tuning/candidate_error``; each result is a
``tuning_result`` event.
"""

from __future__ import annotations

import sys

from apex_tpu_torch.tuning import cache, measure, search_space

# Default sweep shapes: the port's own paths at full width, each the
# shape of a row of PERF.md's kernel table.
DEFAULT_SHAPES = {
    # row 8: GPT-2 345M's 12-layer DDP slab, fp32 g, m, v and bf16 p
    "flat_adam": {"n": 203716608},
    # row 6: GPT-2 345M's LayerNorm, 8 x 1024 tokens of 1024, bf16
    "layer_norm": {"rows": 8192, "h": 1024},
    # row 4: Llama-3-8B's RMSNorm, 2 x 2048 tokens of 4096, bf16
    "rms_norm": {"rows": 4096, "h": 4096},
    # rows 12-13: the long-context causal softmax [1, 16, 2048, 32768]
    "fused_softmax": {"rows": 16 * 2048, "sq": 2048, "sk": 32768},
    # row 9: Llama-3-8B's gate weight 4096 x 14336, bf16, row-major
    "fp8_cast": {"n": 4096 * 14336},
}

def _registry(registry=None):
    if registry is not None:
        return registry
    from apex_tpu_torch.observability import get_registry

    return get_registry()


def tune_kernel(kernel, dims=None, *, live=None, cache_dict=None,
                write=True, registry=None, log=None):
    """Sweep ``kernel`` at ``dims`` (default :data:`DEFAULT_SHAPES`);
    returns the result record (the entry, the ranking, the default
    plan's ms).

    ``live=None`` races on the card when there is one, else ranks by the
    roofline. ``cache_dict`` accumulates results across calls
    (``tune_all``); with ``write`` the cache file is saved."""
    if kernel not in search_space.KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}; valid: "
                         f"{list(search_space.KERNELS)}")
    dims = dict(DEFAULT_SHAPES[kernel] if dims is None else dims)
    if live is None:
        live = measure.backend_is_cuda()
    reg = _registry(registry)
    log = log or (lambda msg: print(msg, file=sys.stderr))

    # one set of inputs for the whole sweep (the flat Adam's is ~3 GB)
    runner = measure.live_runner(kernel, dims) if live else None
    ranked = []
    for params in search_space.candidates(kernel, **dims):
        try:
            t = measure.measure(kernel, params, dims, live=live,
                                runner=runner)
        except Exception as e:  # noqa: BLE001 - a plan the kernel
            # refuses must not end the sweep; it just cannot win
            log(f"tune {kernel} {params}: FAILED {repr(e)[:120]}")
            reg.counter("tuning/candidate_error", kernel=kernel).inc()
            continue
        ranked.append((t, sorted(params.items())))
        log(f"tune {kernel} {params}: {t * 1e3:.4f} ms")
    if not ranked:
        raise RuntimeError(f"every {kernel} candidate failed to measure")
    ranked.sort()  # (time, params): a deterministic tie-break on params
    best_t, best_params = ranked[0][0], dict(ranked[0][1])
    plain_t = measure.measure_plain(kernel, dims, live=live, runner=runner)

    won = best_t <= plain_t
    reg.counter("tuning/race_won_kernel" if won else "tuning/race_won_plain",
                kernel=kernel).inc()
    bucket = search_space.shape_bucket(kernel, **dims)
    reg.gauge("tuning/best_kernel_ms", kernel=kernel,
              bucket=bucket).set(round(best_t * 1e3, 6))
    reg.gauge("tuning/plain_ms", kernel=kernel,
              bucket=bucket).set(round(plain_t * 1e3, 6))
    entry = {
        "params": best_params,
        "kernel_ms": round(best_t * 1e3, 6),
        "plain_ms": round(plain_t * 1e3, 6),
        "use_kernel": bool(won),
        "source": "measured" if live else "roofline",
        "dims": dims,
    }
    device_kind = cache.current_device_kind() if live else "cpu"
    reg.event("tuning_result", kernel=kernel, bucket=bucket,
              device_kind=device_kind, **{
                  k: v for k, v in entry.items() if k != "dims"})
    log(f"tune {kernel}: best {best_params} kernel {best_t * 1e3:.4f} ms "
        f"vs plain {plain_t * 1e3:.4f} ms -> "
        f"{'kernel' if won else 'plain'} [{entry['source']}]")

    default = search_space.default_params(kernel, **dims)
    ranking = [(round(t * 1e3, 6), dict(p)) for t, p in ranked]
    result = {"kernel": kernel, "bucket": bucket,
              "device_kind": device_kind, "entry": entry,
              "default_params": default,
              "default_ms": next((ms for ms, p in ranking if p == default),
                                 None),
              "ranking": ranking}
    if cache_dict is not None:
        cache.put(cache_dict, device_kind, kernel, bucket, entry)
    if write:
        # merge into the file as it is now: saving a bare accumulator
        # would drop what another device or run measured
        target = cache.load()
        if cache_dict is not None:
            cache.merge(target, cache_dict)
        else:
            cache.put(target, device_kind, kernel, bucket, entry)
        path = cache.save(target)
        result["cache_path"] = path
    return result


def tune_all(shapes=None, *, kernels=None, live=None, write=True,
             registry=None, log=None):
    """Sweep every kernel, or just ``kernels``, with ``shapes``
    overriding their dims, and save one merged cache at the end. A
    kernel whose sweep fails is recorded (``"error"``), not fatal."""
    shapes = shapes or {}
    acc = cache.load()
    results = []
    for kernel in (kernels or search_space.KERNELS):
        try:
            results.append(tune_kernel(
                kernel, shapes.get(kernel), live=live, cache_dict=acc,
                write=False, registry=registry, log=log))
        except Exception as e:  # noqa: BLE001 - report every kernel
            results.append({"kernel": kernel, "error": repr(e)[:200]})
    if write:
        path = cache.save(cache.merge(cache.load(), acc))
        for r in results:
            r["cache_path"] = path
    return results
