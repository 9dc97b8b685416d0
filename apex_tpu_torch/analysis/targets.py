"""Registered graph-engine targets (port of the single-device half of
``apex_tpu/analysis/targets.py``): the port's entry points, traced with
fake tensors at the reference targets' sizes and run through the graph,
precision and state checks. ``python -m apex_tpu_torch.analysis`` runs
them all by default, so a regression in a kernel's launch plan, a
donation, the precision discipline or the checkpointed state fails the
gate without a card.

Each target is a zero-argument callable returning a list of findings;
tracing only, no device work. Fake tensors are made on
:func:`.interp.trace_device` (the card's, or the CPU standing in for it),
so every hand-written kernel on a target's path is one node of its graph.

The reference's ``kernel-auto-provenance`` target has no counterpart:
the port pins no kernel verdict (``ops/kernel_config.py``). Its sharding,
spmd and memory targets wait for the sharding engines.
"""

from __future__ import annotations

import time

import torch

from apex_tpu_torch.analysis import interp
from apex_tpu_torch.analysis.findings import Finding
from apex_tpu_torch.analysis.graph_checks import GRAPH_CHECKS, analyze_fn
from apex_tpu_torch.analysis.precision_checks import (
    PRECISION_CHECKS,
    analyze_precision,
)
from apex_tpu_torch.analysis.state_checks import STATE_CHECKS, analyze_state

TARGETS = {}

# per-target check ids dropped at the source (@target(allow=...)) and by
# the CLI's --allow target:check
TARGET_ALLOW = {}

# check ids of targets that trace nothing
TARGET_CHECKS = ("step-record-schema",)

# check ids that need the tracing targets
TRACING_CHECKS = (tuple(GRAPH_CHECKS) + tuple(PRECISION_CHECKS)
                  + tuple(STATE_CHECKS))

# per-target carried/saved leaf counts of the last analyze_state run
STATE_STATS = {}


def target(name, allow=()):
    def deco(fn):
        TARGETS[name] = fn
        if allow:
            unknown = set(allow) - set(TRACING_CHECKS) - set(TARGET_CHECKS)
            if unknown:
                raise ValueError(
                    f"@target({name!r}) allows unknown check id(s) "
                    f"{sorted(unknown)}")
            TARGET_ALLOW[name] = frozenset(allow)
        return fn
    return deco


def _fake(make):
    """``make(device)``'s tensors, fake, on the trace device."""
    return interp.on_trace_device(make)


def _add_in_place(params, updates):
    """``_common.train_step``'s apply: each param plus its update, in
    place."""
    from apex_tpu_torch import _tree

    for p, u in zip(_tree.leaves(params), _tree.leaves(updates)):
        p.add_(u)
    return params


# ------------------------------------------------------------ graph targets

@target("fused_adam_flat_step")
def _fused_adam_flat_step():
    """The flat Adam path behind a donated train step: the kernel writes
    m and v in place and the params take their updates in place, and no
    donated buffer is read after its write."""
    from apex_tpu_torch.optimizers import fused_adam

    tx = fused_adam(lr=1e-3, weight_decay=0.01, flat=True)

    def make(dev):
        params = {"w": torch.zeros((64, 128), device=dev),
                  "b": torch.zeros((128,), device=dev)}
        grads = {k: torch.ones_like(v) for k, v in params.items()}
        return params, tx.init(params), grads

    params, state, grads = _fake(make)

    def train_step(params, opt_state, grads):
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, params)
            return _add_in_place(params, updates), opt_state

    return analyze_fn(train_step, params, state, grads,
                      donate_argnums=(0, 1), name="fused_adam_flat_step")


@target("fused_adam_flat_kernel")
def _fused_adam_flat_kernel():
    """The flat Adam kernel's launch plan (threads, blocks) on a 4096
    slab."""
    from apex_tpu_torch.optimizers import fused_adam

    tx = fused_adam(lr=1e-3, flat=True)

    def make(dev):
        params = {"w": torch.zeros((4096,), device=dev)}
        return params, tx.init(params), {"w": torch.ones((4096,),
                                                         device=dev)}

    params, state, grads = _fake(make)

    def update(g, s, p):
        with torch.no_grad():
            return tx.update(g, s, p)

    return analyze_fn(update, grads, state, params,
                      name="fused_adam_flat_kernel")


@target("flash_attention_fwd")
def _flash_attention_fwd():
    from apex_tpu_torch.ops.flash_attention import flash_attention

    q = _fake(lambda dev: torch.zeros((2, 256, 4, 64), dtype=torch.bfloat16,
                                      device=dev))
    return analyze_fn(lambda q, k, v: flash_attention(q, k, v, causal=True),
                      q, q, q, name="flash_attention_fwd")


@target("layer_norm_fwd")
def _layer_norm_fwd():
    from apex_tpu_torch.ops.layer_norm import layer_norm

    x, w, b = _fake(lambda dev: (
        torch.zeros((256, 1024), dtype=torch.bfloat16, device=dev),
        torch.ones((1024,), device=dev), torch.zeros((1024,), device=dev)))
    return analyze_fn(lambda x, w, b: layer_norm(x, w, b, (1024,)),
                      x, w, b, name="layer_norm_fwd")


@target("causal_softmax")
def _causal_softmax():
    from apex_tpu_torch.transformer.functional.fused_softmax import (
        scaled_upper_triang_masked_softmax,
    )

    x = _fake(lambda dev: torch.zeros((8, 256, 256), dtype=torch.bfloat16,
                                      device=dev))
    return analyze_fn(
        lambda x: scaled_upper_triang_masked_softmax(x, None, 1.0),
        x, name="causal_softmax")


@target("step-record-schema")
def _step_record_schema():
    """The observability layer's own gate: a StepReporter record from
    synthetic inputs carries every STEP_RECORD_FIELDS key and survives a
    registry JSONL round trip."""
    import json as _json

    from apex_tpu_torch.observability.registry import MetricRegistry
    from apex_tpu_torch.observability.step_report import (
        STEP_RECORD_FIELDS, StepReporter,
    )

    findings = []

    def problem(msg):
        findings.append(Finding(
            "step-record-schema", "error",
            "apex_tpu_torch/observability/step_report.py", 0,
            "StepReporter", msg))

    reg = MetricRegistry()
    rec = StepReporter("schema_check", registry=reg, tokens_per_step=1024,
                       flops_per_step=1e12, device_kind="cpu",
                       peak=1e15).step(0.01, loss=1.0)
    for field in STEP_RECORD_FIELDS:
        if field not in rec:
            problem(f"step record is missing documented field {field!r}")
    try:
        records = reg.to_records()
        _json.dumps(records)
    except (TypeError, ValueError) as e:
        problem(f"registry records are not JSON-serializable: {e}")
        return findings
    if not any(r.get("type") == "event" and r.get("name") == "step"
               for r in records):
        problem("StepReporter.step did not append a 'step' event to the "
                "registry")
    return findings


# ------------------------------------------------- precision-flow targets

def _leaf_count(tree):
    from apex_tpu_torch import _tree

    return len(_tree.leaves(tree))


def _mlp_params(dev, dtype, dims=(128, 256, 64)):
    out = []
    for i, o in zip(dims[:-1], dims[1:]):
        out += [torch.zeros((i, o), dtype=dtype, device=dev),
                torch.zeros((o,), dtype=dtype, device=dev)]
    return tuple(out)


def _grads_of(loss_of, params, *args):
    """``(loss, grads)`` of ``loss_of(params, *args)`` over the tuple of
    params (``jax.value_and_grad``'s form)."""
    live = tuple(p.detach().requires_grad_() for p in params)
    loss = loss_of(live, *args)
    return loss.detach(), torch.autograd.grad(loss, live)


@target("mlp_train_step")
def _mlp_train_step():
    """bf16 MLP forward and backward with an fp32 loss: every product
    keeps an fp32 accumulator (``mlp.py``'s ``keep_acc``) and the loss
    reduces in fp32."""
    from apex_tpu_torch.mlp import mlp_function

    params, x, y = _fake(lambda dev: (
        _mlp_params(dev, torch.bfloat16),
        torch.zeros((32, 128), dtype=torch.bfloat16, device=dev),
        torch.zeros((32, 64), device=dev)))

    def loss_fn(params, x, y):
        out = mlp_function(True, "relu", x, *params)
        return torch.mean(torch.square(out.float() - y))

    return analyze_precision(
        lambda p, x, y: _grads_of(loss_fn, p, x, y), params, x, y,
        name="mlp_train_step")


@target("amp_o1_train_step")
def _amp_o1_train_step():
    """O1: fp32 params, bf16 boundary casts by the active policy, the loss
    scaled before the backward: the cast products still accumulate in
    fp32 and the loss stays fp32."""
    from apex_tpu_torch.amp import amp as amp_mod
    from apex_tpu_torch.amp.frontend import Policy
    from apex_tpu_torch.amp.scaler import LossScaler
    from apex_tpu_torch.mlp import mlp_function

    scaler = LossScaler("dynamic")
    params, x, y, sstate = _fake(lambda dev: (
        _mlp_params(dev, torch.float32),
        torch.zeros((32, 128), device=dev),
        torch.zeros((32, 64), device=dev), scaler.init()))
    policy = Policy(param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                    output_dtype=torch.float32)

    def scaled_loss(params, x, y, sstate):
        out = mlp_function(True, "relu", x, *params)
        loss = torch.mean(torch.square(out.float() - y))
        return scaler.scale_loss(loss, sstate)

    with amp_mod.casting(policy):
        return analyze_precision(
            lambda p, x, y, s: _grads_of(scaled_loss, p, x, y, s),
            params, x, y, sstate, name="amp_o1_train_step")


@target("amp_o2_master_update")
def _amp_o2_master_update():
    """O2's update: bf16 model copy, fp32 masters and moments, scaled bf16
    grads through the scaler's unscale, the flat FusedAdam, the master
    apply and the bf16 copy made again. ``scaled_update`` reads the
    overflow flag on the host (one check a step), and ``LossScaler.update``
    is a host automaton: a trace has no value to read, so the target
    composes what a clean (no-overflow) step runs on the card from the
    same functions, the scaler's state feeding the unscale."""
    from apex_tpu_torch import _tree
    from apex_tpu_torch.amp.scaler import LossScaler
    from apex_tpu_torch.optimizers import fused_adam

    tx = fused_adam(lr=1e-3, weight_decay=0.01, flat=True)
    scaler = LossScaler("dynamic")

    def make(dev):
        master = {"w": torch.zeros((64, 128), device=dev),
                  "b": torch.zeros((128,), device=dev)}
        params = {k: v.to(torch.bfloat16) for k, v in master.items()}
        grads = {k: torch.ones_like(v, dtype=torch.bfloat16)
                 for k, v in master.items()}
        return grads, tx.init(master), master, params, scaler.init()

    grads, state, master, params, sstate = _fake(make)

    def update(grads, opt_state, master, params, sstate):
        with torch.no_grad():
            unscaled, overflow = scaler.unscale(grads, sstate)
            updates, new_opt = tx.update(unscaled, opt_state, master)
            new_master = {k: master[k] + updates[k] for k in master}
            new_params = {k: new_master[k].to(params[k].dtype)
                          for k in params}
        return new_master, new_opt, new_params

    n_out = _leaf_count(master) + _leaf_count(state)
    return analyze_precision(
        update, grads, state, master, params, sstate,
        roles={0: "grad", 1: "master", 2: "master", 3: "param",
               4: "scale"},
        master_outs=tuple(range(n_out)), name="amp_o2_master_update")


def _master_step(tx_of, name):
    """A per-tensor optimizer over fp32 masters: the whole update chain
    stays fp32."""
    tx = tx_of()

    def make(dev):
        master = {"w": torch.zeros((64, 128), device=dev),
                  "b": torch.zeros((128,), device=dev)}
        return ({k: torch.ones_like(v) for k, v in master.items()},
                tx.init(master), master)

    grads, state, master = _fake(make)

    def step(grads, state, master):
        with torch.no_grad():
            updates, new_state = tx.update(grads, state, master)
            return {k: master[k] + updates[k] for k in master}, new_state

    n_out = _leaf_count(master) + _leaf_count(state)
    return analyze_precision(step, grads, state, master,
                             roles={1: "master", 2: "master"},
                             master_outs=tuple(range(n_out)), name=name)


@target("fused_adam_tree_master_step")
def _fused_adam_tree_master_step():
    from apex_tpu_torch.optimizers import fused_adam

    return _master_step(lambda: fused_adam(lr=1e-3, weight_decay=0.01),
                        "fused_adam_tree_master_step")


@target("fused_lamb_master_step")
def _fused_lamb_master_step():
    from apex_tpu_torch.optimizers import fused_lamb

    return _master_step(lambda: fused_lamb(lr=1e-3, weight_decay=0.01),
                        "fused_lamb_master_step")


@target("fused_layer_norm_fwd_bwd")
def _fused_layer_norm_fwd_bwd():
    """FusedLayerNorm forward and backward on bf16 activations with fp32
    affine params: the kernels' nodes (statistics and both backward sums
    in fp32 by construction) and the fp32 loss."""
    from apex_tpu_torch.normalization.fused_layer_norm import (
        fused_layer_norm_affine,
    )

    x, w, b = _fake(lambda dev: (
        torch.zeros((256, 1024), dtype=torch.bfloat16, device=dev),
        torch.ones((1024,), device=dev), torch.zeros((1024,), device=dev)))

    def loss(params):
        x, w, b = params
        y = fused_layer_norm_affine(x, w, b, (1024,))
        return torch.sum(y.float())

    return analyze_precision(lambda x, w, b: _grads_of(loss, (x, w, b)),
                             x, w, b, name="fused_layer_norm_fwd_bwd")


@target("fused_rms_norm_fwd_bwd")
def _fused_rms_norm_fwd_bwd():
    from apex_tpu_torch.normalization.fused_layer_norm import (
        fused_rms_norm_affine,
    )

    x, w = _fake(lambda dev: (
        torch.zeros((256, 1024), dtype=torch.bfloat16, device=dev),
        torch.ones((1024,), device=dev)))

    def loss(params):
        x, w = params
        y = fused_rms_norm_affine(x, w, (1024,))
        return torch.sum(y.float())

    return analyze_precision(lambda x, w: _grads_of(loss, (x, w)),
                             x, w, name="fused_rms_norm_fwd_bwd")


@target("tp_fused_softmax")
def _tp_fused_softmax():
    """The fused causal softmax on bf16 logits: its kernel keeps the
    exponentials behind the row max in fp32."""
    from apex_tpu_torch.transformer.functional.fused_softmax import (
        scaled_upper_triang_masked_softmax,
    )

    x = _fake(lambda dev: torch.zeros((8, 256, 256), dtype=torch.bfloat16,
                                      device=dev))
    return analyze_precision(
        lambda x: scaled_upper_triang_masked_softmax(x, None, 1.0),
        x, name="tp_fused_softmax")


@target("fp8_matmul_delayed_scaling")
def _fp8_matmul_delayed_scaling():
    """The O4 epilogue end to end: one site under the Fp8DelayedScaler
    context, its scales from the rings, the cast kernel's nodes, the fp8
    GEMM, the E5M2 gradient cast and the ring update."""
    from apex_tpu_torch.amp.scaler import Fp8DelayedScaler

    fp8 = Fp8DelayedScaler(["proj"], history=4)
    a, b, state = _fake(lambda dev: (
        torch.zeros((16, 32), dtype=torch.bfloat16, device=dev),
        torch.zeros((32, 64), dtype=torch.bfloat16, device=dev),
        fp8.init(dev)))

    def step(a, b, state):
        with fp8.step(state) as ctx:
            def loss(a, b):
                y = ctx.matmul(a, b, name="proj")
                return torch.sum(y.float())

            l, grads = ctx.value_and_grad(loss, argnums=(0, 1))(a, b)
        return l, grads, fp8.update(state, ctx)

    return analyze_precision(step, a, b, state,
                             roles={2: ("fp8_scale", "amax_hist")},
                             name="fp8_matmul_delayed_scaling")


@target("fp8_mlp_train_step")
def _fp8_mlp_train_step():
    """O4 over the MLP entry point: bf16 params, fp8 forward products at
    the ``"mlp"`` sites, fp32 loss, traced under the live context."""
    from apex_tpu_torch.amp.scaler import Fp8DelayedScaler
    from apex_tpu_torch.mlp import mlp_function

    def loss(params, x, y):
        out = mlp_function(True, "relu", x, *params)
        return torch.mean(torch.square(out.float() - y))

    def make(dev):
        return (_mlp_params(dev, torch.bfloat16, (64, 128, 32)),
                torch.zeros((16, 64), dtype=torch.bfloat16, device=dev),
                torch.zeros((16, 32), device=dev))

    fp8 = Fp8DelayedScaler(["mlp", "mlp"], history=4)
    params, x, y, state = _fake(lambda dev: (*make(dev), fp8.init(dev)))

    def step(params, x, y, state):
        with fp8.step(state) as ctx:
            l, grads = ctx.value_and_grad(loss)(params, x, y)
        return l, grads, fp8.update(state, ctx)

    return analyze_precision(step, params, x, y, state,
                             roles={3: ("fp8_scale", "amax_hist")},
                             name="fp8_mlp_train_step")


PRECISION_TARGETS = (
    "mlp_train_step", "amp_o1_train_step", "amp_o2_master_update",
    "fused_adam_tree_master_step", "fused_lamb_master_step",
    "fused_layer_norm_fwd_bwd", "fused_rms_norm_fwd_bwd",
    "tp_fused_softmax", "fp8_matmul_delayed_scaling",
    "fp8_mlp_train_step",
)


# ---------------------------------------------------- state-flow targets

@target("state_llama_o4_step")
def _state_llama_o4_step():
    """The Llama O4 train step in carry form: params, the tree FusedAdam
    state and the fp8 delayed-scaling rings round one step. Every ring
    and moment must be step-carried and covered by the identity save
    tree."""
    from apex_tpu_torch.amp.scaler import Fp8DelayedScaler
    from apex_tpu_torch.models import llama
    from apex_tpu_torch.optimizers import fused_adam

    cfg = llama.tiny(num_layers=1, num_heads=2, num_kv_heads=1,
                     hidden_size=32, intermediate_size=64, vocab_size=128,
                     max_seq_len=16)
    tx = fused_adam(lr=1e-3)
    fp8 = Fp8DelayedScaler(["lm_head"], history=4)

    def make(dev):
        params = llama.init_params(torch.Generator().manual_seed(0), cfg,
                                   device=dev)
        carry = (params, tx.init(params), fp8.init(dev))
        return carry, torch.zeros((2, 16), dtype=torch.long, device=dev)

    carry, tokens = _fake(make)

    def train_step(carry, tokens, targets):
        params, opt_state, fp8_state = carry

        def loss_fn(p):
            return llama.loss_fn(p, (tokens, targets), cfg, remat=False,
                                 tp_axis=None, cp_axis=None, ep_axis=None)

        with fp8.step(fp8_state) as ctx:
            loss, grads = ctx.value_and_grad(loss_fn)(params)
        new_fp8 = fp8.update(fp8_state, ctx)
        with torch.no_grad():
            updates, new_opt = tx.update(grads, opt_state, params)
            new_params = _add_out_of_place(params, updates)
        return (new_params, new_opt, new_fp8), loss

    stats = STATE_STATS.setdefault("state_llama_o4_step", {})
    return analyze_state(train_step, carry, tokens, tokens,
                         name="state_llama_o4_step", stats_out=stats)


def _add_out_of_place(params, updates):
    """Params plus updates as new tensors (the reference's
    ``tree_map(jnp.add, params, updates)``)."""
    if isinstance(params, dict):
        return {k: _add_out_of_place(params[k], updates[k]) for k in params}
    return params + updates


@target("state_resilient_resume_path")
def _state_resilient_resume_path():
    """The ResilientTrainLoop resume composition (``resume_path``): the
    first step after a restore with the restored reference held as the
    fallback. The loop's step returns new tensors; an in-place step
    there would leave the held reference overwritten."""
    from apex_tpu_torch.resilience.loop import resume_path

    state, step = _fake(lambda dev: ({"w": torch.ones((16, 16),
                                                       device=dev)},
                                     torch.zeros((), device=dev)))

    def step_fn(state, step):
        # a gradient that depends on the step, as chaos_probe's seeded one
        g = torch.sin(state["w"] * (step + 1.0))
        w = state["w"] - 0.01 * (g + 0.1 * state["w"])
        return {"w": w}, {"loss": torch.mean(w * w)}

    stats = STATE_STATS.setdefault("state_resilient_resume_path", {})
    return analyze_state(
        step_fn, state, step, name="state_resilient_resume_path",
        save_tree_of=lambda s: {"state": s},
        resume_fn=resume_path(step_fn), resume_args=(step,),
        stats_out=stats)


def _serving_decode_fixture():
    """The tiny-Llama decode step of the serving scheduler: 2 slots over
    8 pages of 4 tokens (and the trash page), both mid-sequence."""
    from apex_tpu_torch.models import llama
    from apex_tpu_torch.serving.scheduler import build_decode_step

    cfg = llama.tiny()
    page_size, num_pages, batch, maxp = 4, 8, 2, 4
    decode = build_decode_step(cfg, page_size)

    def make(dev):
        params = llama.init_params(torch.Generator().manual_seed(0), cfg,
                                   device=dev)
        shape = (cfg.num_layers, num_pages + 1, page_size,
                 cfg.num_kv_heads, cfg.head_dim)
        carry = (torch.zeros((batch,), dtype=torch.int32, device=dev),
                 torch.zeros(shape, dtype=cfg.dtype, device=dev),
                 torch.zeros(shape, dtype=cfg.dtype, device=dev),
                 torch.full((batch,), 5, dtype=torch.int32, device=dev))
        tables = torch.arange(batch * maxp, dtype=torch.int32,
                              device=dev).reshape(batch, maxp)
        active = torch.ones((batch,), dtype=torch.bool, device=dev)
        return params, carry, tables, active

    params, carry, tables, active = _fake(make)

    def serve_step(carry, params, tables, active):
        tokens, k_pages, v_pages, pos = carry
        nxt = decode(params, {}, k_pages, v_pages, tokens, tables, pos,
                     active)
        return nxt, k_pages, v_pages, pos + 1

    return cfg, params, serve_step, carry, tables, active


@target("state_serving_decode_step")
def _state_serving_decode_step():
    """The serving decode step: tokens, both page buffers (written in
    place) and the positions are the carry a server threads forever;
    each must flow step to step."""
    _cfg, params, serve_step, carry, tables, active = \
        _serving_decode_fixture()
    stats = STATE_STATS.setdefault("state_serving_decode_step", {})
    return analyze_state(serve_step, carry, params, tables, active,
                         name="state_serving_decode_step", stats_out=stats)


STATE_TARGETS = ("state_llama_o4_step", "state_resilient_resume_path",
                 "state_serving_decode_step")

# the serving targets: state targets whose wall time the CLI files under
# its "serving" engine
SERVING_TARGETS = ("state_serving_decode_step",)


# ------------------------------------------------------------- running

def run_targets(names=None, extra_allow=None, timings=None):
    """Run the registered targets: ``(findings, errors)``, errors mapping
    a target that failed to trace to the repr of its exception.
    ``extra_allow``: {target: check ids} dropped on top of the
    ``@target(allow=...)`` lists. ``timings``: a dict that receives each
    target's wall seconds."""
    findings, errors = [], {}
    for name, fn in TARGETS.items():
        if names is not None and name not in names:
            continue
        allowed = set(TARGET_ALLOW.get(name, ()))
        if extra_allow:
            allowed |= set(extra_allow.get(name, ()))
        # a target's wall time is host work: tracing, no device
        t0 = time.perf_counter()  # apex-lint: disable=raw-clock
        try:
            got = fn()
        except Exception as e:  # noqa: BLE001 — report, don't abort the scan
            errors[name] = repr(e)[:300]
            continue
        finally:
            if timings is not None:
                timings[name] = (
                    time.perf_counter() - t0)  # apex-lint: disable=raw-clock
        if allowed:
            got = [f for f in got if f.check not in allowed]
        findings.extend(got)
    return findings, errors


def run_precision_findings(registry=None, names=None):
    """Run the precision targets and publish their counts to the registry
    (``analysis/precision_findings``). Returns ``(findings, errors)``."""
    from apex_tpu_torch.analysis.precision_checks import report_to_registry

    wanted = names if names is not None else PRECISION_TARGETS
    findings, errors = run_targets(set(wanted))
    findings = [f for f in findings if f.check in PRECISION_CHECKS]
    report_to_registry(findings, registry=registry)
    return findings, errors


def run_state_findings(registry=None, names=None):
    """Run the state targets and publish their counts (every id
    zero-filled) and carried/saved leaves to the registry
    (``analysis/state_*``). Returns ``(findings, errors, stats)``."""
    from apex_tpu_torch.analysis.state_checks import report_to_registry

    wanted = tuple(names) if names is not None else STATE_TARGETS
    unknown = set(wanted) - set(TARGETS)
    if unknown:
        raise ValueError(
            f"unknown state target(s) {sorted(unknown)}; valid: "
            f"{sorted(STATE_TARGETS)}")
    findings, errors = run_targets(set(wanted))
    findings = [f for f in findings if f.check in STATE_CHECKS]
    results = {}
    for name in wanted:
        if name in errors:
            continue
        results[name] = ([f for f in findings if f.symbol == name],
                         dict(STATE_STATS.get(name, {})))
    report_to_registry(results, registry=registry)
    return findings, errors, {name: s for name, (_, s) in results.items()}


# --------------------------------------------- kernel nodes of the step

def llama_step_kernel_nodes(num_layers: int = 4, batch: int = 2,
                            seq: int = 2048, lr: float = 1e-4) -> dict:
    """{C entry: nodes} of ``llama.train_step`` with
    ``fused_adam(flat=True)`` at Llama-3-8B width, ``num_layers`` deep,
    on a ``batch`` x ``seq`` batch, traced with fake tensors: the kernel
    launches one such step makes on the card."""
    import collections

    from apex_tpu_torch.models import llama
    from apex_tpu_torch.optimizers import fused_adam

    cfg = llama.llama3_8b(num_layers=num_layers)
    tx = fused_adam(lr=lr, flat=True)

    def make(dev):
        params = llama.init_params(torch.Generator().manual_seed(0), cfg,
                                   device=dev)
        tokens = torch.zeros((batch, seq), dtype=torch.long, device=dev)
        return params, tx.init(params), (tokens, tokens)

    params, state, batch_ = _fake(make)

    def step(params, opt_state, batch):
        return llama.train_step(params, opt_state, batch, cfg, tx,
                                remat=False)

    gm = interp.trace(step, params, state, batch_)
    return dict(collections.Counter(
        n.meta["kernel"] for n in interp.kernel_nodes_of(gm)))
