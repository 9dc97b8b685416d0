"""Rules the PyTorch port keeps: it imports neither JAX nor the JAX
package, its entry points refuse to run on the CPU unless asked to, the
CUDA branch of each kernel wrapper has no ``except`` that could fall
back to the plain version, and no CUDA path calls a plain version.
"""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "apex_tpu_torch"
WRAPPERS = {
    "ops/flash_attention.py": ("_flash_fwd_cuda", "_flash_fwd",
                               "flash_attention", "_lib",
                               "_flash_bwd_cuda", "_flash_bwd",
                               "_flash_bwd_dq_cuda",
                               "_flash_bwd_dkv_cuda", "_bwd_lib",
                               "forward", "backward", "_extras",
                               "_dropout_seed"),
    "contrib/fmha.py": ("fmha", "fmha_packed_qkv", "apply"),
    "contrib/multihead_attn.py": ("_masked_attention", "_inverted_dropout",
                                  "forward", "mask_softmax_dropout",
                                  "__call__", "load_flax_params"),
    "transformer/moe.py": ("router_gates", "expert_parallel_apply",
                           "moe_mlp", "init_moe_params"),
    "transformer/context_parallel.py": ("ring_attention", "forward",
                                        "backward", "_rotate"),
    "distributed/backend.py": ("all_to_all", "_all_to_all_raw"),
    "ops/layer_norm.py": ("_rms_fwd_cuda", "_rms_fwd", "rms_norm", "_lib",
                          "_rms_bwd_cuda", "_rms_bwd", "forward",
                          "backward", "_ln_fwd_cuda", "_ln_fwd",
                          "_ln_bwd_cuda", "_ln_bwd", "layer_norm",
                          "_norm_fwd_cuda", "_norm_bwd_cuda"),
    "transformer/functional/fused_softmax.py": (
        "_causal_cuda", "_masked_cuda", "_causal", "_masked", "_lib",
        "forward", "backward", "scaled_upper_triang_masked_softmax",
        "scaled_masked_softmax", "_stats_cuda", "_apply_cuda",
        "_blocked_cuda", "_route", "forward_fused_softmax"),
    "ops/fp8_cast_kernel.py": ("_cast_and_scale_cuda",
                               "cast_and_scale_stats", "_lib"),
    "ops/precision.py": ("matmul_fp8", "matmul_fp8_stats", "einsum_fp8",
                         "quantize_fp8", "quantize_fp8_stats", "forward",
                         "backward", "_fp8_product", "matmul_amp"),
    "serving/scheduler.py": ("_make_mm", "fp8_weight_scales",
                             "build_decode_step", "build_prefill",
                             "__init__", "capture", "replay"),
    "ops/fused_adam_kernel.py": ("_adam_flat_cuda", "adam_flat", "_lib"),
    "optimizers/fused_adam.py": ("fused_adam",),
    "optimizers/fused_lamb.py": ("fused_lamb",),
    "models/_common.py": ("run_stacked", "train_step"),
    "models/llama.py": ("train_step", "loss_fn", "run_layers", "_moe_mlp",
                        "decoder_layer_with_aux", "forward_with_aux",
                        "hidden_states", "init_params"),
    "models/generate.py": ("generate", "_moe_router_weights",
                           "_moe_decode_ffn", "_moe_prefill_ffn",
                           "_decode_layer", "_prefill_layer",
                           "gpt2_generate", "_gpt2_prefill_layer",
                           "_gpt2_decode_layer"),
    "normalization/fused_layer_norm.py": ("forward",),
    "models/gpt2.py": ("train_step", "loss_fn", "hidden_states"),
    "models/bert.py": ("train_step", "loss_fn", "forward"),
    "ops/_build.py": ("build", "library", "check"),
    # the fp8 sites of the MLP, the fused dense layers and the 3-D
    # example's lm head: on the card their casts launch the cast kernel
    "mlp.py": ("mlp_function", "_forward", "forward", "backward"),
    "fused_dense.py": ("fused_dense_function", "dense_no_bias_function",
                       "fused_dense_gelu_dense_function", "_fdgd_forward",
                       "forward", "backward"),
    "examples/llama_train.py": ("loss", "_local_grads", "grads",
                                "train_step"),
}


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "apex_tpu")


# the BASELINE slice's modules: present, and covered by the import rule
# above like every other file of the port
BASELINE_MODULES = ("models/resnet.py", "models/mlp.py",
                    "optimizers/fused_sgd.py", "runtime/host.py",
                    "examples/imagenet_resnet50.py",
                    "examples/simple_distributed.py",
                    "examples/bert_train.py")


# the 3-D example's O4 slice's modules (mlp, fused_dense, DCGAN, the
# samplers and the test harness)
SLICE_MODULES = ("mlp.py", "fused_dense.py", "models/dcgan.py",
                 "examples/dcgan.py", "examples/llama_train.py",
                 "transformer/_data/_batchsampler.py",
                 "transformer/testing/arguments.py",
                 "transformer/testing/global_vars.py",
                 "transformer/testing/commons.py",
                 "transformer/testing/distributed_test_base.py",
                 "transformer/testing/standalone_gpt.py",
                 "transformer/testing/standalone_bert.py")


# the last optimizers, multi_tensor_apply, fp16_utils, rnn and weight
# norm
OPTIMIZER_SLICE_MODULES = (
    "optimizers/fused_adagrad.py", "optimizers/fused_novograd.py",
    "optimizers/fused_mixed_precision_lamb.py", "parallel/larc.py",
    "multi_tensor_apply/multi_tensor_apply.py", "contrib/clip_grad.py",
    "contrib/optimizers/__init__.py", "contrib/optimizers/fp16_optimizer.py",
    "contrib/optimizers/fused_adam.py", "contrib/optimizers/fused_lamb.py",
    "contrib/optimizers/fused_sgd.py", "fp16_utils/fp16util.py",
    "fp16_utils/loss_scaler.py", "fp16_utils/fp16_optimizer.py",
    "rnn/cells.py", "rnn/models.py", "reparameterization.py")


# the rest of contrib and the hf_finetune example
CONTRIB_SLICE_MODULES = (
    "contrib/xentropy.py", "contrib/focal_loss.py", "contrib/layer_norm.py",
    "contrib/conv_bias_relu.py", "contrib/groupbn.py",
    "contrib/peer_memory.py", "contrib/halo_exchangers.py",
    "contrib/bottleneck.py", "contrib/sparsity.py", "contrib/transducer.py",
    "contrib/optimizers/distributed_fused_adam.py",
    "contrib/optimizers/distributed_fused_adam_v2.py",
    "contrib/optimizers/distributed_fused_adam_v3.py",
    "contrib/optimizers/distributed_fused_lamb.py",
    "examples/hf_finetune.py")


# the training telemetry slice: timing, the registry, spans and step
# phases, the flight recorder, step reports, numerics, memory, goodput
# and the report CLI
OBSERVABILITY_SLICE_MODULES = (
    "runtime/timing.py", "observability/__init__.py",
    "observability/__main__.py", "observability/cli.py",
    "observability/events.py", "observability/registry.py",
    "observability/scope.py", "observability/step_report.py",
    "observability/fleet/__init__.py", "observability/fleet/identity.py",
    "observability/fleet/merge.py", "observability/profiling/__init__.py",
    "observability/profiling/spans.py",
    "observability/profiling/step_phases.py",
    "observability/profiling/flight_recorder.py",
    "observability/numerics/__init__.py",
    "observability/numerics/stats.py", "observability/numerics/health.py",
    "observability/memory/__init__.py", "observability/memory/hbm.py",
    "observability/memory/oom.py", "observability/goodput/__init__.py",
    "observability/goodput/ledger.py",
    "observability/goodput/accounting.py",
    # the trace attribution, the fleet tier and the compile listener
    "pyprof/__init__.py", "pyprof/__main__.py", "pyprof/parse.py",
    "pyprof/prof.py", "observability/profiling/xplane.py",
    "observability/fleet/probe.py", "observability/fleet/straggler.py",
    "observability/fleet/desync.py", "observability/fleet/collector.py",
    "observability/recompile.py", "observability/memory/compiled.py")


# the dispatch switch, the tuner and the NaN provenance probe
TUNING_SLICE_MODULES = (
    "ops/kernel_config.py", "tuning/__init__.py", "tuning/__main__.py",
    "tuning/cache.py", "tuning/geometry.py", "tuning/search_space.py",
    "tuning/measure.py", "tuning/tuner.py",
    "observability/numerics/nan_probe.py")


# the lint engines and their CLI
ANALYSIS_SLICE_MODULES = (
    "analysis/__init__.py", "analysis/__main__.py", "analysis/findings.py",
    "analysis/ast_checks.py", "analysis/concurrency_checks.py",
    "analysis/cli.py")


# the graph engines' single-device half and the kernels as graph nodes
GRAPH_SLICE_MODULES = (
    "analysis/interp.py", "analysis/graph_checks.py",
    "analysis/dataflow.py", "analysis/precision_checks.py",
    "analysis/state_checks.py", "analysis/targets.py",
    "ops/kernel_nodes.py")


@pytest.mark.parametrize("rel", BASELINE_MODULES + SLICE_MODULES
                         + OPTIMIZER_SLICE_MODULES + CONTRIB_SLICE_MODULES
                         + OBSERVABILITY_SLICE_MODULES
                         + TUNING_SLICE_MODULES + ANALYSIS_SLICE_MODULES
                         + GRAPH_SLICE_MODULES)
def test_baseline_modules_are_checked(rel):
    assert PORT / rel in _port_sources()


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_apex_tpu_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names = [str(node.args[0].value)]
        else:
            continue
        bad = [n for n in names if _banned(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


@pytest.mark.parametrize("rel", sorted(WRAPPERS))
def test_kernel_wrappers_have_no_fallback(rel):
    """No ``try`` in a wrapper: a CUDA tensor launches the kernel or the
    call raises."""
    tree = ast.parse((PORT / rel).read_text())
    funcs = {n.name: n for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef)}
    for name in WRAPPERS[rel]:
        assert name in funcs, f"{rel} lost {name}"
        tries = [n for n in ast.walk(funcs[name]) if isinstance(n, ast.Try)]
        assert not tries, f"{rel}:{name} has a try at line {tries[0].lineno}"


def _called_names(node):
    for call in ast.walk(node):
        if isinstance(call, ast.Call):
            fn = call.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", "")
            yield call.lineno, name


def _is_cuda_test(test) -> bool:
    """``x.is_cuda``, the dispatch switch's ``use_kernel(...)``, or a
    comparison of its ``dispatch(...)`` path with ``"kernel"``."""
    if isinstance(test, ast.Attribute):
        return test.attr == "is_cuda"
    if isinstance(test, ast.Call):
        return getattr(test.func, "attr", None) == "use_kernel"
    return (isinstance(test, ast.Compare) and any(
        isinstance(c, ast.Constant) and c.value == "kernel"
        for c in test.comparators))


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_cuda_path_calls_a_plain_version(path):
    """A ``*_cuda`` function, and the branch under ``if x.is_cuda:``,
    never call a ``*_plain`` function: on the card the kernel runs or the
    call raises."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name.endswith("_cuda"):
            scopes = [node]
        elif isinstance(node, ast.If) and _is_cuda_test(node.test):
            scopes = node.body
        else:
            continue
        for scope in scopes:
            bad = [(line, name) for line, name in _called_names(scope)
                   if name.endswith("_plain")]
            assert not bad, f"{path.name}: a CUDA path calls {bad}"


def test_entry_points_raise_without_a_gpu(monkeypatch):
    from apex_tpu_torch.models import generate, llama
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.serving import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.tiny()
    params = llama.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(params, cfg, num_pages=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.params_from_numpy({"w": params["final_norm"].numpy()})
    prompt = torch.zeros(1, 3, dtype=torch.long)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.generate(params, prompt, cfg, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.greedy_generate(params, prompt, cfg, 2)
    from apex_tpu_torch.optimizers import opt_state_from_numpy

    state = fused_adam(flat=True).init(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opt_state_from_numpy(state._replace(
            mu={k: v.numpy() for k, v in state.mu.items()},
            nu={k: v.numpy() for k, v in state.nu.items()}))
    # asked for explicitly, the CPU runs the plain versions
    ServingEngine(params, cfg, num_pages=32, device="cpu")
    assert generate.generate(params, prompt, cfg, 2,
                             device="cpu").shape == (1, 5)


@pytest.mark.parametrize("family", ["gpt2", "bert"])
def test_gpt2_bert_entry_points_raise_without_a_gpu(monkeypatch, family):
    import importlib

    from apex_tpu_torch.optimizers import fused_lamb
    from apex_tpu_torch.optimizers.fused_lamb import opt_state_from_numpy

    model = importlib.import_module(f"apex_tpu_torch.models.{family}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = model.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(torch.Generator().manual_seed(0), cfg)
    params = model.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.params_from_numpy({"w": params["embed"].numpy()})
    state = fused_lamb().init(params)
    tree = {"w": state.mu["embed"].numpy()}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        opt_state_from_numpy(state._replace(mu=tree, nu=tree))
    assert opt_state_from_numpy(state._replace(mu=tree, nu=tree),
                                device="cpu").mu["w"].device.type == "cpu"


def test_params_on_another_device_are_refused():
    """Params and the engine or generate() must agree on the device: no
    silent copy."""
    from apex_tpu_torch.models import llama
    from apex_tpu_torch.models.generate import generate
    from apex_tpu_torch.serving import ServingEngine

    cfg = llama.tiny()
    params = llama.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    fake = {"embed": torch.empty(0, device="meta")}
    with pytest.raises(ValueError, match="params live on"):
        ServingEngine(fake, cfg, num_pages=32, device="cpu")
    with pytest.raises(ValueError, match="params live on"):
        generate(fake, torch.zeros(1, 3, dtype=torch.long), cfg, 2,
                 device="cpu")
    ServingEngine(params, cfg, num_pages=32, device="cpu")


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """chip_smoke.py alone, with no card: a non-zero exit and no result
    line."""
    import subprocess
    import sys

    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _param_constructors():
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) and (
                    node.name.startswith("init_") and "params" in node.name
                    or node.name.endswith("_from_numpy")
                    and not node.name.startswith("_")):
                yield str(path.relative_to(PORT)), node


@pytest.mark.parametrize(
    "rel,func", [(rel, node.name) for rel, node in _param_constructors()])
def test_param_constructors_resolve_their_device(rel, func):
    """Every function that makes params or state (``init_*params``,
    ``*_from_numpy``) takes ``device`` and resolves it with
    ``_device.resolve``: the GPU unless the caller asks for the CPU,
    never the device of whatever generator it was handed."""
    node = next(n for r, n in _param_constructors()
                if r == rel and n.name == func)
    args = [a.arg for a in node.args.args + node.args.kwonlyargs]
    assert "device" in args, f"{rel}:{func} takes no device"
    assert "resolve" in {name for _, name in _called_names(node)}, (
        f"{rel}:{func} never calls _device.resolve")


def test_checkpoint_convert_and_norm_entry_points_raise_without_a_gpu(
        monkeypatch, tmp_path):
    """A restore with no target, the HF converters, the norm modules
    (SyncBatchNorm too) and the chaos probe land on the card unless asked
    for the CPU."""
    from apex_tpu_torch import checkpoint
    from apex_tpu_torch.models import convert, gpt2
    from apex_tpu_torch.normalization import fused_layer_norm as fln
    from apex_tpu_torch.parallel import SyncBatchNorm
    from apex_tpu_torch.resilience import chaos_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gpt2.tiny(num_layers=1)
    params = gpt2.init_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    checkpoint.save_checkpoint(str(tmp_path / "c"), params, step=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.restore_checkpoint(str(tmp_path / "c"))
    got = checkpoint.restore_checkpoint(str(tmp_path / "c"), device="cpu")
    assert got["embed"].device.type == "cpu"
    sd = {"wte.weight": params["embed"], "wpe.weight": params["pos_embed"],
          "ln_f.weight": params["lnf_w"], "ln_f.bias": params["lnf_b"]}
    names = {"ln_1.weight": "ln1_w", "ln_1.bias": "ln1_b",
             "attn.c_attn.weight": "wqkv", "attn.c_attn.bias": "bqkv",
             "attn.c_proj.weight": "wo", "attn.c_proj.bias": "bo",
             "ln_2.weight": "ln2_w", "ln_2.bias": "ln2_b",
             "mlp.c_fc.weight": "wfc", "mlp.c_fc.bias": "bfc",
             "mlp.c_proj.weight": "wproj", "mlp.c_proj.bias": "bproj"}
    for hf, ours in names.items():
        sd[f"h.0.{hf}"] = params["layers"][ours][0].reshape(
            64, -1) if ours == "wqkv" else params["layers"][ours][0].reshape(
            -1) if ours == "bqkv" else params["layers"][ours][0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.gpt2_from_hf(sd, cfg=cfg)
    back, _ = convert.gpt2_from_hf(sd, cfg=cfg, device="cpu")
    assert torch.equal(back["layers"]["wqkv"], params["layers"]["wqkv"])
    for cls in (fln.FusedLayerNorm, fln.FusedRMSNorm,
                fln.MixedFusedLayerNorm, fln.MixedFusedRMSNorm):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(8)
        assert cls(8, device="cpu").weight.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyncBatchNorm(8)
    bn = SyncBatchNorm(8, device="cpu")
    assert bn.weight.device.type == bn.running_var.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chaos_probe("preempt@1", str(tmp_path / "p"), steps=2)


def test_tensor_parallel_modules_raise_without_a_gpu(monkeypatch):
    """The Megatron slice's module forms are made on the GPU unless asked
    for the CPU."""
    from apex_tpu_torch.transformer.tensor_parallel import layers

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: layers.ColumnParallelLinear(4, 8, **kw),
                 lambda **kw: layers.RowParallelLinear(8, 4, **kw),
                 lambda **kw: layers.VocabParallelEmbedding(16, 4, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        assert make(device="cpu").weight.device.type == "cpu"


def test_baseline_entry_points_raise_without_a_gpu(monkeypatch):
    """The ResNet's and the MLP's params land on the card unless asked
    for the CPU; the optimizer and the loader need no device."""
    import numpy as np

    from apex_tpu_torch.models import mlp, resnet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    model = resnet.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet.init_variables(gen, model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet.Bottleneck(8).init(gen, 8)
    v = resnet.init_variables(gen, model, device="cpu")
    flax_tree = {"params": {"Conv_0": {"kernel": np.zeros((7, 7, 3, 8),
                                                          np.float32)}}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resnet.variables_from_flax(flax_tree)
    assert resnet.variables_from_flax(flax_tree, device="cpu")["params"][
        "Conv_0"]["kernel"].shape == (8, 3, 7, 7)
    logits, _ = model.apply(v, torch.zeros(1, 32, 32, 3), train=False)
    assert logits.shape == (1, 10)
    cfg = mlp.MLPConfig(sizes=(4, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mlp.init_params(gen, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mlp.params_from_numpy({"layers": [{"w": np.zeros((4, 3))}]})
    assert mlp.init_params(gen, cfg, device="cpu")["layers"][0][
        "w"].device.type == "cpu"


def test_slice_entry_points_raise_without_a_gpu(monkeypatch):
    """The MLP, the fused dense layers, DCGAN's variables, the toy stage
    model and the 3-D example's fp8 state land on the card unless asked
    for the CPU."""
    import numpy as np

    from apex_tpu_torch import fused_dense, mlp
    from apex_tpu_torch.models import dcgan
    from apex_tpu_torch.transformer.testing import commons

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    makers = (lambda **kw: mlp.MLP([4, 3], **kw).params[0]["w"],
              lambda **kw: fused_dense.FusedDense(4, 3, **kw).params[
                  "weight"],
              lambda **kw: fused_dense.FusedDenseGeluDense(4, 8, 3, **kw)
              .params["weight1"],
              lambda **kw: dcgan.init_variables(
                  gen, dcgan.Generator(latent_dim=4, width=2), **kw)[
                  "params"]["Dense_0"]["kernel"],
              lambda **kw: dcgan.variables_from_flax(
                  {"params": {"Dense_0": {"kernel": np.zeros((2, 2))}}},
                  **kw)["params"]["Dense_0"]["kernel"],
              lambda **kw: commons.init_toy_stage_params(gen, 4, **kw)["w"])
    for make in makers:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        assert make(device="cpu").device.type == "cpu"


def test_every_name_of_the_optimizer_slice_is_ported():
    """Each name the JAX package's optimizers, parallel, fp16_utils,
    multi_tensor_apply, rnn, reparameterization and contrib export is
    importable from the port, and none raises NotImplementedError but
    ``auto_shard``."""
    import importlib

    waits = {"auto_shard"}
    names = {
        "optimizers": ("fused_adagrad", "FusedAdagrad", "FusedAdagradState",
                       "fused_novograd", "FusedNovoGrad",
                       "FusedNovoGradState", "fused_mixed_precision_lamb",
                       "FusedMixedPrecisionLamb", "FusedMPLambState",
                       "opt_state_from_numpy"),
        "parallel": ("LARC", "larc", "LARCState", "auto_shard"),
        "multi_tensor_apply": ("MultiTensorApply", "multi_tensor_applier",
                               "multi_tensor_scale", "multi_tensor_axpby",
                               "multi_tensor_l2norm",
                               "multi_tensor_l2norm_mp",
                               "multi_tensor_l2norm_scale"),
        "contrib.clip_grad": ("clip_grad_norm_", "clip_grad_norm"),
        "fp16_utils": ("tofp16", "BN_convert_float", "network_to_half",
                       "convert_module", "convert_network", "FP16Model",
                       "prep_param_lists", "model_grads_to_master_grads",
                       "master_params_to_model_params", "to_python_float",
                       "clip_grad_norm", "LossScaler", "DynamicLossScaler",
                       "FP16_Optimizer"),
        "rnn": ("LSTM", "GRU", "ReLU", "Tanh", "mLSTM", "params_from_numpy"),
        "rnn.cells": ("init_cell_params", "lstm_cell", "mlstm_cell",
                      "gru_cell", "relu_cell", "tanh_cell", "CELLS"),
        "reparameterization": ("WeightNorm", "apply_weight_norm",
                               "compute_weights", "remove_weight_norm",
                               "apply_reparameterization",
                               "remove_reparameterization"),
        "contrib.optimizers": ("FP16_Optimizer", "FusedAdam", "FusedLAMB",
                               "FusedSGD", "DistributedFusedAdam",
                               "distributed_fused_adam",
                               "DistributedFusedLAMB",
                               "distributed_fused_lamb",
                               "dist_adam_partition_specs"),
        "contrib.optimizers.distributed_fused_adam_v2": (
            "DistributedFusedAdamV2",),
        "contrib.optimizers.distributed_fused_adam_v3": (
            "DistributedFusedAdamV3",),
        "contrib.xentropy": ("softmax_cross_entropy_loss",
                             "SoftmaxCrossEntropyLoss"),
        "contrib.focal_loss": ("focal_loss", "FocalLoss"),
        "contrib.layer_norm": ("fast_layer_norm", "FastLayerNorm"),
        "contrib.conv_bias_relu": ("ConvBias", "ConvBiasReLU",
                                   "ConvBiasMaskReLU",
                                   "ConvFrozenScaleBiasReLU"),
        "contrib.groupbn": ("BatchNorm2d_NHWC",),
        "contrib.peer_memory": ("PeerMemoryPool", "halo_exchange_1d",
                                "PeerHaloExchanger1d"),
        "contrib.halo_exchangers": ("HaloExchanger", "HaloExchangerNoComm",
                                    "HaloExchangerAllGather",
                                    "HaloExchangerSendRecv",
                                    "HaloExchangerPeer",
                                    "left_right_halo_exchange"),
        "contrib.bottleneck": ("Bottleneck", "SpatialBottleneck",
                               "FrozenBatchNorm2d"),
        "contrib.sparsity": ("mn_1d_mask", "create_mask",
                             "find_channel_permutation", "permuted_mn_mask",
                             "retained_magnitude", "apply_masks",
                             "masked_update", "ASP"),
        "contrib.transducer": ("transducer_joint", "TransducerJoint",
                               "transducer_loss", "TransducerLoss"),
        "examples.hf_finetune": ("main", "hf_llama_state_dict",
                                 "train_step"),
    }
    for mod, attrs in names.items():
        module = importlib.import_module(f"apex_tpu_torch.{mod}")
        for attr in attrs:
            obj = getattr(module, attr)
            if attr in waits:
                with pytest.raises(NotImplementedError):
                    obj()
            else:
                assert getattr(obj, "__name__", "") != "raise_not_ported", \
                    f"{mod}.{attr}"


def test_contrib_exports_every_reference_module():
    """``apex_tpu_torch.contrib`` names the reference's 14 modules."""
    import apex_tpu_torch.contrib as contrib

    want = {"bottleneck", "clip_grad", "conv_bias_relu", "fmha",
            "focal_loss", "groupbn", "halo_exchangers", "layer_norm",
            "multihead_attn", "optimizers", "peer_memory", "sparsity",
            "transducer", "xentropy"}
    assert set(contrib.__all__) == want
    for name in want:
        assert getattr(contrib, name).__name__ == f"apex_tpu_torch.contrib." \
            f"{name}"


def test_contrib_entry_points_raise_without_a_gpu(monkeypatch):
    """The contrib slice's constructors and the example's state dict land
    on the card unless asked for the CPU."""
    from apex_tpu_torch.contrib import bottleneck, groupbn, layer_norm
    from apex_tpu_torch.contrib import peer_memory
    from apex_tpu_torch.examples import hf_finetune

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    makers = (
        lambda **kw: layer_norm.FastLayerNorm(8, **kw).weight,
        lambda **kw: groupbn.BatchNorm2d_NHWC(8).init(**kw)["params"][
            "BatchNorm_0"]["scale"],
        lambda **kw: bottleneck.FrozenBatchNorm2d(3).init(**kw)["frozen"][
            "weight"],
        lambda **kw: bottleneck.SpatialBottleneck(2).init(gen, 8, **kw)[
            "params"]["Conv_0"]["kernel"],
        lambda **kw: peer_memory.PeerMemoryPool(**kw).allocate_peer_tensors(
            (2,), torch.float32, False, False)[0],
        lambda **kw: hf_finetune.hf_llama_state_dict(
            hf_finetune.tiny_hf_config(), gen, **kw)["model.norm.weight"])
    for make in makers:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        assert make(device="cpu").device.type == "cpu"
