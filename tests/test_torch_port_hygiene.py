"""Rules the PyTorch port keeps: it imports neither JAX nor the JAX
package, its entry points refuse to run on the CPU unless asked to, and
the CUDA branch of each kernel wrapper has no ``except`` that could fall
back to the plain version.
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
                               "forward", "backward"),
    "ops/layer_norm.py": ("_rms_fwd_cuda", "_rms_fwd", "rms_norm", "_lib",
                          "_rms_bwd_cuda", "_rms_bwd", "forward",
                          "backward", "_ln_fwd_cuda", "_ln_fwd",
                          "_ln_bwd_cuda", "_ln_bwd", "layer_norm",
                          "_norm_fwd_cuda", "_norm_bwd_cuda"),
    "transformer/functional/fused_softmax.py": (
        "_causal_cuda", "_masked_cuda", "_causal", "_masked", "_lib",
        "forward", "backward", "scaled_upper_triang_masked_softmax",
        "scaled_masked_softmax"),
    "ops/fused_adam_kernel.py": ("_adam_flat_cuda", "adam_flat", "_lib"),
    "optimizers/fused_adam.py": ("fused_adam",),
    "optimizers/fused_lamb.py": ("fused_lamb",),
    "models/_common.py": ("run_stacked", "train_step"),
    "models/llama.py": ("train_step", "loss_fn", "run_layers"),
    "models/gpt2.py": ("train_step", "loss_fn", "hidden_states"),
    "models/bert.py": ("train_step", "loss_fn", "forward"),
    "ops/_build.py": ("build", "library", "check"),
}


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "apex_tpu")


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
