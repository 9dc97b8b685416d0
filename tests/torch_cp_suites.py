"""The port's side of the context-, expert- and GPT-2/BERT tensor-parallel
tests: suites that run on every rank of a gloo group on the CPU (through
``torch_dist_worker.run_ranks``) and save what they computed. Inputs are
the test's numpy arrays; a model's full params come as flat keys
``<prefix>p.<path>`` (``torch_megatron_suites._unpack``). This file
imports torch and the port, never JAX.
"""

from __future__ import annotations

import numpy as np

from apex_tpu_torch.examples._common import coords_of, shard_tree
from torch_dist_worker import _np, _t
from torch_megatron_suites import _unpack

#: the ring cases: name -> (causal, kv heads divide the query heads by)
RING_CASES = {"causal_mha": (True, 1), "full_mha": (False, 1),
              "causal_gqa": (True, 2), "full_gqa": (False, 2)}


def _seq_block(a, rank: int, n: int, dim: int = 1):
    size = a.shape[dim] // n
    return np.take(a, np.arange(rank * size, (rank + 1) * size), axis=dim)


def _grads(loss, leaves):
    import torch

    return torch.autograd.grad(loss, leaves)


def _save_tree(out, tag, tree):
    from apex_tpu_torch import _tree

    for path, leaf in zip(_tree.paths(tree), _tree.leaves(tree)):
        out[f"{tag}.{'.'.join(str(p) for p in path)}"] = _np(leaf)


# ------------------------------------------------------------- context

def suite_cp_ring(rank, n, inp, directory):
    """``ring_attention`` at cp ``n`` in every RING_CASES case (outputs
    and this rank's dq, dk, dv for the cotangent ``do``),
    ``ulysses_attention`` (forward and grads), the split/gather round
    trip and the positions."""
    import torch

    from apex_tpu_torch.transformer import context_parallel as cp
    from apex_tpu_torch.transformer import parallel_state as ps

    ps.initialize_model_parallel(context_parallel_size_=n)
    out = {}
    for name, (causal, _) in RING_CASES.items():
        q, k, v, do = (_t(_seq_block(inp[f"{name}_{t}"], rank, n))
                       for t in ("q", "k", "v", "do"))
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        o = cp.ring_attention(q, k, v, causal=causal)
        o.backward(do)
        out[f"{name}_o"] = _np(o)
        for t, g in (("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
            out[f"{name}_{t}"] = _np(g)
    for causal in (True, False):
        q, k, v, do = (_t(_seq_block(inp[f"ulysses_{t}"], rank, n))
                       for t in ("q", "k", "v", "do"))
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        o = cp.ulysses_attention(q, k, v, causal=causal)
        o.backward(do)
        tag = f"ulysses_{int(causal)}"
        out[f"{tag}_o"] = _np(o)
        for t, g in (("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
            out[f"{tag}_{t}"] = _np(g)
    x = _t(inp["split_x"])
    local = cp.split_sequence(x)
    out["split_local"] = _np(local)
    out["split_gathered"] = _np(cp.gather_sequence(local))
    out["positions"] = _np(cp.context_parallel_positions(
        x.shape[1] // n, device="cpu"))
    ps.destroy_model_parallel()
    return out


def suite_cp_llama(rank, n, inp, directory):
    """Llama ``tiny()`` (fp32) with its sequence split over cp (n = 2:
    cp 2; n = 4: tp 2 x cp 2): this rank's loss and gradients (its
    shards' under tp), and the long-context example's step
    (``ContextParallelStep.grads``: the reduced gradients and loss)."""
    import torch

    from apex_tpu_torch import _tree
    from apex_tpu_torch.examples import long_context as ex
    from apex_tpu_torch.models import llama
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.transformer import parallel_state as ps

    tp = 2 if n == 4 else 1
    ps.initialize_model_parallel(tp, context_parallel_size_=n // tp)
    coords = coords_of(("cp", "tp"))
    cfg = llama.tiny()
    full = _tree.map_leaves(_t, _unpack(inp, "llama_"))
    tokens = _t(inp["tokens"]).long()
    step = ex.ContextParallelStep(cfg, fused_adam(lr=1e-3), remat=True)
    batch = (step.local_batch(tokens),
             step.local_batch(torch.roll(tokens, -1, dims=-1)))
    params = (shard_tree(full, llama.param_specs(cfg), coords) if tp > 1
              else full)
    live = _tree.map_leaves(lambda v: v.clone().requires_grad_(), params)
    loss = llama.loss_fn(live, batch, cfg, remat=False,
                         tp_axis="tp" if tp > 1 else None, cp_axis="cp")
    out = {"loss": _np(loss)}
    _save_tree(out, "g", _tree.unflatten(
        _tree.paths(live), list(_grads(loss, _tree.leaves(live)))))
    if tp == 1:  # the example's step (its loss_fn takes no tp)
        ex_loss, ex_grads = step.grads(full, *batch)
        out["ex_loss"] = _np(ex_loss)
        _save_tree(out, "ex_g", ex_grads)
    ps.destroy_model_parallel()
    return out


# -------------------------------------------------------------- experts

def suite_ep_moe(rank, n, inp, directory):
    """``moe_mlp`` at ep ``n`` in each case of ``inp['moe_cases']``
    (experts split over the ranks, tokens too): this rank's outputs, aux
    and the gradients of sum(y * ct) + aux w.r.t. its params; then (at n
    = 2) Llama MoE ``tiny()`` with ep 2 (loss, gradients) and the
    moe_train example's step."""
    import torch

    from apex_tpu_torch import _tree
    from apex_tpu_torch.distributed import backend as B
    from apex_tpu_torch.examples import moe_train as ex
    from apex_tpu_torch.models import llama
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.transformer import moe

    B.new_group("ep")
    coords = {"ep": (rank, n), "tp": (0, 1)}
    out = {}
    for case in [str(c) for c in inp["moe_cases"]]:
        e, k, cf = (float(v) for v in inp[f"{case}_cfg"])
        cfg = moe.MoEConfig(hidden_size=16, ffn_hidden_size=32,
                            num_experts=int(e), top_k=int(k),
                            capacity_factor=cf)
        full = {key: _t(inp[f"{case}_{key}"]) for key in ("router", "wi",
                                                          "wo")}
        params = shard_tree(full, moe.moe_param_specs(cfg), coords)
        live = {kk: v.requires_grad_() for kk, v in params.items()}
        x = _t(_seq_block(inp[f"{case}_x"], rank, n, dim=0))
        ct = _t(_seq_block(inp[f"{case}_ct"], rank, n, dim=0))
        y, aux, stats = moe.moe_mlp(live, x, cfg, ep_axis="ep",
                                    with_stats=True)
        loss = torch.sum(y * ct) + aux
        out[f"{case}_y"], out[f"{case}_aux"] = _np(y), _np(aux)
        out[f"{case}_dropped"] = _np(stats["dropped_frac"])
        for kk, g in zip(live, _grads(loss, list(live.values()))):
            out[f"{case}_g_{kk}"] = _np(g)
    if n == 2:
        cfg = llama.tiny(num_experts=4)
        full = _tree.map_leaves(_t, _unpack(inp, "llama_"))
        params = shard_tree(full, llama.param_specs(cfg), coords)
        tok = _t(_seq_block(inp["tokens"], rank, n, dim=0)).long()
        batch = (tok, torch.roll(tok, -1, dims=-1))
        live = _tree.map_leaves(lambda v: v.clone().requires_grad_(),
                                params)
        loss = llama.loss_fn(live, batch, cfg, remat=False, tp_axis=None,
                             ep_axis="ep")
        out["llama_loss"] = _np(loss)
        _save_tree(out, "llama_g", _tree.unflatten(
            _tree.paths(live), list(_grads(loss, _tree.leaves(live)))))
        # the example's step on a dp 1 x ep 2 grid
        ex.bind_ep_grid(1, n)
        mcfg = moe.MoEConfig(hidden_size=16, ffn_hidden_size=32,
                             num_experts=2 * n, top_k=2,
                             capacity_factor=2.0)
        full = {key: _t(inp[f"ex_{key}"]) for key in ("router", "wi", "wo")}
        step = ex.ExpertParallelStep(mcfg, fused_adam(lr=1e-2))
        params = shard_tree(full, moe.moe_param_specs(mcfg), step.coords)
        x, target = _t(inp["ex_x"]), torch.sin(3.0 * _t(inp["ex_x"]))
        mse, grads = step.grads(params, step.local_batch(x),
                                step.local_batch(target))
        out["ex_mse"] = _np(mse)
        for kk, g in grads.items():
            out[f"ex_g_{kk}"] = _np(g)
    return out


# ---------------------------------------------------- GPT-2 / BERT tp

def suite_tp_models(rank, n, inp, directory):
    """GPT-2 and BERT ``tiny()`` (fp32) at tp ``n``: this rank's loss,
    the gradients of its shards, and its shards after one
    ``train_step`` with tree ``fused_adam``; GPT-2 also through the
    gpt2_train example's step."""
    import torch

    from apex_tpu_torch import _tree
    from apex_tpu_torch.examples import gpt2_train as ex
    from apex_tpu_torch.models import bert, gpt2
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.transformer import parallel_state as ps

    ps.initialize_model_parallel(n)
    coords = coords_of(("tp",))
    out = {}
    tok = _t(inp["tokens"]).long()
    for name, model in (("gpt2", gpt2), ("bert", bert)):
        cfg = model.tiny()
        full = _tree.map_leaves(_t, _unpack(inp, name + "_"))
        params = shard_tree(full, model.param_specs(cfg), coords)
        if name == "gpt2":
            batch = (tok, torch.roll(tok, -1, dims=-1))
            kw = {}
        else:
            batch = (tok, _t(inp["bert_targets"]).long(),
                     _t(inp["bert_loss_mask"]))
            kw = {"pad_mask": _t(inp["bert_pad_mask"]).bool()}
        for chunks in (None, 4):
            live = _tree.map_leaves(lambda v: v.clone().requires_grad_(),
                                    params)
            loss = model.loss_fn(live, batch, cfg, remat=True,
                                 vocab_chunks=chunks, tp_axis="tp", **kw)
            tag = f"{name}_{chunks or 0}"
            out[f"{tag}_loss"] = _np(loss)
            _save_tree(out, f"{tag}_g", _tree.unflatten(
                _tree.paths(live), list(_grads(loss, _tree.leaves(live)))))
        tx = fused_adam(lr=1e-3)
        state = tx.init(params)
        stepped, _, loss = model.train_step(params, state, batch, cfg, tx,
                                            remat=False, tp_axis="tp", **kw)
        out[f"{name}_step_loss"] = _np(loss)
        _save_tree(out, f"{name}_stepped", stepped)
    cfg = gpt2.tiny()
    full = _tree.map_leaves(_t, _unpack(inp, "gpt2_"))
    step = ex.TensorParallelGPT2Step(cfg, fused_adam(lr=1e-3), remat=True)
    loss, grads = step.grads(ex.shard_params(full, cfg),
                             tok, torch.roll(tok, -1, dims=-1))
    out["ex_loss"] = _np(loss)
    _save_tree(out, "ex_g", grads)
    ps.destroy_model_parallel()
    return out


# ------------------------------------------------------------ on the card

def suite_cp_cuda(rank, n, inp, directory):
    """Two ranks sharing the GPU over a throwaway gloo group bound to
    ``"cp"``: the differentiable all-to-all of a CUDA tensor (rank r's x
    [2, 6] = 100 * i + 10 * r + arange(6) in row i, split on dim 0 and
    gathered on dim 1; the cotangent (i + 1) in every element of
    gathered chunk i), and ``ring_attention`` (causal, GQA, fp32) on this
    rank's half of the sequence with its backward."""
    import torch
    import torch.distributed as dist

    from apex_tpu_torch.distributed import backend as B
    from apex_tpu_torch.transformer import context_parallel as cp

    dev = torch.device("cuda", torch.cuda.current_device())
    group = dist.new_group([0, 1], backend="gloo")
    B.bind("cp", group)
    out = {}
    x = (torch.arange(6.0, device=dev)[None, :]
         + 100 * torch.arange(2.0, device=dev)[:, None] + 10 * rank)
    x.requires_grad_()
    y = B.all_to_all(x, "cp", split_axis=0, concat_axis=1)
    ct = torch.cat([torch.full((1, 6), 1.0, device=dev),
                    torch.full((1, 6), 2.0, device=dev)], dim=1)
    y.backward(ct)
    out["a2a_x"], out["a2a"], out["a2a_grad"] = _np(x), _np(y), _np(x.grad)
    out["device"] = np.array(str(y.device))
    q, k, v, do = (torch.from_numpy(_seq_block(inp[t], rank, n)).to(dev)
                   for t in ("q", "k", "v", "do"))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = cp.ring_attention(q, k, v, causal=True)
    o.backward(do)
    for name, t in (("o", o), ("dq", q.grad), ("dk", k.grad),
                    ("dv", v.grad)):
        out[name] = _np(t)
    torch.cuda.synchronize()
    B.unbind("cp")
    dist.destroy_process_group(group)
    return out


def suite_cp_ring_off(rank, n, inp, directory):
    """``ring_attention`` under ``kernel_config.force("off")``, with and
    without ``remat``, in every RING_CASES case (outputs and this rank's
    dq, dk, dv for the cotangent ``do``); and the flash ring's block
    calls made under "off" and under "auto" on one case: the ring is the
    flash ring in both."""
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import kernel_config
    from apex_tpu_torch.transformer import context_parallel as cp
    from apex_tpu_torch.transformer import parallel_state as ps

    ps.initialize_model_parallel(context_parallel_size_=n)
    out = {}
    calls = []
    flash_fwd = fa._flash_fwd

    def counted(*args, **kw):
        calls.append(kernel_config.mode())
        return flash_fwd(*args, **kw)

    def causal_block_calls(mode):
        del calls[:]
        q, k, v = (_t(_seq_block(inp[f"causal_mha_{t}"], rank, n))
                   for t in ("q", "k", "v"))
        with kernel_config.force(mode):
            cp.ring_attention(q, k, v, causal=True)
        return np.array(len(calls))

    fa._flash_fwd = counted
    try:
        for remat in (True, False):
            for name, (causal, _) in RING_CASES.items():
                q, k, v, do = (_t(_seq_block(inp[f"{name}_{t}"], rank, n))
                               for t in ("q", "k", "v", "do"))
                q, k, v = (t.requires_grad_() for t in (q, k, v))
                with kernel_config.force("off"):
                    o = cp.ring_attention(q, k, v, causal=causal,
                                          remat=remat)
                    o.backward(do)
                tag = f"{name}_{int(remat)}"
                out[f"{tag}_o"] = _np(o)
                for t, g in (("dq", q.grad), ("dk", k.grad),
                             ("dv", v.grad)):
                    out[f"{tag}_{t}"] = _np(g)
        out["off_flash_calls"] = causal_block_calls("off")
        out["auto_flash_calls"] = causal_block_calls("auto")
    finally:
        fa._flash_fwd = flash_fwd
    ps.destroy_model_parallel()
    return out


SUITES = {"cp_ring": suite_cp_ring, "cp_llama": suite_cp_llama,
          "ep_moe": suite_ep_moe, "tp_models": suite_tp_models,
          "cp_cuda": suite_cp_cuda, "cp_ring_off": suite_cp_ring_off}
