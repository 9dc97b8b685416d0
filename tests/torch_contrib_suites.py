"""The port's side of the multi-rank contrib and hf_finetune tests:
suites that run on every rank of a gloo group on the CPU (through
``torch_dist_worker.run_ranks``) and save what they computed. Inputs are
the test's numpy arrays; a tree comes as flat keys ``<prefix>p.<path>``
(``torch_megatron_suites._unpack``). The world group is bound to "dp"
and "data"; the suites bind "spatial" to it too. This file imports torch
and the port, never JAX.
"""

from __future__ import annotations

import numpy as np

from torch_dist_worker import _np, _t
from torch_megatron_suites import _unpack


def _rows(a, rank: int, n: int, dim: int = 0):
    size = a.shape[dim] // n
    return np.take(a, np.arange(rank * size, (rank + 1) * size), axis=dim)


def _save_tree(out, tag, tree):
    from apex_tpu_torch import _tree

    for path, leaf in zip(_tree.paths(tree), _tree.leaves(tree)):
        out[f"{tag}.{'.'.join(path)}"] = _np(leaf)


def _tensors(tree, dtype=None):
    from apex_tpu_torch import _tree

    return _tree.map_leaves(lambda a: _t(a, dtype), tree)


# ------------------------------------------------------------------ halo

EXCHANGERS = ("NoComm", "AllGather", "SendRecv", "Peer")


def suite_contrib_halo(rank, n, inp, directory):
    """``halo_exchange_1d`` on this rank's H rows of ``inp["map"]``
    (margins of 1 and 2 rows), ``PeerHaloExchanger1d`` along W, and the
    four exchangers on ``inp["left"][rank]`` / ``inp["right"][rank]``;
    each output and the gradients of ``sum(out * w)``."""
    import torch
    import torch.nn.functional as F

    from apex_tpu_torch.contrib import halo_exchangers as hx
    from apex_tpu_torch.contrib import peer_memory as pm
    from apex_tpu_torch.distributed import backend as B

    B.bind("spatial", B.get_group("dp"))
    out = {}
    slab = _t(_rows(inp["map"], rank, n, dim=1))
    for hh in (1, 2):
        y = F.pad(slab, (0, 0, 0, 0, hh, hh)).requires_grad_()
        got = pm.halo_exchange_1d(y, hh, "spatial", h_dim=1)
        (got * _t(inp[f"w{hh}"][rank])).sum().backward()
        out[f"halo{hh}"], out[f"halo{hh}_grad"] = _np(got), _np(y.grad)
    y = F.pad(slab, (0, 0, 1, 1))
    out["peer_w"] = _np(pm.PeerHaloExchanger1d(half_halo=1)(
        y, H_split=False))
    for name in EXCHANGERS:
        left = _t(inp["left"][rank]).requires_grad_()
        right = _t(inp["right"][rank]).requires_grad_()
        ex = getattr(hx, f"HaloExchanger{name}")(axis_name="spatial")
        li, ri = ex.left_right_halo_exchange(left, right)
        (li * _t(inp["wl"][rank]) + ri * _t(inp["wr"][rank])).sum() \
            .backward()
        out[f"{name}_li"], out[f"{name}_ri"] = _np(li), _np(ri)
        out[f"{name}_dl"], out[f"{name}_dr"] = _np(left.grad), \
            _np(right.grad)
    pool = pm.PeerMemoryPool(device="cpu")
    out["pool"] = _np(pool.allocate_peer_tensors((2, 3), torch.float32,
                                                 False, False)[0])
    return out


# ------------------------------------------------------------ bottleneck

def suite_contrib_bottleneck(rank, n, inp, directory):
    """``SpatialBottleneck`` (BatchNorm statistics over the spatial
    group) on this rank's H rows of ``inp["x"]``, for each case of
    ``inp["cases"]`` (features, strides): the output, the input's
    gradient and the params' gradients of ``sum(y * dy)`` (this rank's
    share; their sum over the ranks is the whole map's), and the new
    batch stats."""
    import torch

    from apex_tpu_torch import _tree
    from apex_tpu_torch.contrib.bottleneck import SpatialBottleneck
    from apex_tpu_torch.distributed import backend as B

    B.bind("spatial", B.get_group("dp"))
    out = {}
    for c, (features, stride) in enumerate(inp["cases"].tolist()):
        block = SpatialBottleneck(features, (stride, stride),
                                  axis_name="spatial", sync_bn=True,
                                  bn_axis="spatial")
        variables = _tensors(_unpack(inp, f"c{c}"))
        x = _t(_rows(inp[f"x{c}"], rank, n, dim=1)).requires_grad_()
        live = _tree.map_leaves(lambda t: t.requires_grad_(),
                                variables["params"])
        y, stats = block.apply({"params": live,
                                "batch_stats": variables["batch_stats"]},
                               x, train=True)
        dy = _t(_rows(inp[f"dy{c}"], rank, n, dim=1))
        grads = torch.autograd.grad((y * dy).sum(),
                                    [x] + _tree.leaves(live))
        out[f"y{c}"], out[f"dx{c}"] = _np(y), _np(grads[0])
        _save_tree(out, f"g{c}", _tree.unflatten(_tree.paths(live),
                                                 list(grads[1:])))
        _save_tree(out, f"s{c}", stats)
    return out


def suite_contrib_groupbn(rank, n, inp, directory):
    """``BatchNorm2d_NHWC(bn_group=n)`` (add+ReLU) on this rank's rows:
    output, new stats and the input's gradient."""
    from apex_tpu_torch.contrib.groupbn import BatchNorm2d_NHWC

    bn = BatchNorm2d_NHWC(inp["x"].shape[-1], bn_group=n, momentum=0.8,
                          axis_name="data")
    variables = _tensors(_unpack(inp, "bn"))
    x = _t(_rows(inp["x"], rank, n)).requires_grad_()
    y, stats = bn.apply(variables, x, _t(_rows(inp["z"], rank, n)))
    (y * _t(_rows(inp["dy"], rank, n))).sum().backward()
    out = {"y": _np(y), "dx": _np(x.grad)}
    _save_tree(out, "s", stats)
    return out


# ------------------------------------------------------------ optimizers

def suite_contrib_dist_opt(rank, n, inp, directory):
    """``DistributedFusedAdam`` and ``DistributedFusedLAMB`` over "dp"
    from ``inp``'s params (an fp32 and a bf16 bucket), this rank's grads
    ``g<step>.<leaf>[rank]`` each step: the params after each step, the
    final state's shards, and ``dist_adam_partition_specs``."""
    import torch

    from apex_tpu_torch.contrib.optimizers import (
        DistributedFusedAdam,
        DistributedFusedLAMB,
        dist_adam_partition_specs,
    )

    out = {}
    steps = int(inp["steps"])
    for name, cls, kw in (
            ("adam", DistributedFusedAdam,
             dict(lr=1e-2, weight_decay=0.01)),
            ("lamb", DistributedFusedLAMB,
             dict(lr=1e-2, eps=1e-6, weight_decay=0.01,
                  max_grad_norm=1.0))):
        params = _unpack(inp, "")
        params = {k: _t(v, torch.bfloat16 if k.startswith("bf") else None)
                  for k, v in params.items()}
        opt = cls(params, **kw)
        opt.init()
        for s in range(steps):
            grads = {k: _t(inp[f"g{s}.{k}"][rank]).to(v.dtype)
                     for k, v in params.items()}
            opt.step(grads)
            for k, v in params.items():
                out[f"{name}{s}.{k}"] = _np(v.float())
        for field in ("master_shard", "mu_shard", "nu_shard"):
            for k, v in getattr(opt.state, field).items():
                out[f"{name}_{field}.{k}"] = _np(v)
        out[f"{name}_count"] = _np(opt.state.count)
    specs = dist_adam_partition_specs(params)
    out["specs"] = np.array(repr(specs))
    return out


# ------------------------------------------------------------ hf_finetune

def suite_hf_finetune(rank, n, inp, directory):
    """The hf_finetune example's step on this rank's rows of
    ``inp["tokens"]``: the HF-layout dict ``hfp.<key>`` through
    ``llama_from_hf``, the synced step-0 gradients and loss, then one
    ``train_step`` (the tree ``fused_adam``): the params after it."""
    import torch

    from apex_tpu_torch.examples import hf_finetune as ex
    from apex_tpu_torch.models import convert
    from apex_tpu_torch.optimizers import fused_adam

    sd = {k[4:]: _t(v) for k, v in inp.items() if k.startswith("hfp.")}
    cfg_hf = ex.tiny_hf_config()
    params, cfg = convert.llama_from_hf(
        sd, convert.llama_config_from_hf(cfg_hf), dtype=torch.float32,
        device="cpu")
    tokens = ex.rank_rows(_t(inp["tokens"]))
    targets = ex.rank_rows(_t(inp["targets"]))
    loss, grads = ex.grads(params, tokens, targets, cfg)
    out = {"loss": _np(loss)}
    _save_tree(out, "grads", grads)
    tx = fused_adam(lr=1e-3)
    opt = tx.init(params)
    loss1, opt = ex.train_step(params, opt, tokens, targets, cfg, tx)
    _save_tree(out, "params1", params)
    out["loss1"] = _np(loss1)
    return out


SUITES = {"contrib_halo": suite_contrib_halo,
          "contrib_bottleneck": suite_contrib_bottleneck,
          "contrib_groupbn": suite_contrib_groupbn,
          "contrib_dist_opt": suite_contrib_dist_opt,
          "hf_finetune": suite_hf_finetune}
