"""The port's standalone test harness (``apex_tpu_torch.transformer.
testing``) against the JAX package's (``apex_tpu.transformer.testing``),
the cases of ``tests/run_transformer/test_testing_harness.py``: the
argument parser (the same namespace for the same flags), the global
singletons and timers, the toy stage model, DistributedTestBase over
gloo groups, and the standalone GPT and BERT through the collective
pipeline at pp 2 on 2 gloo ranks (``torch_example_suites.py``) against
the single stage in one process and the JAX package's loss.

Tolerance: losses within 1e-5 relative; gradients elementwise within
1e-5 and a floor of 1e-5 times the largest gradient of the model (fp32
sums in another order, the pipeline's io gradients summed over two
stages).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import bert as jbert
from apex_tpu.models import gpt2 as jgpt2
from apex_tpu.transformer.testing import commons as jcommons
from apex_tpu.transformer.testing.arguments import parse_args as jparse
from apex_tpu_torch import _tree
from apex_tpu_torch.models import bert, gpt2
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.testing import (
    commons,
    fwd_step_func,
    global_vars,
    set_random_seed,
    standalone_bert,
    standalone_gpt,
)
from apex_tpu_torch.transformer.testing.arguments import parse_args
from apex_tpu_torch.transformer.testing.distributed_test_base import (
    DistributedTestBase,
    NcclDistributedTestBase,
)
from torch_dist_worker import run_ranks
from torch_example_suites import HARNESS_ARGS

RTOL = 1e-5
M = 2


@pytest.fixture(autouse=True)
def _clean_globals():
    global_vars.destroy_global_vars()
    yield
    global_vars.destroy_global_vars()
    ps.destroy_model_parallel()


MEGATRON_ARGV = ["--num-layers", "8", "--hidden-size", "32",
                 "--num-attention-heads", "4", "--micro-batch-size", "2",
                 "--global-batch-size", "16",
                 "--tensor-model-parallel-size", "2",
                 "--pipeline-model-parallel-size", "2", "--bf16",
                 "--some-unknown-cuda-flag", "7"]


@pytest.mark.parametrize("argv", [MEGATRON_ARGV, [], HARNESS_ARGS,
                                  ["--fp16", "--kv-channels", "5"]],
                         ids=["megatron", "defaults", "harness", "fp16"])
def test_parse_args_matches_jax(argv):
    assert vars(parse_args(args=argv)) == vars(jparse(args=argv))


def test_parse_args_derived_values_and_rejections():
    args = parse_args(args=MEGATRON_ARGV)
    assert args.ffn_hidden_size == 128 and args.kv_channels == 8
    assert args.model_parallel_size == 4
    assert args.params_dtype == "bfloat16"
    with pytest.raises(ValueError, match="mutually exclusive"):
        parse_args(args=["--fp16", "--bf16"])
    with pytest.raises(ValueError, match="num_layers"):
        parse_args(args=["--num-layers", "6",
                         "--pipeline-model-parallel-size", "2",
                         "--virtual-pipeline-model-parallel-size", "2"])
    args = parse_args(defaults={"seed": 7, "hidden-size": 99}, args=[])
    # a parsed value is kept, as in the reference
    assert args.seed == 1234 and args.hidden_size == 64

    def extra(parser):
        parser.add_argument("--my-flag", type=int, default=3)
        return parser

    assert parse_args(extra, args=["--my-flag", "5"]).my_flag == 5
    with pytest.raises(SystemExit):
        parse_args(args=["--bogus"], ignore_unknown_args=False)


def test_global_vars_lifecycle():
    with pytest.raises(AssertionError):
        global_vars.get_args()
    args = global_vars.set_global_variables(
        args=["--global-batch-size", "8", "--micro-batch-size", "2"],
        data_parallel_size=2)
    assert global_vars.get_args() is args
    assert global_vars.get_num_microbatches() == 2  # 8 / (2 * 2)
    assert global_vars.get_current_global_batch_size() == 8
    with pytest.raises(AssertionError):
        global_vars.set_global_variables(args=[])  # double init


def test_timers():
    global_vars.set_global_variables(args=[], data_parallel_size=1)
    timers = global_vars.get_timers()
    timers("fwd").start()
    time.sleep(0.01)
    timers("fwd").stop()
    assert timers("fwd").elapsed(reset=False) >= 0.01
    lines = []
    timers.log(["fwd"], printer=lines.append)
    assert lines[0].startswith("time (ms) | fwd: ")


def test_toy_model_and_fwd_step_match_jax():
    gen = set_random_seed(1234)
    sp = commons.init_toy_stage_params(gen, hidden_size=8,
                                       layers_per_stage=2, device="cpu")
    assert sp["w"].shape == (2, 8, 8) and sp["b"].shape == (2, 8)
    x = np.random.default_rng(0).standard_normal((4, 8)).astype(np.float32)
    y, loss_fn = fwd_step_func(torch.from_numpy(x), sp)
    jy, jloss_fn = jcommons.fwd_step_func(
        jnp.asarray(x), {k: jnp.asarray(v.numpy()) for k, v in sp.items()})
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=RTOL,
                               atol=1e-6)
    loss, metrics = loss_fn(y)
    np.testing.assert_allclose(float(loss), float(jloss_fn(jy)[0]),
                               rtol=RTOL)
    assert "avg" in metrics
    init_fn, stage_fn = commons.model_provider_func(8)
    assert stage_fn is commons.toy_stage_fn
    assert init_fn(gen, device="cpu")["w"].shape == (1, 8, 8)
    assert commons.process_batch((x,)) is x
    assert commons.IdentityLayer(gen, (3,), device="cpu")().shape == (3,)


def test_distributed_test_base_in_one_process():
    """With no world started the base makes one of one rank for each
    test and ends it; a case that needs more ranks skips; the NCCL base
    skips without a GPU."""
    import unittest

    from apex_tpu_torch.distributed import backend as B

    class OneRank(DistributedTestBase):
        def test_world_of_its_own(self):
            assert self.world_size == 1
            assert self.mesh.shape == {"pp": 1, "dp": 1, "cp": 1, "tp": 1}

    class NeedsTwo(DistributedTestBase):
        TP = 2

        def test_skipped(self):
            raise AssertionError("ran on one rank")

    cases = [OneRank, NeedsTwo]
    if not torch.cuda.is_available():
        class _Nccl(NcclDistributedTestBase):
            def test_skipped(self):
                raise AssertionError("NCCL without a GPU")

        cases.append(_Nccl)
    suite = unittest.TestSuite(
        unittest.defaultTestLoader.loadTestsFromTestCase(c) for c in cases)
    result = unittest.TextTestRunner(verbosity=0).run(suite)
    assert result.wasSuccessful()
    assert len(result.skipped) == len(cases) - 1
    assert not B.is_initialized() and not ps.model_parallel_is_initialized()


def test_build_mesh_in_one_process():
    mesh = commons.build_mesh((1, 1), ("pp", "tp"))
    assert mesh.shape == {"pp": 1, "tp": 1}
    with pytest.raises(RuntimeError, match="grid of 2 ranks"):
        commons.build_mesh((2, 1), ("pp", "tp"))


def _inputs():
    rng = np.random.default_rng(0)
    args = parse_args(args=HARNESS_ARGS)
    shape = (M, args.micro_batch_size, args.seq_length)
    return {"gpt_tokens": rng.integers(0, 64, shape).astype(np.int64),
            "bert_tokens": rng.integers(0, 64, shape).astype(np.int64),
            "bert_targets": rng.integers(0, 64, shape).astype(np.int64),
            "bert_mask": (rng.random(shape) < 0.5).astype(np.float32)}


def _single(name, inp):
    """The single stage in one process (the port's model, tp unbound):
    the microbatches' mean loss and its gradients; the JAX package's
    loss on the same params."""
    args = parse_args(args=HARNESS_ARGS)
    model, jmodel = (gpt2, jgpt2) if name == "gpt" else (bert, jbert)
    provider = (standalone_gpt.gpt_model_provider if name == "gpt"
                else standalone_bert.bert_model_provider)
    cfg = provider(args)[0]
    params = model.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    live = _tree.map_leaves(lambda p: p.clone().requires_grad_(), params)
    tokens = torch.from_numpy(inp[f"{name}_tokens"])
    jcfg = jmodel.tiny(**{f: getattr(cfg, f) for f in (
        "vocab_size", "hidden_size", "num_layers", "num_heads",
        "max_seq_len", "ln_eps")}, dtype=jnp.float32)
    jparams = jax.tree_util.tree_map(
        jnp.asarray, _tree.map_leaves(lambda t: t.numpy(), params))
    losses, jlosses = [], []
    for m in range(M):
        if name == "gpt":
            batch = (tokens[m], torch.roll(tokens[m], -1, dims=-1))
        else:
            batch = (tokens[m], torch.from_numpy(inp["bert_targets"][m]),
                     torch.from_numpy(inp["bert_mask"][m]))
        losses.append(model.loss_fn(live, batch, cfg, remat=False,
                                    tp_axis=None))
        jlosses.append(float(jmodel.loss_fn(
            jparams, tuple(jnp.asarray(b.numpy()) for b in batch), jcfg,
            tp_axis=None, remat=False)))
    loss = torch.stack(losses).mean()
    grads = _tree.unflatten(_tree.paths(live), list(torch.autograd.grad(
        loss, _tree.leaves(live))))
    return float(loss), float(np.mean(jlosses)), grads


@pytest.fixture(scope="module")
def piped(tmp_path_factory):
    inp = _inputs()
    return inp, run_ranks("harness_pipeline", 2,
                          tmp_path_factory.mktemp("harness"), inp)


def test_distributed_test_base_over_gloo_ranks(piped):
    _, ranks = piped
    for r in ranks:
        assert bool(r["base_ok"]) and int(r["base_run"]) == 2
        assert int(r["base_skipped"]) == 1
        assert int(r["mesh_pp"]) == 2 and int(r["mesh_dp"]) == 1
        assert int(r["build_mesh"]) == 2


@pytest.mark.parametrize("name", ["gpt", "bert"])
def test_standalone_pipeline_matches_single_stage(piped, name):
    inp, ranks = piped
    loss, jloss, grads = _single(name, inp)
    np.testing.assert_allclose(loss, jloss, rtol=RTOL)
    for r in ranks:
        np.testing.assert_allclose(float(r[f"{name}_loss"]), loss, rtol=RTOL)
    top = max(float(g.abs().max()) for g in _tree.leaves(grads))
    per_stage = {k: v.shape[0] // 2 for k, v in grads["layers"].items()}
    for rank, r in enumerate(ranks):
        for k, g in grads["layers"].items():
            n = per_stage[k]
            np.testing.assert_allclose(
                r[f"{name}_gstage_{k}"], g[rank * n:(rank + 1) * n].numpy(),
                rtol=RTOL, atol=RTOL * top, err_msg=k)
        for k, g in grads.items():
            if k != "layers":
                np.testing.assert_allclose(r[f"{name}_gio_{k}"], g.numpy(),
                                           rtol=RTOL, atol=RTOL * top,
                                           err_msg=k)


def test_standalone_configs_match_jax():
    from apex_tpu.transformer.testing import standalone_bert as jsb
    from apex_tpu.transformer.testing import standalone_gpt as jsg

    for argv in (HARNESS_ARGS, HARNESS_ARGS + ["--bf16"]):
        args, jargs = parse_args(args=argv), jparse(args=argv)
        for ours, theirs in (
                (standalone_gpt.gpt_config_from_args(args),
                 jsg.gpt_config_from_args(jargs)),
                (standalone_bert.bert_config_from_args(args),
                 jsb.bert_config_from_args(jargs))):
            fields = [f for f in vars(ours) if f != "dtype"]
            assert {f: getattr(ours, f) for f in fields} == {
                f: getattr(theirs, f) for f in fields}
            assert str(ours.dtype).split(".")[-1] == jnp.dtype(
                theirs.dtype).name
