"""The port's HuggingFace import (apex_tpu_torch.models.convert) against
the JAX package's: tiny ``transformers`` Llama, GPT-2 and BERT models
built from local configs (as tests/run_models/test_hf_convert.py builds
them; no weights are fetched). The converted params equal the JAX
converter's exactly (both read fp32 and reshape), and the port's logits
match the HF model's within the reference test's 2e-4.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from apex_tpu.models import convert as jax_convert  # noqa: E402
from apex_tpu_torch import _tree  # noqa: E402
from apex_tpu_torch.models import bert, convert, gpt2, llama  # noqa: E402

TOL = 2e-4


def _llama_hf():
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rms_norm_eps=1e-5,
        tie_word_embeddings=False)
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(hf_cfg).eval()


def _gpt2_hf():
    hf_cfg = transformers.GPT2Config(
        vocab_size=256, n_embd=64, n_layer=2, n_head=4, n_positions=64,
        attn_pdrop=0.0, embd_pdrop=0.0, resid_pdrop=0.0)
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(hf_cfg).eval()


def _bert_hf():
    hf_cfg = transformers.BertConfig(
        vocab_size=256, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=256,
        max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    hf = transformers.BertForMaskedLM(hf_cfg).eval()
    with torch.no_grad():  # a real checkpoint's decoder bias is nonzero
        hf.cls.predictions.bias.uniform_(-0.1, 0.1)
    return hf


def _port_logits(family, params, cfg, tokens):
    if family == "llama":
        return llama.forward(params, tokens, cfg)
    if family == "gpt2":
        return gpt2.forward(params, tokens, cfg, remat=False)
    hidden = bert.forward(params, tokens, cfg, remat=False)
    return bert.mlm_logits(params, hidden, cfg)


FAMILIES = {"llama": (_llama_hf, 0), "gpt2": (_gpt2_hf, 1),
            "bert": (_bert_hf, 2)}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_converter_matches_jax_and_hf(family):
    make, seed = FAMILIES[family]
    hf = make()
    params, cfg = getattr(convert, f"{family}_from_hf")(
        hf, dtype=torch.float32, device="cpu")
    jparams, jcfg = getattr(jax_convert, f"{family}_from_hf")(
        hf, dtype=jax.numpy.float32)
    # the configs agree field for field (dtype aside)
    jfields = dataclasses.asdict(jcfg)
    for field, value in dataclasses.asdict(cfg).items():
        if field != "dtype":
            assert value == jfields[field], field
    # the params: same tree, same values, fp32 exact
    assert _tree.paths(params) == [
        tuple(k.key for k in kp) for kp, _ in
        jax.tree_util.tree_flatten_with_path(jparams)[0]]
    for got, ref in zip(_tree.leaves(params),
                        jax.tree_util.tree_leaves(jparams)):
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    tokens = np.random.default_rng(seed).integers(0, 256, (2, 16))
    with torch.no_grad():
        want = hf(torch.from_numpy(tokens)).logits.numpy()
        got = _port_logits(family, params, cfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_converters_take_a_state_dict_and_a_dtype():
    hf = _gpt2_hf()
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    params, cfg = convert.gpt2_from_hf(sd, cfg=convert.gpt2_config_from_hf(
        hf.config), device="cpu")
    assert cfg.dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for t in _tree.leaves(params))
    ref, _ = convert.gpt2_from_hf(hf, dtype=torch.float32, device="cpu")
    for a, b in zip(_tree.leaves(params), _tree.leaves(ref)):
        assert torch.equal(a, b.to(torch.bfloat16))
