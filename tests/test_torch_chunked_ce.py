"""Parity of the port's chunked lm-head cross entropy
(apex_tpu_torch.transformer.functional.chunked_ce) with the JAX
package's, single-device: per-token losses and the gradients of hidden,
weight and bias, from the same numpy inputs. All math is fp32 on both
sides and differs in summation order only: losses to 1e-5, gradients to
1e-5 relative (atol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.transformer.functional import chunked_ce as jax_ce
from apex_tpu_torch.transformer.functional import chunked_ce as port_ce
from apex_tpu_torch.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy,
)


def _inputs(n=13, h=16, v=48, seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((n, h)).astype(np.float32)
    weight = (rng.standard_normal((h, v)) / 4).astype(np.float32)
    bias = rng.standard_normal(v).astype(np.float32)
    labels = rng.integers(0, v, size=n).astype(np.int32)
    g = rng.standard_normal(n).astype(np.float32)
    return hidden, weight, bias, labels, g


@pytest.mark.parametrize("num_chunks", [1, 4, 8])
@pytest.mark.parametrize("with_bias", [True, False])
def test_chunked_ce_value_and_grads_match_jax(num_chunks, with_bias):
    hidden, weight, bias, labels, g = _inputs(seed=num_chunks)
    args = (hidden, weight, bias) if with_bias else (hidden, weight)

    def jfn(*a):
        return jax_ce.chunked_lm_cross_entropy(
            a[0], a[1], jnp.asarray(labels), num_chunks,
            bias=a[2] if with_bias else None)

    ref, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    grads_ref = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    got = port_ce.chunked_lm_cross_entropy(
        leaves[0], leaves[1], torch.from_numpy(labels), num_chunks,
        bias=leaves[2] if with_bias else None)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(g))
    assert got.dtype == torch.float32 and tuple(got.shape) == (13,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
    for name, a, r in zip(("hidden", "weight", "bias"), grads, grads_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_chunked_ce_equals_full_logits_ce():
    """The streamed loss equals the CE of the materialized logits."""
    hidden, weight, _, labels, _ = _inputs(seed=9)
    got = port_ce.chunked_lm_cross_entropy(
        torch.from_numpy(hidden), torch.from_numpy(weight),
        torch.from_numpy(labels), 6)
    full = vocab_parallel_cross_entropy(
        torch.from_numpy(hidden) @ torch.from_numpy(weight),
        torch.from_numpy(labels).long())
    torch.testing.assert_close(got, full, rtol=1e-5, atol=1e-6)


def test_bf16_inputs_give_fp32_losses_and_grads_in_input_dtypes():
    hidden, weight, bias, labels, _ = _inputs(seed=3)
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
              for a in (hidden, weight, bias)]
    loss = port_ce.chunked_lm_cross_entropy(
        leaves[0], leaves[1], torch.from_numpy(labels), 4, bias=leaves[2])
    assert loss.dtype == torch.float32
    grads = torch.autograd.grad(loss.sum(), leaves)
    assert all(g.dtype == torch.bfloat16 for g in grads)


def test_vocab_not_divisible_by_chunks_is_loud():
    hidden, weight, _, labels, _ = _inputs()
    with pytest.raises(ValueError, match="num_chunks"):
        port_ce.chunked_lm_cross_entropy(
            torch.from_numpy(hidden), torch.from_numpy(weight),
            torch.from_numpy(labels), 5)
