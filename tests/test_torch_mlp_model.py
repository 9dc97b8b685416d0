"""The port's MLP model (``apex_tpu_torch.models.mlp``) against the JAX
package's (``apex_tpu.models.mlp``) on the CPU: the forward and the
softmax cross entropy across the three activations, with and without
bias, from the same numpy params (carried by ``params_from_numpy``) and
batch. fp32 on both sides, products in another summation order: 1e-5
relative (1e-6 absolute)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.models import mlp as jmlp
from apex_tpu_torch.models import mlp

RTOL, ATOL = 1e-5, 1e-6
SIZES = (20, 32, 16, 5)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("activation", ["relu", "sigmoid", "none"])
def test_forward_and_loss_match_jax(activation, bias):
    jcfg = jmlp.MLPConfig(sizes=SIZES, activation=activation, bias=bias)
    cfg = mlp.MLPConfig(sizes=SIZES, activation=activation, bias=bias)
    jparams = jmlp.init_params(jax.random.PRNGKey(0), jcfg)
    if bias:  # biases away from their zero init
        jparams = {"layers": [dict(layer, b=layer["b"] + 0.1 * (i + 1))
                              for i, layer in enumerate(jparams["layers"])]}
    params = mlp.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, SIZES[0])).astype(np.float32)
    y = rng.integers(0, SIZES[-1], 8).astype(np.int32)
    got = mlp.forward(params, torch.from_numpy(x), cfg)
    want = jmlp.forward(jparams, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    loss = mlp.loss_fn(params, (torch.from_numpy(x), torch.from_numpy(y)),
                       cfg)
    jloss = jmlp.loss_fn(jparams, (jnp.asarray(x), jnp.asarray(y)), jcfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)


def test_init_laws_and_unknown_activation():
    cfg = mlp.MLPConfig(sizes=(512, 256, 3))
    params = mlp.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    w = params["layers"][0]["w"]
    assert w.shape == (512, 256) and w.dtype == torch.float32
    assert abs(float(w.std()) - 512 ** -0.5) < 0.05 * 512 ** -0.5
    assert not params["layers"][1]["b"].any()
    with pytest.raises(ValueError, match="unknown activation"):
        mlp.forward(params, torch.zeros(1, 512),
                    mlp.MLPConfig(sizes=(512, 256, 3), activation="gelu"))
