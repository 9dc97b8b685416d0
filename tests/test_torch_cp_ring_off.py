"""The port's context-parallel ring under ``kernel_config.force("off")``
held against the JAX package's jnp online-softmax ring (``ring_attention``
with Pallas off).

The reference switches to a second, jnp ring when Pallas is off; the
port keeps its flash ring in every mode, whose block calls then take the
flash kernels' plain versions. The port runs on 2 gloo CPU ranks
(``tests/torch_cp_suites.py`` ``cp_ring_off``), with and without
``remat`` (which the flash ring does not need); the reference under
``shard_map`` on the conftest's simulated devices. Outputs and dq, dk,
dv, causal and not, MHA and GQA, within 1e-5 of each array's largest
value (fp32), the tolerance of ``test_torch_context_parallel.py``.
"""

import pytest

from test_torch_context_parallel import (
    _block,
    _close,
    _reference_ring,
    _ring_inputs,
)
from torch_cp_suites import RING_CASES
from torch_dist_worker import run_ranks

N = 2


@pytest.fixture(scope="module")
def off_ranks(tmp_path_factory):
    inputs = _ring_inputs()
    ranks = run_ranks("cp_ring_off", N, tmp_path_factory.mktemp("off"),
                      inputs)
    return inputs, ranks


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_under_off_matches_reference_jnp_ring(off_ranks, name, remat):
    inputs, ranks = off_ranks
    want = _reference_ring(N, inputs, name, "off")
    for r, res in enumerate(ranks):
        for t, w in zip(("o", "dq", "dk", "dv"), want):
            _close(res[f"{name}_{int(remat)}_{t}"], _block(w, r, N),
                   f"ring under off, cp{N} {name} remat={remat} rank {r} "
                   f"{t}")


def test_off_keeps_the_flash_ring(off_ranks):
    _, ranks = off_ranks
    for res in ranks:
        # causal at cp 2: rank 0 runs its diagonal block, rank 1 two
        assert int(res["off_flash_calls"]) == int(res["auto_flash_calls"])
        assert int(res["off_flash_calls"]) >= 1
