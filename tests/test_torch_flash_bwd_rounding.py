"""The rounding of the tensor-core flash backward (``csrc/flash_bwd.cu``,
bf16 path) emulated on the CPU, against ``_flash_bwd_plain``.

The bf16 kernels feed bf16 q, k, v and dO to the products, sum S and dP
in fp32, round P and dS once to bf16 before the second products (dV +=
P^T dO, dK += dS^T Q, dQ += dS K), sum those in fp32 and round each
output once. The plain version keeps P and dS in fp32. This holds the
emulation to the tolerance that the card's tests and ``chip_smoke.py``
hold the kernels to: max |kernel - plain| <= 1e-2 * max |plain|, at
ragged lengths (300 spans five 64-row tiles), rep 1, 4 and 8, and
d = 64, 80 and 128, causal and full.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch.ops import flash_attention as fa

REL = 1e-2  # tests/test_torch_kernels_cuda.py and chip_smoke.py hold this
SEQ = 300


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(torch.bfloat16)


def _tensor_core_bwd(q, k, v, o, lse, do, causal, scale):
    """The kernels' arithmetic on [bh, s, d] bf16 tensors: fp32 sums of
    bf16 products, P and dS rounded once to bf16, outputs rounded once."""
    bh, sq, d = q.shape
    bh_kv, sk, _ = k.shape
    rep = bh // bh_kv
    qf = q.float().reshape(bh_kv, rep, sq, d)
    dof = do.float().reshape(bh_kv, rep, sq, d)
    kf, vf = k.float(), v.float()
    # delta as _flash_delta gives it: fp32 from the bf16 o and dO
    delta = torch.sum(dof * o.float().reshape(bh_kv, rep, sq, d), dim=-1,
                      keepdim=True)
    s = torch.einsum("grqd,gkd->grqk", qf, kf)
    p = torch.exp(scale * s - lse.reshape(bh_kv, rep, sq, 1))
    if causal:
        keep = torch.arange(sk)[None, :] <= torch.arange(sq)[:, None]
        p = torch.where(keep, p, torch.zeros_like(p))
    dp = torch.einsum("grqd,gkd->grqk", dof, vf)
    ds = p * (dp - delta) * scale
    p16 = p.to(torch.bfloat16).float()
    ds16 = ds.to(torch.bfloat16).float()
    dq = torch.einsum("grqk,gkd->grqd", ds16, kf)
    dk = torch.einsum("grqk,grqd->gkd", ds16, qf)
    dv = torch.einsum("grqk,grqd->gkd", p16, dof)
    return (dq.reshape(bh, sq, d).to(torch.bfloat16),
            dk.to(torch.bfloat16), dv.to(torch.bfloat16))


# Of the 18 combinations of causal/full x rep 1, 4, 8 x d 64, 80, 128,
# the five with the largest error (0.0057 to 0.0075 of max |plain|)
# that between them take every value of each.
@pytest.mark.parametrize("causal,rep,d", [
    (True, 1, 80), (True, 4, 64), (True, 8, 128), (False, 4, 80),
    (False, 8, 128)])
def test_tensor_core_rounding_within_card_tolerance(causal, rep, d):
    rng = np.random.default_rng(1000 * rep + d + int(causal))
    h = 8
    bh, bh_kv = h, h // rep
    q, do = _bf16(rng, bh, SEQ, d), _bf16(rng, bh, SEQ, d)
    k, v = _bf16(rng, bh_kv, SEQ, d), _bf16(rng, bh_kv, SEQ, d)
    scale = d ** -0.5
    # o and lse as the forward kernel gives them: o in bf16, lse fp32
    o, lse = fa._flash_fwd_plain(q, k, v, causal, scale)
    ref = fa._flash_bwd_plain(q, k, v, o, lse, do, causal, scale)
    got = _tensor_core_bwd(q, k, v, o, lse, do, causal, scale)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == r.dtype == torch.bfloat16
        err = float((g.float() - r.float()).abs().max())
        top = float(r.float().abs().max())
        assert err <= REL * top, f"{name}: {err} > {REL} * {top}"
        # the emulated rounding really moves the result
        assert err > 0, name
