"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: without a GPU every test here skips. On the GPU
machine run them with ``python -m pytest tests/test_torch_kernels_cuda.py``
(``chip_smoke.py`` holds the same kernels at the serving path's shapes).
"""

import pytest
import torch

from apex_tpu_torch.ops import flash_attention as fa
from apex_tpu_torch.ops import layer_norm as ln

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("h", [64, 100, 4096])
@pytest.mark.parametrize("affine", [True, False])
def test_rms_norm_kernel_matches_plain(gen, dtype, h, affine):
    """h = 100 is no multiple of 8 and takes the scalar path."""
    x = torch.randn(37, h, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(h, generator=gen, device="cuda").to(dtype)
         if affine else None)
    before = ln.launches
    y, rstd = ln._rms_fwd_cuda(x, w, 1e-5)
    assert ln.launches == before + 1
    y_ref, rstd_ref = ln._rms_fwd_plain(x, w, 1e-5)
    tol = {torch.float32: 1e-5, torch.bfloat16: 8e-3,
           torch.float16: 1e-3}[dtype]
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol, atol=1e-6)
    torch.testing.assert_close(rstd, rstd_ref, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h_kv", [4, 2, 1])
@pytest.mark.parametrize("sq,sk,d", [(40, 40, 64), (200, 200, 128),
                                     (33, 70, 80)])
def test_flash_fwd_kernel_matches_plain(gen, dtype, causal, h_kv, sq, sk, d):
    b, h = 2, 4
    q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, sk, h_kv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, sk, h_kv, d, generator=gen, device="cuda").to(dtype)
    o, lse = fa._flash_fwd_cuda(q, k, v, causal, d ** -0.5)
    flat = [t.transpose(1, 2).reshape(-1, t.shape[1], d) for t in (q, k, v)]
    o_ref, lse_ref = fa._flash_fwd_plain(*flat, causal, d ** -0.5)
    o_ref = o_ref.reshape(b, h, sq, d).transpose(1, 2)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-3)


def test_flash_rejects_what_the_kernel_does_not_take(gen):
    q = torch.zeros(1, 8, 2, 192, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device="cuda")
    with pytest.raises(NotImplementedError, match="kv_lens"):
        fa.flash_attention(q, q, q, kv_lens=torch.tensor([8], device="cuda"))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), q.half(), q.half())
