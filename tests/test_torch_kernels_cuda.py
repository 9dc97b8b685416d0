"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: without a GPU every test here skips. On the GPU
machine run them with ``python -m pytest tests/test_torch_kernels_cuda.py``
(``chip_smoke.py`` holds the same kernels at the serving and training
paths' shapes).
"""

import pytest
import torch

from apex_tpu_torch.ops import flash_attention as fa
from apex_tpu_torch.ops import fused_adam_kernel as fak
from apex_tpu_torch.ops import layer_norm as ln
from apex_tpu_torch.transformer.functional import fused_softmax as sm

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


def _assert_near(got, ref, rel, what=""):
    """max |got - ref| <= rel * max |ref|: the error relative to the
    output's scale, for sums whose rounding scales with their terms."""
    got, ref = got.float(), ref.float()
    scale = float(ref.abs().max()) or 1.0
    err = float((got - ref).abs().max())
    assert err <= rel * scale, f"{what}: max err {err} > {rel} * {scale}"


def _flat(t):
    return t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3])


def _flash_bwd_inputs(gen, dtype, h, h_kv, sq, sk, d, b=2):
    q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, sk, h_kv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, sk, h_kv, d, generator=gen, device="cuda").to(dtype)
    do = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dtype)
    return q, k, v, do


def _check_flash_bwd(q, k, v, do, causal):
    """dq and dk/dv against _flash_bwd_plain on the same (q, k, v, o,
    lse, do), one launch of each kernel. fp32 (FMA kernels): summation
    order only; bf16 (tensor cores): P and dS rounded once to bf16 before
    their products and one output rounding (2^-9 of the value) on top."""
    b, _, h, d = q.shape
    h_kv = k.shape[2]
    scale = d ** -0.5
    o, lse = fa._flash_fwd_cuda(q, k, v, causal, scale)
    before = (fa.dq_launches, fa.dkv_launches)
    dq, dk, dv = fa._flash_bwd_cuda(q, k, v, o, lse, do, causal, scale)
    assert (fa.dq_launches, fa.dkv_launches) == (before[0] + 1,
                                                 before[1] + 1)
    ref = fa._flash_bwd_plain(_flat(q), _flat(k), _flat(v), _flat(o), lse,
                              _flat(do), causal, scale)
    torch.cuda.synchronize()
    rel = 2e-5 if q.dtype == torch.float32 else 1e-2
    for name, got, r, n in (("dq", dq, ref[0], h), ("dk", dk, ref[1], h_kv),
                            ("dv", dv, ref[2], h_kv)):
        assert got.dtype == q.dtype
        r = r.reshape(b, n, -1, d).transpose(1, 2)
        _assert_near(got, r, rel, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,h_kv", [
    pytest.param(4, 4, id="4"), pytest.param(4, 2, id="2"),
    pytest.param(4, 1, id="1"), pytest.param(8, 1, id="1-rep8")])
@pytest.mark.parametrize("causal,sq,sk,d", [
    (True, 40, 40, 64), (False, 40, 40, 64), (True, 200, 200, 128),
    (False, 200, 200, 128), (False, 33, 70, 80), (True, 130, 130, 32),
    (True, 300, 300, 128), (False, 129, 257, 64), (True, 129, 257, 64),
    (True, 257, 129, 80)])
def test_flash_bwd_kernels_match_plain(gen, dtype, causal, h, h_kv, sq, sk,
                                       d):
    """rep = h // h_kv (8 sums eight query heads into one kv head);
    ragged lengths pad the 64-row tiles (and span several of them at 300
    and 257). Causal with sk > sq leaves key tiles past sq that no query
    sees (zero dk, dv); with sq > sk the diagonal of the last q tiles
    runs past sk."""
    _check_flash_bwd(*_flash_bwd_inputs(gen, dtype, h, h_kv, sq, sk, d),
                     causal)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [20, 32, 80])
def test_flash_bwd_bf16_head_dims_take_the_tensor_cores(gen, causal, d):
    """d = 20 and 32 pad the 64-column tiles with zero columns, d = 80
    the 128-column ones; d = 20 is no multiple of 8 and takes the element
    copies. Each launches the tensor-core kernels once."""
    _check_flash_bwd(*_flash_bwd_inputs(gen, torch.bfloat16, 4, 2, 257,
                                        257, d), causal)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_bf16_unaligned_views(gen, causal):
    """Views whose row stride (81 elements) is no multiple of 8 take the
    tensor-core kernels' element copies instead of 16-byte cp.async."""
    def view(n, s):
        wide = torch.randn(2, s, n, 81, generator=gen, device="cuda")
        return wide.to(torch.bfloat16)[..., :80]

    q, k, v, do = view(4, 150), view(2, 150), view(2, 150), view(4, 150)
    assert q.stride(2) == 81
    _check_flash_bwd(q, k, v, do, causal)


def test_flash_bwd_bf16_is_deterministic(gen):
    """No atomics: two calls give bit-identical dq, dk and dv."""
    q, k, v, do = _flash_bwd_inputs(gen, torch.bfloat16, 8, 2, 300, 300, 128)
    o, lse = fa._flash_fwd_cuda(q, k, v, True, 128 ** -0.5)
    first = fa._flash_bwd_cuda(q, k, v, o, lse, do, True, 128 ** -0.5)
    second = fa._flash_bwd_cuda(q, k, v, o, lse, do, True, 128 ** -0.5)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_autograd_launches_both_backward_kernels(gen):
    q = torch.randn(1, 64, 4, 64, generator=gen, device="cuda",
                    requires_grad=True)
    kv = torch.randn(1, 64, 2, 64, generator=gen, device="cuda",
                     requires_grad=True)
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    o = fa.flash_attention(q, kv, kv, causal=True)
    o.sum().backward()
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == tuple(
        x + 1 for x in before)
    with torch.no_grad():
        fa.flash_attention(q, kv, kv, causal=True)
    assert fa.dq_launches == before[1] + 1
    assert torch.isfinite(q.grad).all() and torch.isfinite(kv.grad).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("h", [64, 100, 4096])
@pytest.mark.parametrize("rows", [1, 37, 1000])
@pytest.mark.parametrize("affine", [True, False])
def test_rms_norm_bwd_kernel_matches_plain(gen, dtype, h, rows, affine):
    """h = 100 is no multiple of 8 and takes the scalar path; 1000 rows
    is more than the DW_PARTS blocks of the dw partials."""
    x = torch.randn(rows, h, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(rows, h, generator=gen, device="cuda").to(dtype)
    w = ((1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(dtype)
         if affine else None)
    _, rstd = ln._rms_fwd_cuda(x, w, 1e-5)
    before = ln.bwd_launches
    got = ln._rms_bwd_cuda(x, w, rstd, dy)
    assert ln.bwd_launches == before + 1
    ref = ln._rms_bwd_plain(x, w, rstd, dy)
    torch.cuda.synchronize()
    if not affine:
        got, ref = (got,), (ref,)
    rel = {torch.float32: 2e-5, torch.bfloat16: 8e-3,
           torch.float16: 1e-3}[dtype]
    for name, a, r in zip(("dx", "dw"), got, ref):
        assert a.dtype == r.dtype and a.shape == r.shape
        _assert_near(a, r, rel, name)


@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16,
                                     torch.float16])
@pytest.mark.parametrize("n,offset", [(1, 0), (7, 0), (1001, 0),
                                      ((1 << 20) + 3, 0), (4099, 1)])
@pytest.mark.parametrize("adam_w_mode,weight_decay", [(True, 0.0),
                                                      (True, 0.01),
                                                      (False, 0.01)])
@pytest.mark.parametrize("bias_correction", [True, False])
def test_adam_kernel_matches_plain(gen, p_dtype, n, offset, adam_w_mode,
                                   weight_decay, bias_correction):
    """Odd slab sizes take the scalar tail, offset 1 misaligns every slab
    (the scalar path). The kernel rounds each operation on its own, as
    the plain version's eager ops do, so m and v agree to a few fp32
    ulps and delta to one ulp of p's dtype."""
    def slab(dtype=torch.float32, scale=1.0):
        t = torch.randn(n + offset, generator=gen, device="cuda") * scale
        return t.to(dtype)[offset:]

    g, p = slab(), slab(p_dtype)
    m, v = slab(scale=0.1), slab(scale=0.1).abs()
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=weight_decay,
              adam_w_mode=adam_w_mode, bias_correction=bias_correction)
    m_ref, v_ref = m.clone(), v.clone()
    before = fak.launches
    delta, m2, v2 = fak._adam_flat_cuda(g, p, m, v, 1e-3, 7, **kw)
    assert fak.launches == before + 1 and m2 is m and v2 is v
    d_ref, _, _ = fak._adam_flat_plain(g, p, m_ref, v_ref, 1e-3, 7, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(m, m_ref, rtol=2e-6, atol=1e-7)
    torch.testing.assert_close(v, v_ref, rtol=2e-6, atol=1e-9)
    assert delta.dtype == p_dtype
    # one ulp of p's dtype; fp16 deltas below 2^-14 are subnormal, where
    # an ulp is 2^-24 absolute
    rtol, atol = {torch.float32: (2e-6, 1e-9), torch.bfloat16: (8e-3, 1e-9),
                  torch.float16: (1e-3, 2.0 ** -24)}[p_dtype]
    torch.testing.assert_close(delta.float(), d_ref.float(), rtol=rtol,
                               atol=atol)


LN_REL = {torch.float32: 2e-5, torch.bfloat16: 8e-3, torch.float16: 1e-3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("h", [64, 100, 768, 1024, 4096])
@pytest.mark.parametrize("rows", [1, 37, 1000])
@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_kernels_match_plain(gen, dtype, h, rows, affine):
    """Forward (y, mu, rstd) and backward (dx, dw, db) against the plain
    versions. h = 100 is no multiple of 8 and takes the scalar path; 1000
    rows is more than the DW_PARTS blocks of the dw/db partials; x has a
    mean of 0.5 so the centring matters. Outputs within one ulp of their
    dtype of the output's scale (fp32: summation order)."""
    x = (2 * torch.randn(rows, h, generator=gen, device="cuda") + 0.5).to(
        dtype)
    dy = torch.randn(rows, h, generator=gen, device="cuda").to(dtype)
    w = b = None
    if affine:
        w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(dtype)
        b = (0.1 * torch.randn(h, generator=gen, device="cuda")).to(dtype)
    before = (ln.ln_launches, ln.ln_bwd_launches)
    y, mu, rstd = ln._ln_fwd_cuda(x, w, b, 1e-5)
    got = ln._ln_bwd_cuda(x, w, mu, rstd, dy)
    assert (ln.ln_launches, ln.ln_bwd_launches) == (before[0] + 1,
                                                    before[1] + 1)
    y_ref, mu_ref, rstd_ref = ln._ln_fwd_plain(x, w, b, 1e-5)
    ref = ln._ln_bwd_plain(x, w, mu, rstd, dy)
    torch.cuda.synchronize()
    rel = LN_REL[dtype]
    assert y.dtype == dtype
    _assert_near(y, y_ref, rel, "y")
    torch.testing.assert_close(mu, mu_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rstd, rstd_ref, rtol=1e-5, atol=0)
    if not affine:
        got, ref = (got,), (ref,)
    for name, a, r in zip(("dx", "dw", "db"), got, ref):
        assert a.dtype == r.dtype and a.shape == r.shape
        _assert_near(a, r, rel, name)


def test_layer_norm_mixed_dtype_and_autograd_launch_both_kernels(gen):
    """bf16 activations with fp32 affine params (the mixed-dtype API),
    through the autograd Function: one forward and one backward launch,
    grads in their inputs' dtypes."""
    from apex_tpu_torch.normalization import fused_layer_norm as fln

    x = torch.randn(3, 5, 768, generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()
    w = torch.ones(768, device="cuda", requires_grad=True)
    b = torch.zeros(768, device="cuda", requires_grad=True)
    before = (ln.ln_launches, ln.ln_bwd_launches)
    y = fln.mixed_dtype_fused_layer_norm_affine(x, w, b, 768, eps=1e-12)
    y.float().square().sum().backward()
    assert (ln.ln_launches, ln.ln_bwd_launches) == (before[0] + 1,
                                                    before[1] + 1)
    assert y.dtype == x.grad.dtype == torch.bfloat16
    assert w.grad.dtype == b.grad.dtype == torch.float32
    y_ref, _, _ = ln._ln_fwd_plain(x.detach().reshape(-1, 768), w.detach(),
                                   b.detach(), 1e-12)
    _assert_near(y.detach().reshape(-1, 768), y_ref, 8e-3, "y")


SM_TOL = {torch.float32: (2e-5, 1e-7), torch.bfloat16: (8e-3, 1e-6),
          torch.float16: (1e-3, 1e-7)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("sq,sk", [(1, 1), (37, 37), (33, 70), (128, 1024),
                                   (7, 4099), (3, 16384)])
@pytest.mark.parametrize("scale", [1.0, 0.125])
def test_causal_softmax_kernel_matches_plain(gen, dtype, sq, sk, scale):
    """sq < sk checks the sk - sq offset; sk = 4099 takes the scalar
    path; 16384 is the whole-row limit (16 values a thread). Each output
    is exp(s - max) / sum rounded once: within one ulp of its dtype."""
    x = (4 * torch.randn(5, sq, sk, generator=gen, device="cuda")).to(dtype)
    before = sm.causal_launches
    y = sm._causal_cuda(x, scale)
    assert sm.causal_launches == before + 1
    ref = sm._causal_plain(x, scale)
    torch.cuda.synchronize()
    rtol, atol = SM_TOL[dtype]
    assert y.dtype == dtype
    torch.testing.assert_close(y.float(), ref.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("sq,sk", [(16, 16), (5, 37), (64, 512),
                                   (9, 1000)])
@pytest.mark.parametrize("mask_kind", ["padding", "full", "rows"])
def test_masked_softmax_kernel_matches_plain(gen, dtype, sq, sk, mask_kind):
    """x [2, 3, sq, sk] with a [2, 1, 1, sk] padding mask (read through
    zero strides), a full [2, 3, sq, sk] mask with one fully masked row
    (uniform 1/sk), or a [sq, sk] mask broadcast over both lead dims."""
    x = (4 * torch.randn(2, 3, sq, sk, generator=gen, device="cuda")).to(
        dtype)
    if mask_kind == "padding":
        mask = torch.zeros(2, 1, 1, sk, dtype=torch.bool, device="cuda")
        mask[1, ..., 3:] = True
    elif mask_kind == "full":
        mask = torch.rand(2, 3, sq, sk, generator=gen, device="cuda") < 0.3
        mask[0, 1, sq - 1] = True
    else:
        mask = torch.rand(sq, sk, generator=gen, device="cuda") < 0.5
    before = sm.masked_launches
    y = sm._masked_cuda(x, mask, 0.125)
    assert sm.masked_launches == before + 1
    ref = sm._masked_plain(x, mask, 0.125)
    torch.cuda.synchronize()
    rtol, atol = SM_TOL[dtype]
    torch.testing.assert_close(y.float(), ref.float(), rtol=rtol, atol=atol)
    if mask_kind == "full":
        torch.testing.assert_close(y[0, 1, sq - 1].float(),
                                   torch.full((sk,), 1.0 / sk,
                                              device="cuda"),
                                   rtol=rtol, atol=atol)


def test_softmax_autograd_launches_one_forward_kernel(gen):
    """The backward is plain PyTorch from the saved output: one kernel
    launch per forward, none in the backward."""
    x = torch.randn(2, 4, 16, 16, generator=gen, device="cuda",
                    requires_grad=True)
    mask = torch.zeros(2, 1, 1, 16, dtype=torch.bool, device="cuda")
    before = (sm.causal_launches, sm.masked_launches)
    y1 = sm.scaled_upper_triang_masked_softmax(x.reshape(8, 16, 16), None,
                                               0.5)
    y2 = sm.scaled_masked_softmax(x, mask, 0.5)
    (y1.sum() + y2.square().sum()).backward()
    assert (sm.causal_launches, sm.masked_launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("sq,sk", [(1, 1), (5, 100), (8, 16400),
                                   (16, 32768), (3, 20001)])
@pytest.mark.parametrize("mask_kind", ["causal", "padding", "full"])
def test_blocked_softmax_kernels_match_plain(gen, dtype, sq, sk, mask_kind):
    """The stats and apply kernels against the plain two passes, at any
    sk (20001 is odd: the scalar path), causal with sq < sk, a [2, 1, 1,
    sk] padding mask read through zero strides, or a full mask with one
    fully masked row (uniform 1/sk)."""
    x = (4 * torch.randn(2, 3, sq, sk, generator=gen, device="cuda")).to(
        dtype)
    mask = None
    if mask_kind == "padding":
        mask = torch.zeros(2, 1, 1, sk, dtype=torch.bool, device="cuda")
        mask[1, ..., 3:] = True
    elif mask_kind == "full":
        mask = torch.rand(2, 3, sq, sk, generator=gen, device="cuda") < 0.3
        mask[0, 1, sq - 1] = True
    before = (sm.stats_launches, sm.apply_launches)
    m, l = sm._stats_cuda(x, mask, 0.125)
    y = sm._apply_cuda(x, mask, 0.125, m, l)
    assert (sm.stats_launches, sm.apply_launches) == (before[0] + 1,
                                                      before[1] + 1)
    causal = mask is None
    m_ref, l_ref = sm._stats_plain(x, mask, 0.125, causal)
    ref = sm._apply_plain(x, mask, 0.125, causal, m_ref, l_ref)
    torch.cuda.synchronize()
    torch.testing.assert_close(m, m_ref, rtol=0, atol=0)
    torch.testing.assert_close(l, l_ref, rtol=2e-5, atol=0)
    rtol, atol = SM_TOL[dtype]
    assert y.dtype == dtype
    torch.testing.assert_close(y.float(), ref.float(), rtol=rtol, atol=atol)
    if mask_kind == "full":
        torch.testing.assert_close(y[0, 1, sq - 1].float(),
                                   torch.full((sk,), 1.0 / sk,
                                              device="cuda"),
                                   rtol=rtol, atol=atol)


def test_blocked_softmax_minus_inf_rows(gen):
    """Rows whose first blocks are -inf normalize; a row all below the
    fill value too (the running max starts at -inf)."""
    x = torch.randn(1, 4, 20000, generator=gen, device="cuda")
    x[:, :, :12000] = -torch.inf
    x[:, 2] = -30000.0
    y = sm._blocked_cuda(x, None, 1.0)
    ref = sm._blocked_plain(x, None, 1.0, causal=True)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y, ref, rtol=2e-5, atol=1e-7)


def test_long_rows_reach_the_blocked_kernels(gen):
    """sk above the whole-row limit launches the two passes, once each per
    forward and never the whole-row kernels, through every entry point,
    FusedScaleMaskSoftmax included; the backward launches nothing."""
    from apex_tpu_torch.transformer.enums import AttnMaskType
    from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax

    sk = sm._WHOLE_ROW_MAX_SK + 1
    x = torch.randn(1, 2, 4, sk, generator=gen, device="cuda",
                    requires_grad=True)
    pad = torch.zeros(1, 1, 1, sk, dtype=torch.bool, device="cuda")
    pad[..., -5:] = True

    def counts():
        return (sm.causal_launches, sm.masked_launches, sm.stats_launches,
                sm.apply_launches)

    before = counts()
    ys = [sm.scaled_upper_triang_masked_softmax(x[0], None, 1.0),
          sm.scaled_masked_softmax(x, pad, 1.0),
          FusedScaleMaskSoftmax(attn_mask_type=AttnMaskType.causal)(x),
          FusedScaleMaskSoftmax(attn_mask_type=AttnMaskType.causal)(x, pad),
          FusedScaleMaskSoftmax(attn_mask_type=AttnMaskType.padding,
                                scale=0.5).forward_fused_softmax(x, pad)]
    sum(y.float().square().sum() for y in ys).backward()
    assert counts() == (before[0], before[1], before[2] + 5, before[3] + 5)
    assert torch.isfinite(x.grad).all()
    ref = FusedScaleMaskSoftmax(attn_mask_type=AttnMaskType.causal
                                ).forward_torch_softmax(x, pad)
    assert counts()[2:] == (before[2] + 5, before[3] + 5)
    torch.testing.assert_close(ys[3], ref, rtol=2e-5, atol=1e-7)


# ----------------------------------------------------------------- fp8


FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _cast_counts():
    from apex_tpu_torch.ops import fp8_cast_kernel as fc

    return fc.launches, fc.col_launches


def _cast_pair(x, scale, fp8, col_major=False):
    from apex_tpu_torch.ops import fp8_cast_kernel as fc

    row, col = _cast_counts()
    y, amax = fc._cast_and_scale_cuda(x, scale, fp8, FP8[fp8], col_major)
    assert _cast_counts() == ((row, col + 1) if col_major else (row + 1, col))
    y_ref, amax_ref = fc._cast_and_scale_plain(x, scale, fp8, FP8[fp8],
                                               col_major)
    torch.cuda.synchronize()
    return y, amax, y_ref, amax_ref


def _assert_bits(y, y_ref):
    nan, nan_ref = torch.isnan(y.float()), torch.isnan(y_ref.float())
    assert torch.equal(nan, nan_ref)
    assert torch.equal(y.view(torch.uint8)[~nan],
                       y_ref.view(torch.uint8)[~nan_ref])


@pytest.mark.parametrize("fp8", sorted(FP8, key=str))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("n", list(range(1, 33)) + [4099, 1 << 20])
def test_fp8_cast_kernel_bits_equal_plain(gen, fp8, dtype, n):
    """Every tail length mod 16 (n = 1..32), an odd size and a large one;
    scale 1.7 saturates the largest E4M3 values."""
    x = (300 * torch.randn(n, generator=gen, device="cuda")
         * torch.exp(-12 * torch.rand(n, generator=gen, device="cuda"))
         ).to(dtype)
    for scale in (1.7, torch.tensor(0.37, device="cuda")):
        y, amax, y_ref, amax_ref = _cast_pair(x, scale, fp8)
        assert y.dtype == fp8 and y.shape == x.shape
        _assert_bits(y, y_ref)
        assert float(amax) == float(amax_ref)


@pytest.mark.parametrize("fp8", sorted(FP8, key=str))
def test_fp8_cast_kernel_saturates_and_propagates_nan(gen, fp8):
    fmax = FP8[fp8]
    x = torch.randn(4096, generator=gen, device="cuda")
    x[:4] = torch.tensor([1e9, -1e9, torch.inf, -torch.inf])
    y, amax, y_ref, amax_ref = _cast_pair(x, 2.0, fp8)
    _assert_bits(y, y_ref)
    assert y[:4].float().tolist() == [fmax, -fmax, fmax, -fmax]
    assert float(amax) == float(amax_ref) == float("inf")
    for at in (0, 17, 4095):  # a NaN anywhere wins the amax
        xn = x.clone()
        xn[at] = torch.nan
        y, amax, y_ref, amax_ref = _cast_pair(xn, 2.0, fp8)
        _assert_bits(y, y_ref)
        assert torch.isnan(y[at].float()) and torch.isnan(amax)


def test_fp8_cast_kernel_views_and_2d(gen):
    """A misaligned view (the scalar path) and a 2-D weight."""
    x = torch.randn(1001, generator=gen, device="cuda").to(torch.bfloat16)
    y, amax, y_ref, amax_ref = _cast_pair(x[3:], 1.0, torch.float8_e4m3fn)
    _assert_bits(y, y_ref)
    assert float(amax) == float(amax_ref)
    w = torch.randn(256, 384, generator=gen, device="cuda").to(torch.bfloat16)
    y, amax, y_ref, amax_ref = _cast_pair(w, 30.0, torch.float8_e4m3fn)
    assert y.shape == w.shape
    _assert_bits(y, y_ref)


def test_fp8_cast_kernel_scalar_launches_and_empty_raises(gen):
    """A 0-dim CUDA x launches the kernel (y of shape ()), bits equal to
    the plain version; an empty one raises, as max of nothing does."""
    from apex_tpu_torch.ops import fp8_cast_kernel as fc

    for fp8 in FP8:
        x = torch.tensor(-500.0, device="cuda")
        row, col = _cast_counts()
        y, amax = fc.cast_and_scale_stats(x, 1.0, fp8, FP8[fp8])
        assert _cast_counts() == (row + 1, col)
        y_ref, amax_ref = fc._cast_and_scale_plain(x, 1.0, fp8, FP8[fp8])
        assert y.shape == () and amax.shape == ()
        _assert_bits(y, y_ref)
        assert float(amax) == float(amax_ref) == 500.0
        with pytest.raises(RuntimeError, match="empty"):
            fc.cast_and_scale_stats(torch.zeros(0, device="cuda"), 1.0, fp8,
                                    FP8[fp8])
        assert _cast_counts() == (row + 1, col)


@pytest.mark.parametrize("fp8", sorted(FP8, key=str))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (4, 1000), (64, 64),
                                   (65, 130), (127, 193), (256, 384),
                                   (130, 17), (1000, 3)])
def test_fp8_cast_col_major_kernel_bits_equal_plain(gen, fp8, dtype, shape):
    """The column-major kernel at whole and partial 64 x 64 tiles, rows
    a multiple of 4 (word stores) or not (byte stores): y laid out
    (1, rows), bits and amax equal to the plain version."""
    rows, cols = shape
    x = (300 * torch.randn(shape, generator=gen, device="cuda")
         * torch.exp(-12 * torch.rand(shape, generator=gen, device="cuda"))
         ).to(dtype)
    for scale in (1.7, torch.tensor(0.37, device="cuda")):
        y, amax, y_ref, amax_ref = _cast_pair(x, scale, fp8, col_major=True)
        assert y.dtype == fp8 and y.shape == x.shape
        assert y.stride() == (1, rows)
        _assert_bits(y, y_ref)
        assert float(amax) == float(amax_ref)


def test_fp8_cast_col_major_kernel_nan_and_view(gen):
    """A NaN anywhere in the tile grid wins the amax; a column slice (a
    non-contiguous x) is cast from its values, and so is a misaligned
    one."""
    x = torch.randn(200, 96, generator=gen, device="cuda")
    x[0, 0] = 1e9
    for at in ((0, 1), (63, 64), (199, 95)):
        xn = x.clone()
        xn[at] = torch.nan
        y, amax, y_ref, amax_ref = _cast_pair(xn, 2.0, torch.float8_e4m3fn,
                                              col_major=True)
        _assert_bits(y, y_ref)
        assert torch.isnan(y[at].float()) and torch.isnan(amax)
        assert float(y[0, 0].float()) == 448.0
    y, amax, y_ref, amax_ref = _cast_pair(x[:, 5:70], 1.0,
                                          torch.float8_e5m2, col_major=True)
    _assert_bits(y, y_ref)
    assert float(amax) == float(amax_ref)
    # a contiguous x 2 bytes off a 16-byte boundary: one element a thread
    flat = torch.randn(1 + 192 * 256, generator=gen, device="cuda").to(
        torch.bfloat16)
    y, amax, y_ref, amax_ref = _cast_pair(flat[1:].view(192, 256), 1.0,
                                          torch.float8_e4m3fn, col_major=True)
    _assert_bits(y, y_ref)
    assert float(amax) == float(amax_ref)


def test_matmul_fp8_on_the_card_matches_the_cpu(gen):
    """The fp8 GEMM against the CPU's upcast product on the same
    operands: the fp8 values are equal bit for bit, the sums differ in
    order (1e-2 of the output's scale), and two casts launch a product
    (the activation row-major, the weight column-major); the backward
    launches one more (the cotangent, row-major)."""
    from apex_tpu_torch.ops import precision

    for m in (1, 8, 16, 512):
        a = torch.randn(m, 256, generator=gen, device="cuda").to(
            torch.bfloat16).requires_grad_()
        b = (0.05 * torch.randn(256, 384, generator=gen, device="cuda")).to(
            torch.bfloat16).requires_grad_()
        row, col = _cast_counts()
        y = precision.matmul_fp8(a, b, 1.0, 30.0)
        assert _cast_counts() == (row + 1, col + 1)
        y.float().sum().backward()
        assert _cast_counts() == (row + 2, col + 1)
        ac, bc = (t.detach().cpu().requires_grad_() for t in (a, b))
        y_ref = precision.matmul_fp8(ac, bc, 1.0, 30.0)
        y_ref.float().sum().backward()
        torch.cuda.synchronize()
        assert y.dtype == torch.bfloat16
        for got, ref in ((y, y_ref), (a.grad, ac.grad), (b.grad, bc.grad)):
            got, ref = got.detach().float().cpu(), ref.detach().float()
            assert float((got - ref).abs().max()) <= \
                1e-2 * float(ref.abs().max())


def test_fp8_serving_reaches_the_cast_kernel(gen):
    """weight_mode="fp8" on CUDA tensors: every layer product launches the
    row-major cast for its activation and the column-major cast for its
    weight, in each prefill and in each decode step, and tokens come out
    for every request."""
    from apex_tpu_torch.models import llama
    from apex_tpu_torch.observability import MetricRegistry
    from apex_tpu_torch.serving import ServingEngine

    cfg = llama.tiny(dtype=torch.bfloat16)
    params = llama.init_params(gen, cfg, device="cuda")
    engine = ServingEngine(params, cfg, num_pages=32, page_size=8,
                           max_batch=2, max_prompt_len=16, max_new_cap=4,
                           weight_mode="fp8", registry=MetricRegistry())
    row, col = _cast_counts()
    engine.submit(torch.arange(5).numpy(), 4)
    engine.submit(torch.arange(9).numpy(), 3)
    results = engine.run()
    sched = engine.scheduler
    want = 7 * cfg.num_layers * (sched.prefill_count + sched.decode_steps)
    assert _cast_counts() == (row + want, col + want) and want > 0
    assert {rid: len(r["tokens"]) for rid, r in results.items()} == {
        0: 4, 1: 3}
