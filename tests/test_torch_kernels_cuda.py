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


@pytest.mark.parametrize("b,s", [(4, 512), (1, 7), (2, 130)])
def test_flash_fwd_kernel_at_gpt2_generate_prefill(gen, b, s):
    """gpt2_generate's prefill: GPT-2 345M's 16 heads of 64, causal, no
    GQA, bf16 (4 prompts of 512 in chip_smoke.py's gpt2_resilient
    phase), and ragged prompt lengths; one launch a call."""
    h, d = 16, 64
    q, k, v = (torch.randn(b, s, h, d, generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    before = fa.launches
    o, lse = fa._flash_fwd_cuda(q, k, v, True, d ** -0.5)
    assert fa.launches == before + 1
    flat = [t.transpose(1, 2).reshape(-1, s, d) for t in (q, k, v)]
    o_ref, lse_ref = fa._flash_fwd_plain(*flat, True, d ** -0.5)
    o_ref = o_ref.reshape(b, h, s, d).transpose(1, 2)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-3)


def test_flash_rejects_what_the_kernel_does_not_take(gen):
    q = torch.zeros(1, 8, 2, 192, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device="cuda")
    # kv_lens launches the kernel on the card, as it runs the plain
    # version on the CPU
    before = fa.launches
    o = fa.flash_attention(q, q, q, kv_lens=torch.tensor([5], device="cuda"))
    assert fa.launches == before + 1 and not o[:, 5:].any()
    with pytest.raises(ValueError, match="dropout_key"):
        fa.flash_attention(q, q, q, dropout_p=0.1)
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


# varlen and dropout: one length a sequence (b = 2; the kernels take one a
# flat query row), an empty sequence among them; the seed above 2**31
VARLEN_DROP = {"varlen": ([57, 0], 0.0), "dropout": (None, 0.2),
               "varlen+dropout": ([130, 57], 0.2)}
SEED = 3_000_000_001


def _extras(mode, h, sq):
    lens, p_drop = VARLEN_DROP[mode]
    if lens is None:
        return None, p_drop, SEED
    lens = torch.tensor([min(n, sq) for n in lens], dtype=torch.int32,
                        device="cuda")
    return torch.repeat_interleave(lens, h), p_drop, SEED


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", sorted(VARLEN_DROP))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h_kv,sq,d", [(4, 200, 128), (1, 130, 64),
                                       (2, 300, 80)])
def test_flash_fwd_kernel_varlen_dropout_matches_plain(gen, dtype, mode,
                                                       causal, h_kv, sq, d):
    """The forward's varlen and dropout branches (fp32 FMA and bf16
    tensor-core kernels) against the plain version with the same kv_lens
    and seed; the empty sequence gives o = 0, lse = -1e30."""
    b, h = 2, 4
    q = torch.randn(b, sq, h, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, sq, h_kv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, sq, h_kv, d, generator=gen, device="cuda").to(dtype)
    extras = _extras(mode, h, sq)
    before = fa.launches
    o, lse = fa._flash_fwd_cuda(q, k, v, causal, d ** -0.5, *extras)
    assert fa.launches == before + 1
    o_ref, lse_ref = fa._flash_fwd_plain(*(_flat(t) for t in (q, k, v)),
                                         causal, d ** -0.5, *extras)
    o_ref = o_ref.reshape(b, h, sq, d).transpose(1, 2)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-3)
    if extras[0] is not None and int(extras[0][-1]) == 0:
        assert not o[1].any() and bool((lse[h:] == -1e30).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", sorted(VARLEN_DROP))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,h_kv,sq,d", [(4, 4, 200, 128), (4, 1, 130, 64),
                                         (8, 1, 300, 80)])
def test_flash_bwd_kernels_varlen_dropout_match_plain(gen, dtype, mode,
                                                      causal, h, h_kv, sq,
                                                      d):
    """dq and dk/dv with kv_lens and dropout against _flash_bwd_plain on
    the same (q, k, v, o, lse, do, kv_lens, seed): the masks are selected
    (lse = -1e30 on the empty sequence), key tiles past every row's
    kv_len write zeros, and dropout recomputes the forward's mask."""
    q, k, v, do = _flash_bwd_inputs(gen, dtype, h, h_kv, sq, sq, d)
    extras = _extras(mode, h, sq)
    scale = d ** -0.5
    o, lse = fa._flash_fwd_cuda(q, k, v, causal, scale, *extras)
    before = (fa.dq_launches, fa.dkv_launches)
    dq, dk, dv = fa._flash_bwd_cuda(q, k, v, o, lse, do, causal, scale,
                                    *extras)
    assert (fa.dq_launches, fa.dkv_launches) == (before[0] + 1,
                                                 before[1] + 1)
    ref = fa._flash_bwd_plain(_flat(q), _flat(k), _flat(v), _flat(o), lse,
                              _flat(do), causal, scale, *extras)
    torch.cuda.synchronize()
    rel = 2e-5 if dtype == torch.float32 else 1e-2
    for name, got, r, n in (("dq", dq, ref[0], h), ("dk", dk, ref[1], h_kv),
                            ("dv", dv, ref[2], h_kv)):
        assert torch.isfinite(got).all(), name
        _assert_near(got, r.reshape(2, n, -1, d).transpose(1, 2), rel, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("varlen", [False, True])
def test_flash_kernel_keep_masks_equal_plain(gen, dtype, varlen):
    """With q = k = 0 every allowed key has p = 1 / l, so with V one-hot in
    the key index (sk <= d) o[q, j] > 0 exactly where key j is kept for
    query q: the forward kernel's keep mask, read off o, equals
    _keep_mask. With dO one-hot in the query index, dV[k, q] > 0 exactly
    where (q, k) is kept: the dk/dv kernel's mask. b = 2, h = 3 (rep 1)
    spreads the flat row index."""
    b, h, s, d, p_drop = 2, 3, 64, 64, 0.3
    z = torch.zeros(b, s, h, d, device="cuda", dtype=dtype)
    eye = torch.eye(s, d, device="cuda", dtype=dtype)[None, :, None, :]
    onehot = eye.expand(b, s, h, d).contiguous()
    lens = torch.tensor([64, 37], dtype=torch.int32, device="cuda")
    rows = torch.repeat_interleave(lens, h) if varlen else None
    o, lse = fa._flash_fwd_cuda(z, z, onehot, False, 1.0, rows, p_drop, SEED)
    dq, dk, dv = fa._flash_bwd_cuda(z, z, onehot, o, lse, onehot, False,
                                    1.0, rows, p_drop, SEED)
    torch.cuda.synchronize()
    keep = fa._keep_mask(SEED, torch.arange(b * h, device="cuda")[:, None,
                                                                  None],
                         torch.arange(s, device="cuda")[:, None],
                         torch.arange(s, device="cuda")[None, :], p_drop)
    if varlen:  # keys past a row's length are never kept
        keep &= (torch.arange(s, device="cuda")[None, None, :]
                 < rows[:, None, None])
    assert 0.5 < float(keep.float().mean()) < 0.8
    seen_fwd = _flat(o)[..., :s] > 0                  # [bh, q, key]
    seen_bwd = (_flat(dv)[..., :s] > 0).transpose(1, 2)   # [bh, q, key]
    assert torch.equal(seen_fwd, keep)
    assert torch.equal(seen_bwd, keep)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_varlen_dropout_reruns_are_bit_identical(gen, dtype):
    q, k, v, do = _flash_bwd_inputs(gen, dtype, 8, 2, 300, 300, 128)
    extras = _extras("varlen+dropout", 8, 300)
    runs = []
    for _ in range(2):
        o, lse = fa._flash_fwd_cuda(q, k, v, True, 128 ** -0.5, *extras)
        runs.append((o, lse, *fa._flash_bwd_cuda(q, k, v, o, lse, do, True,
                                                 128 ** -0.5, *extras)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_fmha_takes_the_packed_qkv_views_without_a_copy(gen, monkeypatch):
    """FMHAFun.apply at BERT's head width: q, k and v reach the kernels
    as the strided views qkv[:, :, i] (same storage); forward and
    backward launch once each, and padded rows of the output and of the
    gradient are exactly zero."""
    from apex_tpu_torch.contrib.fmha import FMHAFun

    seen = []
    real = fa._flash_fwd_cuda

    def spy(q, k, v, *args):
        seen.append((q.data_ptr(), k.data_ptr(), v.data_ptr()))
        return real(q, k, v, *args)

    monkeypatch.setattr(fa, "_flash_fwd_cuda", spy)
    qkv = torch.randn(4, 128, 3, 12, 64, generator=gen, device="cuda").to(
        torch.bfloat16).requires_grad_()
    lens = torch.tensor([128, 100, 64, 1], device="cuda")
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    out = FMHAFun.apply(qkv, seqlens=lens, p_dropout=0.1, dropout_key=7)
    out.float().sum().backward()
    assert seen == [tuple(qkv[:, :, i].data_ptr() for i in range(3))]
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == tuple(
        x + 1 for x in before)
    for i, n in enumerate(lens.tolist()):
        assert not out[i, n:].any() and not qkv.grad[i, n:].any()


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
    # each prefill, each replayed decode step, and the decode graph's
    # warm-up step before its capture
    want = 7 * cfg.num_layers * (sched.prefill_count + sched.decode_steps
                                 + sched.decode_captures())
    assert _cast_counts() == (row + want, col + want) and want > 0
    assert {rid: len(r["tokens"]) for rid, r in results.items()} == {
        0: 4, 1: 3}


# ------------------------------------- row-norm backward: both launch paths

NORM_BWD_CASES = [(rows, h) for h in (64, 100, 768, 1024, 2048, 4096)
                  for rows in (1, 3, 1000, 8192)] + [
    (37, 16384), (37, 20480)]


def _norm_bwd_pair(gen, centred, rows, h, dtype, x=None):
    """(kernel, plain) backward outputs, affine, one launch counted."""
    if x is None:
        x = (2 * torch.randn(rows, h, generator=gen, device="cuda")
             + 0.5).to(dtype)
    dy = torch.randn(rows, h, generator=gen, device="cuda").to(dtype)
    w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(dtype)
    if centred:
        _, mu, rstd = ln._ln_fwd_cuda(x, w, torch.zeros_like(w), 1e-5)
        before = ln.ln_bwd_launches
        got = ln._ln_bwd_cuda(x, w, mu, rstd, dy)
        assert ln.ln_bwd_launches == before + 1
        return got, ln._ln_bwd_plain(x, w, mu, rstd, dy)
    _, rstd = ln._rms_fwd_cuda(x, w, 1e-5)
    before = ln.bwd_launches
    got = ln._rms_bwd_cuda(x, w, rstd, dy)
    assert ln.bwd_launches == before + 1
    return got, ln._rms_bwd_plain(x, w, rstd, dy)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,h", NORM_BWD_CASES)
@pytest.mark.parametrize("centred", [True, False], ids=["ln", "rms"])
def test_norm_bwd_kernel_paths_match_plain(gen, dtype, rows, h, centred):
    """LayerNorm and RMSNorm backward on the register path (one warp a
    row up to 32 x 4 vectors: h <= 1024 in 16-bit dtypes, <= 512 in
    fp32; several warps above) and the loop path (h = 100 is no multiple
    of 8; 20480 is past the register path's 16384 in bf16), rows fewer
    than a block's row slots (1, 3) and more than its partial rows."""
    plan = ln._bwd_plan(rows, h, dtype)
    v = 16 // dtype.itemsize
    assert plan.registers == (h % v == 0 and h // v <= 512 * 4)
    got, ref = _norm_bwd_pair(gen, centred, rows, h, dtype)
    torch.cuda.synchronize()
    for name, a, r in zip(("dx", "dw", "db"), got, ref):
        assert a.dtype == r.dtype and a.shape == r.shape
        _assert_near(a, r, LN_REL[dtype], name)


@pytest.mark.parametrize("rows,h", [(8192, 1024), (4096, 768), (4096, 4096),
                                    (1000, 100)])
@pytest.mark.parametrize("centred", [True, False], ids=["ln", "rms"])
def test_norm_bwd_reruns_are_bit_identical(gen, rows, h, centred):
    """dw and db are sums over rows in an order fixed by the shape: two
    calls on the same inputs give the same bits, and so does dx."""
    x = torch.randn(rows, h, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.Generator(device="cuda")
    outs = []
    for _ in range(2):
        g.manual_seed(7)
        outs.append(_norm_bwd_pair(g, centred, rows, h, torch.bfloat16,
                                   x=x)[0])
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("centred", [True, False], ids=["ln", "rms"])
def test_norm_bwd_unaligned_rows_take_the_loop_path(gen, centred):
    """x starting 8 bytes past a 16-byte boundary cannot take 16-byte
    loads: the plan sends it to the loop path, which matches the plain
    version all the same."""
    rows, h = 300, 1024
    buf = torch.randn(rows * h + 4, generator=gen, device="cuda").to(
        torch.bfloat16)
    x = buf[4:].view(rows, h)
    assert x.data_ptr() % 16 == 8
    got, ref = _norm_bwd_pair(gen, centred, rows, h, torch.bfloat16, x=x)
    torch.cuda.synchronize()
    for name, a, r in zip(("dx", "dw", "db"), got, ref):
        _assert_near(a, r, LN_REL[torch.bfloat16], name)


# ------------------------------- whole-row causal softmax: masked keys unread

# scores exact in fp32, fp16 and bf16 (multiples of 64) just below the
# -10000 fill: a row with a masked key has its max at the fill, so its
# masked keys carry nearly all its weight
NEAR_FILL = (-10048.0, -10112.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("sq,sk", [(40, 24), (64, 1000), (24, 40),
                                   (5, 16384), (3, 4099)])
@pytest.mark.parametrize("scores", ["randn", "near_fill"])
def test_causal_softmax_skips_masked_keys_exactly(gen, dtype, sq, sk,
                                                  scores):
    """sq > sk: the first sq - sk rows have no unmasked key and come out
    uniform 1/sk; sk = 1000 puts the diagonal inside a vector (loaded,
    filled per element); 16384 takes 512 threads a row; 4099 the scalar
    path. With scores near -10000 the masked keys keep their weight, so
    each masked output is held to the plain version's relative to itself."""
    if scores == "randn":
        x = (4 * torch.randn(2, sq, sk, generator=gen, device="cuda")).to(
            dtype)
    else:
        pick = torch.randint(0, 2, (2, sq, sk), generator=gen, device="cuda")
        x = torch.tensor(NEAR_FILL, device="cuda")[pick].to(dtype)
    before = sm.causal_launches
    y = sm._causal_cuda(x, 1.0)
    assert sm.causal_launches == before + 1
    ref = sm._causal_plain(x, 1.0)
    torch.cuda.synchronize()
    rtol, atol = SM_TOL[dtype]
    torch.testing.assert_close(y.float(), ref.float(), rtol=rtol, atol=atol)
    masked = sm._causal_mask(sq, sk, "cuda").expand(x.shape)
    torch.testing.assert_close(y.float()[masked], ref.float()[masked],
                               rtol=rtol, atol=0)
    if scores == "near_fill":  # 1 / (masked keys + ~0) each
        assert bool((y.float()[masked] >= 0.99 / sk).all())
    if sq > sk:
        torch.testing.assert_close(
            y[:, :sq - sk].float(),
            torch.full((2, sq - sk, sk), 1.0 / sk, device="cuda"),
            rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("sk", [2048, 16384])
def test_masked_softmax_kernel_multiwarp_rows(gen, dtype, sk):
    """Rows of several warps (128 and 512 threads in bf16) under a
    padding mask read through zero strides."""
    x = (4 * torch.randn(2, 2, 3, sk, generator=gen, device="cuda")).to(
        dtype)
    mask = torch.zeros(2, 1, 1, sk, dtype=torch.bool, device="cuda")
    mask[1, ..., sk // 3:] = True
    before = sm.masked_launches
    y = sm._masked_cuda(x, mask, 0.125)
    assert sm.masked_launches == before + 1
    ref = sm._masked_plain(x, mask, 0.125)
    torch.cuda.synchronize()
    rtol, atol = SM_TOL[dtype]
    torch.testing.assert_close(y.float(), ref.float(), rtol=rtol, atol=atol)


# -------------------------------------- row-norm forward: both launch paths

NORM_FWD_WIDTHS = (64, 100, 768, 1024, 4096, 16384, 20480)
NORM_FWD_ROWS = (1, 3, 8, 1000, 8192)


def _norm_fwd_pair(centred, x, w, b=None):
    """(kernel, plain) forward outputs (y, mu or None, rstd), one launch
    counted."""
    if centred:
        before = ln.ln_launches
        got = ln._ln_fwd_cuda(x, w, b, 1e-5)
        assert ln.ln_launches == before + 1
        return got, ln._ln_fwd_plain(x, w, b, 1e-5)
    before = ln.launches
    y, rstd = ln._rms_fwd_cuda(x, w, 1e-5)
    assert ln.launches == before + 1
    y_ref, rstd_ref = ln._rms_fwd_plain(x, w, 1e-5)
    return (y, None, rstd), (y_ref, None, rstd_ref)


def _assert_fwd_near(got, ref, dtype):
    """y within one ulp of its dtype of its scale (fp32: the summation
    order); mu and rstd within the fp32 rounding of sums taken in
    another order."""
    (y, mu, rstd), (y_ref, mu_ref, rstd_ref) = got, ref
    assert y.dtype == y_ref.dtype and y.shape == y_ref.shape
    _assert_near(y, y_ref, LN_REL[dtype], "y")
    if mu is not None:
        torch.testing.assert_close(mu, mu_ref, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rstd, rstd_ref, rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("h", NORM_FWD_WIDTHS)
@pytest.mark.parametrize("rows", NORM_FWD_ROWS)
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("centred", [True, False], ids=["ln", "rms"])
def test_norm_fwd_kernel_paths_match_plain(gen, dtype, h, rows, affine,
                                           centred):
    """LayerNorm and RMSNorm forward on the register path (a warp a row
    up to 32 x 4 vectors, several warps above, more threads a row when
    the rows are few) and on the loop path (h = 100 is no multiple of 8;
    20480 is past the register path's 16384 in 16-bit dtypes, 16384 past
    its 8192 in fp32); x has a mean of 0.5 so the centring matters."""
    v = 16 // dtype.itemsize
    plan = ln._fwd_plan(rows, h, dtype)
    assert plan.registers == (h % v == 0 and h // v <= 512 * 4)
    x = (2 * torch.randn(rows, h, generator=gen, device="cuda") + 0.5).to(
        dtype)
    w = b = None
    if affine:
        w = (1 + 0.1 * torch.randn(h, generator=gen, device="cuda")).to(dtype)
        b = (0.1 * torch.randn(h, generator=gen, device="cuda")).to(dtype)
    got, ref = _norm_fwd_pair(centred, x, w, b if centred else None)
    torch.cuda.synchronize()
    _assert_fwd_near(got, ref, dtype)


@pytest.mark.parametrize("h", [768, 1024, 4096, 100])
@pytest.mark.parametrize("rows", [8, 1000])
@pytest.mark.parametrize("centred", [True, False], ids=["ln", "rms"])
def test_norm_fwd_fp32_params_with_bf16_x(gen, h, rows, centred):
    """fp32 affine params with bf16 x (the mixed-dtype API): on the
    register path a vector of x spans two 16-byte vectors of w and b."""
    x = torch.randn(rows, h, generator=gen, device="cuda").to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    b = 0.1 * torch.randn(h, generator=gen, device="cuda")
    got, ref = _norm_fwd_pair(centred, x, w, b if centred else None)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.bfloat16
    _assert_fwd_near(got, ref, torch.bfloat16)


@pytest.mark.parametrize("centred", [True, False], ids=["ln", "rms"])
@pytest.mark.parametrize("what", ["x", "w"])
def test_norm_fwd_unaligned_views_take_the_loop_path(gen, centred, what):
    """x, or the weight, starting 8 bytes past a 16-byte boundary cannot
    take 16-byte loads: the plan sends the call to the loop path, which
    matches the plain version all the same."""
    rows, h = 300, 1024
    buf = torch.randn(rows * h + 4, generator=gen, device="cuda").to(
        torch.bfloat16)
    x = buf[4:].view(rows, h) if what == "x" else buf[:rows * h].view(rows, h)
    wbuf = (1 + 0.1 * torch.randn(h + 4, generator=gen, device="cuda")).to(
        torch.bfloat16)
    w = wbuf[4:] if what == "w" else wbuf[:h]
    b = torch.zeros(h + 4, device="cuda", dtype=torch.bfloat16)[4:]
    assert (x if what == "x" else w).data_ptr() % 16 == 8
    assert not ln._fwd_plan(rows, h, torch.bfloat16, aligned=False).registers
    got, ref = _norm_fwd_pair(centred, x, w, b if centred else None)
    torch.cuda.synchronize()
    _assert_fwd_near(got, ref, torch.bfloat16)


@pytest.mark.parametrize("rows,h", [(8192, 1024), (4096, 768), (4096, 4096),
                                    (512, 4096), (8, 4096), (1000, 100)])
@pytest.mark.parametrize("centred", [True, False], ids=["ln", "rms"])
def test_norm_fwd_reruns_are_bit_identical(gen, rows, h, centred):
    """Every row's sums are taken in an order fixed by the shape: two
    calls on the same inputs give the same bits of y, mu and rstd."""
    x = torch.randn(rows, h, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(h, generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randn(h, generator=gen, device="cuda").to(torch.bfloat16)
    outs = [_norm_fwd_pair(centred, x, w, b if centred else None)[0]
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, c in zip(*outs):
        assert (a is None and c is None) or torch.equal(a, c)


@pytest.mark.parametrize("centred", [True, False], ids=["ln", "rms"])
def test_norm_fwd_refuses_a_plan_that_does_not_fit(gen, monkeypatch,
                                                   centred):
    """A plan whose threads cannot hold the row (or whose loop path does
    not give a block a row) is refused by the C entry point: the call
    raises and launches nothing, and no plain version runs instead."""
    x = torch.randn(16, 4096, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.ones(4096, device="cuda", dtype=torch.bfloat16)
    b = torch.zeros_like(w)
    for bad in (ln.FwdPlan(32, 8, 2, True),     # 16 vectors a lane
                ln.FwdPlan(96, 1, 16, True),    # not a power of two
                ln.FwdPlan(512, 2, 8, True),    # 1024 threads a block
                ln.FwdPlan(128, 2, 9, True),    # more blocks than rows
                ln.FwdPlan(512, 1, 15, False)):  # loop path, a row short
        monkeypatch.setattr(ln, "_fwd_plan", lambda *a, bad=bad, **k: bad)
        before = (ln.launches, ln.ln_launches)
        with pytest.raises(RuntimeError, match="CUDA error"):
            if centred:
                ln._ln_fwd_cuda(x, w, b, 1e-5)
            else:
                ln._rms_fwd_cuda(x, w, 1e-5)
        assert (ln.launches, ln.ln_launches) == before


# ------------------------------------------ fp8 cast: one launch a cast


def _device_events(fn):
    """Names of the device activities (kernels, fills, copies) that one
    call of ``fn()`` ran, by ``torch.profiler`` (``chip_smoke.py``'s
    ``device_activities``, which profiles again when the profiler lost
    every record of a call)."""
    import chip_smoke

    return chip_smoke.device_activities(fn)


def _counter(device="cuda"):
    """The blocks' counter of the current stream's scratch buffer."""
    from apex_tpu_torch.ops import fp8_cast_kernel as fc

    torch.cuda.synchronize()
    return int(fc._scratch(torch.device(device, torch.cuda.current_device()))
               [0])


@pytest.mark.parametrize("col_major", [False, True])
@pytest.mark.parametrize("scale", ["number", "tensor"])
def test_fp8_cast_is_one_launch(gen, col_major, scale):
    """Once the stream's scratch exists (after a first call), a cast runs
    exactly one device activity, its kernel: no fill of amax or of the
    counter before it."""
    from apex_tpu_torch.ops import fp8_cast_kernel as fc

    x = torch.randn(512, 4096, generator=gen, device="cuda").to(
        torch.bfloat16)
    s = 1.0 if scale == "number" else torch.tensor(0.5, device="cuda")
    fc._cast_and_scale_cuda(x, s, torch.float8_e4m3fn, 448.0, col_major)
    fills = fc.fills
    names = _device_events(lambda: fc._cast_and_scale_cuda(
        x, s, torch.float8_e4m3fn, 448.0, col_major))
    assert len(names) == 1, names
    assert ("cast_scale_t_kernel" if col_major else "cast_scale_kernel") \
        in names[0]
    assert fc.fills == fills


@pytest.mark.parametrize("col_major", [False, True])
def test_fp8_cast_amax_falls_back_to_back(gen, col_major):
    """Casts one after another whose amax falls, over shapes of 1 to
    hundreds of blocks: each amax is its own x's, exactly (the counter
    came back to 0 and no slot or word carried the last call's max), and
    the counter is 0 after every call."""
    shapes = ((512, 4096), (8, 4096), (8, 14336), (3, 5), (4096, 1024))
    for i, shape in enumerate(shapes * 2):
        x = (1000.0 / 2 ** i * torch.rand(shape, generator=gen,
                                          device="cuda")).to(torch.bfloat16)
        y, amax, y_ref, amax_ref = _cast_pair(x, 1.0, torch.float8_e4m3fn,
                                              col_major)
        _assert_bits(y, y_ref)
        assert float(amax) == float(amax_ref)
        assert _counter() == 0


def test_fp8_cast_on_two_streams_at_once(gen):
    """Casts queued on two streams without a sync between them each get
    their own scratch (their own counter) and their own exact amax."""
    from apex_tpu_torch.ops import fp8_cast_kernel as fc

    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    xs = [[(100.0 * (k + 1) / (i + 1) * torch.randn(
        512, 4096, generator=gen, device="cuda")).to(torch.bfloat16)
        for i in range(8)] for k in range(2)]
    torch.cuda.synchronize()
    outs = [[], []]
    for i in range(8):
        for k, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                outs[k].append(fc._cast_and_scale_cuda(
                    xs[k][i], 1.0, torch.float8_e4m3fn, 448.0,
                    col_major=bool(i % 2)))
    torch.cuda.synchronize()
    keys = {(torch.cuda.current_device(), s.cuda_stream) for s in streams}
    assert keys <= set(fc._SCRATCH)
    for k in range(2):
        for i, (y, amax) in enumerate(outs[k]):
            y_ref, amax_ref = fc._cast_and_scale_plain(
                xs[k][i], 1.0, torch.float8_e4m3fn, 448.0, bool(i % 2))
            _assert_bits(y, y_ref)
            assert float(amax) == float(amax_ref)
        with torch.cuda.stream(streams[k]):
            assert _counter() == 0


def test_fp8_cast_a_thousand_in_a_row(gen):
    """1000 casts queued back to back, row- and column-major, at grid
    sizes from 1 to hundreds of blocks: every amax exact."""
    from apex_tpu_torch.ops import fp8_cast_kernel as fc

    xs = [(float(2 ** (i % 9)) * torch.randn(shape, generator=gen,
                                               device="cuda")).to(
        torch.bfloat16)
        for i, shape in enumerate(((8, 4096), (512, 4096), (8, 14336),
                                   (256, 384), (1, 3), (64, 1000)) * 3)]
    amaxes = []
    for i in range(1000):
        x = xs[i % len(xs)]
        amaxes.append(fc._cast_and_scale_cuda(
            x, 1.0, torch.float8_e4m3fn, 448.0, col_major=i % 3 == 0)[1])
    got = torch.stack(amaxes).cpu()
    want = torch.stack([torch.amax(torch.abs(xs[i % len(xs)].float()))
                        for i in range(1000)]).cpu()
    assert torch.equal(got, want)
    assert _counter() == 0


@pytest.mark.parametrize("cols", [4096, 14336])
@pytest.mark.parametrize("fp8", sorted(FP8, key=str))
def test_fp8_cast_decode_activation(gen, cols, fp8):
    """A decode step's [8, 4096] and [8, 14336] activations, some values
    past the format's max: bits and amax equal the plain version's."""
    x = 30 * torch.randn(8, cols, generator=gen, device="cuda")
    x[:, ::97] *= 40
    x = x.to(torch.bfloat16)
    y, amax, y_ref, amax_ref = _cast_pair(x, 1.0, fp8)
    _assert_bits(y, y_ref)
    assert float(amax) == float(amax_ref)


def test_fp8_cast_failed_launch_leaves_the_counter_at_zero(gen,
                                                           monkeypatch):
    """A launch that reports an error (here one that counted blocks in
    before it died: the counter is set by hand) has its counter re-zeroed
    before the wrapper raises, and the next cast's amax is exact."""
    from apex_tpu_torch.ops import fp8_cast_kernel as fc

    x = torch.randn(512, 4096, generator=gen, device="cuda").to(
        torch.bfloat16)
    fc._cast_and_scale_cuda(x, 1.0, torch.float8_e4m3fn, 448.0)
    real = fc._lib()

    class Refusing:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def fp8_cast_scale(*args):
            return 1  # cudaErrorInvalidValue

    scratch = fc._scratch(x.device)
    scratch[0] = 5
    monkeypatch.setattr(fc, "_lib", lambda: Refusing())
    before = fc.launches
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        fc._cast_and_scale_cuda(x, 1.0, torch.float8_e4m3fn, 448.0)
    assert fc.launches == before
    assert _counter() == 0
    monkeypatch.undo()
    y, amax, y_ref, amax_ref = _cast_pair(x / 3, 1.0, torch.float8_e4m3fn)
    _assert_bits(y, y_ref)
    assert float(amax) == float(amax_ref)


@pytest.mark.parametrize("rows,h", [(37, 64), (1000, 100), (4096, 4096)])
def test_rms_norm_bf16_rows_fp32_weight_match_plain(gen, rows, h):
    """amp's O2 pair (norm weights kept fp32, activations bf16): y and dx
    in bf16 within one bf16 ulp of the output's scale, rstd and dw in
    fp32 (dw an fp32 sum over the rows in another order), and autograd
    through ``rms_norm`` launching each kernel once."""
    x = torch.randn(rows, h, generator=gen, device="cuda").to(torch.bfloat16)
    dy = torch.randn(rows, h, generator=gen, device="cuda").to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn(h, generator=gen, device="cuda")
    y, rstd = ln._rms_fwd_cuda(x, w, 1e-5)
    y_ref, rstd_ref = ln._rms_fwd_plain(x, w, 1e-5)
    assert y.dtype == torch.bfloat16 and rstd.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=8e-3,
                               atol=1e-6)
    torch.testing.assert_close(rstd, rstd_ref, rtol=1e-5, atol=0)
    dx, dw = ln._rms_bwd_cuda(x, w, rstd, dy)
    dx_ref, dw_ref = ln._rms_bwd_plain(x, w, rstd, dy)
    torch.cuda.synchronize()
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    _assert_near(dx, dx_ref, 8e-3, "dx")
    _assert_near(dw, dw_ref, 1e-5, "dw")
    xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
    fwd, bwd = ln.launches, ln.bwd_launches
    out = ln.rms_norm(xl, wl, h, 1e-5)
    gx, gw = torch.autograd.grad(out, (xl, wl), dy)
    assert (ln.launches, ln.bwd_launches) == (fwd + 1, bwd + 1)
    assert gx.dtype == torch.bfloat16 and gw.dtype == torch.float32


@pytest.mark.parametrize("name", ["input", "weight", "cotangent"])
def test_fp8_cast_at_the_lm_head_shapes_bits_equal_plain(gen, name):
    """The three casts an O4 Llama-3-8B step runs at its lm_head (batch 2
    x 2048): the E4M3 input [4096, 4096] row-major, the E4M3 weight
    [4096, 128256] column-major and the E5M2 cotangent [4096, 128256]
    row-major, each at a delayed-style scale fmax / amax."""
    rows, cols, fp8, col = {
        "input": (4096, 4096, torch.float8_e4m3fn, False),
        "weight": (4096, 128256, torch.float8_e4m3fn, True),
        "cotangent": (4096, 128256, torch.float8_e5m2, False)}[name]
    spread = {"input": 1.0, "weight": 4096 ** -0.5, "cotangent": 1e-4}[name]
    x = (spread * torch.randn(rows, cols, generator=gen, device="cuda")).to(
        torch.bfloat16)
    amax_x = torch.amax(torch.abs(x)).float()
    scale = torch.full_like(amax_x, FP8[fp8]) / amax_x
    y, amax, y_ref, amax_ref = _cast_pair(x, scale, fp8, col_major=col)
    assert y.stride() == ((1, rows) if col else (cols, 1))
    _assert_bits(y, y_ref)
    assert float(amax) == float(amax_ref) == float(amax_x)


# ----------------------------------------------------- multihead_attn shapes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p_drop", [0.0, 0.2])
@pytest.mark.parametrize("sq,sk", [(40, 96), (130, 256), (96, 40)])
def test_flash_kernels_encdec_views_match_plain(gen, dtype, p_drop, sq, sk):
    """Non-causal, head dim 64, sq != sk, with and without dropout, on
    the strided views contrib.multihead_attn passes ([s, b, h*d]
    transposed to [b, s, h, d]): forward, dq and dk/dv against the plain
    versions with the same seed."""
    b, h, d = 3, 4, 64
    scale = d ** -0.5

    def view(s):  # [s, b, h*d] -> a [b, s, h, d] view, no copy
        t = torch.randn(s, b, h * d, generator=gen, device="cuda").to(dtype)
        return t.transpose(0, 1).unflatten(-1, (h, d))

    q, k, v, do = view(sq), view(sk), view(sk), view(sq)
    extras = (None, p_drop, SEED)
    o, lse = fa._flash_fwd_cuda(q, k, v, False, scale, *extras)
    dq, dk, dv = fa._flash_bwd_cuda(q, k, v, o, lse, do, False, scale,
                                    *extras)
    o_ref, lse_ref = fa._flash_fwd_plain(_flat(q), _flat(k), _flat(v),
                                         False, scale, *extras)
    ref = fa._flash_bwd_plain(_flat(q), _flat(k), _flat(v), _flat(o), lse,
                              _flat(do), False, scale, *extras)
    torch.cuda.synchronize()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), fa._seq_major(o_ref, b).float(),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-3)
    rel = 2e-5 if dtype == torch.float32 else 1e-2
    for name, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        _assert_near(got, fa._seq_major(r, b), rel, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_softmax_kernel_takes_the_mha_key_padding_mask(gen, dtype):
    """The [b, 1, sq, sk] key-padding mask _masked_attention builds by
    expanding [b, sk] (zero strides over the query rows), at 16 heads."""
    b, n, s = 4, 16, 64
    x = (4 * torch.randn(b, n, s, s, generator=gen, device="cuda")).to(
        dtype)
    pad = torch.arange(s, device="cuda")[None, :] >= torch.tensor(
        [64, 50, 17, 1], device="cuda")[:, None]
    mask = pad[:, None, None, :].expand(b, 1, s, s)
    before = sm.masked_launches
    y = sm._masked_cuda(x, mask, 0.125)
    assert sm.masked_launches == before + 1
    ref = sm._masked_plain(x, mask, 0.125)
    torch.cuda.synchronize()
    rtol, atol = SM_TOL[dtype]
    torch.testing.assert_close(y.float(), ref.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", ["self", "self_masked", "encdec"])
def test_multihead_attn_modules_launch_their_kernels(gen, kind):
    """A module on the card launches its kernels once each, forward and
    backward, and agrees with the same module's plain path on the CPU
    (same params, dropout off)."""
    from apex_tpu_torch.contrib import multihead_attn as mha
    from apex_tpu_torch.ops import layer_norm as lnm

    h, heads, s, b = 64, 4, 48, 2
    cls = mha.EncdecMultiheadAttn if kind == "encdec" else \
        mha.SelfMultiheadAttn
    cuda_mod = cls(h, heads, include_norm_add=True, bias=True)
    cpu_mod = cls(h, heads, include_norm_add=True, bias=True, device="cpu")
    cpu_mod.load_state_dict({k: v.cpu() for k, v in
                             cuda_mod.state_dict().items()})
    x = torch.randn(s, b, h, generator=gen, device="cuda")
    kv = torch.randn(2 * s, b, h, generator=gen, device="cuda")
    pad = torch.zeros(b, s, dtype=torch.bool, device="cuda")
    pad[1, 30:] = True

    def run(mod, dev):
        xs = [x.to(dev).requires_grad_()]
        kw = {"is_training": False}
        if kind == "encdec":
            xs.append(kv.to(dev).requires_grad_())
        if kind == "self_masked":
            kw["key_padding_mask"] = pad.to(dev)
        out = mod(*xs, **kw)
        grads = torch.autograd.grad(out.square().sum(),
                                    xs + list(mod.parameters()))
        return out, grads

    before = (fa.launches, fa.dq_launches, fa.dkv_launches,
              sm.masked_launches, lnm.ln_launches, lnm.ln_bwd_launches)
    out, grads = run(cuda_mod, "cuda")
    after = (fa.launches, fa.dq_launches, fa.dkv_launches,
             sm.masked_launches, lnm.ln_launches, lnm.ln_bwd_launches)
    flash = 0 if kind == "self_masked" else 1
    assert tuple(a - c for a, c in zip(after, before)) == (
        flash, flash, flash, 1 - flash, 1, 1)
    ref, ref_grads = run(cpu_mod, "cpu")
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-4, atol=1e-4)
    for got, r in zip(grads, ref_grads):
        torch.testing.assert_close(got.cpu(), r, rtol=1e-3, atol=1e-3)


def test_inverted_dropout_cpu_generator_on_cuda_probs():
    """On the card a CPU generator gives a mask drawn on the card, from a
    CUDA generator seeded with one draw of it."""
    from apex_tpu_torch.contrib import multihead_attn as mha

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    probs = torch.rand(2, 4, 64, 64, device="cuda")
    got = mha._inverted_dropout(probs, 0.1, torch.Generator().manual_seed(5))
    seed = int(torch.randint(0, 2 ** 63 - 1, (),
                             generator=torch.Generator().manual_seed(5)))
    keep = torch.rand(probs.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(seed)) < 0.9
    assert got.device == probs.device
    assert torch.equal(got, torch.where(keep, probs / 0.9,
                                        torch.zeros_like(probs)))


# ------------------------------------------------ the decode step's graph


def _tiny_engine(gen, weight_mode="native", params=None, **kw):
    from apex_tpu_torch.models import llama
    from apex_tpu_torch.observability import MetricRegistry
    from apex_tpu_torch.serving import ServingEngine

    cfg = llama.tiny(dtype=torch.bfloat16)
    if params is None:
        params = llama.init_params(gen, cfg, device="cuda")
    geo = dict(num_pages=48, page_size=8, max_batch=3, max_prompt_len=16,
               max_new_cap=12, weight_mode=weight_mode,
               registry=MetricRegistry())
    geo.update(kw)
    return cfg, params, ServingEngine(params, cfg, **geo)


def _serving_jobs(cfg, n=7, seed=11):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size,
                          size=int(rng.integers(3, 16))).astype(np.int32),
             int(rng.integers(3, 13))) for _ in range(n)]


class _EagerRunner:
    """The decode runner with the graph taken out: the same step on the
    same static inputs, called eagerly on the current stream."""

    def __init__(self, graph):
        self.graph = graph
        self.captures = 0

    def __call__(self, tokens, tables, pos, active):
        self.graph._stage(tokens, tables, pos, active)
        return self.graph.step(*self.graph.inputs()).cpu().numpy()


def _defrag(sched):
    mapping = sched.cache.defrag()
    for row in sched._tables:
        row[:] = [mapping.get(int(p), int(p)) for p in row]
    return mapping


def _serve(engine, jobs, defrag_at=None):
    for prompt, max_new in jobs:
        engine.submit(prompt, max_new)
    moved = {}
    while engine.pending:
        engine.step()
        if (defrag_at is not None and not moved
                and len(engine.results) >= defrag_at
                and engine.scheduler.num_active()):
            moved = _defrag(engine.scheduler)
    return engine.results, moved


@pytest.mark.parametrize("weight_mode", ["native", "fp8"])
def test_decode_graph_tokens_equal_the_eager_step(gen, weight_mode):
    """tiny() in bf16: the graphed decode step gives the eager step's
    tokens, bit for bit, across refills of 3 slots from 7 requests, an
    EOS eviction and an in-place defrag, and is captured once."""
    cfg, params, probe = _tiny_engine(gen, weight_mode)
    jobs = _serving_jobs(cfg)
    first, _ = _serve(probe, jobs)
    eos = first[1]["tokens"][1]
    results = []
    for eager in (False, True):
        _, _, engine = _tiny_engine(gen, weight_mode, params, eos_id=eos)
        if eager:
            engine.scheduler._graph = _EagerRunner(engine.scheduler._graph)
        got, moved = _serve(engine, jobs, defrag_at=2)
        assert moved
        results.append(got)
        if not eager:
            assert engine.scheduler.decode_captures() == 1
            assert engine.scheduler.decode_retraces() == 0
    assert results[0] == results[1]
    assert len(results[0][1]["tokens"]) <= 2


def test_decode_graph_not_captured_again_after_refills_import_and_defrag(
        gen):
    cfg, params, engine = _tiny_engine(gen)
    sched = engine.scheduler
    jobs = _serving_jobs(cfg)
    ptrs = (sched.cache.k_pages.data_ptr(), sched.cache.v_pages.data_ptr())
    _serve(engine, jobs[:5], defrag_at=1)
    assert sched.decode_captures() == 1
    # a request exported from another engine mid-decode, imported here
    _, _, other = _tiny_engine(gen, params=params)
    for prompt, max_new in jobs[5:]:
        other.submit(prompt, max_new)
    other.step()
    other.step()
    _, inflight, arrays = other.scheduler.export_requests()
    for rec in inflight:
        rec = dict(rec, rid=100 + rec["rid"])
        sched.import_request(rec, arrays[f"k_{rec['rid'] - 100}"],
                             arrays[f"v_{rec['rid'] - 100}"])
    engine.run()
    assert {100 + rec["rid"] for rec in inflight} <= set(engine.results)
    assert sched.decode_captures() == 1 and sched.decode_retraces() == 0
    assert (sched.cache.k_pages.data_ptr(),
            sched.cache.v_pages.data_ptr()) == ptrs


def test_decode_graph_replays_add_the_captured_launches(gen):
    """A capture launches nothing; its warm-up step launches 2L + 1
    RMSNorm forwards; every replay adds the capture's 2L + 1."""
    cfg, _, engine = _tiny_engine(gen)
    sched = engine.scheduler
    per_step = 2 * cfg.num_layers + 1
    engine.submit(torch.arange(5).numpy(), 6)
    sched.try_admit()
    before = ln.launches
    sched.step_decode()
    assert ln.launches - before == 2 * per_step
    for _ in range(3):
        before = ln.launches
        sched.step_decode()
        assert ln.launches - before == per_step
    before = ln.launches
    sched._graph.replay()
    torch.cuda.synchronize()
    assert ln.launches - before == per_step


def test_failed_capture_raises(gen):
    """A host sync inside the step breaks the capture: the step raises,
    with no eager fallback, and nothing is captured."""
    cfg, _, engine = _tiny_engine(gen)
    sched = engine.scheduler
    step = sched._graph.step

    def syncing(*slots):
        out = step(*slots)
        float(out.sum())
        return out

    sched._graph.step = syncing
    engine.submit(torch.arange(5).numpy(), 4)
    with pytest.raises(RuntimeError):
        engine.step()
    assert sched.decode_captures() == 0
    assert sched._graph.graph is None


# ------------------------------------------------ data parallelism


@pytest.fixture
def one_rank(gen, tmp_path, request):
    """A process group of this process alone, over the backend given as
    the test's parameter, torn down after the test."""
    from apex_tpu_torch.distributed import backend as B

    B.init_process_group(request.param, init_method=f"file://{tmp_path}/s",
                         world_size=1, rank=0)
    yield request.param
    B.destroy_process_group()


def _zero_case(gen, dtype):
    p = {"w": torch.randn(37, 11, generator=gen, device="cuda").to(dtype),
         "b": torch.randn(13, generator=gen, device="cuda").to(dtype)}
    g = {k: torch.randn(v.shape, generator=gen, device="cuda").to(dtype)
         for k, v in p.items()}
    return p, g


@pytest.mark.parametrize("one_rank", ["gloo", "nccl"], indirect=True)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero1_shard_update_launches_the_adam_kernel(one_rank, gen, dtype):
    """ZeRO-1's shard update is the hand-written flat Adam kernel, one
    launch a bucket, and at one rank equals the replicated flat step bit
    for bit (params and moments)."""
    from apex_tpu_torch import _tree
    from apex_tpu_torch.ops import flat as flat_ops
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.parallel import Zero1FusedAdam

    zp, g = _zero_case(gen, dtype)
    rp = _tree.map_leaves(torch.clone, zp)
    opt = Zero1FusedAdam(lr=1e-2, axis_name="dp", bucket_cap_mb=0.0005)
    tx = fused_adam(lr=1e-2, flat=True)
    zs, rs = opt.init(zp), tx.init(rp)
    before = fak.launches
    zp, zs = opt.step(g, zs, zp)
    assert fak.launches == before + len(zs.mu) > before + 1
    upd, rs = tx.update(g, rs, rp)
    for p, u in zip(_tree.leaves(rp), _tree.leaves(upd)):
        p.add_(u)
    assert all(torch.equal(zp[k], rp[k]) for k in zp)
    mu, _ = opt.unpack_state(zp, opt.gather_state(zs))
    ref_mu = flat_ops.unflatten_tree(rs.mu, flat_ops.tree_meta(rp))
    assert all(torch.equal(mu[k], ref_mu[k]) for k in mu)
    assert all(m.is_cuda for m in zs.mu)


@pytest.mark.parametrize("one_rank", ["gloo", "nccl"], indirect=True)
def test_overlapped_value_and_grad_on_cuda_equals_autograd(one_rank, gen):
    """The buckets' all-reduces issued from the backward on the card (one
    rank: the identity) give autograd's grads bit for bit, and the trace
    holds a CUDA event for each bucket."""
    from apex_tpu_torch.parallel import overlapped_value_and_grad

    p = {"w1": torch.randn(64, 64, generator=gen, device="cuda"),
         "w2": torch.randn(64, 8, generator=gen, device="cuda")}
    x = torch.randn(32, 64, generator=gen, device="cuda")

    def loss(q, x):
        return (torch.tanh(x @ q["w1"]) @ q["w2"]).square().mean()

    fn = overlapped_value_and_grad(loss, axis_name="dp",
                                   bucket_cap_mb=0.01)
    value, grads = fn(p, x)
    live = {k: v.detach().requires_grad_() for k, v in p.items()}
    ref = torch.autograd.grad(loss(live, x), [live["w1"], live["w2"]])
    assert torch.equal(grads["w1"], ref[0])
    assert torch.equal(grads["w2"], ref[1])
    assert len(fn.last_trace.issued) == 2
    assert all(ev is not None for _, _, ev in fn.last_trace.issued)


def test_zero1_on_two_ranks_sharing_the_gpu_over_gloo(gen, tmp_path):
    """Two ranks on the one card over gloo (CUDA tensors reduced through
    the host): ZeRO-1 equals the replicated step bit for bit, launches the
    Adam kernel once a bucket a step, and the ranks' params agree."""
    import numpy as np

    from torch_dist_worker import run_ranks

    rng = np.random.default_rng(3)
    inputs = {"zp_w": rng.standard_normal((37, 11)).astype(np.float32),
              "zp_b": rng.standard_normal(13).astype(np.float32)}
    for step in range(3):
        inputs[f"zg{step}_w"] = rng.standard_normal((2, 37, 11)).astype(
            np.float32)
        inputs[f"zg{step}_b"] = rng.standard_normal((2, 13)).astype(
            np.float32)
    ranks = run_ranks("cuda", 2, tmp_path, inputs, cpu=False)
    for res in ranks:
        assert bool(res["equal"])
        assert int(res["launches"]) == 3 * int(res["buckets"])
        assert str(res["device"]).startswith("cuda")
        assert float(res["divergence"]) == 0.0


def test_pipeline_shift_on_cuda_tensors_over_gloo(gen, tmp_path):
    """Two pipeline stages sharing the card over gloo: the shift moves
    rank 0's CUDA tensor to rank 1 (rank 0 gets zeros) and its backward
    moves rank 1's cotangent back, staged through host memory. Prints
    whether gloo's own send took the CUDA tensor."""
    import numpy as np

    from torch_dist_worker import run_ranks

    r0, r1 = run_ranks("megatron_cuda", 2, tmp_path, {}, cpu=False)
    print("gloo send of a CUDA tensor:",
          str(r0["send_cuda_error"]) or "taken as it is", "| receiver:",
          str(r1["recv_error"]) or r1["recv_data"])
    np.testing.assert_array_equal(r0["shift"], np.zeros(3))
    np.testing.assert_array_equal(r1["shift"], np.ones(3))
    np.testing.assert_array_equal(r0["shift_grad"], np.full(3, 20.0))
    np.testing.assert_array_equal(r1["shift_grad"], np.zeros(3))
    assert str(r1["shift_device"]).startswith("cuda")


# ------------------------------------------------ context parallelism


def _ring_case(gen, dtype, h_kv, s=96, b=2, h=4, d=64):
    """Rank 1's view of a cp 2 ring: its queries, the block from rank 0
    (whole) and its own (diagonal), and a cotangent."""
    def randn(n):
        return torch.randn(b, s, n, d, generator=gen, device="cuda").to(dtype)
    return randn(h), randn(h_kv), randn(h_kv), randn(h_kv), randn(h_kv), \
        randn(h)


def _merged(q, blocks, scale):
    """(o, lse) of ``q`` over the ``(k, v, causal)`` blocks, merged by
    logsumexp in fp32 as the ring merges them; o in q's dtype."""
    from apex_tpu_torch.transformer.context_parallel import _merge_lse

    b, s, h, _ = q.shape
    o = torch.zeros(q.shape, dtype=torch.float32, device="cuda")
    lse = torch.full((b * h, s), float("-inf"), device="cuda")
    for k, v, causal in blocks:
        o, lse = _merge_lse(o, lse, *fa._flash_fwd_cuda(q, k, v, causal,
                                                        scale))
    return o.to(q.dtype), lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h_kv", [4, 2])
@pytest.mark.parametrize("causal", [False, True],
                         ids=["offdiag", "diag"])
def test_flash_bwd_with_the_rings_global_lse_matches_plain(gen, dtype, h_kv,
                                                          causal):
    """The dq and dk/dv kernels called as the ring calls them: one
    block's k and v with the o and lse merged over two blocks (on the
    off-diagonal block the lse exceeds the block's own row maximum),
    against ``_flash_bwd_plain`` on the same inputs."""
    q, k0, v0, k1, v1, do = _ring_case(gen, dtype, h_kv)
    d = q.shape[-1]
    scale = d ** -0.5
    o, lse = _merged(q, ((k0, v0, False), (k1, v1, True)), scale)
    k, v = (k0, v0) if not causal else (k1, v1)
    before = (fa.dq_launches, fa.dkv_launches)
    got = fa._flash_bwd_cuda(q, k, v, o, lse, do, causal, scale)
    assert (fa.dq_launches, fa.dkv_launches) == (before[0] + 1,
                                                 before[1] + 1)
    ref = fa._flash_bwd_plain(*(fa._heads_major(t) for t in (q, k, v, o)),
                              lse, fa._heads_major(do), causal, scale)
    rel = 2e-5 if dtype == torch.float32 else 1e-2
    for g, r, n in zip(got, ref, (q.shape[2], h_kv, h_kv)):
        r = r.reshape(q.shape[0], n, q.shape[1], d).transpose(1, 2)
        err = float((g.float() - r.float()).abs().max())
        assert err <= rel * float(r.float().abs().max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h_kv", [4, 2])
def test_ring_of_two_blocks_matches_the_whole_sequence_kernel(gen, dtype,
                                                              h_kv):
    """Both ranks of a causal cp 2 ring, emulated: rank 0's diagonal
    block, rank 1's full and diagonal blocks merged by lse, and their
    backward calls with the merged (o, lse), dK/dV summed in fp32, held
    against the forward and backward kernels on the whole sequence."""
    s = 96
    q0, k0, v0, k1, v1, do1 = _ring_case(gen, dtype, h_kv, s=s)
    q1, do0 = (torch.randn(q0.shape, generator=gen, device="cuda").to(dtype)
               for _ in range(2))
    d = q0.shape[-1]
    scale = d ** -0.5
    o0, l0 = _merged(q0, ((k0, v0, True),), scale)
    o1, l1 = _merged(q1, ((k0, v0, False), (k1, v1, True)), scale)
    dq0, dk0, dv0 = fa._flash_bwd_cuda(q0, k0, v0, o0, l0, do0, True, scale)
    dq1a, dk0b, dv0b = fa._flash_bwd_cuda(q1, k0, v0, o1, l1, do1, False,
                                          scale)
    dq1b, dk1, dv1 = fa._flash_bwd_cuda(q1, k1, v1, o1, l1, do1, True,
                                        scale)
    Q, K, V, dO = (torch.cat(p, 1) for p in ((q0, q1), (k0, k1), (v0, v1),
                                             (do0, do1)))
    O, L = fa._flash_fwd_cuda(Q, K, V, True, scale)
    dQ, dK, dV = fa._flash_bwd_cuda(Q, K, V, O, L, dO, True, scale)
    ring = {"o": torch.cat([o0, o1], 1).float(),
            "dq": torch.cat([dq0.float(), dq1a.float() + dq1b.float()], 1),
            "dk": torch.cat([dk0.float() + dk0b.float(), dk1.float()], 1),
            "dv": torch.cat([dv0.float() + dv0b.float(), dv1.float()], 1)}
    rel = 2e-5 if dtype == torch.float32 else 2e-2
    for name, want in (("o", O), ("dq", dQ), ("dk", dK), ("dv", dV)):
        err = float((ring[name] - want.float()).abs().max())
        assert err <= rel * float(want.float().abs().max()), (name, err)


def test_ring_and_all_to_all_on_cuda_tensors_over_gloo(gen, tmp_path):
    """Two ranks sharing the card over a throwaway gloo group: the
    differentiable all-to-all and the ring (K/V rotations staged through
    pinned host memory) on CUDA tensors, against the all-to-all's own
    definition and the whole-sequence plain attention."""
    import numpy as np

    from torch_dist_worker import run_ranks

    rng = np.random.default_rng(5)
    inputs = {t: rng.standard_normal((1, 64, 4, 32)).astype(np.float32)
              for t in ("q", "do")}
    inputs.update({t: rng.standard_normal((1, 64, 2, 32)).astype(np.float32)
                   for t in ("k", "v")})
    ranks = run_ranks("cp_cuda", 2, tmp_path, inputs, cpu=False)
    # the all-to-all: row r of each sender's x arrives at rank r, in
    # sender order; the cotangent of the piece from sender s (s + 1)
    # goes back to s
    for r, res in enumerate(ranks):
        assert str(res["device"]).startswith("cuda")
        want = np.concatenate([100 * r + 10 * src + np.arange(6.0)
                               for src in (0, 1)])
        np.testing.assert_array_equal(res["a2a"], want.reshape(1, 12))
        np.testing.assert_array_equal(res["a2a_grad"], np.full((2, 6),
                                                               r + 1.0))
    flat = [torch.from_numpy(inputs[t]).transpose(1, 2).reshape(-1, 64, 32)
            for t in ("q", "k", "v", "do")]
    o, lse = fa._flash_fwd_plain(*flat[:3], True, 32 ** -0.5)
    dq, dk, dv = fa._flash_bwd_plain(*flat[:3], o, lse, flat[3], True,
                                     32 ** -0.5)
    for name, full, n in (("o", o, 4), ("dq", dq, 4), ("dk", dk, 2),
                          ("dv", dv, 2)):
        full = full.reshape(1, n, 64, 32).transpose(1, 2).numpy()
        for r, res in enumerate(ranks):
            want = full[:, 32 * r:32 * (r + 1)]
            np.testing.assert_allclose(res[name], want, rtol=0,
                                       atol=2e-5 * np.abs(full).max())


# ------------------------------------------------- the BASELINE slice


def _composite_batch_norm(x, w, b, eps):
    """Training-mode BatchNorm over dim 1 in fp32 written with ordinary
    autograd (mean, biased variance, normalise)."""
    x32 = x.float()
    mean = x32.mean((0, 2, 3), keepdim=True)
    var = (x32 - mean).square().mean((0, 2, 3), keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps) * w.view(1, -1, 1, 1) \
        + b.view(1, -1, 1, 1)
    return y.to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_function_matches_autograd_on_the_card(gen, dtype):
    """The BatchNorm's written-out backward (``sync_batchnorm._BatchNorm``)
    on a channels_last CUDA tensor, against autograd of the composite in
    fp32 on the same bf16-exact inputs."""
    from apex_tpu_torch.ops import launch_counts
    from apex_tpu_torch.parallel import sync_batchnorm as sbn

    x = (torch.randn(8, 16, 12, 12, generator=gen, device="cuda") * 2 + 1
         ).to(dtype).contiguous(memory_format=torch.channels_last)
    w = torch.rand(16, generator=gen, device="cuda") + 0.5
    b = torch.randn(16, generator=gen, device="cuda")
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
    before = launch_counts.snapshot()
    xs, ws, bs = (t.detach().requires_grad_() for t in (x, w, b))
    y, _, _ = sbn.sync_batch_norm(xs, ws, bs, None, None, True, ch=1,
                                  group=None)
    y.backward(dy)
    assert launch_counts.snapshot() == before  # plain PyTorch: no kernel
    xr, wr, br = (t.detach().float().requires_grad_() for t in (x, w, b))
    yr = _composite_batch_norm(xr, wr, br, 1e-5)
    yr.backward(dy.float())
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), yr, rtol=tol, atol=tol)
    for got, ref in ((xs.grad, xr.grad), (ws.grad, wr.grad),
                     (bs.grad, br.grad)):
        torch.testing.assert_close(got.float(), ref, rtol=tol,
                                   atol=tol * float(ref.abs().max()))


def test_resnet_o2_step_runs_on_the_card(gen):
    """The BASELINE entry points on the card: ``resnet.init_variables``
    and ``mlp.init_params`` default to it; the fp32 ResNet's logits and
    gradients on the card equal the CPU's (TF32 off; 1e-4 of each leaf's
    largest value: the convolutions sum in another order); a step at amp
    O2 (channels_last bf16 convolutions, fp32 BatchNorm leaves) with
    ``fused_sgd`` gives finite gradients and moves the running stats; no
    hand-written kernel is launched. (At this size bf16 gradients sit
    0.1-0.3 rel. L2 from fp32 on any device, the reference's too:
    BatchNorm's backward cancels most of dy; chip_smoke.py holds the
    ResNet-50 step to fp32.)"""
    from apex_tpu_torch import _tree, amp
    from apex_tpu_torch.models import mlp, resnet
    from apex_tpu_torch.ops import launch_counts
    from apex_tpu_torch.optimizers import fused_sgd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = resnet.tiny(dtype=torch.bfloat16)
    v = resnet.init_variables(torch.Generator(device="cuda").manual_seed(0),
                              model)
    assert all(t.is_cuda for t in _tree.leaves(v))
    x = torch.randn(8, 32, 32, 3, generator=gen, device="cuda")
    y = torch.randint(0, 10, (8,), generator=gen, device="cuda")
    policy = amp.initialize(None, opt_level="O2", verbosity=0).policy
    before = launch_counts.snapshot()

    def grads(m, params, stats, x, y):
        live = _tree.map_leaves(lambda p: p.detach().requires_grad_(),
                                params)
        logits, new = m.apply({"params": live, "batch_stats": stats}, x)
        loss = torch.nn.functional.cross_entropy(logits, y)
        return logits, torch.autograd.grad(loss, _tree.leaves(live)), new

    l32, g32, _ = grads(resnet.tiny(), v["params"], v["batch_stats"], x, y)
    cpu = _tree.map_leaves(lambda t: t.cpu(), v)
    lc, gc, _ = grads(resnet.tiny(), cpu["params"], cpu["batch_stats"],
                      x.cpu(), y.cpu())
    torch.testing.assert_close(l32.cpu(), lc, rtol=1e-4, atol=1e-4)
    for a, b in zip(g32, gc):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))
    _, g16, stats = grads(model, policy.cast_model(v["params"]),
                          v["batch_stats"], x, y)
    assert all(torch.isfinite(t).all() for t in g16)
    tx = fused_sgd(lr=0.1, momentum=0.9, weight_decay=1e-4)
    grads32 = _tree.unflatten(_tree.paths(v["params"]),
                              [t.float() for t in g16])
    upd, _ = tx.update(grads32, tx.init(v["params"]), v["params"])
    assert all(u.is_cuda and torch.isfinite(u).all()
               for u in _tree.leaves(upd))
    assert not torch.equal(stats["BatchNorm_0"]["BatchNorm_0"]["var"],
                           v["batch_stats"]["BatchNorm_0"]["BatchNorm_0"][
                               "var"])
    cfg = mlp.MLPConfig(sizes=(16, 8, 4))
    p = mlp.init_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    assert mlp.forward(p, torch.ones(2, 16, device="cuda"), cfg).is_cuda
    torch.cuda.synchronize()
    assert launch_counts.snapshot() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fast_layer_norm_launches_the_layer_norm_kernels(gen, dtype):
    """``contrib.FastLayerNorm`` at BERT-base rows: one LayerNorm forward
    and one backward launch a call, outputs and grads against the plain
    versions on the same inputs (fp32 1e-5; bf16 one rounding)."""
    from apex_tpu_torch.contrib.layer_norm import FastLayerNorm

    ln_mod = FastLayerNorm(768)
    with torch.no_grad():
        ln_mod.weight.normal_(1.0, 0.1, generator=gen)
        ln_mod.bias.normal_(0.0, 0.1, generator=gen)
    x = torch.randn(4, 128, 768, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(dtype)
    xs = x.clone().requires_grad_()
    before = (ln.ln_launches, ln.ln_bwd_launches)
    y = ln_mod(xs)
    y.backward(dy)
    assert (ln.ln_launches, ln.ln_bwd_launches) == (before[0] + 1,
                                                    before[1] + 1)
    rows, w, b = x.reshape(-1, 768), ln_mod.weight.detach(), \
        ln_mod.bias.detach()
    y_ref, mu, rstd = ln._ln_fwd_plain(rows, w, b, 1e-5)
    dx_ref, dw_ref, db_ref = ln._ln_bwd_plain(rows, w, mu, rstd,
                                              dy.reshape(-1, 768))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.reshape(-1, 768).float(), y_ref.float(),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(xs.grad.reshape(-1, 768).float(),
                               dx_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(ln_mod.weight.grad, dw_ref.float(),
                               rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(ln_mod.bias.grad, db_ref.float(), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("one_rank", ["gloo", "nccl"], indirect=True)
def test_distributed_fused_adam_shard_step_launches_the_adam_kernel(
        one_rank, gen):
    """``DistributedFusedAdam``'s shard step is the flat Adam kernel, one
    launch a dtype bucket (here fp32 and bf16), and at one rank equals
    the plain version of the same arithmetic on the same shard bit for
    bit."""
    from apex_tpu_torch import _tree
    from apex_tpu_torch.contrib.optimizers import distributed_fused_adam

    p = {"w": torch.randn(37, 11, generator=gen, device="cuda"),
         "b": torch.randn(13, generator=gen, device="cuda").bfloat16()}
    g = {k: torch.randn(v.shape, generator=gen, device="cuda").to(v.dtype)
         for k, v in p.items()}
    tx = distributed_fused_adam(lr=1e-2, weight_decay=0.01)
    state = tx.init(p)
    host = _tree.map_leaves(lambda t: t.cpu(), {
        "master": dict(state.master_shard), "mu": dict(state.mu_shard),
        "nu": dict(state.nu_shard)})
    before = fak.launches
    upd, state = tx.update(g, state, p)
    assert fak.launches == before + 2
    for k in ("float32", "bfloat16"):
        grads = torch.cat([g[n].reshape(-1).float().cpu() for n in
                           (("w",) if k == "float32" else ("b",))])
        m, v = host["mu"][k].clone(), host["nu"][k].clone()
        delta, m, v = fak._adam_flat_plain(
            grads, host["master"][k], m, v, 1e-2, torch.tensor(1.0),
            b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
            adam_w_mode=True, bias_correction=True)
        assert torch.equal(state.mu_shard[k].cpu(), m)
        assert torch.equal(state.nu_shard[k].cpu(), v)
        assert torch.equal(state.master_shard[k].cpu(),
                           host["master"][k] + delta)
    assert all(u.is_cuda for u in _tree.leaves(upd))


# ------------------------------------- traces, compiles and the fleet


def _small_llama(gen):
    from apex_tpu_torch.models import llama

    cfg = llama.tiny(dtype=torch.bfloat16, vocab_size=1024, hidden_size=512,
                     intermediate_size=1024, num_heads=4, num_kv_heads=2,
                     max_seq_len=256)
    params = llama.init_params(gen, cfg, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                           device="cuda")
    return cfg, params, (tokens, torch.roll(tokens, -1, dims=-1))


def test_profiled_train_steps_count_the_kernels_as_the_counters(gen,
                                                                tmp_path):
    """Two train steps under ``pyprof.start/stop``: the port's Report
    counts each hand-written kernel exactly as its launch counter moved,
    flash in attention-kernel, the rest in custom-kernel, and the phase
    shares sum to 1."""
    import chip_smoke
    from apex_tpu_torch import pyprof
    from apex_tpu_torch.models import llama
    from apex_tpu_torch.observability.profiling import attribute_report
    from apex_tpu_torch.optimizers import fused_adam

    cfg, params, batch = _small_llama(gen)
    tx = fused_adam(lr=1e-4, flat=True)
    opt = tx.init(params)
    llama.train_step(params, opt, batch, cfg, tx, remat=False)
    pyprof.init(trace_dir=str(tmp_path))
    before = chip_smoke.read_counts()
    pyprof.start()
    for i in range(2):
        if i:
            pyprof.step()
        params, opt, loss = llama.train_step(params, opt, batch, cfg, tx,
                                             remat=False)
        float(loss)
    report = pyprof.Report.from_capture(pyprof.stop())
    launched = chip_smoke.counts_delta(before)
    seen = chip_smoke.trace_kernel_counts(report)
    assert seen == {k: launched[k] for k in seen}
    assert seen["flash_attention_fwd"] == 2 * cfg.num_layers
    assert seen["fused_adam"] == 2
    for op in report.ops:
        if "flash_" in op.name:
            assert op.category == "attention-kernel"
        elif "row_norm::" in op.name or "adam_kernel" in op.name:
            assert op.category == "custom-kernel"
        assert op.flops is None
    att = attribute_report(report)
    assert abs(sum(att.fractions().values()) - 1.0) <= 1e-3
    assert len(report.steps_us) == 2
    assert att.total_self_us <= att.step_wall_us


def test_decode_graph_capture_reports_to_the_listener_and_memory(gen):
    """The decode graph's capture is one compile of ``_decode_step``; the
    compiled-memory capture records the bytes its pool holds (alias and
    code bytes None); a forced second capture trips retrace_guard."""
    from apex_tpu_torch.observability import recompile
    from apex_tpu_torch.observability.memory import compiled

    listener = recompile.install()
    cap = compiled.install_compiled_capture()
    try:
        n0 = listener.compiles("_decode_step")
        _, _, engine = _tiny_engine(gen)
        _serve(engine, _serving_jobs(engine.scheduler.cfg)[:3])
        sched = engine.scheduler
        assert listener.compiles("_decode_step") == n0 + 1
        assert sched.decode_retraces() == 0
        row = cap.snapshot()["_decode_step"]
        assert row["pool_bytes"] > 0 and row["total_bytes"] > 0
        assert row["alias_bytes"] is None
        assert row["generated_code_bytes"] is None
        with pytest.raises(recompile.RetraceBudgetExceeded):
            with recompile.retrace_guard(budget=0, fns=["_decode_step"]):
                sched._graph.capture()
        assert sched.decode_retraces() == 1
    finally:
        compiled.uninstall_compiled_capture()
        recompile.uninstall()


def test_compiled_capture_records_a_step_and_replays_it(gen):
    from apex_tpu_torch.observability.memory import compiled

    cap = compiled.CompiledMemoryCapture()
    x = torch.randn(256, 256, generator=gen, device="cuda")
    replay, fields = cap.capture(lambda t: (t @ t).relu(), x, name="mm")
    assert fields["argument_bytes"] == x.numel() * 4
    assert fields["output_bytes"] == x.numel() * 4
    assert fields["pool_bytes"] >= fields["output_bytes"]
    torch.testing.assert_close(replay(), (x @ x).relu())
    assert cap.snapshot()["mm"]["compiles"] == 1


@pytest.mark.parametrize("one_rank", ["gloo", "nccl"], indirect=True)
def test_fleet_probe_on_the_card_is_bit_for_bit(one_rank, gen):
    """The grad-sync probe, on, syncs the card at the bucket's enter and
    exit and changes nothing else: the synced grads bit for bit, the
    same launches, one wait recorded at the flat bucket's site."""
    from apex_tpu_torch.observability.fleet import probe
    from apex_tpu_torch.parallel import sync_gradients_flat

    g = {"w": torch.randn(37, 11, generator=gen, device="cuda").bfloat16(),
         "b": torch.randn(13, generator=gen, device="cuda").bfloat16()}
    probe.reset()
    try:
        off = sync_gradients_flat(g, "dp")
        probe.enable()
        on = sync_gradients_flat(g, "dp")
        assert all(torch.equal(off[k], on[k]) for k in off)
        assert list(probe.wait_times()) == [("ddp/bucket/bfloat16", 0)]
        assert probe.last_collective() == "ddp/bucket/bfloat16"
    finally:
        probe.reset()


# ------------------------------------- the tuner's plans and the switch

# small shapes of each tuned kernel, as the tuner's dims
TUNING_SMALL = {
    "rms_norm": {"rows": 96, "h": 4096},
    "layer_norm": {"rows": 300, "h": 1024},
    "flat_adam": {"n": 100003},
    "fp8_cast": {"n": 1 << 20},
    "fused_softmax": {"rows": 2 * 64, "sq": 64, "sk": 20000},
}
TUNING_TOL = {"rms_norm": 8e-3, "layer_norm": 8e-3,
              "fp8_cast": 0.0, "fused_softmax": 8e-3}


def _as_float(t):
    return t.view(torch.uint8).float() if t.element_size() == 1 else t.float()


@pytest.mark.parametrize("kernel", sorted(TUNING_SMALL))
def test_every_tuning_candidate_matches_plain(gen, kernel):
    """Every candidate plan of the search space, pinned through the real
    dispatch path, against the plain version on the same inputs (the fp8
    cast bit for bit)."""
    from apex_tpu_torch.ops import kernel_config
    from apex_tpu_torch.tuning import geometry, measure, search_space

    dims = TUNING_SMALL[kernel]
    runner = measure.live_runner(kernel, dims)
    with kernel_config.force("off"):
        ref = [_as_float(t) for t in runner.outputs()]
    cands = search_space.candidates(kernel, **dims)
    assert cands
    for params in cands:
        with geometry.override(kernel, params), kernel_config.force("on"):
            got = [_as_float(t) for t in runner.outputs()]
        for g, r in zip(got, ref):
            if kernel == "flat_adam":
                # every operation rounded on its own, as the plain
                # version's: within one bf16 ulp of each delta
                torch.testing.assert_close(g, r, rtol=8e-3, atol=0)
                continue
            scale = float(r.abs().max()) or 1.0
            err = float((g - r).abs().max())
            assert err <= TUNING_TOL[kernel] * scale, (params, err, scale)


def test_a_plan_the_kernel_cannot_run_is_refused(gen):
    """The C entry points return cudaErrorInvalidValue (1) for threads
    they are not compiled for or a grid they cannot take, and launch
    nothing: the output stays as it was."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import fp8_cast_kernel as fc

    n = 4096
    g = torch.randn(n, generator=gen, device="cuda")
    p = torch.randn(n, generator=gen, device="cuda").bfloat16()
    m, v = torch.zeros(n, device="cuda"), torch.ones(n, device="cuda")
    delta = torch.full((n,), 7.0, device="cuda").bfloat16()
    lib = fak._lib()
    stream = _build.stream_handle(g.device)
    for threads, blocks in ((96, 8), (2048, 8), (256, 0)):
        rc = lib.adam_flat(g.data_ptr(), p.data_ptr(), m.data_ptr(),
                           v.data_ptr(), delta.data_ptr(), n, 1e-3, 1.0,
                           1.0, 0.9, 0.1, 0.999, 0.001, 1e-8, 0.0, 1, 1, 1,
                           threads, blocks, stream)
        assert rc == 1
    torch.cuda.synchronize()
    assert bool((delta == 7.0).all()) and bool((m == 0).all())
    x = torch.randn(n, generator=gen, device="cuda").bfloat16()
    y = torch.zeros(n, dtype=torch.uint8, device="cuda")
    amax = torch.zeros((), device="cuda")
    scratch = fc._scratch(x.device)
    cl = fc._lib()
    for threads, bps in ((96, 8), (256, 0), (256, 17)):
        rc = cl.fp8_cast_scale(x.data_ptr(), y.data_ptr(), n, 1, 0, None,
                               1.0, 448.0, amax.data_ptr(),
                               scratch.data_ptr(), fc.AMAX_SLOTS, threads,
                               bps, stream)
        assert rc == 1
    x3 = torch.randn(4, 20000, generator=gen, device="cuda").bfloat16()
    mm = torch.full((4,), 3.0, device="cuda")
    ll = torch.full((4,), 3.0, device="cuda")
    sl = sm._lib()
    rc = sl.fused_softmax_stats(x3.data_ptr(), None, mm.data_ptr(),
                                ll.data_ptr(), 4, 4, 20000, 1, 0, 0, 0, 0,
                                1.0, 1, 384, stream)
    assert rc == 1
    torch.cuda.synchronize()
    assert bool((y == 0).all()) and bool((mm == 3.0).all())
    assert _counter() == 0


def test_dispatch_switch_on_cuda_tensors(gen, tmp_path, monkeypatch):
    """``"off"`` moves no launch counter and ticks kernels/plain_dispatch;
    ``"on"`` and ``"auto"`` launch; a cache entry whose race the plain
    version won changes nothing; ``forward_torch_softmax`` takes the
    plain version for its own call and ticks the counter."""
    from apex_tpu_torch.observability import MetricRegistry, set_registry
    from apex_tpu_torch.ops import kernel_config
    from apex_tpu_torch.tuning import cache

    x = torch.randn(64, 1024, generator=gen, device="cuda").bfloat16()
    w = torch.ones(1024, device="cuda", dtype=torch.bfloat16)
    reg = MetricRegistry()
    prev = set_registry(reg)
    try:
        before = ln.launches
        with kernel_config.force("off"):
            off = ln.rms_norm(x, w, 1024)
        assert ln.launches == before
        ticks = {m.labels.get("kernel"): m.value for m in reg.metrics()
                 if m.name == "kernels/plain_dispatch"}
        assert ticks == {"rms_norm": 1}
        for mode in ("on", "auto"):
            with kernel_config.force(mode):
                on = ln.rms_norm(x, w, 1024)
        assert ln.launches == before + 2
        torch.testing.assert_close(on.float(), off.float(), rtol=8e-3,
                                   atol=8e-3)
        path = tmp_path / "t.json"
        monkeypatch.setenv("APEX_TPU_TUNING_CACHE", str(path))
        cache.save(cache.put(cache.empty(), cache.current_device_kind(),
                             "rms_norm", "rows~64,h=1024",
                             {"params": {"row_threads": 64,
                                         "rows_per_block": 1, "blocks": 8},
                              "use_kernel": False}))
        ln.rms_norm(x, w, 1024)
        assert ln.launches == before + 3
        s = torch.randn(1, 2, 64, 64, generator=gen,
                        device="cuda").bfloat16()
        mod = sm.FusedScaleMaskSoftmax(scale=0.5)
        launched = sm.causal_launches
        mod.forward_torch_softmax(s)
        assert sm.causal_launches == launched
        assert kernel_config.mode() == "auto"
        mod.forward_fused_softmax(s)
        assert sm.causal_launches == launched + 1
        ticks = {m.labels.get("kernel"): m.value for m in reg.metrics()
                 if m.name == "kernels/plain_dispatch"}
        assert ticks == {"rms_norm": 1, "fused_softmax": 1}
    finally:
        set_registry(prev)
        cache.clear_memo()


def test_probe_names_the_flash_kernel_as_origin(gen):
    """q and k finite (entries of 1e19 at d = 128) whose scores overflow
    fp32 inside the flash forward: the kernel's report makes it the
    origin, by name."""
    from apex_tpu_torch.observability.numerics import nan_probe

    q = torch.full((1, 64, 2, 128), 1e19, device="cuda")
    k = torch.full((1, 64, 2, 128), 1e19, device="cuda")
    v = torch.randn(1, 64, 2, 128, generator=gen, device="cuda")
    before = fa.launches
    prov = nan_probe.probe_fn(
        lambda q, k, v: fa.flash_attention(q, k, v, causal=True), q, k, v)
    assert fa.launches == before + 1
    assert (prov.kind, prov.primitive) == ("origin", "flash_fwd")
    assert "flash_attention.py" in prov.source


def test_probe_sees_the_backward_on_the_engine_thread(gen):
    """A CUDA backward runs on the autograd engine's device thread: the
    dispatch mode reaches it, and the kernels' reports too."""
    from apex_tpu_torch.observability.numerics import nan_probe

    class BadBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x * 1.0

        @staticmethod
        def backward(ctx, g):
            return g / torch.zeros_like(g)

    def step(x, w):
        x = x.clone().requires_grad_()
        y = ln.rms_norm(BadBackward.apply(x), w, 1024)
        y.float().sum().backward()
        return x.grad

    x = torch.randn(16, 1024, generator=gen, device="cuda").bfloat16()
    w = torch.ones(1024, device="cuda", dtype=torch.bfloat16)
    before = ln.bwd_launches
    prov = nan_probe.probe_fn(step, x, w)
    assert ln.bwd_launches == before + 1
    assert (prov.kind, prov.primitive) == ("origin", "div")
    assert "backward" in prov.source
