"""The port's kernel dispatch switch (``apex_tpu_torch.ops.kernel_config``)
held against the JAX package's ``apex_tpu.ops.pallas_config``: the same
modes, an unknown one refused by both; and the modes on CPU tensors,
where ``"on"`` raises and the others take the plain versions (``"off"``
the whole-row softmax, ``"auto"`` and ``"interpret"`` the kernel path's
structure). The port has no pinned verdicts and no flash tile overrides
(the module docstring says why), so nothing of those is compared.
"""

import numpy as np
import pytest
import torch

from apex_tpu.ops import pallas_config
from apex_tpu_torch.ops import kernel_config as kc
from apex_tpu_torch.tuning import cache as pcache


@pytest.fixture
def tables(tmp_path, monkeypatch):
    """A tuning cache of the test's own, its memo cleared before and
    after the test."""
    monkeypatch.setenv("APEX_TPU_TUNING_CACHE", str(tmp_path / "t.json"))
    pcache.clear_memo()
    yield tmp_path
    pcache.clear_memo()


def _error(fn, *args, **kwargs):
    """The exception type fn raises, or None."""
    try:
        fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001
        return type(e)
    return None


def test_unknown_mode_raises_in_both(tables):
    for mod in (pallas_config, kc):
        with pytest.raises(ValueError):
            with mod.force("sometimes"):
                pass
    assert kc.mode() == "auto"


def test_modes_on_cpu_tensors(tables):
    x = torch.ones(4)
    assert kc.dispatch("layer_norm", x) == "interpret"
    assert not kc.use_kernel("layer_norm", x)
    with kc.force("off"):
        assert kc.dispatch("layer_norm", x) == "plain"
    with kc.force("interpret"):
        assert kc.dispatch("layer_norm", x) == "interpret"
    with kc.force("on"), pytest.raises(RuntimeError, match="CUDA kernel"):
        kc.use_kernel("layer_norm", x)


def test_a_calls_own_mode_leaves_the_process_mode(tables):
    """``dispatch(..., mode=)`` answers for that call alone; an unknown
    one is refused as ``force`` refuses it."""
    x = torch.ones(4)
    with kc.force("interpret"):
        assert kc.dispatch("fused_softmax", x, mode="off") == "plain"
        assert kc.mode() == "interpret"
        assert kc.dispatch("fused_softmax", x) == "interpret"
    assert kc.dispatch("fused_softmax", x, mode="interpret") == "interpret"
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        kc.dispatch("fused_softmax", x, mode="on")
    with pytest.raises(ValueError, match="sometimes"):
        kc.dispatch("fused_softmax", x, mode="sometimes")
    assert kc.mode() == "auto"


def test_softmax_entry_points_keep_their_choice_local(tables, monkeypatch):
    """``forward_torch_softmax`` and ``forward_fused_softmax`` choose
    their own call's path: while they run, the process-wide mode (what
    every other wrapper and the autograd engine's thread read) stays as
    it was."""
    from apex_tpu_torch.transformer.functional import fused_softmax as fs

    seen = []
    for name in ("_causal_plain", "_masked_plain"):
        plain = getattr(fs, name)
        monkeypatch.setattr(
            fs, name, lambda *a, _p=plain: seen.append(kc.mode()) or _p(*a))
    mod = fs.FusedScaleMaskSoftmax(attn_mask_type=fs.AttnMaskType.causal,
                                   scale=0.5)
    x = torch.randn(1, 2, 8, 8, generator=torch.Generator().manual_seed(3))
    mod.forward_torch_softmax(x)
    mod.forward_torch_softmax(x, torch.zeros(1, 1, 8, 8, dtype=torch.bool))
    with kc.force("interpret"):
        mod.forward_fused_softmax(x)
    assert seen == ["auto", "auto", "interpret"]


def test_off_takes_the_whole_row_softmax_on_long_rows(tables, monkeypatch):
    """Long rows take the two-pass plain version under "auto" and
    "interpret" (the kernel path's structure) and the whole-row one under
    "off", as the reference's jnp fallback; the values agree."""
    from apex_tpu_torch.transformer.functional import fused_softmax as fs

    monkeypatch.setattr(fs, "_WHOLE_ROW_MAX_SK", 32)
    monkeypatch.setattr(fs, "_BLOCKED_BK", 16)
    calls = []
    blocked = fs._blocked_plain
    monkeypatch.setattr(fs, "_blocked_plain",
                        lambda *a, **k: calls.append(1) or blocked(*a, **k))
    x = torch.randn(2, 8, 64, generator=torch.Generator().manual_seed(0))
    mod = fs.FusedScaleMaskSoftmax(attn_mask_type=fs.AttnMaskType.causal,
                                   scale=0.5)
    x4 = x.reshape(1, 2, 8, 64)
    auto = mod(x4)
    assert len(calls) == 1
    with kc.force("interpret"):
        mod(x4)
    assert len(calls) == 2
    off = mod.forward_torch_softmax(x4)
    with kc.force("off"):
        mod(x4)
    assert len(calls) == 2
    torch.testing.assert_close(auto, off, rtol=1e-6, atol=1e-7)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.forward_fused_softmax(x4)
    with kc.force("interpret"):
        torch.testing.assert_close(mod.forward_fused_softmax(x4), auto)


@pytest.mark.parametrize("mode", ["auto", "off", "interpret"])
def test_every_site_gives_the_plain_result_in_every_cpu_mode(tables, mode):
    """Norms, flash, the flat Adam and the fp8 cast through their public
    functions: on the CPU every mode gives the plain versions' values."""
    from apex_tpu_torch.ops import flash_attention as fa
    from apex_tpu_torch.ops import fp8_cast_kernel as fc
    from apex_tpu_torch.ops import fused_adam_kernel as fak
    from apex_tpu_torch.ops import layer_norm as ln

    g = torch.Generator().manual_seed(1)
    x = torch.randn(6, 32, generator=g)
    w = torch.randn(32, generator=g)
    q, k, v = (torch.randn(1, 8, 2, 16, generator=g) for _ in range(3))
    n = 40
    gr, p, m, vv = (torch.randn(n, generator=g) for _ in range(4))
    vv = vv.abs()
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
              adam_w_mode=True, bias_correction=True)
    with kc.force(mode):
        y = ln.rms_norm(x, w, 32)
        z = ln.layer_norm(x, w, w, 32)
        o = fa.flash_attention(q, k, v, causal=True)
        d, m2, v2 = fak.adam_flat(gr, p, m.clone(), vv.clone(), 1e-3, 1.0,
                                  **kw)
        y8, amax = fc.cast_and_scale_stats(x, 2.0, torch.float8_e4m3fn,
                                           448.0)
    torch.testing.assert_close(y, ln._rms_fwd_plain(x, w, 1e-5)[0])
    torch.testing.assert_close(z, ln._ln_fwd_plain(x, w, w, 1e-5)[0])
    ref, _ = fa._flash_fwd_plain(fa._heads_major(q), fa._heads_major(k),
                                 fa._heads_major(v), True, 16 ** -0.5)
    torch.testing.assert_close(o, fa._seq_major(ref, 1))
    d_ref, _, _ = fak._adam_flat_plain(gr, p, m.clone(), vv.clone(), 1e-3,
                                       1.0, **kw)
    torch.testing.assert_close(d, d_ref)
    assert torch.equal(y8.view(torch.uint8), fc._cast_and_scale_plain(
        x, 2.0, torch.float8_e4m3fn, 448.0)[0].view(torch.uint8))
    assert float(amax) == float(np.abs(x.numpy()).max())


def test_device_limits(tables, monkeypatch):
    assert kc.device_smem_bytes("NVIDIA H100 80GB HBM3") == 232448
    assert kc.device_smem_bytes("some other card") == 48 << 10
    if not torch.cuda.is_available():
        assert kc.device_smem_bytes() == 48 << 10
    monkeypatch.setenv("APEX_TPU_HBM_BYTES", str(80 << 30))
    assert kc.device_hbm_bytes("cpu") == 80 << 30
    kc.refresh_tuning()
