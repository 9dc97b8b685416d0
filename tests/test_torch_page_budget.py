"""The port's page budget (``serving.kv_cache.derive_page_budget``) and
its priors file (``analysis.memory_checks``) against the JAX package's:
the same pages, ratio and usable bytes on the overrides of
``tests/run_serving/test_kv_cache.py``, the same safety errors, a
committed priors file that loads and names its card, a loader that
refuses a schema drift, a device memory figure only from a card or the
override, and an engine whose ``num_pages=None`` takes the budget capped
at its worst case.
"""

import json

import numpy as np
import pytest
import torch

from apex_tpu.analysis import memory_checks as jax_priors
from apex_tpu.models import llama as jax_llama
from apex_tpu.serving import kv_cache as jax_kvc
from apex_tpu_torch import _device
from apex_tpu_torch.analysis import memory_checks as priors_mod
from apex_tpu_torch.models import llama
from apex_tpu_torch.serving import (
    PageBudget,
    ServingEngine,
    derive_page_budget,
    page_hbm_bytes,
    pages_per_request,
)

# (hbm pages, watermark pages, priors, safety): test_kv_cache.py:62-98
CASES = {
    "serving_prior": (100, 10, {"priors": {"serving_decode_step": {
        "ratio": 2.0}}, "default_ratio": 1.5}, 0.5),
    "default_ratio": (100, 0, {"priors": {}, "default_ratio": 1.5}, 1.0),
    "watermark_floor": (4, 50, {"priors": {}, "default_ratio": 1.0}, 0.9),
    "fractional": (1000, 3, {"priors": {"serving_decode_step": {
        "ratio": 1.2345}}}, 0.77),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("page_size", [8, 16])
def test_budget_equals_the_reference(case, page_size):
    hbm, mark, priors, safety = CASES[case]
    cfg, jcfg = llama.tiny(), jax_llama.tiny()
    page = page_hbm_bytes(cfg, page_size)
    assert page == jax_kvc.page_hbm_bytes(jcfg, page_size)
    got = derive_page_budget(cfg, page_size, hbm_bytes=page * hbm,
                             watermark_bytes=page * mark, priors=priors,
                             safety=safety)
    want = jax_kvc.derive_page_budget(jcfg, page_size, hbm_bytes=page * hbm,
                                      watermark_bytes=page * mark,
                                      priors=priors, safety=safety)
    assert isinstance(got, PageBudget)
    assert (got.pages, got.page_bytes, got.ratio, got.hbm_bytes,
            got.watermark_bytes, got.usable_bytes, got.safety) == (
        want.pages, want.page_bytes, want.ratio, want.hbm_bytes,
        want.watermark_bytes, want.usable_bytes, want.safety)


def test_budget_math_as_the_reference_states_it():
    cfg = llama.tiny()
    page = page_hbm_bytes(cfg, 8)
    b = derive_page_budget(cfg, 8, hbm_bytes=page * 100,
                           watermark_bytes=page * 10,
                           priors=CASES["serving_prior"][2], safety=0.5)
    # usable = 100p * 0.5 - 10p = 40p; effective page cost = 2.0p
    assert (b.usable_bytes, b.ratio, b.pages) == (page * 40, 2.0, 20)
    b = derive_page_budget(cfg, 8, hbm_bytes=page * 4,
                           watermark_bytes=page * 50,
                           priors={"priors": {}, "default_ratio": 1.0})
    assert b.usable_bytes == 0 and b.pages == 0


@pytest.mark.parametrize("safety", [0.0, 1.5, -0.1])
def test_safety_outside_the_unit_interval_raises(safety):
    kw = dict(hbm_bytes=1, watermark_bytes=0,
              priors={"priors": {}, "default_ratio": 1.0}, safety=safety)
    with pytest.raises(ValueError, match="safety") as got:
        derive_page_budget(llama.tiny(), 8, **kw)
    with pytest.raises(ValueError, match="safety") as want:
        jax_kvc.derive_page_budget(jax_llama.tiny(), 8, **kw)
    assert str(got.value) == str(want.value)


def test_committed_priors_load_and_name_their_card():
    data = priors_mod.load_hbm_priors()
    assert data["schema_version"] == priors_mod.PRIORS_SCHEMA_VERSION == (
        jax_priors.PRIORS_SCHEMA_VERSION)
    assert data["default_ratio"] == 1.0
    assert "H100" in data["device"] and data["power_limit"]
    row = data["priors"]["serving_decode_step"]
    assert row["ratio"] == pytest.approx(
        row["measured_bytes"] / row["modeled_bytes"], rel=1e-6)
    assert priors_mod.prior_for("serving_decode_step") == row["ratio"]
    assert priors_mod.prior_for("nothing") is None
    assert priors_mod.prior_for("nothing", default=True) == 1.0


@pytest.mark.parametrize("drift", ["schema", "empty", "ratio", "default"])
def test_priors_loader_refuses_a_drift(tmp_path, drift):
    data = priors_mod.load_hbm_priors()
    if drift == "schema":
        data["schema_version"] = 2
    elif drift == "empty":
        data["priors"] = {}
    elif drift == "ratio":
        data["priors"]["serving_decode_step"]["ratio"] = -1.0
    else:
        data["default_ratio"] = "much"
    path = tmp_path / "priors.json"
    path.write_text(json.dumps(data))
    with pytest.raises(ValueError):
        priors_mod.load_hbm_priors(str(path))
    with pytest.raises(ValueError):
        jax_priors.load_hbm_priors(str(path))


@pytest.mark.parametrize("row", [2.5, {"ratio": 0.75}, {"ratio": "1.25"}])
def test_prior_ratio_of_equals_the_reference(row):
    from apex_tpu.analysis.sharding_flow import prior_ratio_of

    assert priors_mod.prior_ratio_of(row) == prior_ratio_of(row)


def test_budget_without_a_card_or_override_raises(monkeypatch):
    monkeypatch.delenv("APEX_TPU_HBM_BYTES", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        derive_page_budget(cfg, 8)
    with pytest.raises(RuntimeError, match="APEX_TPU_HBM_BYTES"):
        derive_page_budget(cfg, 8, device="cpu")
    with pytest.raises(RuntimeError, match="APEX_TPU_HBM_BYTES"):
        _device.memory("cpu")
    params = llama.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(params, cfg)
    with pytest.raises(RuntimeError, match="APEX_TPU_HBM_BYTES"):
        ServingEngine(params, cfg, device="cpu")


def test_override_prices_the_budget_on_the_cpu(monkeypatch):
    cfg = llama.tiny()
    page = page_hbm_bytes(cfg, 8)
    monkeypatch.setenv("APEX_TPU_HBM_BYTES", str(page * 1000))
    assert _device.memory("cpu") == (page * 1000, 0)
    b = derive_page_budget(cfg, 8, device="cpu")
    ratio = priors_mod.prior_for("serving_decode_step")
    assert b.hbm_bytes == page * 1000 and b.watermark_bytes == 0
    assert b.pages == int(page * 900 // int(np.ceil(page * ratio)))
    monkeypatch.setenv("APEX_TPU_HBM_BYTES", "lots")
    with pytest.raises(ValueError, match="integer byte count"):
        _device.memory("cpu")


def test_engine_takes_the_budget_capped_at_its_worst_case(monkeypatch):
    """``num_pages=None``: the budget, capped at max_batch worst-case
    requests, and kept on the engine; a budget that cannot hold one
    worst-case request raises, as the reference's does."""
    cfg = llama.tiny()
    params = llama.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    one = pages_per_request(16, 8, 8)
    page = page_hbm_bytes(cfg, 8)
    monkeypatch.setenv("APEX_TPU_HBM_BYTES", str(page * 10_000))
    engine = ServingEngine(params, cfg, page_size=8, max_batch=3,
                           max_prompt_len=16, max_new_cap=8, device="cpu")
    assert engine.page_budget.pages > 3 * one
    assert engine.scheduler.cache.num_pages == 3 * one
    engine.submit(np.arange(5), 4)
    assert len(engine.run()[0]["tokens"]) == 4
    monkeypatch.setenv("APEX_TPU_HBM_BYTES", str(page * one))
    with pytest.raises(ValueError, match="cannot hold one"):
        ServingEngine(params, cfg, page_size=8, max_batch=3,
                      max_prompt_len=16, max_new_cap=8, device="cpu",
                      hbm_safety=0.5)
