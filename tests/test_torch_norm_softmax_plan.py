"""The launch plans of the row-norm forward and backward
(``ops/layer_norm.py`` ``_fwd_plan``, ``_bwd_plan``) and of the whole-row
softmax (``fused_softmax.py`` ``_softmax_plan``): pure functions of the
shape, checked here on the CPU by walking the rows and columns the
kernels would give each thread."""

import pytest
import torch

from apex_tpu_torch.ops import layer_norm as ln
from apex_tpu_torch.transformer.functional import fused_softmax as sm

DTYPES = [torch.float32, torch.bfloat16, torch.float16]
NORM_WIDTHS = (64, 100, 768, 1024, 2048, 4096, 16384, 20480)
NORM_SHAPES = [(rows, h) for rows in (1, 3, 1000, 8192, 100_000)
               for h in NORM_WIDTHS]
# the forward's shapes add serving's decode (8 rows) and prefill (512)
FWD_NORM_SHAPES = NORM_SHAPES + [(rows, h) for rows in (8, 512)
                                 for h in NORM_WIDTHS]


def _vec(dtype):
    return 16 // dtype.itemsize


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,h", NORM_SHAPES)
def test_norm_bwd_plan_covers_every_row_once(rows, h, dtype):
    """The rows the kernel's slots walk (slot g of block b: b * per_block
    + g + k * blocks * per_block; the loop path: b + k * blocks) are each
    row exactly once, and the plan keeps the kernel's limits."""
    plan = ln._bwd_plan(rows, h, dtype)
    assert 1 <= plan.blocks <= min(rows, ln.DW_PARTS)
    assert plan.partial_rows == plan.blocks
    seen = torch.zeros(rows, dtype=torch.int64)
    per_block = plan.rows_per_block
    step = plan.blocks * per_block
    for b in range(plan.blocks):
        for g in range(per_block):
            seen[b * per_block + g::step] += 1
    assert bool((seen == 1).all())
    if plan.registers:
        assert plan.row_threads & (plan.row_threads - 1) == 0
        assert 32 <= plan.row_threads <= ln.MAX_ROW_THREADS
        assert per_block * plan.row_threads <= max(ln.ROW_BLOCK,
                                                   plan.row_threads)
        assert plan.blocks == min(-(-rows // per_block), ln.DW_PARTS)
    else:
        assert per_block == 1 and plan.row_threads % 32 == 0
        assert 32 <= plan.row_threads <= 1024


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h", [8, 64, 100, 768, 1024, 1032, 2048, 4096,
                               8192, 16384, 16392, 20480])
def test_norm_bwd_plan_values_a_thread_stay_within_the_cap(h, dtype):
    """On the register path each thread holds at most ROW_VECS
    16-byte vectors of x and of dy (32 values of a 16-bit dtype, 16 of
    fp32), every vector of a row has exactly one owner, and a row takes
    the fewest threads that allow that; rows of whole vectors within the
    cap never take the loop path."""
    v = _vec(dtype)
    plan = ln._bwd_plan(1000, h, dtype)
    fits = h % v == 0 and h // v <= ln.MAX_ROW_THREADS * ln.ROW_VECS
    assert plan.registers == fits
    if not fits:
        return
    nvec = h // v
    owners = torch.zeros(nvec, dtype=torch.int64)
    for t in range(plan.row_threads):
        mine = list(range(t, nvec, plan.row_threads))
        assert len(mine) <= ln.ROW_VECS
        assert len(mine) * v <= 32
        owners[mine] += 1
    assert bool((owners == 1).all())
    assert plan.row_threads == 32 or (
        plan.row_threads // 2 * ln.ROW_VECS < nvec)


def test_norm_bwd_plan_one_warp_a_row_at_the_training_widths():
    """GPT-2's and BERT's rows are one warp each, 8 to a block;
    Llama's h = 4096 four warps, 2 to a block."""
    assert ln._bwd_plan(8192, 1024, torch.bfloat16) == ln.BwdPlan(
        32, 8, 264, True)
    assert ln._bwd_plan(4096, 768, torch.bfloat16) == ln.BwdPlan(
        32, 8, 264, True)
    assert ln._bwd_plan(4096, 4096, torch.bfloat16) == ln.BwdPlan(
        128, 2, 264, True)


@pytest.mark.parametrize("rows,h", [(8192, 1024), (4096, 768), (3, 4096),
                                    (1000, 100)])
def test_norm_bwd_partial_rows_do_not_depend_on_the_device(monkeypatch,
                                                           rows, h):
    """The plan reads no device property: with every CUDA query made to
    fail it gives the same plan, so the number of partial rows, and with
    it the order of the dw and db sums, is the same on every card."""
    want = ln._bwd_plan(rows, h, torch.bfloat16)

    def refuse(*args, **kwargs):
        raise AssertionError("the plan asked the device")

    for name in ("get_device_properties", "device_count",
                 "get_device_name", "current_device"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    assert ln._bwd_plan(rows, h, torch.bfloat16) == want
    assert ln._bwd_plan(rows, h, torch.bfloat16, aligned=False).registers \
        is False


def _rows_walked(rows, per_block, blocks):
    """How often each row is taken when slot g of block b takes rows
    b * per_block + g + k * blocks * per_block."""
    seen = torch.zeros(rows, dtype=torch.int64)
    step = blocks * per_block
    for b in range(blocks):
        for g in range(per_block):
            seen[b * per_block + g::step] += 1
    return seen


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,h", FWD_NORM_SHAPES)
def test_norm_fwd_plan_covers_every_row_once(rows, h, dtype):
    """The rows the forward's slots walk are each row exactly once, and
    the plan keeps the kernel's limits: on the register path a power of
    two of threads a row, at most 512 threads a block, no more blocks
    than row groups; on the loop path a block a row."""
    plan = ln._fwd_plan(rows, h, dtype)
    if plan.registers:
        per_block = plan.rows_per_block
        assert plan.row_threads & (plan.row_threads - 1) == 0
        assert 32 <= plan.row_threads <= ln.MAX_ROW_THREADS
        assert 1 <= per_block * plan.row_threads <= ln.MAX_ROW_THREADS
        assert 1 <= plan.blocks <= -(-rows // per_block)
        assert bool((_rows_walked(rows, per_block, plan.blocks) == 1).all())
    else:
        assert plan.rows_per_block == 1 and plan.blocks == rows
        assert plan.row_threads % 32 == 0
        assert 32 <= plan.row_threads <= 1024


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [1, 8, 512, 8192])
@pytest.mark.parametrize("h", [8, 64, 100, 768, 1024, 1032, 2048, 4096,
                               8192, 14336, 16384, 16392, 20480])
def test_norm_fwd_plan_vectors_a_lane_stay_within_the_cap(rows, h, dtype):
    """On the register path a lane holds at most ROW_VECS 16-byte
    vectors of x (32 values of a 16-bit dtype, 16 of fp32) and at least
    one, every vector of a row has exactly one owner, and rows of whole
    vectors within the cap never take the loop path."""
    v = _vec(dtype)
    plan = ln._fwd_plan(rows, h, dtype)
    fits = h % v == 0 and h // v <= ln.MAX_ROW_THREADS * ln.ROW_VECS
    assert plan.registers == fits
    if not fits:
        return
    nvec = h // v
    owners = torch.zeros(nvec, dtype=torch.int64)
    for t in range(plan.row_threads):
        mine = list(range(t, nvec, plan.row_threads))
        assert len(mine) <= ln.ROW_VECS
        assert len(mine) * v <= 32
        owners[mine] += 1
    assert bool((owners == 1).all())
    # more threads than the fewest only for few rows, and never past a
    # vector a thread
    fewest = 32
    while fewest * ln.ROW_VECS < nvec:
        fewest *= 2
    assert plan.row_threads == fewest or (
        rows * plan.row_threads // 2 < ln.FWD_FILL_THREADS
        and plan.row_threads <= nvec)


def test_norm_fwd_plan_register_path_at_the_path_shapes():
    """GPT-2's and BERT's rows are one warp each, 8 to a block; Llama's
    h = 4096 four warps, 2 to a block, in training; serving's prefill
    (512 rows) takes 256 threads a row and its decode step (8 rows) 512,
    a vector a thread, a row a block."""
    bf16 = torch.bfloat16
    assert ln._fwd_plan(8192, 1024, bf16) == ln.FwdPlan(32, 8, 1024, True)
    assert ln._fwd_plan(4096, 768, bf16) == ln.FwdPlan(32, 8, 512, True)
    assert ln._fwd_plan(4096, 4096, bf16) == ln.FwdPlan(128, 2, 2048, True)
    assert ln._fwd_plan(512, 4096, bf16) == ln.FwdPlan(256, 1, 512, True)
    assert ln._fwd_plan(8, 4096, bf16) == ln.FwdPlan(512, 1, 8, True)
    for rows, h in ((8192, 1024), (4096, 768), (4096, 4096), (8, 4096)):
        for dtype in DTYPES:
            assert ln._fwd_plan(rows, h, dtype).registers
        assert not ln._fwd_plan(rows, h, bf16, aligned=False).registers


@pytest.mark.parametrize("rows,h", [(8192, 1024), (4096, 768), (4096, 4096),
                                    (512, 4096), (8, 4096), (1000, 100)])
def test_norm_fwd_plan_does_not_depend_on_the_device(monkeypatch, rows, h):
    """The forward's plan reads no device property: with every CUDA query
    made to fail it gives the same plan on every card."""
    want = {d: ln._fwd_plan(rows, h, d) for d in DTYPES}

    def refuse(*args, **kwargs):
        raise AssertionError("the plan asked the device")

    for name in ("get_device_properties", "device_count",
                 "get_device_name", "current_device", "is_available"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    assert {d: ln._fwd_plan(rows, h, d) for d in DTYPES} == want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sk", [1, 7, 37, 64, 100, 512, 1000, 1024, 1032,
                                2048, 4099, 8192, 16383, 16384])
def test_softmax_plan_covers_every_key_once(sk, dtype):
    """Every load of a row (vec keys each) has exactly one owner thread,
    a thread holds at most _MAX_VALUES keys, and sk up to the whole-row
    limit of 16384 is accepted."""
    plan = sm._softmax_plan(sk, dtype)
    assert plan.vec == (_vec(dtype) if sk % _vec(dtype) == 0 else 1)
    assert plan.row_threads & (plan.row_threads - 1) == 0
    assert 32 <= plan.row_threads <= sm._MAX_ROW_THREADS
    assert plan.rows_per_block * plan.row_threads == max(sm._ROW_BLOCK,
                                                         plan.row_threads)
    loads = sk // plan.vec
    owners = torch.zeros(loads, dtype=torch.int64)
    for t in range(plan.row_threads):
        mine = list(range(t, loads, plan.row_threads))
        assert len(mine) * plan.vec <= sm._MAX_VALUES
        owners[mine] += 1
    assert bool((owners == 1).all())


@pytest.mark.parametrize("sk", [0, 16385, 32768])
def test_softmax_plan_refuses_rows_past_the_whole_row_limit(sk):
    with pytest.raises(ValueError, match="whole-row"):
        sm._softmax_plan(sk, torch.bfloat16)


def test_softmax_plan_one_warp_a_row_at_the_training_shapes():
    """GPT-2's sk = 1024 and BERT's 512 in bf16: one warp a row, 8 rows
    a block; an unaligned x takes the scalar loads."""
    for sk in (512, 1024):
        assert sm._softmax_plan(sk, torch.bfloat16) == sm.RowPlan(8, 32, 8)
    assert sm._softmax_plan(1024, torch.bfloat16, aligned=False) == \
        sm.RowPlan(1, 32, 8)
    assert sm._softmax_plan(16384, torch.bfloat16) == sm.RowPlan(8, 512, 1)
