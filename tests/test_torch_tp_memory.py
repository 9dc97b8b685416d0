"""``apex_tpu_torch.transformer.tensor_parallel.memory`` held against the
JAX package's ``memory.py``: the same registry, bump-pointer offsets,
usage tracking, ring rotation and errors, and the same values read back
after the same writes (the port's ``get`` is a view of the buffer, as in
the CUDA reference; the JAX one a copy)."""

import numpy as np
import pytest
import torch

from apex_tpu.transformer.tensor_parallel import memory as jmem
from apex_tpu_torch.transformer.tensor_parallel import memory as pmem


@pytest.fixture(autouse=True)
def _fresh_registries():
    jmem.reset_mem_buffs()
    pmem.reset_mem_buffs()
    yield
    jmem.reset_mem_buffs()
    pmem.reset_mem_buffs()


def test_registry_offsets_and_values_match_reference():
    import jax.numpy as jnp

    jb = jmem.allocate_mem_buff("a", 24, jnp.float32, True)
    pb = pmem.allocate_mem_buff("a", 24, torch.float32, True, device="cpu")
    assert pmem.get_mem_buff("a") is pb and pmem.get_mem_buff("b") is None
    rng = np.random.default_rng(0)
    for shape in ((2, 3), (4,), (3, 2, 2)):
        assert pb.add(shape) == jb.add(shape)
        assert pb.allocated() == jb.allocated()
        value = rng.standard_normal(shape).astype(np.float32)
        start = pb.allocated() - value.size
        jb.put(jnp.asarray(value), start)
        pb.put(torch.from_numpy(value), start)
        np.testing.assert_array_equal(pb.get(shape, start).numpy(),
                                      np.asarray(jb.get(shape, start)))
    np.testing.assert_array_equal(pb.data.numpy(), np.asarray(jb.data))
    assert pb.is_in_use() == jb.is_in_use()
    assert pb.in_use_value == jb.in_use_value
    for buf in (jb, pb):
        with pytest.raises(MemoryError, match="out of space"):
            buf.add((100,))
    jb.reset()
    pb.reset()
    assert (pb.allocated(), pb.is_in_use(), pb.total_value) == (
        jb.allocated(), jb.is_in_use(), jb.total_value)
    with pytest.raises(ValueError, match="already allocated"):
        pmem.allocate_mem_buff("a", 4, torch.float32, False, device="cpu")


def test_get_is_a_view_and_put_casts():
    buf = pmem.MemoryBuffer("v", 8, torch.bfloat16, device="cpu")
    start, stop = buf.add((2, 2))
    assert (start, stop) == (0, 4)
    view = buf.get((2, 2), start)
    view.fill_(3.0)
    assert torch.equal(buf.data[:4], torch.full((4,), 3.0,
                                                dtype=torch.bfloat16))
    buf.put(torch.tensor([1.0, 2.0], dtype=torch.float64), 4)
    assert buf.data.dtype == torch.bfloat16
    assert buf.data[4:6].tolist() == [1.0, 2.0]


def test_ring_buffer_matches_reference():
    import jax.numpy as jnp

    jr = jmem.RingMemBuffer("r", 2, 8, jnp.float32, False)
    pr = pmem.RingMemBuffer("r", 2, 8, torch.float32, False, device="cpu")
    names = []
    for ring in (jr, pr):
        first = ring.get_next_buffer()
        first.add((4,))
        second = ring.get_next_buffer()
        names.append((first.name, second.name))
        with pytest.raises(RuntimeError, match="still in use"):
            ring.get_next_buffer()
        first.reset()
        # the refused call moved the cursor on: the next is the second
        names.append(ring.get_next_buffer().name)
    assert names[0] == names[2] == ("r-0", "r-1")
    assert names[1] == names[3] == "r-1"


def test_memory_buffer_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmem.MemoryBuffer("g", 4, torch.float32)
