"""The port's ``runtime.PrefetchLoader`` (worker threads over a ``fill``
callback): batches in order, at most ``n_slots`` in flight, an early
close or an abandoned iterator joins every worker, and a ``fill`` that
raises surfaces as ``RuntimeError`` on the consumer. The order and the
values are held against the JAX package's loader over the same
callback."""

import gc
import threading
import time

import numpy as np
import pytest

from apex_tpu.runtime.host import PrefetchLoader as JPrefetchLoader
from apex_tpu_torch.runtime import PrefetchLoader


def _fill(b, out):
    time.sleep(0.002 * (b % 3))  # workers finish out of order
    out[:] = np.arange(out.size, dtype=out.dtype).reshape(out.shape) + b


def _workers():
    return [t for t in threading.enumerate()
            if t.name.startswith("apex-prefetch-fill")]


@pytest.mark.parametrize("n_workers", [1, 3])
def test_batches_in_order_equal_the_reference(n_workers):
    got = list(PrefetchLoader(_fill, 12, (2, 3), np.float32, n_slots=4,
                              n_workers=n_workers))
    want = list(JPrefetchLoader(_fill, 12, (2, 3), np.float32, n_slots=4,
                                n_workers=n_workers))
    assert len(got) == 12
    for g, w in zip(got, want):
        assert g.shape == (2, 3) and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert not _workers()


def test_at_most_n_slots_in_flight():
    """No fill starts more than ``n_slots`` batches ahead of the last
    batch the consumer received: at most ``n_slots`` are being filled or
    waiting while the consumer works on one."""
    handed, ahead = [0], []

    def fill(b, out):
        ahead.append(b - handed[0])
        out[:] = b

    for arr in PrefetchLoader(fill, 30, (1,), n_slots=2, n_workers=4):
        handed[0] = int(arr[0]) + 1
        time.sleep(0.002)
    assert max(ahead) <= 2


@pytest.mark.parametrize("how", ["close", "abandon"])
def test_early_close_joins_the_workers(how):
    """A slow fill is in flight when the consumer leaves; no new fill
    starts after, and every worker has exited when close returns (an
    abandoned generator is closed when it is collected)."""
    started = []

    def fill(b, out):
        started.append(b)
        time.sleep(0.05)
        out[:] = b

    it = iter(PrefetchLoader(fill, 100, (4,), n_slots=3, n_workers=2))
    assert next(it)[0] == 0
    if how == "close":
        it.close()
    else:
        del it
        gc.collect()
    assert not _workers()
    n = len(started)
    time.sleep(0.1)
    assert len(started) == n < 100


def test_fill_exception_surfaces_as_runtime_error():
    def fill(b, out):
        if b == 3:
            raise ValueError("bad shard")
        out[:] = b

    got = []
    with pytest.raises(RuntimeError, match="fill callback failed") as info:
        for arr in PrefetchLoader(fill, 10, (2,), n_slots=2, n_workers=2):
            got.append(int(arr[0]))
    assert got == [0, 1, 2]
    assert isinstance(info.value.__cause__, ValueError)
    assert not _workers()


def test_bad_sizes_are_refused():
    with pytest.raises(ValueError, match="at least 1"):
        PrefetchLoader(_fill, 4, (1,), n_slots=0)
