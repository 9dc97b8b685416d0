"""The port's Megatron batch samplers
(``apex_tpu_torch.transformer._data``) against the JAX package's: for the
cases of ``tests/run_transformer/test_batchsampler.py`` (and a few
around them) every rank's whole index stream, item for item, the padded
tail and ``with_validity`` included; then the reference test's own
properties on the port. Index streams are exact: no tolerance.
"""

import pytest

from apex_tpu.transformer import _data as jdata
from apex_tpu_torch.transformer import _data

# (total, consumed, local minibatch, dp, kwargs) of the sequential sampler
SEQ_CASES = [
    (64, 0, 4, 2, {}), (32, 8, 4, 1, {}), (10, 0, 4, 1, {}),
    (10, 0, 4, 1, {"drop_last": False}), (10, 0, 4, 2, {"drop_last": False}),
    (9, 0, 4, 2, {"drop_last": False}), (64, 0, 2, 2, {}),
    (9, 0, 2, 4, {"drop_last": False, "with_validity": True}),
    (8, 0, 2, 2, {"drop_last": False, "with_validity": True}),
    (8, 0, 2, 2, {}), (23, 5, 3, 3, {"drop_last": False}),
]
# (total, consumed, local minibatch, dp) of the random sampler
RANDOM_CASES = [(64, 0, 4, 2), (64, 8, 4, 1), (64, 0, 4, 1),
                (70, 0, 4, 2), (70, 150, 4, 2), (65, 24, 3, 4)]


def _streams(mod, cls, args, kwargs=None):
    total, consumed, mb, dp = args[:4]
    return [list(getattr(mod, cls)(total, consumed, mb, r, dp,
                                   **(kwargs or {})))
            for r in range(dp)]


@pytest.mark.parametrize("case", SEQ_CASES, ids=str)
def test_sequential_stream_matches_jax(case):
    *args, kwargs = case
    got = _streams(_data, "MegatronPretrainingSampler", args, kwargs)
    want = _streams(jdata, "MegatronPretrainingSampler", args, kwargs)
    assert got == want
    assert len(got[0]) > 0


@pytest.mark.parametrize("case", RANDOM_CASES, ids=str)
def test_random_stream_matches_jax(case):
    got = _streams(_data, "MegatronPretrainingRandomSampler", case)
    want = _streams(jdata, "MegatronPretrainingRandomSampler", case)
    assert got == want
    assert all(len(b) == case[2] for s in got for b in s)


def test_reference_properties_hold():
    """The reference test's checks, on the port: disjoint ranks, resume
    skips what was consumed, the padded tail covers every sample once,
    the ramp-up setter."""
    S, R = (_data.MegatronPretrainingSampler,
            _data.MegatronPretrainingRandomSampler)
    seen = [{i for b in S(64, 0, 4, r, 2) for i in b} for r in range(2)]
    assert not seen[0] & seen[1]
    assert next(iter(S(32, 8, 4, 0, 1))) == [8, 9, 10, 11]
    full = list(R(64, 0, 4, 0, 1))
    assert list(R(64, 8, 4, 0, 1)) == full[2:]
    real, pads = [], 0
    for r in range(4):
        for idx, valid in S(9, 0, 2, r, 4, drop_last=False,
                            with_validity=True):
            real += [i for i, ok in zip(idx, valid) if ok]
            pads += sum(not ok for ok in valid)
    assert sorted(real) == list(range(9)) and pads == 3
    s = S(64, 0, 2, 0, 2)
    it = iter(s)
    assert len(next(it)) == 2
    s.local_minibatch_size = 4
    assert s.local_minibatch_times_data_parallel_size == 8


@pytest.mark.parametrize("bad", [
    ("MegatronPretrainingSampler", (0, 0, 4, 0, 1)),
    ("MegatronPretrainingSampler", (8, 8, 4, 0, 1)),
    ("MegatronPretrainingSampler", (8, 0, 0, 0, 1)),
    ("MegatronPretrainingRandomSampler", (8, 0, 4, 2, 2)),
    ("MegatronPretrainingRandomSampler", (4, 0, 4, 0, 2)),
], ids=lambda b: f"{b[0]}{b[1]}")
def test_validation_matches_jax(bad):
    cls, args = bad
    with pytest.raises(ValueError) as err:
        getattr(_data, cls)(*args)
    with pytest.raises(ValueError) as jerr:
        getattr(jdata, cls)(*args)
    assert str(err.value) == str(jerr.value)
