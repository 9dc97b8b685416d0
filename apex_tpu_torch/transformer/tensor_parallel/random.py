"""Model-parallel RNG streams (port of
``apex_tpu/transformer/tensor_parallel/random.py``).

The reference tracks named JAX keys and folds the tensor-parallel rank
into a key where a stream must differ per rank (``tp_rank_key``). The
port tracks named ``torch.Generator``s, explicit like the reference's
keys (CUDA Apex swaps the global CUDA generator state instead). Its bits
cannot match JAX's; what holds is the reference's contract: the
model-parallel stream differs per tp rank and is the same across dp,
the default stream is the same everywhere, and :func:`checkpoint`
replays the generators a recomputed function draws from.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel.mappings import _axis_bound

_MODEL_PARALLEL_RNG_TRACKER_NAME = "model-parallel-rng"
# the seed offset of the model-parallel stream (Megatron's)
_TP_SEED_OFFSET = 2718
_SEED_BOUND = 2 ** 63 - 1
_GOLDEN = 0x9E3779B97F4A7C15


def _derived_generator(g: torch.Generator, salt: int = 0) -> torch.Generator:
    """A new generator on ``g``'s device, seeded from one draw of a copy
    of ``g`` mixed with ``salt``; ``g`` itself does not advance."""
    copy = torch.Generator(device=g.device)
    copy.set_state(g.get_state())
    base = int(torch.randint(0, _SEED_BOUND, (), generator=copy,
                             device=g.device))
    seed = (base + _GOLDEN * salt) % _SEED_BOUND
    return torch.Generator(device=g.device).manual_seed(seed)


class RNGStatesTracker:
    """Named generators with fork semantics (ref random.py:120); CPU
    generators, whose draws a caller moves to its device or seeds a
    device generator from (``_device.generator_on``)."""

    def __init__(self):
        self.states_: Dict[str, torch.Generator] = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def get_states(self):
        """Each stream's generator state (a byte tensor)."""
        return {k: g.get_state() for k, g in self.states_.items()}

    def set_states(self, states):
        if not isinstance(states, dict):
            raise TypeError("states must be a dict of name -> generator "
                            "state")
        for name, state in states.items():
            if name not in self.states_:
                self.states_[name] = torch.Generator()
            self.states_[name].set_state(state)

    def add(self, name: str, seed: int):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already present")
        self.seeds_.add(seed)
        if name in self.states_:
            raise ValueError(f"rng state {name} already present")
        self.states_[name] = torch.Generator().manual_seed(seed)

    @contextlib.contextmanager
    def fork(self, name: str = _MODEL_PARALLEL_RNG_TRACKER_NAME):
        """Yield a fresh generator split off the named stream, and
        advance the stream (the reference yields a subkey)."""
        if name not in self.states_:
            raise KeyError(f"rng state {name} is not added")
        g = self.states_[name]
        sub = _derived_generator(g)
        torch.randint(0, _SEED_BOUND, (), generator=g, device=g.device)
        yield sub


# Parity alias (the reference class name).
CudaRNGStatesTracker = RNGStatesTracker

_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_tracker() -> RNGStatesTracker:
    return _RNG_STATE_TRACKER


# Parity alias (ref random.py:195).
get_cuda_rng_tracker = get_rng_tracker


def model_parallel_rng_seed(seed: int) -> None:
    """Seed the default and model-parallel streams (ref random.py:200
    ``model_parallel_cuda_manual_seed``): the default stream is ``seed``
    on every rank; the model-parallel stream ``seed + 2718 + tp_rank``
    (Megatron's), so it differs per tp rank and is equal across dp. The
    reference folds the rank in at use time; a generator's seed is where
    the port can put it."""
    tracker = get_rng_tracker()
    tracker.reset()
    tracker.add("default", seed)
    tracker.add(_MODEL_PARALLEL_RNG_TRACKER_NAME,
                seed + _TP_SEED_OFFSET
                + parallel_state.get_tensor_model_parallel_rank())


model_parallel_cuda_manual_seed = model_parallel_rng_seed


def tp_rank_key(generator: torch.Generator,
                axis_name: Optional[str] = None) -> torch.Generator:
    """A per-tp-rank stream derived from ``generator`` (the reference's
    ``fold_in`` of the rank): a new generator seeded from a copy of
    ``generator`` and this rank's index; ``generator`` itself as it is
    when the axis is not bound. The same on every dp rank."""
    axis = axis_name if axis_name is not None else parallel_state.TENSOR_AXIS
    if not _axis_bound(axis):
        return generator
    return _derived_generator(generator, _backend.get_rank(axis) + 1)


def _generators(args):
    return [a for a in args if isinstance(a, torch.Generator)]


def checkpoint(function, *args, **kwargs):
    """Activation-checkpointed call (ref random.py:306): the forward runs
    again in the backward (``torch.utils.checkpoint``, non-reentrant),
    and every ``torch.Generator`` among ``args`` is set back to its state
    at the first call before the recompute, so a recomputed draw equals
    the first (the reference's explicit keys replay by construction).
    The global generators are restored as ``torch.utils.checkpoint``
    does."""
    from torch.utils.checkpoint import checkpoint as _checkpoint

    gens = _generators(args) + _generators(kwargs.values())
    states = [g.get_state() for g in gens]
    calls = [0]

    def run(*a, **kw):
        if calls[0]:
            for g, state in zip(gens, states):
                g.set_state(state)
        calls[0] += 1
        return function(*a, **kw)

    return _checkpoint(run, *args, use_reentrant=False, **kwargs)


def init_checkpointed_activations_memory_buffer(*args, **kwargs):
    """No-op, as in the reference (ref random.py:45): the caching
    allocator owns activation memory."""
    del args, kwargs


def reset_checkpointed_activations_memory_buffer():
    """No-op (ref random.py:80)."""
