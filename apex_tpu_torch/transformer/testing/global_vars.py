"""Global singletons of the test harness (port of
``apex_tpu/transformer/testing/global_vars.py``, after Apex's
``apex/transformer/testing/global_vars.py``).

``set_global_variables`` parses the arguments once and builds the
number-of-microbatches calculator; ``get_args``, ``get_num_microbatches``
and ``get_timers`` read the singletons with the reference's initialized
and not-initialized assertions. The timers are the port's pipeline
timers (``pipeline_parallel/_timers.py``) that synchronise the card at
start and stop, as Apex's ``cuda.synchronize`` does (its
``global_vars.py:191``), so a bracket excludes work queued before it.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex_tpu_torch.transformer.microbatches import (
    build_num_microbatches_calculator,
)
from apex_tpu_torch.transformer.pipeline_parallel import _timers as _shared
from apex_tpu_torch.transformer.testing.arguments import parse_args

_GLOBAL_ARGS = None
_GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
_GLOBAL_TIMERS = None


def _ensure_initialized(var, name):
    assert var is not None, f"{name} is not initialized."
    return var


def _ensure_not_initialized(var, name):
    assert var is None, f"{name} is already initialized."


def get_args():
    """The parsed arguments (``global_vars.py:34``)."""
    return _ensure_initialized(_GLOBAL_ARGS, "args")


def _calculator():
    return _ensure_initialized(_GLOBAL_NUM_MICROBATCHES_CALCULATOR,
                               "num microbatches calculator")


def get_num_microbatches() -> int:
    return _calculator().get()


def get_current_global_batch_size() -> int:
    return _calculator().get_current_global_batch_size()


def update_num_microbatches(consumed_samples: int, *,
                            consistency_check: bool = True) -> None:
    _calculator().update(consumed_samples, consistency_check)


def get_timers():
    return _ensure_initialized(_GLOBAL_TIMERS, "timers")


def set_global_variables(extra_args_provider=None, args_defaults=None,
                         ignore_unknown_args: bool = True,
                         data_parallel_size: Optional[int] = None,
                         args=None):
    """Parse the arguments and set every singleton
    (``global_vars.py:87``)."""
    global _GLOBAL_ARGS, _GLOBAL_NUM_MICROBATCHES_CALCULATOR, _GLOBAL_TIMERS
    _ensure_not_initialized(_GLOBAL_ARGS, "args")
    parsed = parse_args(extra_args_provider, args_defaults,
                        ignore_unknown_args, args=args)
    _GLOBAL_ARGS = parsed
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        rank=0, rampup_batch_size=parsed.rampup_batch_size,
        global_batch_size=parsed.global_batch_size,
        micro_batch_size=parsed.micro_batch_size,
        data_parallel_size=(data_parallel_size
                            if data_parallel_size is not None else 1))
    _GLOBAL_TIMERS = Timers()
    return parsed


def destroy_global_vars():
    """Reset the singletons for the next test."""
    global _GLOBAL_ARGS, _GLOBAL_NUM_MICROBATCHES_CALCULATOR, _GLOBAL_TIMERS
    _GLOBAL_ARGS = None
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
    _GLOBAL_TIMERS = None


def _synchronize():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Timer(_shared._Timer):
    """The pipeline timer with the card synchronised at start and stop."""

    def start(self):
        _synchronize()
        super().start()

    def stop(self, block_on=None):
        _synchronize()
        super().stop(block_on)


class Timers(_shared.Timers):
    """Named registry over the synchronising timer
    (``global_vars.py:236``)."""

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = _Timer(name, self._registry)
        return self.timers[name]
