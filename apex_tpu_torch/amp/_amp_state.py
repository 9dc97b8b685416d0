"""Process-level amp registry (port of ``apex_tpu/amp/_amp_state.py``).

Holds the active :class:`~apex_tpu_torch.amp.handle.AmpHandle`, so that
the module-level ``amp.state_dict()`` / ``amp.load_state_dict()`` work as
Apex's do.
"""

from __future__ import annotations

import torch

from apex_tpu_torch import _tree


class AmpState:
    def __init__(self):
        self.handle = None
        self.opt_properties = None
        self.verbosity = 1


_amp_state = AmpState()


def maybe_print(s: str, verbose: bool = False) -> None:
    if _amp_state.verbosity > (0 if verbose else 1) or (
            verbose and _amp_state.verbosity > 0):
        print(s)


def warn_or_err(msg: str) -> None:
    raise RuntimeError("\n".join(["", msg]))


def master_params(optimizer):
    """Iterate the (master, fp32 at O2) param leaves an optimizer owns
    (``_amp_state.py:27``): a ``FusedOptimizer``'s master tree when amp
    attached fp32 masters, else its params; the inner optimizer's params
    of a wrapper that holds one as ``.optimizer``; or a bare params
    tree."""
    tree = getattr(optimizer, "master_params", None)
    if tree is None and hasattr(optimizer, "optimizer"):
        tree = getattr(optimizer.optimizer, "params", None)
    if tree is None:
        tree = getattr(optimizer, "params", optimizer)
    if tree is optimizer and not isinstance(
            tree, (dict, list, tuple, torch.Tensor)):
        raise TypeError(
            f"master_params: {type(optimizer).__name__} carries no "
            "params/master_params tree")
    if isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tree.leaves(t)
    else:
        yield from _tree.leaves(tree)
