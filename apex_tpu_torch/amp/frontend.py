"""amp frontend: opt levels O0–O4 and ``initialize`` (port of
``apex_tpu/amp/frontend.py``).

An opt level sets the model's param dtype, boundary casting, fp32 master
weights and the loss scale, as in Apex:

=====  ==================  =====================  ==============  ===========
level  param dtype         compute casting        master weights  loss scale
=====  ==================  =====================  ==============  ===========
O0     fp32                none                   no              1.0
O1     fp32                bf16 at op boundaries  no              dynamic
O2     bf16 (norms fp32)   bf16 params            fp32 (in opt)   dynamic
O3     bf16                pure bf16              no              1.0
O4     bf16 (norms fp32)   fp8 matmuls (E4M3/     fp32 (in opt)   dynamic
                           E5M2, delayed scaling)
=====  ==================  =====================  ==============  ===========

O4 keeps O2's storage and masters and runs the registered
``ops.precision.matmul_amp`` sites in fp8 under
:class:`~apex_tpu_torch.amp.scaler.Fp8DelayedScaler`. bf16 is the
default "half" dtype (``half_dtype=torch.float16`` for fp16). Params are
nested dicts of tensors; ``initialize`` returns a cast copy, never an
alias of the caller's tensors, since the port's optimizers update params
in place. O1 casts where the port's library calls go through
:func:`~apex_tpu_torch.amp.amp_call`; no torch function is patched.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

from apex_tpu_torch import _tree
from apex_tpu_torch.amp._amp_state import _amp_state, maybe_print, warn_or_err

_NORM_KEY_HINTS = ("batchnorm", "bn", "layernorm", "rmsnorm", "norm",
                   "scale_bias")


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def map_tree(fn, tree):
    """``fn`` on every tensor of a tree of dicts, lists and tuples; any
    other leaf is kept as it is."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def cast_floats(tree, dtype: torch.dtype):
    """Every floating tensor of ``tree`` in ``dtype``; others untouched."""
    return map_tree(lambda x: x.to(dtype) if _is_float(x) else x, tree)


@dataclasses.dataclass
class Properties:
    """Resolved amp options (``frontend.py:45``, Apex's ``Properties``).
    ``patch_torch_functions`` is the reference's ``patch_jax_functions``
    under Apex's name."""

    enabled: bool = False
    opt_level: Optional[str] = None
    cast_model_type: Optional[torch.dtype] = None  # param dtype (None: keep)
    patch_torch_functions: bool = False            # O1 boundary casting
    keep_batchnorm_fp32: Optional[bool] = None
    master_weights: Optional[bool] = None
    loss_scale: Union[float, str] = 1.0
    fp8: bool = False                              # O4: fp8 matmul sites


def _opt_level_props(opt_level: str, half) -> Properties:
    if opt_level not in opt_levels:
        raise ValueError(
            f"Unexpected optimization level {opt_level}. Options are 'O0', "
            "'O1', 'O2', 'O3', 'O4'. Note that in `O0`, `O1`, etc., the "
            "prefix O is the letter O, not the number zero.")
    return opt_levels[opt_level](Properties(), half)


class O0:
    brief = "O0: pure FP32 training.\n"
    more = ("Params stay fp32, no boundary casting, no loss scaling: the "
            "baseline every other level is compared against.\n")

    def __call__(self, properties, half=torch.bfloat16):
        properties.enabled = True
        properties.opt_level = "O0"
        properties.cast_model_type = torch.float32
        properties.patch_torch_functions = False
        properties.keep_batchnorm_fp32 = None
        properties.master_weights = False
        properties.loss_scale = 1.0
        return properties


class O1:
    brief = "O1: insert automatic casts at op boundaries.\n"
    more = ("Weights stay fp32; contractions run in the half dtype at the "
            "calls that go through amp_call (amp/lists.py).\n")

    def __call__(self, properties, half=torch.bfloat16):
        properties.enabled = True
        properties.opt_level = "O1"
        properties.cast_model_type = None
        properties.patch_torch_functions = True
        properties.keep_batchnorm_fp32 = None
        properties.master_weights = None
        properties.loss_scale = "dynamic"
        return properties


class O2:
    brief = "O2: 'almost half': half model, fp32 master weights.\n"
    more = ("Params are cast to the half dtype (norm params stay fp32), "
            "the optimizer keeps fp32 master weights, dynamic loss "
            "scaling guards the update.\n")

    def __call__(self, properties, half=torch.bfloat16):
        properties.enabled = True
        properties.opt_level = "O2"
        properties.cast_model_type = half
        properties.patch_torch_functions = False
        properties.keep_batchnorm_fp32 = True
        properties.master_weights = True
        properties.loss_scale = "dynamic"
        return properties


class O3:
    brief = "O3: pure half-precision training.\n"
    more = ("Everything in the half dtype, no master weights, no loss "
            "scaling.\n")

    def __call__(self, properties, half=torch.bfloat16):
        properties.enabled = True
        properties.opt_level = "O3"
        properties.cast_model_type = half
        properties.patch_torch_functions = False
        properties.keep_batchnorm_fp32 = False
        properties.master_weights = False
        properties.loss_scale = 1.0
        return properties


class O4:
    brief = "O4: fp8 matmuls (E4M3 fwd / E5M2 grad) with delayed scaling.\n"
    more = ("O2's storage (half model, fp32 norms and master weights, "
            "dynamic loss scale) plus fp8 products at the registered "
            "matmul_amp sites: operands quantized to E4M3 and backward "
            "cotangents to E5M2 under per-tensor delayed scales from "
            "AmaxHistory rings (amp.scaler.Fp8DelayedScaler).\n")

    def __call__(self, properties, half=torch.bfloat16):
        properties.enabled = True
        properties.opt_level = "O4"
        properties.cast_model_type = half
        properties.patch_torch_functions = False
        properties.keep_batchnorm_fp32 = True
        properties.master_weights = True
        properties.loss_scale = "dynamic"
        properties.fp8 = True
        return properties


opt_levels = {"O0": O0(), "O1": O1(), "O2": O2(), "O3": O3(), "O4": O4()}


@dataclasses.dataclass(frozen=True)
class Policy:
    """The dtype policy of an opt level: param, compute and output
    dtypes (``frontend.py:177``)."""

    param_dtype: Any
    compute_dtype: Any
    output_dtype: Any
    keep_batchnorm_fp32: bool = True

    def cast_to_compute(self, tree):
        """Floating tensors entering a compute region, in the compute
        dtype (the O1 boundary cast)."""
        return cast_floats(tree, self.compute_dtype)

    def cast_to_param(self, tree):
        return cast_floats(tree, self.param_dtype)

    def cast_to_output(self, tree):
        return cast_floats(tree, self.output_dtype)

    def cast_model(self, params):
        """A copy of a params tree (nested dicts) in ``param_dtype``,
        with norm params kept fp32 when ``keep_batchnorm_fp32``: a leaf
        whose key path (``"layers/attn_norm"``), lower-cased, holds one
        of ``_NORM_KEY_HINTS``, as the reference matches flax module
        paths. Every floating leaf is a new tensor."""
        paths = _tree.paths(params)

        def cast_one(path, leaf):
            if not _is_float(leaf):
                return leaf
            if self.keep_batchnorm_fp32:
                keys = "/".join(path).lower()
                if any(h in keys for h in _NORM_KEY_HINTS):
                    return leaf.detach().to(torch.float32, copy=True)
            return leaf.detach().to(self.param_dtype, copy=True)

        return _tree.unflatten(paths, [cast_one(p, leaf) for p, leaf in zip(
            paths, _tree.leaves(params))])


def initialize(models=None, optimizers=None, enabled: bool = True,
               opt_level: str = "O1", cast_model_type=None,
               patch_torch_functions=None, keep_batchnorm_fp32=None,
               master_weights=None, loss_scale=None, min_loss_scale=None,
               max_loss_scale=2.0 ** 24, half_dtype=torch.bfloat16,
               verbosity: int = 1, **kwargs):
    """Apex's ``amp.initialize`` (``frontend.py:210``). ``models`` is a
    params tree, a list or tuple of them, or None. Returns
    ``(cast_params, optimizers, handle)`` with an optimizer,
    ``(cast_params, handle)`` without, and the
    :class:`~apex_tpu_torch.amp.handle.AmpHandle` alone with no params.
    With amp enabled the optimizer (a ``FusedOptimizer`` or a list of
    them) is attached: its ``step`` unscales, skips on overflow and, at
    O2 and O4, keeps fp32 masters built from the params it holds."""
    from apex_tpu_torch.amp.handle import AmpHandle

    del kwargs
    _amp_state.verbosity = verbosity
    props = _opt_level_props(opt_level, half_dtype)
    if not enabled:
        props.enabled = False
    if cast_model_type is not None:
        if props.opt_level == "O1" and cast_model_type not in (
                None, torch.float32):
            warn_or_err("O1 keeps model weights fp32; use O2/O3 to cast "
                        "weights.")
        props.cast_model_type = cast_model_type
    if patch_torch_functions is not None:
        props.patch_torch_functions = patch_torch_functions
    if keep_batchnorm_fp32 is not None:
        if isinstance(keep_batchnorm_fp32, str):
            keep_batchnorm_fp32 = keep_batchnorm_fp32 == "True"
        props.keep_batchnorm_fp32 = keep_batchnorm_fp32
    if master_weights is not None:
        props.master_weights = master_weights
    if loss_scale is not None:
        props.loss_scale = loss_scale

    maybe_print(f"Selected optimization level {opt_level}", True)

    handle = AmpHandle(props, min_loss_scale=min_loss_scale,
                       max_loss_scale=max_loss_scale, half_dtype=half_dtype)
    _amp_state.handle = handle
    _amp_state.opt_properties = props

    if models is None:
        return handle
    # disabled amp leaves the params and the optimizer untouched; a list
    # of models (Apex's list-of-models form) casts each
    cast_params = models
    if props.enabled and props.cast_model_type:
        cast = handle.policy.cast_model
        cast_params = (type(models)(cast(m) for m in models)
                       if isinstance(models, (list, tuple)) else cast(models))
    if optimizers is None:
        return cast_params, handle
    if props.enabled:
        handle.attach(optimizers)
    return cast_params, optimizers, handle


def state_dict(destination=None):
    """Module-level amp checkpoint: the active handle's state."""
    del destination
    if _amp_state.handle is None:
        return {}
    return _amp_state.handle.state_dict()


def load_state_dict(state_dict_):
    if _amp_state.handle is None:
        raise RuntimeError("amp.initialize must be called before "
                           "amp.load_state_dict")
    _amp_state.handle.load_state_dict(state_dict_)
