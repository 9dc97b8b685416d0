"""The pre-amp fp16 workflow (counterpart of ``apex_tpu.fp16_utils``):
``FP16_Optimizer`` over fp32 masters with its host-side loss scalers,
and the half-precision helpers over param trees."""

from apex_tpu_torch.fp16_utils.fp16_optimizer import FP16_Optimizer
from apex_tpu_torch.fp16_utils.fp16util import (
    BN_convert_float,
    FP16Model,
    clip_grad_norm,
    convert_module,
    convert_network,
    master_params_to_model_params,
    model_grads_to_master_grads,
    network_to_half,
    prep_param_lists,
    to_python_float,
    tofp16,
)
from apex_tpu_torch.fp16_utils.loss_scaler import (
    DynamicLossScaler,
    LossScaler,
)

__all__ = [
    "BN_convert_float", "network_to_half", "prep_param_lists",
    "model_grads_to_master_grads", "master_params_to_model_params",
    "tofp16", "to_python_float", "clip_grad_norm", "convert_module",
    "convert_network", "FP16Model", "FP16_Optimizer", "LossScaler",
    "DynamicLossScaler",
]
