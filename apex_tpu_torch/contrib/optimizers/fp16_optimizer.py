"""The contrib ``FP16_Optimizer`` (port of
``apex_tpu/contrib/optimizers/fp16_optimizer.py``): the fp16_utils class
with the contrib default, a dynamic loss scale."""

from __future__ import annotations

from apex_tpu_torch.fp16_utils.fp16_optimizer import FP16_Optimizer as _Base


class FP16_Optimizer(_Base):
    def __init__(self, init_optimizer, static_loss_scale=1.0,
                 dynamic_loss_scale=True, dynamic_loss_args=None,
                 verbose=False):
        super().__init__(init_optimizer, static_loss_scale=static_loss_scale,
                         dynamic_loss_scale=dynamic_loss_scale,
                         dynamic_loss_args=dynamic_loss_args,
                         verbose=verbose)
