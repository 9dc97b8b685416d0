"""The contrib ``FusedSGD`` (port of
``apex_tpu/contrib/optimizers/fused_sgd.py``): the main one, which takes
the legacy ``materialize_master_grads`` already."""

from apex_tpu_torch.optimizers.fused_sgd import FusedSGD, fused_sgd

__all__ = ["FusedSGD", "fused_sgd"]
