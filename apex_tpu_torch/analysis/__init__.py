"""apex_tpu_torch.analysis: the calibration priors half of
``apex_tpu.analysis.memory_checks`` (port). The reference's static
analysis engines are not ported."""

from apex_tpu_torch.analysis.memory_checks import (  # noqa: F401
    HBM_PRIORS_PATH,
    PRIORS_SCHEMA_VERSION,
    load_hbm_priors,
    prior_for,
    prior_ratio_of,
)

__all__ = ["HBM_PRIORS_PATH", "PRIORS_SCHEMA_VERSION", "load_hbm_priors",
           "prior_for", "prior_ratio_of"]
