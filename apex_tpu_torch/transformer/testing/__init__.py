"""The standalone test harness (port of ``apex_tpu/transformer/testing``,
after Apex's ``apex/transformer/testing``): the Megatron argument
parser's core flags, the ``get_args``/``get_num_microbatches``/
``get_timers`` singletons, the toy stage model and forward step, the
process-group fixtures, a distributed unittest base, and standalone
GPT/BERT over the port's models."""

from apex_tpu_torch.transformer.testing import global_vars
from apex_tpu_torch.transformer.testing.commons import (
    build_mesh,
    fwd_step_func,
    initialize_distributed,
    model_provider_func,
    print_separator,
    set_random_seed,
)

__all__ = ["global_vars", "build_mesh", "fwd_step_func",
           "initialize_distributed", "model_provider_func",
           "print_separator", "set_random_seed"]
