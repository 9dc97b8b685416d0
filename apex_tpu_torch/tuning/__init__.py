"""apex_tpu_torch.tuning: the launch-plan tuner of the port's hand-written
kernels (counterpart of ``apex_tpu.tuning``).

Each kernel's candidate launch plans are declared in
:mod:`~apex_tpu_torch.tuning.search_space` (threads, blocks, rows a block:
what the CUDA entry points take), raced against the plain PyTorch version by
:mod:`~apex_tpu_torch.tuning.measure` (CUDA events on the card, a
deterministic H100 roofline off it), and the winners kept in a
schema-versioned JSON cache (:mod:`~apex_tpu_torch.tuning.cache`) keyed by
``(device_kind, kernel, shape-bucket)``. The wrappers ask
:mod:`~apex_tpu_torch.tuning.geometry` for their plans, which reads the
cache for launch plans only: an entry's race verdict is a record, and a
CUDA tensor always launches its kernel.

Offline tune-everything: ``python -m apex_tpu_torch.tuning``.
"""

from apex_tpu_torch.tuning.cache import (  # noqa: F401
    SCHEMA_VERSION,
    cache_path,
    entries_for,
)
from apex_tpu_torch.tuning.cache import load as load_cache  # noqa: F401
from apex_tpu_torch.tuning.cache import save as save_cache  # noqa: F401
from apex_tpu_torch.tuning.geometry import (  # noqa: F401
    flat_adam_geometry,
    fp8_cast_geometry,
    norm_bwd_plan,
    norm_plan,
    override,
    softmax_threads,
)
from apex_tpu_torch.tuning.search_space import (  # noqa: F401
    KERNELS,
    candidates,
    shape_bucket,
)
from apex_tpu_torch.tuning.tuner import (  # noqa: F401
    DEFAULT_SHAPES,
    tune_all,
    tune_kernel,
)
