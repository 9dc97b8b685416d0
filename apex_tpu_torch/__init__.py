"""apex_tpu_torch — the PyTorch/CUDA port of ``apex_tpu``.

The package mirrors ``apex_tpu``'s layout, so each ported module sits at
the same path as its JAX counterpart. It imports ``torch`` and never
``jax`` or ``apex_tpu``. Every Pallas kernel of the JAX package becomes a
kernel written by hand for Hopper (CUDA C++ under ``ops/csrc``), with a
plain PyTorch version beside it: a CUDA tensor launches the kernel, a CPU
tensor takes the plain version.

Ported so far: the serving path (``serving.ServingEngine`` over the
llama family), with the flash-attention forward and RMSNorm forward
kernels, and the single-device training step (``models.llama.train_step``
with ``optimizers.fused_adam``), with the flash-attention backward,
RMSNorm backward and flat Adam kernels. See ROADMAP.md for what
follows.
"""

__version__ = "0.1.0"
