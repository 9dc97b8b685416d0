"""apex_tpu_torch — the PyTorch/CUDA port of ``apex_tpu``.

The package mirrors ``apex_tpu``'s layout, so each ported module sits at
the same path as its JAX counterpart. It imports ``torch`` and never
``jax`` or ``apex_tpu``. Every Pallas kernel of the JAX package becomes a
kernel written by hand for Hopper (CUDA C++ under ``ops/csrc``), with a
plain PyTorch version beside it: a CUDA tensor launches the kernel, a CPU
tensor takes the plain version.

Ported so far: the serving path (``serving.ServingEngine`` over the
llama family, bf16 or fp8 weights, preemption and resume); the training
steps of Llama (dense and MoE), GPT-2, BERT, ResNet, DCGAN and the MLPs
(``mlp``, ``fused_dense``), with amp O0–O4, checkpoints and the
resilient loop; data parallelism (DDP, ZeRO-1, SyncBatchNorm) and model
parallelism (the tp/pp/dp/cp/ep groups, the tensor-parallel layers, the
pipeline schedules, ring attention, expert dispatch) with their
examples, the 3-D one at O4 with checkpoints; the transformer samplers
and test harness; every fused optimizer (Adam, SGD, LAMB, Adagrad,
NovoGrad, mixed-precision LAMB) with LARC and the multi-tensor ops; the
pre-amp fp16 workflow (``fp16_utils.FP16_Optimizer``); the RNNs
(``rnn``, the mLSTM among them) and weight norm
(``reparameterization``); the training telemetry (``observability``:
the JSONL registry, spans and step phases, the flight recorder, step
reports, numerics, the memory monitor and OOM forensics, goodput, the
report CLI) and ``runtime.timing``; device attribution on
``torch.profiler`` traces (``pyprof``, ``observability.profiling.
xplane``), the fleet tier (the grad-sync probe, the straggler and desync
detectors, the fleet merge) and the compile listener with the captured
graphs' memory; the dispatch switch (``ops.kernel_config``), the tuner
(``tuning``) and the NaN provenance probe; the static lint
(``analysis``: the AST and host-concurrency engines, their CLI and the
port's gate). Every one of the JAX package's 13 Pallas kernels has a
Hopper kernel. See ROADMAP.md for what follows.
"""

from apex_tpu_torch import pyprof

__all__ = ["pyprof"]
__version__ = "0.1.0"
