"""Op-category precision tables (port of ``apex_tpu/amp/lists.py``).

Plain data, copied: the classification Apex's O1 applies by patching
torch functions (``apex/amp/lists``), which the port, like the JAX
package, applies where an op is called instead
(:func:`apex_tpu_torch.amp.amp_call`, :class:`~.frontend.Policy`), and
the O4 table of which contractions run in fp8. The fused kernels
(RMSNorm, LayerNorm, softmax, cross-entropy) compute in fp32 whatever
their storage dtype, which is what the FP32 list asks for.
"""

# tensor-core friendly: run in compute (bf16/fp16) precision — ref functional_overrides.py FP16_FUNCS
COMPUTE_PRECISION_OPS = frozenset({
    "dot", "dot_general", "conv", "conv_general_dilated", "einsum", "matmul",
    "dense", "linear", "attention_qk", "attention_av",
})

# Range-sensitive: force fp32 math — ref functional_overrides.py FP32_FUNCS
FP32_OPS = frozenset({
    "softmax", "log_softmax", "layer_norm", "rms_norm", "batch_norm",
    "group_norm", "cross_entropy", "nll_loss", "mse_loss", "cosine_similarity",
    "exp", "log", "pow", "sum", "mean", "var", "std", "norm", "cumsum",
    "erf", "erfinv", "softplus", "sigmoid_focal_loss",
})

# Type-promotion ops: widest input dtype wins — ref tensor_overrides.py CASTS
PROMOTE_OPS = frozenset({
    "add", "sub", "mul", "div", "where", "concatenate", "stack", "maximum",
    "minimum",
})


def classify(op_name: str) -> str:
    """Return 'compute', 'fp32', or 'promote' for an op name."""
    if op_name in COMPUTE_PRECISION_OPS:
        return "compute"
    if op_name in FP32_OPS:
        return "fp32"
    return "promote"


# --------------------------------------------------------------- fp8 (O4)
# The O4 policy table ("FP8 Formats for Deep Learning", Micikevicius et
# al. 2022): contractions run in fp8 — E4M3 for the forward
# operands (activations + weights: more mantissa, 448 max), E5M2 for the
# backward cotangents (more range, 57344 max) — every tensor scaled by
# its delayed per-tensor factor before the cast
# (amp.scaler.Fp8DelayedScaler over AmaxHistory rings).
# Everything else keeps the O2 discipline: bf16 storage/elementwise,
# fp32 for range-sensitive math and optimizer state.

#: ops whose *forward* operands quantize to E4M3 under O4. These are the
#: only op shapes the fp8 tier converts — all are matmul-family work
#: routed through ops.precision.matmul_amp / matmul_fp8.
FP8_E4M3_FWD_OPS = frozenset({
    "dot", "dot_general", "matmul", "einsum", "dense", "linear",
})

#: ops whose *backward* cotangents quantize to E5M2 under O4 (the vjp
#: side of the table above — matmul_fp8's autograd Function implements it).
FP8_E5M2_GRAD_OPS = FP8_E4M3_FWD_OPS

#: tensor-core friendly but fp8-unsafe: stays in the bf16 compute dtype under O4
#: (attention logits/probs keep bf16 until an fp8 flash path exists;
#: convs are out of the llama workload's scope).
FP8_BF16_FALLBACK_OPS = frozenset({
    "attention_qk", "attention_av", "conv", "conv_general_dilated",
})

#: range-sensitive or state math: fp32 under O4, exactly the O1/O2
#: FP32_OPS discipline plus the scaling machinery itself (amax
#: reductions and scale arithmetic must never quantize).
FP8_FP32_OPS = FP32_OPS | frozenset({"amax", "scale", "optimizer_update"})


def classify_fp8(op_name: str) -> str:
    """O4 classification for an op name: ``'fp8'`` (E4M3 fwd / E5M2
    grad via the delayed-scaling epilogues), ``'fp32'``, ``'bf16'``
    (explicitly listed fp8-unsafe contractions), or ``'promote'`` for
    ops in none of the tables — widest-input promotion, the same
    default :func:`classify` gives O1."""
    if op_name in FP8_E4M3_FWD_OPS:
        return "fp8"
    if op_name in FP8_FP32_OPS:
        return "fp32"
    if op_name in FP8_BF16_FALLBACK_OPS:
        return "bf16"
    return "promote"
