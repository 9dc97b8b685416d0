"""Fine-tune a HuggingFace-layout Llama, then sample from it (port of
``examples/hf_finetune.py``): the interop loop in one script, an HF
``LlamaForCausalLM`` state dict -> ``models.convert.llama_from_hf`` ->
fp32 data-parallel fine-tuning (``sync_autodiff_gradients``, the tree
``fused_adam``, the chunked CE) -> ``models.generate`` greedy decoding::

    python -m apex_tpu_torch.parallel.multiproc --nprocs 2 --backend gloo \\
        [--cpu] apex_tpu_torch/examples/hf_finetune.py [--steps 20] \\
        [--hf-dir /path/to/llama]

One process a rank, every rank holding the whole params. Without
``--hf-dir`` the weights are a random HF-layout state dict built here
(:func:`hf_llama_state_dict`: HF's keys, shapes and ``_init_weights``
law, drawn from a seeded ``torch.Generator`` on the rank's device) for
the reference's tiny config, and ``transformers`` is never imported;
``--hf-dir`` loads a local checkpoint through
``transformers.AutoModelForCausalLM`` (that branch alone imports it).
A fixed synthetic batch (tokens from a seeded generator, targets the
tokens shifted by one) is overfit, so the loss must fall: the script
exits 1 when it does not. The step runs the flash forward and backward
and the RMSNorm forward and backward kernels (fp32 on the card).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import torch

from apex_tpu_torch import _device, _tree
from apex_tpu_torch.distributed import backend as _backend
from apex_tpu_torch.examples._common import apply_updates
from apex_tpu_torch.models import llama
from apex_tpu_torch.parallel import sync_autodiff_gradients


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--hf-dir", default="",
                   help="local HF checkpoint dir (empty = tiny random)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=8, help="global batch")
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--devices", type=int, default=0,
                   help="data-parallel ranks (0: the launcher's world)")
    p.add_argument("--vocab-chunks", type=int, default=4)
    p.add_argument("--sample-tokens", type=int, default=8)
    return p.parse_args(argv)


@dataclasses.dataclass(frozen=True)
class HFLlamaConfig:
    """The fields of ``transformers.LlamaConfig`` that the conversion and
    the state dict read, under HF's names, with HF's defaults."""

    vocab_size: int = 256
    hidden_size: int = 64
    intermediate_size: int = 128
    num_hidden_layers: int = 2
    num_attention_heads: int = 4
    num_key_value_heads: int = 2
    max_position_embeddings: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    initializer_range: float = 0.02

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def tiny_hf_config() -> HFLlamaConfig:
    """The reference example's random model (``:66-69``)."""
    return HFLlamaConfig()


def hf_llama_state_dict(cfg: HFLlamaConfig, generator: torch.Generator,
                        device: _device.DeviceLike = None
                        ) -> Dict[str, torch.Tensor]:
    """A random ``LlamaForCausalLM(cfg).state_dict()`` without
    ``transformers``: HF's keys and shapes (no rotary buffer: HF keeps it
    out of the state dict) and HF's ``_init_weights``, N(0,
    ``initializer_range``) for the embedding and every linear, ones for
    the RMSNorm weights; fp32, drawn on the generator's device, placed on
    ``device`` (default: the GPU, raising when there is none)."""
    dev = _device.resolve(device)
    h, i, d = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads

    def normal(*shape):
        t = torch.empty(shape, dtype=torch.float32, device=generator.device)
        return t.normal_(0.0, cfg.initializer_range,
                         generator=generator).to(dev)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    sd = {"model.embed_tokens.weight": normal(cfg.vocab_size, h)}
    for layer in range(cfg.num_hidden_layers):
        p = f"model.layers.{layer}."
        sd.update({
            p + "self_attn.q_proj.weight": normal(nq * d, h),
            p + "self_attn.k_proj.weight": normal(nkv * d, h),
            p + "self_attn.v_proj.weight": normal(nkv * d, h),
            p + "self_attn.o_proj.weight": normal(h, nq * d),
            p + "mlp.gate_proj.weight": normal(i, h),
            p + "mlp.up_proj.weight": normal(i, h),
            p + "mlp.down_proj.weight": normal(h, i),
            p + "input_layernorm.weight": ones(h),
            p + "post_attention_layernorm.weight": ones(h),
        })
    sd["model.norm.weight"] = ones(h)
    if not cfg.tie_word_embeddings:
        sd["lm_head.weight"] = normal(cfg.vocab_size, h)
    return sd


def import_model(args, device):
    """``(params, cfg)``: fp32 on ``device``, from ``--hf-dir`` or, by
    default, the tiny random HF-layout dict (seed 0)."""
    from apex_tpu_torch.models import convert

    if args.hf_dir:
        import transformers

        hf = transformers.AutoModelForCausalLM.from_pretrained(args.hf_dir)
        return convert.llama_from_hf(hf, dtype=torch.float32, device=device)
    hf_cfg = tiny_hf_config()
    sd = hf_llama_state_dict(
        hf_cfg, torch.Generator(device=device).manual_seed(0), device)
    return convert.llama_from_hf(sd, convert.llama_config_from_hf(hf_cfg),
                                 dtype=torch.float32, device=device)


def make_batch(cfg: llama.LlamaConfig, batch: int, seq: int, device,
               seed: int = 1):
    """The fixed global batch: tokens uniform in the vocabulary from a
    seeded generator (the same on every rank), targets the tokens rolled
    by one."""
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
    return tokens.to(device), torch.roll(tokens, -1, dims=-1).to(device)


def rank_rows(t: torch.Tensor, axis_name: str = "dp") -> torch.Tensor:
    """This rank's rows of a global ``[B, ...]`` batch."""
    r, n = _backend.get_rank(axis_name), _backend.get_world_size(axis_name)
    rows = t.shape[0] // n
    return t[r * rows:(r + 1) * rows]


def loss_of(params, tokens, targets, cfg: llama.LlamaConfig,
            vocab_chunks: Optional[int]):
    """The reference's loss (``:80-84``): ``llama.loss_fn`` with no model
    parallel axis."""
    return llama.loss_fn(params, (tokens, targets), cfg,
                         vocab_chunks=vocab_chunks, tp_axis=None,
                         cp_axis=None, ep_axis=None)


def grads(params, tokens, targets, cfg: llama.LlamaConfig,
          vocab_chunks: Optional[int] = 4, axis_name: str = "dp"):
    """``(loss, grads)`` of this rank's rows, the gradients synced over
    ``axis_name`` (``sync_autodiff_gradients``: equal shards, so the
    global batch's mean gradient) and the loss averaged."""
    live = _tree.map_leaves(lambda p: p.detach().requires_grad_(), params)
    loss = loss_of(live, tokens, targets, cfg, vocab_chunks)
    g = torch.autograd.grad(loss, _tree.leaves(live))
    del live
    g = sync_autodiff_gradients(_tree.unflatten(_tree.paths(params), list(g)),
                                axis_name)
    loss = _backend.all_reduce(loss.detach(), _backend.ReduceOp.AVG,
                               axis_name)
    return loss, g


def train_step(params, opt_state, tokens, targets, cfg: llama.LlamaConfig,
               tx, vocab_chunks: Optional[int] = 4, axis_name: str = "dp"):
    """One data-parallel step (``:80-95``): :func:`grads`, then ``tx``
    applied in place. ``(loss, opt_state)``."""
    loss, g = grads(params, tokens, targets, cfg, vocab_chunks, axis_name)
    return loss, apply_updates(tx, params, opt_state, g)


def finetune(args, rank: int, device):
    """The example's run on this rank (``:61-124``): import, ``--steps``
    data-parallel steps, then greedy samples; rank 0 prints. Returns
    ``(params, first loss, last loss)``."""
    from apex_tpu_torch.models import generate
    from apex_tpu_torch.optimizers import fused_adam

    def log(msg):
        if rank == 0:
            print(msg, flush=True)

    params, cfg = import_model(args, device)
    n = sum(t.numel() for t in _tree.leaves(params))
    log(f"imported llama: {n / 1e6:.2f}M params, vocab {cfg.vocab_size}")
    tx = fused_adam(lr=args.lr)
    opt_state = tx.init(params)
    tokens, targets = make_batch(cfg, args.batch, args.seq, device)
    mine = rank_rows(tokens), rank_rows(targets)
    first = loss = None
    t0 = time.perf_counter()
    for it in range(args.steps):
        loss, opt_state = train_step(params, opt_state, *mine, cfg, tx,
                                     args.vocab_chunks)
        loss = float(loss)
        if first is None:
            first, t0 = loss, time.perf_counter()
        if it % 5 == 0 or it == args.steps - 1:
            log(f"step {it:3d}  loss {loss:.4f}")
    dt = (time.perf_counter() - t0) / max(args.steps - 1, 1)
    log(f"{dt * 1e3:.0f} ms/step")
    prompt = tokens[:1, :4]
    out = generate.greedy_generate(params, prompt, cfg, args.sample_tokens,
                                   device=device)
    log(f"prompt {prompt[0].tolist()} -> {out[0, 4:].tolist()}")
    verdict = "decreased" if loss < first else "NOT decreased"
    log(f"hf-finetune: loss {first:.4f} -> {loss:.4f} ({verdict})")
    return params, first, loss


def main(argv: Optional[list] = None) -> int:
    """1 when the loss did not fall (``:121-124``)."""
    from apex_tpu_torch.parallel.multiproc import initialize_distributed

    args = parse_args(argv)
    rank, world, device = initialize_distributed()
    if args.devices and world != args.devices:
        raise SystemExit(f"{world} ranks for --devices {args.devices}")
    _, first, loss = finetune(args, rank, device)
    return 0 if loss < first else 1


if __name__ == "__main__":
    raise SystemExit(main())
