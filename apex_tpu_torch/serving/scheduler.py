"""Continuous-batching scheduler: prefill/decode split over paged KV
(port of ``apex_tpu/serving/scheduler.py``).

- **prefill**: one full-sequence pass per admitted request through the
  flash-attention kernel, the prompt padded with token 0 to a page-size
  multiple. Causal attention keeps the pad suffix out of every real
  position; the first token is read at ``true_len - 1``.
- **decode**: one step over the packed ``[max_batch]`` slot tensors. The
  batch composition (who occupies which slot, who is active) is data
  (block tables, positions, an active mask), never shape. Inactive slots
  write their k/v to the trash page and pass their token through.

Every decode op is per-slot independent (row-wise gemms, per-row
attention over the row's own block table, per-row argmax).

Admission is FCFS: a request enters when a slot is free AND its whole
page worst case (padded prompt + max_new_tokens) can be allocated, so an
admitted request never stalls on pages mid-decode. Eviction (EOS or
length cap) frees pages and refills from the queue.

Every layer product goes through ``mm(x, w, scale)`` (:func:`_make_mm`):
a plain matmul in ``weight_mode="native"`` (or ``"bf16"``), and in
``"fp8"`` :func:`~apex_tpu_torch.ops.precision.matmul_fp8` with the
activation at scale 1 and the weight at its static per-layer E4M3 scale
(:func:`fp8_weight_scales`), two launches of the fp8 cast kernel a
product. The lm head stays a plain matmul in both modes.

PyTorch runs eagerly, so the reference's "one jit, zero retraces"
contract has no counterpart yet; a CUDA graph of the decode step will
take its place.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch import _device
from apex_tpu_torch.models import generate as _gen
from apex_tpu_torch.models import llama as _llama
from apex_tpu_torch.ops.precision import matmul_fp8
from apex_tpu_torch.serving.kv_cache import PagedKVCache

__all__ = [
    "ContinuousBatchScheduler",
    "Request",
    "build_decode_step",
    "build_prefill",
    "fp8_weight_scales",
    "pages_per_request",
]

_E4M3_MAX = 448.0
WEIGHT_MODES = ("native", "bf16", "fp8")


@dataclasses.dataclass
class Request:
    """One serving request and its lifecycle timestamps (monotonic
    seconds; ``arrival_s`` is the loadgen trace offset)."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_s: float = 0.0
    submit_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    state: str = "queued"                 # queued -> active -> done
    tokens: List[int] = dataclasses.field(default_factory=list)


def pages_per_request(prompt_len: int, max_new_tokens: int,
                      page_size: int) -> int:
    """Worst-case pages one request holds: the padded prompt bucket
    plus every decode write."""
    bucket = max(1, math.ceil(prompt_len / page_size)) * page_size
    return math.ceil((bucket + max_new_tokens) / page_size)


@torch.no_grad()
def fp8_weight_scales(params) -> Dict[str, torch.Tensor]:
    """Static per-layer E4M3 weight scales, ``448 / max(amax, 1e-12)``
    stacked ``[L]`` (fp32), for every dense layer kernel
    (``scheduler.py:82``). Serving weights are frozen, so one amax pass
    when the scheduler is built replaces the training path's
    delayed-scaling history. |w| and its max are exact in the weights'
    dtype, so no fp32 copy of a weight is made."""
    out = {}
    for name in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
        w = params["layers"][name]
        amax = torch.clamp(torch.amax(torch.abs(w), dim=tuple(
            range(1, w.dim()))).float(), min=1e-12)
        # a division of tensors: ``number / tensor`` would round twice
        # (a reciprocal, then a product)
        out[name] = torch.full_like(amax, _E4M3_MAX) / amax
    return out


def _make_mm(weight_mode: str):
    """The native-or-fp8 product every layer gemm goes through
    (``scheduler.py:95``): ``native`` is a plain matmul in the
    activation dtype, ``fp8`` :func:`matmul_fp8` with the static weight
    scale."""
    if weight_mode == "fp8":
        def mm(x, w, scale):
            return matmul_fp8(x, w, 1.0, scale).to(x.dtype)
        return mm
    return _llama.matmul


def _normalize_weight_mode(weight_mode: str) -> str:
    if weight_mode not in WEIGHT_MODES:
        raise ValueError(f"weight_mode must be one of {WEIGHT_MODES}, "
                         f"got {weight_mode!r}")
    return "fp8" if weight_mode == "fp8" else "native"


def _layer_scales(scales: Dict[str, torch.Tensor], idx: int) -> Dict:
    return {name: s[idx] for name, s in scales.items()}


def build_decode_step(cfg, page_size: int, weight_mode: str = "native"):
    """The decode step: ``(params, scales, k_pages, v_pages, tokens,
    tables, pos, active) -> next_tokens``. ``scales`` is
    :func:`fp8_weight_scales`' dict in ``fp8`` mode, else empty. Batch
    inputs are packed ``[max_batch]`` slot tensors; ``tables`` is
    ``[max_batch, max_pages]`` of page indices (trash-padded). Writes
    each slot's new k/v into the pages in place. Greedy (argmax) by
    design. Dense configs only, as in the reference."""
    if cfg.moe:
        raise NotImplementedError(
            "serving decode is dense-only; MoE routing needs a paged "
            "expert-gather step (llama dense configs only for now)")
    mm = _make_mm(_normalize_weight_mode(weight_mode))

    def _layer(x, lp, sc, kp, vp, tables, pos, page_idx, off):
        def attend(q, k, v):
            # several inactive slots may write the trash page at once: it
            # is never read, so which write lands does not matter
            kp[page_idx, off] = k[:, 0]
            vp[page_idx, off] = v[:, 0]
            b = q.shape[0]
            kg = kp[tables].reshape(b, -1, *kp.shape[2:])
            vg = vp[tables].reshape(b, -1, *vp.shape[2:])
            return _gen._decode_attention(q, kg, vg,
                                          pos[:, None, None]).to(x.dtype)

        return _llama.decoder_layer(x, lp, cfg, pos[:, None], attend, mm,
                                    sc)[0]

    @torch.no_grad()
    def _decode_step(params, scales, k_pages, v_pages, tokens, tables, pos,
                     active):
        x = _llama.embed(params, tokens[:, None], cfg)
        trash = k_pages.shape[1] - 1
        page_idx = torch.gather(tables, 1, (pos // page_size)[:, None])[:, 0]
        page_idx = torch.where(active, page_idx,
                               torch.full_like(page_idx, trash))
        off = pos % page_size
        for i in range(cfg.num_layers):
            x = _layer(x, _llama.layer(params, i), _layer_scales(scales, i),
                       k_pages[i], v_pages[i], tables, pos, page_idx, off)
        logits = _llama.lm_head(params, x, cfg)[:, 0]
        nxt = torch.argmax(logits, dim=-1).to(tokens.dtype)
        return torch.where(active, nxt, tokens)

    return _decode_step


def build_prefill(cfg, bucket_len: int, weight_mode: str = "native"):
    """Full-sequence prefill for ONE prompt padded to ``bucket_len``:
    ``(params, scales, prompt [1, S], true_len) -> (first_token [1],
    ks [L, S, nkv, d], vs [L, S, nkv, d])``. The pad k/v land in the
    request's pages, but decode overwrites index ``p + t`` before it
    ever unmasks it. Dense configs only, as in the reference."""
    if cfg.moe:
        raise NotImplementedError("serving prefill is dense-only")
    mm = _make_mm(_normalize_weight_mode(weight_mode))

    @torch.no_grad()
    def prefill(params, scales, prompt, true_len: int):
        b, s = prompt.shape
        if s != bucket_len:
            raise ValueError(f"prefill built for {bucket_len} tokens, "
                             f"got {s}")
        positions = torch.arange(s, device=prompt.device).expand(b, s)
        x = _llama.embed(params, prompt, cfg)
        ks, vs = [], []
        for i in range(cfg.num_layers):
            x, k, v = _gen._prefill_layer(x, _llama.layer(params, i), cfg,
                                          positions, mm,
                                          _layer_scales(scales, i))
            ks.append(k[0])
            vs.append(v[0])
        x_last = x[:, true_len - 1:true_len]
        logits = _llama.lm_head(params, x_last, cfg)[:, 0]
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        return first, torch.stack(ks), torch.stack(vs)

    prefill.__name__ = f"_serving_prefill_s{bucket_len}"
    prefill.__qualname__ = prefill.__name__
    return prefill


class ContinuousBatchScheduler:
    """Queue + slots + paged cache behind the prefill and decode steps.

    Host mirrors (numpy) of the slot arrays are the source of truth;
    each decode step copies them to the device (same shapes every step).
    """

    def __init__(self, params, cfg, *, num_pages: int,
                 page_size: int = 8, max_batch: int = 4,
                 max_prompt_len: int = 64, max_new_cap: int = 32,
                 weight_mode: str = "native",
                 eos_id: Optional[int] = None,
                 device: _device.DeviceLike = None):
        if cfg.moe:
            raise NotImplementedError("serving is dense-only")
        if max_batch < 1 or page_size < 1:
            raise ValueError("max_batch and page_size must be >= 1")
        self.device = _device.resolve(device)
        held = _device.of(params)
        if held is not None and held.type != self.device.type:
            raise ValueError(f"params live on {held}, the engine runs on "
                             f"{self.device}")
        self.params = params
        self.cfg = cfg
        self.page_size = int(page_size)
        self.max_batch = int(max_batch)
        self.max_prompt_len = int(max_prompt_len)
        self.max_new_cap = int(max_new_cap)
        self.eos_id = eos_id
        self.weight_mode = _normalize_weight_mode(weight_mode)
        self.max_pages_per_req = pages_per_request(
            max_prompt_len, max_new_cap, page_size)
        if num_pages < self.max_pages_per_req:
            raise ValueError(
                f"num_pages={num_pages} cannot hold even one "
                f"worst-case request ({self.max_pages_per_req} pages "
                f"for prompt {max_prompt_len} + {max_new_cap} new)")
        self.cache = PagedKVCache(cfg, num_pages, page_size,
                                  device=self.device)
        self.queue: "collections.deque[Request]" = collections.deque()
        self.slots: List[Optional[Request]] = [None] * self.max_batch
        trash = self.cache.trash_page
        self._tokens = np.zeros(self.max_batch, np.int32)
        self._pos = np.zeros(self.max_batch, np.int64)
        self._tables = np.full(
            (self.max_batch, self.max_pages_per_req), trash, np.int64)
        self._active = np.zeros(self.max_batch, bool)
        self._scales = (fp8_weight_scales(params)
                        if self.weight_mode == "fp8" else {})
        self._decode = build_decode_step(cfg, self.page_size,
                                         self.weight_mode)
        self._prefills: Dict[int, object] = {}
        self.decode_steps = 0
        self.prefill_count = 0

    # --------------------------------------------------------- queries

    def occupancy(self) -> float:
        return float(np.count_nonzero(self._active)) / self.max_batch

    def has_work(self) -> bool:
        return bool(self.queue) or any(
            r is not None for r in self.slots)

    def num_active(self) -> int:
        return int(np.count_nonzero(self._active))

    # ------------------------------------------------------- admission

    def submit(self, req: Request) -> None:
        p = len(req.prompt)
        if not 1 <= p <= self.max_prompt_len:
            raise ValueError(f"prompt length {p} outside "
                             f"[1, {self.max_prompt_len}]")
        if not 1 <= req.max_new_tokens <= self.max_new_cap:
            raise ValueError(
                f"max_new_tokens {req.max_new_tokens} outside "
                f"[1, {self.max_new_cap}]")
        self.queue.append(req)

    def pages_needed(self, req: Request) -> int:
        return pages_per_request(len(req.prompt), req.max_new_tokens,
                                 self.page_size)

    def try_admit(self) -> Tuple[List[Request], List[Request]]:
        """Admit FCFS while a slot is free and the head request's
        worst-case pages fit; returns ``(admitted, finished)``, where
        finished covers requests that complete inside their own
        prefill."""
        admitted, finished = [], []
        while self.queue and None in self.slots:
            if not self.cache.alloc.can_alloc(
                    self.pages_needed(self.queue[0])):
                break
            req = self.queue.popleft()
            admitted.append(req)
            if not self._admit(req):
                finished.append(req)
        return admitted, finished

    def _bucket(self, p: int) -> int:
        return max(1, math.ceil(p / self.page_size)) * self.page_size

    def _prefill_for(self, bucket_len: int):
        fn = self._prefills.get(bucket_len)
        if fn is None:
            fn = build_prefill(self.cfg, bucket_len, self.weight_mode)
            self._prefills[bucket_len] = fn
        return fn

    def _admit(self, req: Request) -> bool:
        """Prefill + slot placement; returns False when the request
        finished at its first token (no slot taken)."""
        p = len(req.prompt)
        s_pad = self._bucket(p)
        pages = self.cache.alloc.alloc(self.pages_needed(req), req.rid)
        prompt = np.zeros((1, s_pad), np.int64)
        prompt[0, :p] = req.prompt
        first, ks, vs = self._prefill_for(s_pad)(
            self.params, self._scales,
            torch.from_numpy(prompt).to(self.device), p)
        self.prefill_count += 1
        self.cache.write_prompt(pages[:s_pad // self.page_size], ks, vs)
        t0 = int(first[0])
        req.tokens = [t0]
        req.first_token_s = time.monotonic()
        if self._is_finished(req, t0):
            self._retire(req)
            return False
        slot = self.slots.index(None)
        self.slots[slot] = req
        req.state = "active"
        self._tokens[slot] = t0
        self._pos[slot] = p
        row = np.full(self.max_pages_per_req, self.cache.trash_page,
                      np.int64)
        row[:len(pages)] = pages
        self._tables[slot] = row
        self._active[slot] = True
        return True

    # ---------------------------------------------------------- decode

    def step_decode(self) -> List[Request]:
        """One packed decode step; returns requests finished by it."""
        if not self._active.any():
            return []
        dev = self.device
        nxt = self._decode(
            self.params, self._scales, self.cache.k_pages, self.cache.v_pages,
            torch.from_numpy(self._tokens).to(dev),
            torch.from_numpy(self._tables).to(dev),
            torch.from_numpy(self._pos).to(dev),
            torch.from_numpy(self._active).to(dev))
        self.decode_steps += 1
        nxt = nxt.cpu().numpy()
        finished = []
        for slot, req in enumerate(self.slots):
            if req is None or not self._active[slot]:
                continue
            t = int(nxt[slot])
            req.tokens.append(t)
            self._tokens[slot] = t
            self._pos[slot] += 1
            if self._is_finished(req, t):
                self._free_slot(slot)
                self._retire(req)
                finished.append(req)
        return finished

    def _is_finished(self, req: Request, token: int) -> bool:
        return (len(req.tokens) >= req.max_new_tokens
                or (self.eos_id is not None and token == self.eos_id))

    def _retire(self, req: Request) -> None:
        req.state = "done"
        req.finish_s = time.monotonic()
        self.cache.alloc.free_owner(req.rid)

    def _free_slot(self, slot: int) -> None:
        self.slots[slot] = None
        self._active[slot] = False
        self._tables[slot] = self.cache.trash_page
        self._tokens[slot] = 0
        self._pos[slot] = 0
