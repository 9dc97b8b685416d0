"""Continuous-batching scheduler: prefill/decode split over paged KV
(port of ``apex_tpu/serving/scheduler.py``).

- **prefill**: one full-sequence pass per admitted request through the
  flash-attention kernel, the prompt padded with token 0 to a page-size
  multiple. Causal attention keeps the pad suffix out of every real
  position; the first token is read at ``true_len - 1``.
- **decode**: one step over the packed ``[max_batch]`` slot tensors. The
  batch composition (who occupies which slot, who is active) is data
  (block tables, positions, an active mask), never shape. Inactive slots
  write their k/v to the trash page and pass their token through. On the
  card the step is ONE CUDA graph (:class:`DecodeGraph`), captured at a
  scheduler's first decode step and replayed on every step after it: the
  counterpart of the reference's single jitted ``_decode_step``: the
  capture reports itself to the recompile listener
  (:mod:`apex_tpu_torch.observability.recompile`) under that name, and
  the zero-retrace contract :meth:`ContinuousBatchScheduler.
  decode_retraces` reads the listener (captures after the first, 0 in
  steady state).

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

The host mirrors of the slot arrays (numpy) are the source of truth,
as in the reference; :meth:`~ContinuousBatchScheduler.export_requests`
and :meth:`~ContinuousBatchScheduler.import_request` carry the in-flight
requests and their pages across a preemption dump. Importing changes
only data, so the graph is not captured again.
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
from apex_tpu_torch.observability import recompile
from apex_tpu_torch.ops import launch_counts
from apex_tpu_torch.ops.precision import matmul_fp8
from apex_tpu_torch.serving.kv_cache import PagedKVCache

__all__ = [
    "DECODE_STEP",
    "ContinuousBatchScheduler",
    "DecodeGraph",
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


#: the name the decode graph's captures are reported under: the
#: reference's jitted ``_decode_step``
DECODE_STEP = "_decode_step"

# one capture stream a device for every decode graph of the process, so
# the fp8 cast's per-stream scratch buffer is made once for all of them
_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream decode graphs on ``device`` are captured on."""
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    stream = _CAPTURE_STREAMS.get(index)
    if stream is None:
        stream = torch.cuda.Stream(device=index)
        _CAPTURE_STREAMS[index] = stream
    return stream


class DecodeGraph:
    """The decode step over static device inputs: one CUDA graph on the
    card, the same step called eagerly on a CPU device.

    ``step(tokens, tables, pos, active) -> next_tokens`` runs the decode
    step on tensors that never move: the inputs are views of one int64
    device buffer ``[max_batch x (max_pages + 3)]`` (tokens, block
    tables, positions, the active mask as 0/1), filled each call from
    the host mirrors through one pinned staging buffer and one copy.
    Shapes are fixed by ``max_batch`` and ``max_pages``; the batch
    composition is data. ``pages()`` returns the tensors the step
    updates in place (the KV pages).

    On the card the first call warms the step up on the capture stream
    (:func:`capture_stream`) with every slot inactive (the writes land
    on the trash page), captures it, and every call replays the graph on
    the caller's stream. The step reads params and pages by address, so
    they must stay where they are (the cache updates them in place); a
    call raises when the pages moved. A failed capture or replay raises:
    there is no eager fallback on the card. The kernels' launch counters
    advance by the capture's launches on every replay (the capture
    itself launches nothing).

    Each capture is reported to the recompile listener under ``name``
    (:func:`~apex_tpu_torch.observability.recompile.note_capture`), and
    :meth:`compiled_memory_stats` gives the compiled-memory capture the
    graph's measured footprint."""

    def __init__(self, step, device: torch.device, max_batch: int,
                 max_pages: int, pages, name: str = DECODE_STEP):
        self.step = step
        self.name = name
        self.device = device
        self.max_batch = int(max_batch)
        self.max_pages = int(max_pages)
        self.pages = pages
        n = self.max_batch * (self.max_pages + 3)
        cuda = device.type == "cuda"
        self._host = torch.zeros(n, dtype=torch.int64, pin_memory=cuda)
        self._static = torch.zeros(n, dtype=torch.int64, device=device)
        self.graph = None
        self.captures = 0
        self.capture_s = None
        self._out = None
        self._launches = {}
        self._held = ()

    def inputs(self):
        """The static inputs: views of the device buffer."""
        b, p = self.max_batch, self.max_pages
        buf = self._static
        return (buf[:b], buf[b:b + b * p].view(b, p),
                buf[b + b * p:2 * b + b * p], buf[2 * b + b * p:] != 0)

    def _stage(self, tokens, tables, pos, active) -> None:
        b, p = self.max_batch, self.max_pages
        host = self._host.numpy()
        host[:b] = tokens
        host[b:b + b * p] = np.asarray(tables).reshape(-1)
        host[b + b * p:2 * b + b * p] = pos
        host[2 * b + b * p:] = active
        self._static.copy_(self._host, non_blocking=True)

    def _addresses(self):
        return tuple(t.data_ptr() for t in self.pages())

    def capture(self) -> None:
        """Warm the step up on the capture stream and capture it;
        ``capture_s`` is the host time the two took."""
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        stream = capture_stream(self.device)
        tokens, tables, pos, active = self.inputs()
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self.step(tokens, tables, pos, torch.zeros_like(active))
        current.wait_stream(stream)
        before = launch_counts.snapshot()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = self.step(*self.inputs())
        self._launches = launch_counts.delta(launch_counts.snapshot(),
                                             before)
        launch_counts.restore(before)
        self.graph, self._out = graph, out
        self._held = self._addresses()
        self.captures += 1
        self.capture_s = time.perf_counter() - t0
        recompile.note_capture(self.name, self, self.capture_s)

    def compiled_memory_stats(self) -> dict:
        """The captured graph's memory (``memory.compiled``'s fields):
        its static inputs and output, and the bytes its pool holds."""
        from apex_tpu_torch.observability.memory.compiled import (
            captured_graph_fields,
        )

        return captured_graph_fields(self.graph, (self._static,),
                                     (self._out,))

    def replay(self) -> torch.Tensor:
        """Replay the captured step on its static inputs as they stand;
        returns the static output tensor (next tokens, on the device)."""
        if self._addresses() != self._held:
            raise RuntimeError(
                "the KV pages moved since the decode graph was captured: "
                "the cache must update them in place")
        self.graph.replay()
        launch_counts.add(self._launches)
        return self._out

    def __call__(self, tokens, tables, pos, active) -> np.ndarray:
        """One decode step from the host mirrors; next tokens as numpy."""
        self._stage(tokens, tables, pos, active)
        if self.device.type != "cuda":
            return self.step(*self.inputs()).numpy()
        if self.graph is None:
            self.capture()
        return self.replay().cpu().numpy()


class ContinuousBatchScheduler:
    """Queue + slots + paged cache behind the prefill and decode steps.

    Host mirrors (numpy) of the slot arrays are the source of truth;
    each decode step stages them into the decode graph's static inputs
    (same shapes every step).
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
        # closures over the step's operands, not over self: the graph
        # and its memory pool go with the scheduler, without a cycle
        decode, scales, cache = self._decode, self._scales, self.cache

        def step(*slots):
            return decode(params, scales, cache.k_pages, cache.v_pages,
                          *slots)

        self._graph = DecodeGraph(
            step, self.device, self.max_batch, self.max_pages_per_req,
            pages=lambda: (cache.k_pages, cache.v_pages))
        self._prefills: Dict[int, object] = {}
        self.decode_steps = 0
        self.prefill_count = 0
        # the listener's count of this graph's captures right after the
        # first decode step: the zero-retrace guard's baseline
        self._decode_compiles0: Optional[int] = None

    # --------------------------------------------------------- queries

    def occupancy(self) -> float:
        return float(np.count_nonzero(self._active)) / self.max_batch

    def has_work(self) -> bool:
        return bool(self.queue) or any(
            r is not None for r in self.slots)

    def num_active(self) -> int:
        return int(np.count_nonzero(self._active))

    def decode_captures(self) -> int:
        """Captures of this scheduler's decode graph (1 once it decoded
        on the card, 0 on a CPU device, which runs the step eagerly)."""
        return self._graph.captures

    def decode_retraces(self) -> int:
        """Captures of this scheduler's decode graph after its first
        decode step, as the recompile listener counts them
        (``scheduler.py:310``): steady state must report 0, and a CPU
        device, which captures nothing, reports 0."""
        if self._decode_compiles0 is None:
            return 0
        listener = recompile.install()
        return max(0, listener.compiles(DECODE_STEP, source=self._graph)
                   - self._decode_compiles0)

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
        nxt = self._graph(self._tokens, self._tables, self._pos,
                          self._active)
        self.decode_steps += 1
        if self._decode_compiles0 is None:
            self._decode_compiles0 = recompile.install().compiles(
                DECODE_STEP, source=self._graph)
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

    # --------------------------------------------------- dump / resume

    def _req_record(self, req: Request) -> dict:
        return {"rid": req.rid,
                "prompt": [int(t) for t in req.prompt],
                "max_new_tokens": int(req.max_new_tokens),
                "arrival_s": float(req.arrival_s)}

    def export_requests(self):
        """Emergency-dump payload (``scheduler.py:451``): (queued records,
        inflight records, {name: host tensor} pages). In-flight k/v pages
        are gathered so resume restores them by scatter: re-prefilling
        would re-run float math and forfeit bit-identical resumption."""
        queued = [self._req_record(r) for r in self.queue]
        inflight, arrays = [], {}
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            pages = self.cache.alloc.pages_of(req.rid)
            k, v = self.cache.gather_pages(pages)
            arrays[f"k_{req.rid}"] = k
            arrays[f"v_{req.rid}"] = v
            rec = self._req_record(req)
            rec.update(pos=int(self._pos[slot]),
                       tokens=[int(t) for t in req.tokens],
                       npages=len(pages))
            inflight.append(rec)
        return queued, inflight, arrays

    def import_request(self, rec: dict, k, v) -> Request:
        """Rebuild one in-flight request from a dump record and its
        gathered pages (numpy in the dump's format, or tensors): the
        pages are restored in place and the slot's mirrors set, so the
        decode graph replays on as it was."""
        req = Request(rid=rec["rid"],
                      prompt=np.asarray(rec["prompt"], np.int32),
                      max_new_tokens=rec["max_new_tokens"],
                      arrival_s=rec.get("arrival_s", 0.0),
                      submit_s=time.monotonic())
        slot = self.slots.index(None)
        pages = self.cache.alloc.alloc(rec["npages"], req.rid)
        self.cache.restore_pages(pages, k, v)
        req.tokens = list(rec["tokens"])
        req.state = "active"
        req.first_token_s = time.monotonic()
        self.slots[slot] = req
        self._tokens[slot] = req.tokens[-1]
        self._pos[slot] = rec["pos"]
        row = np.full(self.max_pages_per_req, self.cache.trash_page,
                      np.int64)
        row[:len(pages)] = pages
        self._tables[slot] = row
        self._active[slot] = True
        return req
