"""Paged KV cache for the continuous-batching runtime (port of
``apex_tpu/serving/kv_cache.py``).

The cache is two device tensors ``[L, P + 1, page_size, nkv, d]`` (k and
v) plus a host-side free-list allocator with per-request page accounting.
Requests own page lists; the scheduler maps them into a static
``[B, max_pages]`` block table for the decode step.

Page ``P`` (the last one) is the *trash page*: inactive batch slots
scatter their never-read k/v writes there, which keeps the decode step
free of per-slot control flow. The allocator never hands it out.

The page *budget* (:func:`derive_page_budget`) is derived from the card's
memory rather than guessed: usable bytes = total x safety - the bytes
already in use (the weights among them), divided by the per-page
footprint corrected by the port's own ``hbm_priors.json``
measured/modeled ratio.

The port updates the page tensors in place where the reference rebuilds
them with ``.at[].set``: prompt writes, restores and :meth:`defrag` keep
``k_pages.data_ptr()`` and ``v_pages.data_ptr()`` fixed, so a captured
decode graph that holds them stays valid.

The emergency dump stores pages as numpy arrays in the reference's
format (:func:`~apex_tpu_torch._npy.dump_array`,
:func:`~apex_tpu_torch._npy.load_array`, shared with the checkpoints):
float32 as it is, bf16
as 2-byte ``|V2`` items holding the bf16 bits, which is what ``np.savez``
writes for the reference's ``ml_dtypes`` bf16 arrays. Either package's
dump loads here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch

from apex_tpu_torch import _device
from apex_tpu_torch._npy import dump_array, load_array

__all__ = ["PageAllocator", "PageBudget", "PagedKVCache",
           "derive_page_budget", "dump_array", "load_array",
           "page_hbm_bytes"]


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def page_hbm_bytes(cfg, page_size: int, dtype=None) -> int:
    """Device bytes of ONE page: k + v across all layers."""
    dtype = cfg.dtype if dtype is None else dtype
    return (2 * cfg.num_layers * page_size * cfg.num_kv_heads
            * cfg.head_dim * _itemsize(dtype))


@dataclasses.dataclass(frozen=True)
class PageBudget:
    """The derivation trail of a page budget (``kv_cache.py:50``)."""

    pages: int
    page_bytes: int          # modeled bytes per page
    ratio: float             # hbm_priors measured/modeled correction
    hbm_bytes: int           # device memory total used
    watermark_bytes: int     # monitor watermark, else bytes in use
    usable_bytes: int        # hbm * safety - watermark (floored at 0)
    safety: float


def derive_page_budget(cfg, page_size: int, *,
                       hbm_bytes: Optional[int] = None,
                       watermark_bytes: Optional[int] = None,
                       priors: Optional[dict] = None,
                       safety: float = 0.90, dtype=None,
                       device: _device.DeviceLike = None) -> PageBudget:
    """Page budget from the card's memory (``kv_cache.py:63``).

    ``pages = floor((hbm x safety - watermark) / ceil(page_bytes x
    ratio))`` where ``ratio`` is the port's ``serving_decode_step`` prior
    (the file's default ratio when it has none). Every input is
    overridable; a missing ``hbm_bytes`` is read from ``device`` (the
    card unless the caller asks for the CPU) by
    :func:`apex_tpu_torch._device.memory`. A missing ``watermark_bytes``
    is the active :class:`~apex_tpu_torch.observability.MemoryMonitor`'s
    watermark when one is attached to ``device``, as in the reference.
    With none attached the reference subtracts 0; the port subtracts the
    bytes in use on the card (total - free, the weights included), a
    deliberate difference (ROADMAP.md, Queue 3): a budget that ignored
    the resident weights would overcommit the card.
    """
    from apex_tpu_torch.analysis.memory_checks import (
        load_hbm_priors,
        prior_for,
    )

    if not 0.0 < safety <= 1.0:
        raise ValueError(f"safety must be in (0, 1], got {safety}")
    if watermark_bytes is None:
        from apex_tpu_torch.observability.memory.hbm import active_monitor

        mon = active_monitor()
        if mon is not None and _device._same(mon.device,
                                             _device.resolve(device)):
            watermark_bytes = mon.summary()["watermark_bytes"]
    if hbm_bytes is None or watermark_bytes is None:
        total, used = _device.memory(device)
        hbm_bytes = total if hbm_bytes is None else hbm_bytes
        watermark_bytes = used if watermark_bytes is None else watermark_bytes
    if priors is None:
        priors = load_hbm_priors()
    ratio = prior_for("serving_decode_step", priors, default=True)
    page_bytes = page_hbm_bytes(cfg, page_size, dtype=dtype)
    usable = max(0, int(hbm_bytes * safety) - int(watermark_bytes))
    pages = int(usable // max(1, int(math.ceil(page_bytes * ratio))))
    return PageBudget(pages=pages, page_bytes=page_bytes, ratio=ratio,
                      hbm_bytes=int(hbm_bytes),
                      watermark_bytes=int(watermark_bytes),
                      usable_bytes=usable, safety=safety)


class PageAllocator:
    """Free-list page allocator with per-owner accounting.

    Pages are plain ints in ``[0, num_pages)``; owners are request ids.
    Allocation is all-or-nothing (the admission check), frees are by
    owner (eviction returns every page a request held).
    """

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError(f"need at least 1 page, got {num_pages}")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._owned: Dict[object, List[int]] = {}

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_pages - len(self._free)

    def owners(self):
        return list(self._owned)

    def pages_of(self, owner) -> List[int]:
        return list(self._owned.get(owner, ()))

    def can_alloc(self, n: int) -> bool:
        return 0 < n <= len(self._free)

    def alloc(self, n: int, owner) -> List[int]:
        if n < 1:
            raise ValueError(f"alloc needs n >= 1, got {n}")
        if n > len(self._free):
            raise RuntimeError(
                f"out of KV pages: want {n}, have {len(self._free)} "
                f"free of {self.num_pages} (admission must check "
                f"can_alloc first)")
        pages = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(owner, []).extend(pages)
        return pages

    def free_owner(self, owner) -> int:
        """Return every page held by ``owner``; returns the count."""
        pages = self._owned.pop(owner, [])
        # freed pages go back lowest-first so reuse stays compact
        self._free.extend(pages)
        self._free.sort(reverse=True)
        return len(pages)

    def live_pages(self) -> List[int]:
        return sorted(p for pages in self._owned.values() for p in pages)


class PagedKVCache:
    """The device-side paged cache + its allocator.

    Tensors are ``[L, P + 1, page_size, nkv, d]`` in ``cfg.dtype`` on
    ``device``; the extra page at index ``P`` (:attr:`trash_page`)
    absorbs inactive-slot writes.
    """

    def __init__(self, cfg, num_pages: int, page_size: int, dtype=None,
                 device: _device.DeviceLike = None):
        self.cfg = cfg
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.dtype = cfg.dtype if dtype is None else dtype
        self.device = _device.resolve(device)
        self.alloc = PageAllocator(self.num_pages)
        shape = (cfg.num_layers, self.num_pages + 1, self.page_size,
                 cfg.num_kv_heads, cfg.head_dim)
        self.k_pages = torch.zeros(shape, dtype=self.dtype,
                                   device=self.device)
        self.v_pages = torch.zeros(shape, dtype=self.dtype,
                                   device=self.device)

    @property
    def trash_page(self) -> int:
        return self.num_pages

    def utilization(self) -> float:
        return self.alloc.num_used / self.num_pages

    def _index(self, pages: List[int]) -> torch.Tensor:
        return torch.as_tensor(pages, dtype=torch.int64, device=self.device)

    def write_prompt(self, pages: List[int], ks, vs) -> None:
        """Store prefill k/v ``[L, S, nkv, d]`` (S = len(pages) x page
        size) into ``pages`` in order, in place."""
        L = self.cfg.num_layers
        n = len(pages)
        s = ks.shape[1]
        if s != n * self.page_size:
            raise ValueError(f"prefill length {s} != {n} pages x "
                             f"{self.page_size}")
        idx = self._index(pages)
        self.k_pages[:, idx] = ks.to(self.dtype).reshape(
            L, n, self.page_size, *ks.shape[2:])
        self.v_pages[:, idx] = vs.to(self.dtype).reshape(
            L, n, self.page_size, *vs.shape[2:])

    def gather_pages(self, pages: List[int]):
        """``pages`` as host ``(k, v)`` tensors
        ``[L, n, page_size, nkv, d]``: the emergency-dump payload
        (:func:`dump_array` makes the dump's arrays of them)."""
        idx = self._index(pages)
        return self.k_pages[:, idx].cpu(), self.v_pages[:, idx].cpu()

    def restore_pages(self, pages: List[int], k, v) -> None:
        """Scatter a dumped payload ``[L, n, page_size, nkv, d]`` back into
        ``pages``, in place (resume path, ``kv_cache.py:214``). Restoring
        by scatter, not re-prefilling, is what keeps resumed decodes
        bit-identical to the uninterrupted run."""
        idx = self._index(pages)
        for pages_t, payload in ((self.k_pages, k), (self.v_pages, v)):
            pages_t[:, idx] = load_array(payload, self.dtype).to(self.device)

    def defrag(self) -> Dict[int, int]:
        """Compact live pages to the front; returns {old: new} so the
        caller can rewrite block tables. A no-op ({}) when already
        compact. One gather-permute per layer, written back in place: the
        page tensors keep their storage (a captured decode graph reads
        them by address)."""
        live = self.alloc.live_pages()
        mapping = {old: new for new, old in enumerate(live)}
        if all(old == new for old, new in mapping.items()):
            return {}
        taken = set(live)
        perm = list(live)
        perm.extend(p for p in range(self.num_pages) if p not in taken)
        perm.append(self.trash_page)
        idx = self._index(perm)
        for pages_t in (self.k_pages, self.v_pages):
            for layer in pages_t:
                layer.copy_(torch.index_select(layer, 0, idx))
        for owner in self.alloc.owners():
            self.alloc._owned[owner] = [
                mapping[p] for p in self.alloc._owned[owner]]
        n_live = len(live)
        self.alloc._free = list(range(self.num_pages - 1, n_live - 1, -1))
        return mapping
