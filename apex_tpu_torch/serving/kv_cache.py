"""Paged KV cache for the continuous-batching runtime (port of
``apex_tpu/serving/kv_cache.py``).

The cache is two device tensors ``[L, P + 1, page_size, nkv, d]`` (k and
v) plus a host-side free-list allocator with per-request page accounting.
Requests own page lists; the scheduler maps them into a static
``[B, max_pages]`` block table for the decode step.

Page ``P`` (the last one) is the *trash page*: inactive batch slots
scatter their never-read k/v writes there, which keeps the decode step
free of per-slot control flow. The allocator never hands it out.

The reference derives its page budget from memory priors calibrated on a
TPU; here ``num_pages`` is given by the caller until the port measures
its own. The port updates the page tensors in place where the reference
rebuilds them with ``.at[].set``.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from apex_tpu_torch import _device

__all__ = ["PageAllocator", "PagedKVCache", "page_hbm_bytes"]


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def page_hbm_bytes(cfg, page_size: int, dtype=None) -> int:
    """Device bytes of ONE page: k + v across all layers."""
    dtype = cfg.dtype if dtype is None else dtype
    return (2 * cfg.num_layers * page_size * cfg.num_kv_heads
            * cfg.head_dim * _itemsize(dtype))


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
        ``[L, n, page_size, nkv, d]``."""
        idx = self._index(pages)
        return self.k_pages[:, idx].cpu(), self.v_pages[:, idx].cpu()

    def defrag(self) -> Dict[int, int]:
        """Compact live pages to the front; returns {old: new} so the
        caller can rewrite block tables. A no-op ({}) when already
        compact. One gather-permute per tensor."""
        live = self.alloc.live_pages()
        mapping = {old: new for new, old in enumerate(live)}
        if all(old == new for old, new in mapping.items()):
            return {}
        taken = set(live)
        perm = list(live)
        perm.extend(p for p in range(self.num_pages) if p not in taken)
        perm.append(self.trash_page)
        idx = self._index(perm)
        self.k_pages = torch.index_select(self.k_pages, 1, idx)
        self.v_pages = torch.index_select(self.v_pages, 1, idx)
        for owner in self.alloc.owners():
            self.alloc._owned[owner] = [
                mapping[p] for p in self.alloc._owned[owner]]
        n_live = len(live)
        self.alloc._free = list(range(self.num_pages - 1, n_live - 1, -1))
        return mapping
