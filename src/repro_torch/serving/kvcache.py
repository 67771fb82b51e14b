"""Paged KV cache (the port of `repro.serving.kvcache`, fp pools only).

  * `PagedCache` — page pools (L, P, Hkv, page, Dh), per-slot block tables
    and lengths, all device tensors. Physical page 0 is a trash page that
    is never allocated; unmapped table entries point at it, so writes from
    empty or parked slots land there harmlessly.
  * `append_kv_pages` / `append_chunk_kv_pages` write new K/V into the
    pools IN PLACE (`index_put_` through advanced indexing), where the JAX
    versions return updated copies. Several parked slots may write the
    trash page at the same offset in one step; which value lands there is
    unspecified and never read by a live slot.
  * `BlockAllocator` — a copy of the host-side free-list allocator with
    watermark admission, without the prefix cache (prefix sharing is not
    ported yet).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import resolve_device

TRASH_PAGE = 0  # physical page 0: scribble target for unmapped writes


@dataclasses.dataclass
class PagedCache:
    """Decode-time paged KV state.

    lengths:      (B,) int32           valid tokens per slot
    block_tables: (B, max_pages) int32 physical page per logical page
    k_pages:      (L, P, Hkv, page_size, Dh) shared K pool
    v_pages:      (L, P, Hkv, page_size, Dh) shared V pool
    """

    lengths: torch.Tensor
    block_tables: torch.Tensor
    k_pages: torch.Tensor
    v_pages: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]


def _check_kv_dtype(kv_dtype: str) -> None:
    if kv_dtype in ("int8", "int4"):
        raise NotImplementedError(f"kv_dtype={kv_dtype!r} pools are not ported yet")
    if kv_dtype != "model":
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")


def page_kv_bytes(cfg, page_size: int, kv_dtype: str = "model") -> int:
    """Device bytes one physical page costs (K + V, all layers)."""
    _check_kv_dtype(kv_dtype)
    itemsize = torch.empty((), dtype=cfg.cdtype).element_size()
    return 2 * cfg.n_layers * cfg.n_kv_heads * page_size * cfg.head_dim * itemsize


def init_paged_cache(cfg, batch: int, num_pages: int, page_size: int,
                     max_pages: int, dtype=None, kv_dtype: str = "model", *,
                     device="cuda") -> PagedCache:
    """Empty pool + all-trash block tables for `batch` decode slots."""
    _check_kv_dtype(kv_dtype)
    dev = resolve_device(device)
    dtype = dtype or cfg.cdtype
    shape = (cfg.n_layers, num_pages, cfg.n_kv_heads, page_size, cfg.head_dim)
    return PagedCache(
        lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
        block_tables=torch.full((batch, max_pages), TRASH_PAGE,
                                dtype=torch.int32, device=dev),
        k_pages=torch.zeros(shape, dtype=dtype, device=dev),
        v_pages=torch.zeros(shape, dtype=dtype, device=dev),
    )


def append_kv_pages(k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_tables: torch.Tensor, lengths: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor):
    """Write one token's K/V at each slot's current length, in place.

    k_pages/v_pages: (P, Hkv, page, Dh) one layer's pool; k_new/v_new:
    (B, Hkv, Dh). Slots whose logical page is unmapped hit the trash page.
    Returns (k_pages, v_pages), the same tensors.
    """
    page = k_pages.shape[2]
    lengths = lengths.long()
    phys = torch.gather(block_tables.long(), 1, (lengths // page)[:, None])[:, 0]
    off = lengths % page
    k_pages[phys, :, off] = k_new.to(k_pages.dtype)
    v_pages[phys, :, off] = v_new.to(v_pages.dtype)
    return k_pages, v_pages


def append_chunk_kv_pages(k_pages: torch.Tensor, v_pages: torch.Tensor,
                          block_tables: torch.Tensor, start: torch.Tensor,
                          k_new: torch.Tensor, v_new: torch.Tensor):
    """Write one prefill chunk's K/V at positions start..start+S-1, in place.

    k_pages/v_pages: (P, Hkv, page, Dh) one layer's pool; k_new/v_new:
    (B, S, Hkv, Dh); start: (B,) position of each chunk's first token.
    Every page the chunk touches must already be mapped in block_tables.
    Returns (k_pages, v_pages), the same tensors.
    """
    page = k_pages.shape[2]
    S = k_new.shape[1]
    pos = start.long()[:, None] + torch.arange(S, device=start.device)[None, :]
    phys = torch.gather(block_tables.long(), 1, pos // page)
    off = pos % page
    # Advanced indices (B, S) around the Hkv slice: the indexed view is
    # chunk-major (B, S, Hkv, Dh), the layout of k_new.
    k_pages[phys, :, off] = k_new.to(k_pages.dtype)
    v_pages[phys, :, off] = v_new.to(v_pages.dtype)
    return k_pages, v_pages


def clear_slot(cache: PagedCache, slot: int) -> PagedCache:
    """Point a released slot back at the trash page (in place)."""
    cache.lengths[slot] = 0
    cache.block_tables[slot] = TRASH_PAGE
    return cache


class BlockAllocator:
    """Free-list page allocator with watermark (reserve-ahead) admission.

    Physical page 0 is never handed out (trash page). `admit` reserves a
    sequence's worst-case page count up front and allocates only the
    prompt's pages; `extend` draws one page from the reservation at a
    decode-step boundary; `release` returns everything. Because admission
    is gated on `free - reserved`, an admitted sequence can always extend.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need at least trash + 1 usable page")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = list(range(num_pages - 1, TRASH_PAGE, -1))
        self._reserved = 0
        self._pages: dict[int, list[int]] = {}
        self._quota: dict[int, int] = {}     # worst-case pages per uid
        self._owned: dict[int, int] = {}     # pages uid drew so far

    # -- accounting ---------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def available_pages(self) -> int:
        """Pages not yet promised to any admitted sequence."""
        return len(self._free) - self._reserved

    @property
    def used_pages(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def pages_for(self, tokens: int) -> int:
        return -(-max(tokens, 1) // self.page_size)

    @staticmethod
    def worst_case_tokens(prompt_tokens: int, max_new_tokens: int) -> int:
        """Cache positions a request can ever occupy: the prompt plus one
        KV append per generated token except the last."""
        return prompt_tokens + max(max_new_tokens, 1) - 1

    def pages_of(self, uid: int) -> list[int]:
        return list(self._pages[uid])

    # -- lifecycle ----------------------------------------------------------
    def admit(self, uid: int, prompt_tokens: int,
              max_new_tokens: int) -> Optional[list[int]]:
        """Reserve worst case, allocate prompt pages. None if over watermark."""
        if uid in self._pages:
            raise ValueError(f"uid {uid} already admitted")
        worst = self.pages_for(self.worst_case_tokens(prompt_tokens,
                                                      max_new_tokens))
        if self.available_pages < worst:
            return None
        n0 = self.pages_for(prompt_tokens)
        pages = [self._free.pop() for _ in range(n0)]
        self._pages[uid] = pages
        self._quota[uid] = worst
        self._owned[uid] = n0
        self._reserved += worst - n0
        return list(pages)

    def needs_extend(self, uid: int, next_token_pos: int) -> bool:
        """True when the write at `next_token_pos` falls off mapped pages."""
        return self.pages_for(next_token_pos + 1) > len(self._pages[uid])

    def extend(self, uid: int) -> int:
        """One more page for uid, drawn from its reservation."""
        if self._owned[uid] >= self._quota[uid]:
            raise RuntimeError(f"uid {uid} has used its page quota")
        self._reserved -= 1
        self._owned[uid] += 1
        page = self._free.pop()
        self._pages[uid].append(page)
        return page

    def release(self, uid: int) -> None:
        pages = self._pages.pop(uid)
        self._reserved -= self._quota.pop(uid) - self._owned.pop(uid)
        self._free.extend(pages)
