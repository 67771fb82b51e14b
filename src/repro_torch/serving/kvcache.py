"""Paged KV cache (the port of `repro.serving.kvcache`).

  * `PagedCache` — page pools (L, P, Hkv, page, Dh), per-slot block tables
    and lengths, all device tensors. Physical page 0 is a trash page that
    is never allocated; unmapped table entries point at it, so writes from
    empty or parked slots land there harmlessly.
  * Pool formats (`kv_dtype`): "model" stores pages in the compute dtype;
    "int8" stores int8 payload plus (L, P, Hkv, page) scale-row pools
    `k_scale`/`v_scale` in `kv_scale_dtype` (f32 or bf16); "int4" packs two
    values a byte (payload axis Dh/2, `serving/quantize.pack_int4`) with
    the same scale rows. Both appends quantize at write time
    (`quantize_vec` / `quantize_vec_int4`); a pool whose payload axis is
    half the incoming head_dim is int4.
  * `append_kv_pages` / `append_chunk_kv_pages` write new K/V (and scales)
    into the pools IN PLACE (`index_put_` through advanced indexing), where
    the JAX versions return updated copies. Several parked slots may write
    the trash page at the same offset in one step; which value lands there
    is unspecified and never read by a live slot.
  * `BlockAllocator` — a copy of the host-side free-list allocator with
    watermark admission, without the prefix cache (prefix sharing is not
    ported yet).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.kernels import paged_attention as paged_k
from repro_torch.serving.quantize import quantize_vec, quantize_vec_int4

TRASH_PAGE = 0  # physical page 0: scribble target for unmapped writes
_SCALE_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass
class PagedCache:
    """Decode-time paged KV state.

    lengths:      (B,) int32           valid tokens per slot
    block_tables: (B, max_pages) int32 physical page per logical page
    k_pages:      (L, P, Hkv, page_size, Dh) shared K pool (Dh/2 for int4)
    v_pages:      (L, P, Hkv, page_size, Dh) shared V pool
    k_scale:      (L, P, Hkv, page_size) int8/int4 dequant scales (f32 or
    v_scale:      bf16); None for fp pools
    """

    lengths: torch.Tensor
    block_tables: torch.Tensor
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def page_kv_bytes(cfg, page_size: int, kv_dtype: str = "model",
                  kv_scale_dtype: str = "float32") -> int:
    """Device bytes one physical page costs (K + V, all layers, with the
    int8/int4 scale rows), from the kernels' `kv_vector_bytes`."""
    unit = cfg.n_layers * cfg.n_kv_heads * page_size
    return 2 * unit * paged_k.kv_vector_bytes(
        cfg.head_dim, kv_dtype, kv_scale_dtype, payload_dtype=cfg.cdtype)


def init_paged_cache(cfg, batch: int, num_pages: int, page_size: int,
                     max_pages: int, dtype=None, kv_dtype: str = "model",
                     kv_scale_dtype: str = "float32", *,
                     device="cuda") -> PagedCache:
    """Empty pool + all-trash block tables for `batch` decode slots.

    kv_dtype "model" stores pages in `dtype` (default cfg.cdtype); "int8"
    stores int8 payload pools plus scale-row pools in `kv_scale_dtype`;
    "int4" packs two values a byte (payload axis Dh/2, even Dh only) with
    the same scale rows.
    """
    dev = resolve_device(device)
    dtype = dtype or cfg.cdtype
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    shape = (L, num_pages, Hkv, page_size, Dh)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=dev)
    tables = torch.full((batch, max_pages), TRASH_PAGE, dtype=torch.int32,
                        device=dev)
    if kv_scale_dtype not in _SCALE_DTYPES:
        raise ValueError(f"unknown kv_scale_dtype {kv_scale_dtype!r}")
    if kv_dtype in ("int8", "int4"):
        sdt = getattr(torch, kv_scale_dtype)
        if kv_dtype == "int4":
            if Dh % 2:
                raise ValueError("int4 KV pools need an even head_dim")
            shape = shape[:-1] + (Dh // 2,)
        return PagedCache(
            lengths=lengths, block_tables=tables,
            k_pages=torch.zeros(shape, dtype=torch.int8, device=dev),
            v_pages=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.zeros(shape[:-1], dtype=sdt, device=dev),
            v_scale=torch.zeros(shape[:-1], dtype=sdt, device=dev),
        )
    if kv_dtype != "model":
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
    return PagedCache(
        lengths=lengths, block_tables=tables,
        k_pages=torch.zeros(shape, dtype=dtype, device=dev),
        v_pages=torch.zeros(shape, dtype=dtype, device=dev),
    )


def _write(k_pages, v_pages, phys, off, k_new, v_new, k_scale, v_scale):
    """Store k_new/v_new at (phys, :, off), quantized into the scale pools'
    formats when they are given; returns the 2- or 4-tuple of pools."""
    if k_scale is None:
        k_pages[phys, :, off] = k_new.to(k_pages.dtype)
        v_pages[phys, :, off] = v_new.to(v_pages.dtype)
        return k_pages, v_pages
    quant = (quantize_vec_int4 if 2 * k_pages.shape[-1] == k_new.shape[-1]
             else quantize_vec)
    k_q, k_sc = quant(k_new, scale_dtype=k_scale.dtype)
    v_q, v_sc = quant(v_new, scale_dtype=v_scale.dtype)
    k_pages[phys, :, off] = k_q
    v_pages[phys, :, off] = v_q
    k_scale[phys, :, off] = k_sc
    v_scale[phys, :, off] = v_sc
    return k_pages, v_pages, k_scale, v_scale


def append_kv_pages(k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_tables: torch.Tensor, lengths: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    k_scale: torch.Tensor | None = None,
                    v_scale: torch.Tensor | None = None):
    """Write one token's K/V at each slot's current length, in place.

    k_pages/v_pages: (P, Hkv, page, Dh) one layer's pool; k_new/v_new:
    (B, Hkv, Dh). Slots whose logical page is unmapped hit the trash page.
    With scale pools (P, Hkv, page) the vectors are quantized here and the
    payload and its scale land at the same (page, offset). Returns the
    same tensors: (k_pages, v_pages), or the 4-tuple with the scale pools.
    """
    page = k_pages.shape[2]
    lengths = lengths.long()
    phys = torch.gather(block_tables.long(), 1, (lengths // page)[:, None])[:, 0]
    return _write(k_pages, v_pages, phys, lengths % page, k_new, v_new,
                  k_scale, v_scale)


def append_chunk_kv_pages(k_pages: torch.Tensor, v_pages: torch.Tensor,
                          block_tables: torch.Tensor, start: torch.Tensor,
                          k_new: torch.Tensor, v_new: torch.Tensor,
                          k_scale: torch.Tensor | None = None,
                          v_scale: torch.Tensor | None = None):
    """Write one prefill chunk's K/V at positions start..start+S-1, in place.

    k_pages/v_pages: (P, Hkv, page, Dh) one layer's pool; k_new/v_new:
    (B, S, Hkv, Dh); start: (B,) position of each chunk's first token.
    Every page the chunk touches must already be mapped in block_tables.
    Quantizes like `append_kv_pages` when scale pools are given, and
    returns the same 2- or 4-tuple.
    """
    page = k_pages.shape[2]
    S = k_new.shape[1]
    pos = start.long()[:, None] + torch.arange(S, device=start.device)[None, :]
    phys = torch.gather(block_tables.long(), 1, pos // page)
    # Advanced indices (B, S) around the Hkv slice: the indexed view is
    # chunk-major (B, S, Hkv, Dh), the layout of k_new.
    return _write(k_pages, v_pages, phys, pos % page, k_new, v_new,
                  k_scale, v_scale)


def clear_slot(cache: PagedCache, slot: int) -> PagedCache:
    """Point a released slot back at the trash page (in place); the pools
    and scale pools stay as they are."""
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
