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
  * `copy_page` (a COW fork's page copy, payload and scale rows),
    `rewind_slot` (speculative rollback of a slot's length and table row)
    and `write_prompt_pages` (fp pools) change the cache in place too.
  * `BlockAllocator` — a copy of the host-side free-list allocator with
    watermark admission, per-page refcounts and the content-addressed
    prefix cache (hash chain over full pages, `_chain_key`), COW
    `fork_page`, speculative `rewind` and pinned refcount-0 pages. The
    swap tier's `admission_probe` and `admit_restored` are not ported.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
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




def write_prompt_pages(cache: PagedCache, slot: int, page_ids: list[int],
                       k_dense: torch.Tensor, v_dense: torch.Tensor,
                       length: int) -> PagedCache:
    """Scatter a slot's prefill KV (L, Hkv, S, Dh) into its pages, in
    place, and map the slot's block-table row and length.

    `page_ids` are the physical pages the allocator handed this slot; they
    must cover ceil(length / page_size) logical pages. fp pools only, as in
    the JAX package: a quantized prompt goes through
    `append_chunk_kv_pages`.
    """
    if cache.quantized:
        raise ValueError("write_prompt_pages is fp-only: quantized pools "
                         "take their prompts through append_chunk_kv_pages")
    L, Hkv, S, Dh = k_dense.shape
    bs = cache.page_size
    n0 = len(page_ids)
    if n0 * bs < length:
        raise ValueError(f"{n0} pages of {bs} cannot hold {length} tokens")
    if n0 * bs > S:
        pad = (0, 0, 0, n0 * bs - S)
        k_dense = torch.nn.functional.pad(k_dense, pad)
        v_dense = torch.nn.functional.pad(v_dense, pad)
    # (L, Hkv, n0 * bs, Dh) -> (L, n0, Hkv, bs, Dh): the pool's page layout.
    ck = k_dense[:, :, :n0 * bs].reshape(L, Hkv, n0, bs, Dh).movedim(2, 1)
    cv = v_dense[:, :, :n0 * bs].reshape(L, Hkv, n0, bs, Dh).movedim(2, 1)
    ids = torch.as_tensor(page_ids, dtype=torch.long, device=cache.k_pages.device)
    cache.k_pages[:, ids] = ck.to(cache.k_pages.dtype)
    cache.v_pages[:, ids] = cv.to(cache.v_pages.dtype)
    cache.block_tables[slot] = TRASH_PAGE
    cache.block_tables[slot, :n0] = ids.to(torch.int32)
    cache.lengths[slot] = length
    return cache


def copy_page(cache: PagedCache, src: int, dst: int) -> PagedCache:
    """COW fork: duplicate physical page `src` into `dst` on every layer,
    in place: the payload and, in a quantized pool, the scale rows, so the
    fork owns private scales from its first write."""
    for pool in (cache.k_pages, cache.v_pages, cache.k_scale, cache.v_scale):
        if pool is not None:
            pool[:, dst] = pool[:, src]
    return cache


def clear_slot(cache: PagedCache, slot: int) -> PagedCache:
    """Point a released slot back at the trash page (in place); the pools
    and scale pools stay as they are."""
    cache.lengths[slot] = 0
    cache.block_tables[slot] = TRASH_PAGE
    return cache


def rewind_slot(cache: PagedCache, slot: int, new_len: int,
                keep_pages: int) -> PagedCache:
    """Roll a slot back after speculative rejection, in place: device
    length to `new_len`, table entries past the first `keep_pages`
    re-trashed (the allocator freed those pages through `rewind`). The
    pools are untouched: rejected K/V (and scale rows) past `new_len` in a
    kept page is dead data, masked by the length and overwritten by the
    next appends."""
    cache.lengths[slot] = new_len
    cache.block_tables[slot, keep_pages:] = TRASH_PAGE
    return cache


_PREFIX_ROOT = b"salpim-prefix-root"


def _chain_key(prev: bytes, chunk: np.ndarray) -> bytes:
    """Hash-chain key for one page-aligned token chunk: folds the parent
    key in, so equal keys imply equal *prefixes*, not just equal chunks."""
    h = hashlib.sha256(prev)
    h.update(np.ascontiguousarray(chunk, np.int64).tobytes())
    return h.digest()


class BlockAllocator:
    """Free-list page allocator with watermark (reserve-ahead) admission,
    per-page refcounts and content-addressed prefix sharing.

    Physical page 0 is never handed out (trash page). `admit` /
    `admit_tokens` reserve a sequence's worst-case page count up front
    and allocate only the prompt's pages; `extend` draws one page from the
    reservation at a decode-step boundary; `release` returns everything.
    Because admission is gated on `free - reserved`, an admitted sequence
    can always extend.

    With `prefix_sharing=True`, `admit_tokens` first walks the prefix cache
    (a hash chain over full page-sized token chunks) and maps the longest
    cached run of pages instead of allocating them: those pages get
    refcount + 1 and the watermark reserves only the worst case net of
    shared pages. A shared page must be `fork_page`d (COW) before any write
    lands in it. `pin_budget_pages` > 0 keeps up to that many cached pages
    alive at refcount 0 (0 never pins).
    """

    def __init__(self, num_pages: int, page_size: int,
                 prefix_sharing: bool = False, pin_budget_pages: int = 0):
        if num_pages < 2:
            raise ValueError("need at least trash + 1 usable page")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self.prefix_sharing = prefix_sharing
        self.pin_budget_pages = pin_budget_pages
        self._free = list(range(num_pages - 1, TRASH_PAGE, -1))
        self._reserved = 0
        self._pages: dict[int, list[int]] = {}
        self._quota: dict[int, int] = {}     # worst-case *new* pages per uid
        self._owned: dict[int, int] = {}     # pages uid drew from the free list
        self._reserve_mode: dict[int, bool] = {}   # uid -> watermark-reserved?
        self._ref: dict[int, int] = {}       # physical page -> refcount
        self._prefix_cache: dict[bytes, int] = {}  # chain key -> phys page
        self._page_key: dict[int, bytes] = {}      # phys page -> chain key
        self._pinned: dict[int, None] = {}   # refcount-0 cached pages (FIFO)

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

    @property
    def reserved_pages(self) -> int:
        """Pages promised to admitted sequences and not yet drawn."""
        return self._reserved

    def pages_for(self, tokens: int) -> int:
        return -(-max(tokens, 1) // self.page_size)

    @staticmethod
    def worst_case_tokens(prompt_tokens: int, max_new_tokens: int) -> int:
        """Cache positions a request can ever occupy: the prompt plus one
        KV append per generated token except the last."""
        return prompt_tokens + max(max_new_tokens, 1) - 1

    def pages_of(self, uid: int) -> list[int]:
        return list(self._pages[uid])

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    @property
    def cached_pages(self) -> int:
        """Pages currently addressable through the prefix cache."""
        return len(self._prefix_cache)

    @property
    def pinned_pages(self) -> int:
        """Prefix-cache pages held alive at refcount 0."""
        return len(self._pinned)

    # -- internal helpers ---------------------------------------------------
    def _alloc(self) -> int:
        page = self._free.pop()
        self._ref[page] = 1
        return page

    def _drop_key(self, page: int) -> None:
        key = self._page_key.pop(page, None)
        if key is not None:
            self._prefix_cache.pop(key, None)

    def _decref(self, page: int) -> None:
        self._ref[page] -= 1
        if self._ref[page] == 0:
            del self._ref[page]
            if (page in self._page_key
                    and len(self._pinned) < self.pin_budget_pages):
                # Pin: the page keeps its bytes and prefix-cache entry at
                # refcount 0; a later admission hit revives it.
                self._pinned[page] = None
                return
            self._drop_key(page)
            self._free.append(page)

    def reclaim_pinned(self, n: int, protect=()) -> int:
        """Evict up to `n` pinned pages (oldest pin first, skipping
        `protect`) back to the free list, dropping their prefix-cache
        entries. Returns the number reclaimed."""
        freed = 0
        for page in list(self._pinned):
            if freed >= n:
                break
            if page in protect:
                continue
            del self._pinned[page]
            self._drop_key(page)
            self._free.append(page)
            freed += 1
        return freed

    def _walk_hits(self, tokens) -> tuple[list[bytes], list[int]]:
        """Hash-chain walk over `tokens`' full pages: (chain keys, the
        longest cached run of pages). A pure lookup."""
        ps = self.page_size
        keys: list[bytes] = []
        if self.prefix_sharing:
            key = _PREFIX_ROOT
            for i in range(int(tokens.shape[0]) // ps):
                key = _chain_key(key, tokens[i * ps:(i + 1) * ps])
                keys.append(key)
        hits: list[int] = []
        for key in keys:
            page = self._prefix_cache.get(key)
            if page is None:
                break
            hits.append(page)
        return keys, hits

    def _register(self, key: bytes, page: int) -> None:
        if key not in self._prefix_cache and page not in self._page_key:
            self._prefix_cache[key] = page
            self._page_key[page] = key

    # -- lifecycle ----------------------------------------------------------
    def can_admit(self, prompt_tokens: int, max_new_tokens: int) -> bool:
        worst = self.pages_for(self.worst_case_tokens(prompt_tokens,
                                                      max_new_tokens))
        return self.available_pages >= worst

    def admit(self, uid: int, prompt_tokens: int,
              max_new_tokens: int) -> Optional[list[int]]:
        """Reserve worst case, allocate prompt pages. None if over the
        watermark. Content-free: no prefix-cache lookup or registration
        (`admit_tokens` shares)."""
        if uid in self._pages:
            raise ValueError(f"uid {uid} already admitted")
        worst = self.pages_for(self.worst_case_tokens(prompt_tokens,
                                                      max_new_tokens))
        if self.available_pages < worst:
            return None
        n0 = self.pages_for(prompt_tokens)
        pages = [self._alloc() for _ in range(n0)]
        self._pages[uid] = pages
        self._quota[uid] = worst
        self._owned[uid] = n0
        self._reserve_mode[uid] = True
        self._reserved += worst - n0
        return list(pages)

    def admit_tokens(self, uid: int, tokens, max_new_tokens: int,
                     reserve: bool = True
                     ) -> Optional[tuple[list[int], int]]:
        """Admit with prefix reuse: (prompt pages, shared tokens), or None
        when the pool cannot cover the request (no state changes then).

        The longest cached run of `tokens`' full pages is mapped
        (refcount + 1, reviving pinned pages), the rest allocated fresh,
        and the fresh full pages registered for later admissions. With
        `reserve=True` the worst case net of shared pages is reserved up
        front, plus one fork page when the prompt is fully covered (the
        engine recomputes its last token, whose write must COW the final
        shared page). With `reserve=False` only the pages written during
        prefill must be free now. Pinned pages this prompt does not hit
        are reclaimed to cover a shortage."""
        if uid in self._pages:
            raise ValueError(f"uid {uid} already admitted")
        tokens = np.asarray(tokens)
        n_tok = int(tokens.shape[0])
        keys, hits = self._walk_hits(tokens)
        n_shared = len(hits)
        shared_tokens = n_shared * self.page_size
        total = self.pages_for(self.worst_case_tokens(n_tok, max_new_tokens))
        fork = int(shared_tokens >= n_tok)       # fully covered prompt
        worst_new = total - n_shared + fork
        n0 = self.pages_for(n_tok)
        need_now = worst_new if reserve else n0 - n_shared + fork

        def shortage():
            return need_now - (self.available_pages if reserve
                               else len(self._free))

        if shortage() > 0:
            self.reclaim_pinned(shortage(), protect=frozenset(hits))
        if shortage() > 0:
            return None
        fresh = [self._alloc() for _ in range(n0 - n_shared)]
        for p in hits:
            if p in self._pinned:        # revive: back to refcount 1
                del self._pinned[p]
                self._ref[p] = 1
            else:
                self._ref[p] += 1
        pages = hits + fresh
        for i in range(n_shared, len(keys)):
            self._register(keys[i], pages[i])
        self._pages[uid] = pages
        self._quota[uid] = worst_new
        self._owned[uid] = len(fresh)
        self._reserve_mode[uid] = reserve
        if reserve:
            self._reserved += worst_new - len(fresh)
        return list(pages), shared_tokens

    def needs_extend(self, uid: int, next_token_pos: int) -> bool:
        """True when the write at `next_token_pos` falls off mapped pages."""
        return self.pages_for(next_token_pos + 1) > len(self._pages[uid])

    def _draw(self, uid: int, what: str) -> int:
        """One page for uid against its quota: from its reservation in
        watermark mode, from the free list in optimistic mode."""
        if self._owned[uid] >= self._quota[uid]:
            raise RuntimeError(f"uid {uid} has used its page quota")
        if self._reserve_mode[uid]:
            self._reserved -= 1
        elif not self._free:
            raise RuntimeError(f"optimistic {what} on a dry pool")
        self._owned[uid] += 1
        return self._alloc()

    def extend(self, uid: int) -> int:
        """One more page for uid (decode-step boundary)."""
        page = self._draw(uid, "extend")
        self._pages[uid].append(page)
        return page

    def fork_page(self, uid: int, logical_idx: int) -> tuple[int, int]:
        """COW fork: move uid's `logical_idx` page to a private physical
        page. Returns (old, new); the caller copies the device page
        (`copy_page`) and repoints the block table before writing."""
        pages = self._pages[uid]
        old = pages[logical_idx]
        if self._ref[old] <= 1:
            raise RuntimeError(f"fork of unshared page {old}")
        new = self._draw(uid, "fork")
        self._decref(old)
        pages[logical_idx] = new
        return old, new

    def rewind(self, uid: int, n_tokens: int) -> list[int]:
        """Speculative rollback: unmap uid's pages past those that hold
        `n_tokens`, each back to the free list *and* uid's reservation
        (the inverse of `extend`, so `available_pages` is unchanged by a
        draft-verify round). Only decode-frontier pages are rewound; a
        shared or cached page raises, as freeing it would free KV another
        sequence reads. Returns the dropped physical pages."""
        pages = self._pages[uid]
        keep = self.pages_for(n_tokens)
        for p in pages[keep:]:
            if self._ref[p] != 1:
                raise RuntimeError(f"rewind of shared page {p}")
            if p in self._page_key:
                raise RuntimeError(f"rewind of cached page {p}")
        dropped: list[int] = []
        while len(pages) > keep:
            p = pages.pop()
            del self._ref[p]
            self._free.append(p)
            self._owned[uid] -= 1
            if self._reserve_mode[uid]:
                self._reserved += 1
            dropped.append(p)
        return dropped

    def unregister(self, uid: int, from_logical: int = 0) -> None:
        """Drop the prefix-cache entries of uid's pages at logical index >=
        `from_logical` (pages registered at admission whose contents will
        never be written)."""
        for p in self._pages[uid][from_logical:]:
            self._drop_key(p)

    def release(self, uid: int) -> None:
        pages = self._pages.pop(uid)
        quota, owned = self._quota.pop(uid), self._owned.pop(uid)
        if self._reserve_mode.pop(uid):
            self._reserved -= quota - owned
        for p in pages:
            self._decref(p)
