"""Paged decode attention over a block-table KV pool, single walk and
KV-split.

`paged_attention` launches the CUDA kernel `csrc/paged_attention.cu`,
which replaces the TPU kernel
`src/repro/kernels/paged_attention.py::paged_attention`;
`paged_attention_plain` is its plain PyTorch version, the twin of the JAX
oracle `repro.kernels.ref.paged_attention_ref` (gather the pages dense,
dequantize, then masked softmax attention). In LUT mode the kernel, like
the TPU kernel, computes the page-ordered online softmax, another
function (LUT(a) LUT(b) != LUT(a + b)): `paged_attention_online_plain` is
that walk in plain PyTorch, and `online_walk` its core, shared with the
prefill's reference. `decode_plan` picks how many blocks of a cluster
share one (slot, kv head) and the window a block walks at a time;
`split_plan` does the same for a split's run and `arena_plan` for the dense
arena of `decode_attention`, whose kernel is the same walk
(`csrc/decode_walk.cuh`).

With `kv_splits` > 1 and a block table of at least `KV_SPLIT_MIN_CONTEXT`
tokens (`effective_kv_splits`), `paged_attention` routes to the KV-split
kernels of `csrc/paged_attention_split.cu`, which replace
`_paged_attention_split`: `paged_attention_split` writes raw (m, l, acc)
partials per run of pages and `merge_partials` combines them in a second
launch, which may start while the split kernel drains (programmatic
dependent launch). Their plain versions are
`paged_attention_split_plain` (the twin of `ref.paged_attention_split_ref`)
and `merge_partials_plain`, the function of
`distributed.collectives.merge_partial_softmax_stacked` summed in split
order, as the kernel sums, so that the two agree bit for bit.

q (B, H, D) holds one query per sequence; the pools (P, Hkv, page, D) are
shared by all sequences and read through block_tables (B, n_pages);
length (B,) counts the valid keys. Pools hold q's dtype, or int8 payload
with (P, Hkv, page) scale rows `k_scales`/`v_scales` in f32 or bf16, or
nibble-packed int4 payload (last axis D/2) with bf16 scale rows; the
kernels dequantize as they stage pages. Optional LUT exp (`exp_table`),
softcap and sliding window.

Bound on the H100: the valid K and V bytes (`kv_vector_bytes` a vector)
over 3.35 TB/s; the notes in the CUDA sources give the designs.
"""
from __future__ import annotations

import torch

from repro_torch.core import lut as lut_lib
from repro_torch.core.lut import LutTable
from repro_torch.distributed.collectives import merge_partial_softmax_stacked
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import BLOCK_S, _exp, decode_attention_plain
from repro_torch.kernels._build import DTYPE_CODE as _DTYPE_CODE
from repro_torch.kernels._build import cfunc as _fn, ptr, stream as _stream
from repro_torch.serving.quantize import unpack_int4

NEG_INF = -1e30

# Below this table width (tokens) the split path's partials traffic
# outweighs the parallelism; effective_kv_splits turns it off.
KV_SPLIT_MIN_CONTEXT = 1024

# The single-walk kernel spreads one (slot, kv head) over a cluster of up
# to DECODE_MAX_CLUSTER blocks, each a run of the pages, until the grid
# covers the card's `_build.SMS` multiprocessors. (At 4 slots x 16 heads x
# 1024 keys, 8 blocks a cluster measured slower than 4:
# scripts/sweep_clusters.py on the H100 80GB HBM3 at 700 W.)
DECODE_MAX_CLUSTER = 8

# A block of the decode walk keeps a window of its run in shared memory
# (csrc/decode_walk.cuh, `layout`): a ring of DECODE_STAGES stages of
# about DECODE_STAGE_BYTES, every key's scores (one float a query row) and
# K and V scales, each page's m_j, weight and page id, the run's state and
# fixed pieces, in all at most DECODE_SMEM_MAX bytes. A run that does not
# fit at DECODE_MAX_CLUSTER blocks is walked in windows of whole ring
# stages, with a second read of its K.
DECODE_STAGES = 4
DECODE_STAGE_BYTES = 16384
DECODE_THREADS = 256
DECODE_SMEM_MAX = 227 * 1024
# The arena's ring: 2 stages of up to 32 KB (a 256-key block of bf16 at
# head_dim 64 in one piece), the same 64 KB.
ARENA_STAGES = 2
ARENA_STAGE_BYTES = 32768

# The dense arena's "page": the TPU decode_attention kernel's 256-key
# online-softmax block (kernels/decode_attention.BLOCK_S).
ARENA_PAGE = BLOCK_S

def decode_chunk_pages(page: int, row_bytes: int, win_pages: int,
                       stage_bytes: int = DECODE_STAGE_BYTES) -> int:
    """Pages a ring stage of the walk holds when a page fits a stage."""
    return max(1, min(stage_bytes // (page * row_bytes), win_pages))


def decode_chunk_keys(page: int, row_bytes: int, win_pages: int,
                      stage_bytes: int = DECODE_STAGE_BYTES) -> int:
    """Keys a ring stage holds (the kernel's `chunk_keys`): whole pages
    (`decode_chunk_pages`), or for a page larger than a stage the largest
    divisor of the page that fits one."""
    if page * row_bytes <= stage_bytes:
        return decode_chunk_pages(page, row_bytes, win_pages, stage_bytes) * page
    return max(c for c in range(1, page + 1)
               if page % c == 0 and c * row_bytes <= stage_bytes)


def _ring(arena: bool) -> tuple[int, int]:
    return (ARENA_STAGES, ARENA_STAGE_BYTES) if arena else (DECODE_STAGES, DECODE_STAGE_BYTES)


def decode_smem_bytes(g: int, D: int, page: int, win_pages: int, row_bytes: int,
                      cluster: int = DECODE_MAX_CLUSTER, arena: bool = False) -> int:
    """Shared memory of a walk block whose window holds `win_pages` pages
    of `row_bytes`-byte K/V rows, for g query rows of head_dim D in a
    cluster of `cluster` blocks, with the pools' ring or the arena's: the
    kernel's `layout`, each piece rounded up to 16 bytes."""
    def take(n):
        return -(-n // 16) * 16
    stages, stage_bytes = _ring(arena)
    stage = decode_chunk_keys(page, row_bytes, win_pages, stage_bytes) * row_bytes
    keys = win_pages * page
    return (take(stages * stage) + take(8 * stages)
            + take(4 * g * D) + take(4 * g * keys) + 2 * take(4 * keys)
            + 2 * take(4 * g * win_pages) + take(4 * win_pages) + take(4 * DECODE_THREADS)
            + take(4 * cluster * g) + take(4 * cluster * (2 * g + g * D))
            + take(8 * _build.MAX_TABLE_ROWS) + take(4 * 5 * g) + 2 * take(4 * g * D))


def decode_window_pages(g: int, D: int, page: int, row_bytes: int, cluster: int,
                        arena: bool = False) -> int:
    """The widest window (pages) of whole ring stages that fits one block's
    shared memory in a cluster of `cluster` blocks (0 when not one stage
    fits)."""
    step = max(1, decode_chunk_keys(page, row_bytes, 1 << 30, _ring(arena)[1]) // page)
    n = 0
    while decode_smem_bytes(g, D, page, (n + 1) * step, row_bytes, cluster,
                            arena) <= DECODE_SMEM_MAX:
        n += 1
    return n * step


def decode_plan(B: int, Hkv: int, n_pages: int, g: int, D: int, page: int,
                row_bytes: int, name: str = "paged_attention",
                arena: bool = False) -> tuple[int, int]:
    """(cluster, window pages) of the walk. The cluster is doubled from 1
    while B * Hkv * cluster < `_build.SMS` and every block keeps at least
    one page of the table, at most DECODE_MAX_CLUSTER; then doubled further
    while a block's run of pages does not fit its shared memory. A run that
    still does not fit is walked in the widest windows that do
    (`decode_window_pages`); a cluster too large for even one window is
    halved. Raises ValueError, naming the kernel, only when not one ring
    stage of g x D fits a block."""
    cs = 1
    while cs < DECODE_MAX_CLUSTER and 2 * cs <= n_pages and B * Hkv * cs < _build.SMS:
        cs *= 2
    while (decode_smem_bytes(g, D, page, -(-n_pages // cs), row_bytes, cs, arena)
           > DECODE_SMEM_MAX and cs < DECODE_MAX_CLUSTER and 2 * cs <= n_pages):
        cs *= 2
    run = -(-n_pages // cs)
    if decode_smem_bytes(g, D, page, run, row_bytes, cs, arena) <= DECODE_SMEM_MAX:
        return cs, run
    while cs >= 1:
        win = decode_window_pages(g, D, page, row_bytes, cs, arena)
        if win:
            return cs, win
        cs //= 2
    raise ValueError(f"{name}: not one page of {g} query heads a kv head x "
                     f"head_dim {D} ({row_bytes}-byte K/V rows, page {page}) fits "
                     f"{DECODE_SMEM_MAX} bytes of shared memory")


def split_plan(B: int, Hkv: int, splits: int, n_table: int, g: int, D: int, page: int,
               row_bytes: int) -> tuple[int, int]:
    """(cluster, window pages) of the KV-split kernel: `decode_plan` over
    B * Hkv * splits clusters, each walking one split's run of
    ceil(n_table / splits) pages."""
    return decode_plan(B * Hkv * splits, 1, -(-n_table // splits), g, D, page, row_bytes,
                       name="paged_attention_split")


def arena_plan(B: int, Hkv: int, S: int, g: int, D: int, row_bytes: int) -> tuple[int, int]:
    """(cluster, window blocks) of `decode_attention`: `decode_plan` over
    the arena's ceil(S / 256) blocks of ARENA_PAGE keys, with the arena's
    ring."""
    return decode_plan(B, Hkv, -(-S // ARENA_PAGE), g, D, ARENA_PAGE, row_bytes,
                       name="decode_attention", arena=True)


def effective_kv_splits(kv_splits: int | None, n_pages: int,
                        page_size: int) -> int | None:
    """The split count to run, or None for the single walk: splitting
    engages when asked (kv_splits > 1) and the block table spans at least
    KV_SPLIT_MIN_CONTEXT tokens (n_pages * page_size, whatever is
    resident), clamped to n_pages so that every split owns a page."""
    if kv_splits is None or kv_splits <= 1:
        return None
    if n_pages * page_size < KV_SPLIT_MIN_CONTEXT:
        return None
    return min(kv_splits, n_pages)


def _itemsize(dtype) -> int:
    return (getattr(torch, dtype) if isinstance(dtype, str) else dtype).itemsize


def kv_vector_bytes(head_dim: int, kv_dtype: str = "model",
                    kv_scale_dtype="float32", payload_dtype=torch.float32) -> int:
    """Device bytes one (token, head) K-or-V vector costs the kernels:
    head_dim * itemsize(payload) for fp pools, head_dim + itemsize(scale)
    for int8, head_dim / 2 + itemsize(scale) for int4."""
    if kv_dtype == "int8":
        return head_dim + _itemsize(kv_scale_dtype)
    if kv_dtype == "int4":
        return head_dim // 2 + _itemsize(kv_scale_dtype)
    return head_dim * _itemsize(payload_dtype)


def gather_paged_kv(pages: torch.Tensor, block_tables: torch.Tensor,
                    scales: torch.Tensor | None = None,
                    head_dim: int | None = None) -> torch.Tensor:
    """(P, Hkv, page, Dp) pool -> dense (B, Hkv, n_pages * page, D).

    With scale rows (P, Hkv, page) the payload is dequantized in fp32; a
    payload axis of half `head_dim` is nibble-packed int4 and is unpacked
    first (the twin of `ref._gather_paged_kv`)."""
    B, n_pages = block_tables.shape
    Hkv, page, Dp = pages.shape[1:]
    idx = block_tables.long()
    x = pages[idx].permute(0, 2, 1, 3, 4).reshape(B, Hkv, n_pages * page, Dp)
    if head_dim is not None and 2 * Dp == head_dim:
        if scales is None:
            raise ValueError("packed int4 pools require scale rows")
        x = unpack_int4(x)
    if scales is not None:
        s = scales[idx].permute(0, 2, 1, 3).reshape(B, Hkv, n_pages * page)
        x = x.float() * s[..., None].float()
    return x


def paged_attention_plain(q, k_pages, v_pages, block_tables, length,
                          k_scales=None, v_scales=None, *,
                          scale: float | None = None,
                          exp_table: LutTable | None = None,
                          softcap: float | None = None,
                          window: int | None = None) -> torch.Tensor:
    """Plain version (mirrors `decode_attention_ref` on the gathered pages)."""
    D = q.shape[-1]
    k = gather_paged_kv(k_pages, block_tables, k_scales, D)
    v = gather_paged_kv(v_pages, block_tables, v_scales, D)
    return decode_attention_plain(q, k, v, length, scale=scale, exp_table=exp_table,
                                  softcap=softcap, window=window)


def paged_attention_split_plain(q, k_pages, v_pages, block_tables, length,
                                k_scales=None, v_scales=None, *,
                                kv_splits: int,
                                scale: float | None = None,
                                exp_table: LutTable | None = None,
                                softcap: float | None = None,
                                window: int | None = None) -> torch.Tensor:
    """Plain KV-split version (mirrors `ref.paged_attention_split_ref`):
    the table, padded with the trash page to splits * pps pages, is cut
    into `kv_splits` runs; each run's (m, l, acc) comes from one masked
    softmax over its own keys, and `merge_partial_softmax_stacked`
    combines them. All runs are computed at once along a splits axis."""
    B, H, D = q.shape
    Hkv, page = k_pages.shape[1], k_pages.shape[2]
    n_pages = block_tables.shape[1]
    g = H // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    splits = max(1, min(kv_splits, n_pages))
    pps = -(-n_pages // splits)
    tables = torch.nn.functional.pad(block_tables, (0, pps * splits - n_pages))
    S_s = pps * page

    def gather(pages, scales):
        x = gather_paged_kv(pages, tables, scales, D).float()
        return x.reshape(B, Hkv, splits, S_s, D)

    k, v = gather(k_pages, k_scales), gather(v_pages, v_scales)
    qf = q.float().reshape(B, Hkv, g, D)
    scores = torch.einsum("bhgd,bhksd->bhkgs", qf, k) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    pos = torch.arange(splits * S_s, device=q.device).reshape(splits, S_s)
    lens = length.long().reshape(-1).expand(B)[:, None, None]
    mask = pos[None] < lens
    if window is not None:
        mask = mask & (pos[None] >= lens - window)
    mb = mask[:, None, :, None, :]                       # (B, 1, K, 1, S_s)
    scores = torch.where(mb, scores, NEG_INF)
    m = torch.amax(scores, dim=-1, keepdim=True)         # (B, Hkv, K, g, 1)
    e = torch.where(mb, _exp(scores - m, exp_table), 0.0)
    l = torch.sum(e, dim=-1, keepdim=True)
    acc = torch.einsum("bhkgs,bhksd->bhkgd", e, v)
    out = merge_partial_softmax_stacked(m, l, acc, axis=2)
    return out.reshape(B, H, D).to(q.dtype)


def online_walk(q, k, v, qpos, length, page, splits, *, scale,
                exp_table: LutTable | None = None, softcap: float | None = None,
                window: int | None = None) -> torch.Tensor:
    """The TPU kernels' online softmax in plain PyTorch: rows q (B, Hkv, R,
    D) at absolute positions qpos (B, R) against dense keys k, v (B, Hkv,
    n * page, D) of q's dtype (fp32, or fp64 for the prefill's twin: a LUT
    is then evaluated in fp32 on its argument rounded to fp32) valid below
    length (B,), walked page by page over
    `splits` runs of ceil(n / splits) pages, the runs merged by
    `merge_partial_softmax_stacked`. Per page, m_new = max(m, max(s)),
    p = exp(s - m_new) and corr = exp(m - m_new), or in LUT mode
    p = LUT(s - m_new) and corr = LUT(max(m - m_new, lo)); p = 0 outside
    the mask; l = l * corr + sum(p), acc = acc * corr + p . v. Returns
    acc / max(l, 1e-9) as (B, Hkv, R, D) in q's dtype."""
    B, Hkv, S, D = k.shape
    n = S // page
    pps = -(-n // splits)
    lens = length.long()[:, None, None]
    parts = []
    for sp in range(splits):
        m = torch.full((*q.shape[:3], 1), NEG_INF, dtype=q.dtype, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(q)
        for pg in range(sp * pps, min((sp + 1) * pps, n)):
            kp, vp = k[:, :, pg * page:(pg + 1) * page], v[:, :, pg * page:(pg + 1) * page]
            sc = torch.einsum("bhrd,bhkd->bhrk", q, kp) * scale
            if softcap is not None:
                sc = softcap * torch.tanh(sc / softcap)
            pos = pg * page + torch.arange(page, device=q.device)[None, None, :]
            mask = (pos < lens) & (pos <= qpos[:, :, None].long())
            if window is not None:
                mask = mask & (pos > qpos[:, :, None].long() - window)
            mask = mask[:, None]
            sc = torch.where(mask, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            if exp_table is not None:
                p = lut_lib.apply_table((sc - m_new).float(), exp_table).to(q.dtype)
                corr = lut_lib.apply_table(torch.clamp(m - m_new, min=exp_table.lo).float(),
                                           exp_table).to(q.dtype)
            else:
                p, corr = torch.exp(sc - m_new), torch.exp(m - m_new)
            p = torch.where(mask, p, 0.0)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + torch.einsum("bhrk,bhkd->bhrd", p, vp)
            m = m_new
        parts.append((m, l, acc))
    return merge_partial_softmax_stacked(
        *(torch.stack(x, dim=2) for x in zip(*parts)), axis=2)


def paged_attention_online_plain(q, k_pages, v_pages, block_tables, length,
                                 k_scales=None, v_scales=None, *,
                                 scale: float | None = None,
                                 exp_table: LutTable | None = None,
                                 softcap: float | None = None,
                                 window: int | None = None,
                                 splits: int = 1) -> torch.Tensor:
    """`online_walk` for decode rows: q (B, H, D) at position length - 1
    over the gathered, dequantized pages, the table trash-padded to a
    multiple of `splits`. splits=1 is the single walk the kernel computes;
    splits > 1 the split kernels' runs. -> (B, H, D) f32."""
    B, H, D = q.shape
    Hkv, page = k_pages.shape[1], k_pages.shape[2]
    n = block_tables.shape[1]
    tables = torch.nn.functional.pad(block_tables, (0, -(-n // splits) * splits - n))
    kd = gather_paged_kv(k_pages, tables, k_scales, D).float()
    vd = gather_paged_kv(v_pages, tables, v_scales, D).float()
    g = H // Hkv
    qpos = (length.long() - 1)[:, None].expand(B, g)
    out = online_walk(q.float().reshape(B, Hkv, g, D), kd, vd, qpos, length, page, splits,
                      scale=scale if scale is not None else D ** -0.5,
                      exp_table=exp_table, softcap=softcap, window=window)
    return out.reshape(B, H, D)


# ---------------------------------------------------------------------------
# Launchers
# ---------------------------------------------------------------------------

def pool_format(name, q, k_pages, v_pages, k_scales, v_scales) -> int:
    """Check the pools against q and return the kernels' pool code: 0 = q's
    dtype, 1 = int8 + f32 scale rows, 2 = int8 + bf16, 3 = packed int4 +
    bf16."""
    D = q.shape[-1]
    for t_name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != q.device or t.dim() != 4:
            raise ValueError(f"{name}: {t_name} must be a 4-D pool on {q.device}")
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: pools {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)} differ")
    if (k_scales is None) != (v_scales is None):
        raise ValueError(f"{name}: pass both k_scales and v_scales or neither")
    if k_scales is None:
        if k_pages.dtype != q.dtype or k_pages.shape[-1] != D:
            raise ValueError(f"{name}: pools without scale rows must be "
                             f"(P, Hkv, page, {D}) {q.dtype}")
        return 0
    for t_name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        if (t.device != q.device or tuple(t.shape) != tuple(k_pages.shape[:3])
                or t.dtype not in _DTYPE_CODE or not t.is_contiguous()):
            raise ValueError(f"{name}: {t_name} must be contiguous "
                             f"{tuple(k_pages.shape[:3])} float32 or bfloat16 "
                             f"scale rows on {q.device}")
    if k_scales.dtype != v_scales.dtype:
        raise ValueError(f"{name}: k_scales and v_scales differ in dtype")
    if k_pages.dtype != torch.int8:
        raise ValueError(f"{name}: pools with scale rows must be int8, "
                         f"got {k_pages.dtype}")
    if k_pages.shape[-1] == D:
        return 1 if k_scales.dtype == torch.float32 else 2
    if 2 * k_pages.shape[-1] == D:
        if k_scales.dtype != torch.bfloat16:
            raise ValueError(f"{name}: packed int4 pools take bfloat16 scale rows")
        return 3
    raise ValueError(f"{name}: payload axis {k_pages.shape[-1]} is neither "
                     f"head_dim {D} (int8) nor {D // 2} (packed int4)")


def check_paged_args(name, q, k_pages, v_pages, block_tables, ints,
                     k_scales, v_scales, exp_table, window, softcap) -> int:
    """Validation shared by the paged attention launchers; returns the
    pool format code."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    fmt = pool_format(name, q, k_pages, v_pages, k_scales, v_scales)
    B = q.shape[0]
    if (block_tables.dim() != 2 or block_tables.shape[0] != B
            or block_tables.dtype != torch.int32 or block_tables.device != q.device):
        raise ValueError(f"block_tables must be ({B}, n_pages) int32 on {q.device}")
    for t_name, t in ints:
        if tuple(t.shape) != (B,) or t.dtype != torch.int32 or t.device != q.device:
            raise ValueError(f"{t_name} must be ({B},) int32 on {q.device}")
    for t_name, t in [("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                      ("block_tables", block_tables)] + list(ints):
        if not t.is_contiguous():
            raise ValueError(f"{t_name} must be contiguous")
    H, Hkv = q.shape[-2], k_pages.shape[1]
    if H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    _build.check_table(exp_table)
    return fmt


def lut_args(exp_table, device):
    """(use_lut, table tensor or None, lo, inv_step, sections) for a launch."""
    if exp_table is None:
        return 0, None, -1.0, 1.0, 1
    return (1, exp_table.wb_on(device), exp_table.lo, exp_table.inv_step,
            exp_table.sections)


def _mask_args(D, scale, softcap, window, exp_table, device):
    use_lut, wb, lo, inv_step, sections = lut_args(exp_table, device)
    return (ptr(wb), (scale if scale is not None else 1.0 / (D ** 0.5),
                      softcap if softcap is not None else 0.0,
                      window if window is not None else 0,
                      use_lut, lo, inv_step, sections))


def paged_attention(q, k_pages, v_pages, block_tables, length,
                    k_scales=None, v_scales=None, *,
                    scale: float | None = None,
                    exp_table: LutTable | None = None,
                    softcap: float | None = None,
                    window: int | None = None,
                    kv_splits: int | None = None) -> torch.Tensor:
    """q (B, H, D) -> out (B, H, D) in q.dtype: the single-walk kernel, or
    the split kernel and its combine when `effective_kv_splits` engages."""
    fmt = check_paged_args("paged_attention", q, k_pages, v_pages, block_tables,
                           [("length", length)], k_scales, v_scales, exp_table,
                           window, softcap)
    B, H, D = q.shape
    P, Hkv, page, _ = k_pages.shape
    splits = effective_kv_splits(kv_splits, block_tables.shape[1], page)
    if splits is not None:
        kw = dict(kv_splits=splits, scale=scale, exp_table=exp_table, softcap=softcap,
                  window=window)
        m, l, acc = paged_attention_split(q, k_pages, v_pages, block_tables, length,
                                          k_scales, v_scales, **kw)
        return merge_partials(m, l, acc, q.dtype)
    n_table = block_tables.shape[1]
    if B == 0 or n_table == 0:
        return torch.zeros_like(q)
    row_bytes = k_pages.shape[-1] * k_pages.element_size()
    cluster, win = decode_plan(B, Hkv, n_table, H // Hkv, D, page, row_bytes)
    return launch_decode(q, k_pages, v_pages, block_tables, length, k_scales, v_scales,
                         fmt, cluster, win, scale=scale, exp_table=exp_table,
                         softcap=softcap, window=window)


def launch_decode(q, k_pages, v_pages, block_tables, length, k_scales, v_scales,
                  fmt: int, cluster: int, win_pages: int | None = None, *, scale=None,
                  exp_table=None, softcap=None, window=None) -> torch.Tensor:
    """The single-walk kernel on `cluster` blocks a (slot, kv head) in
    windows of `win_pages` pages (None: a whole run), after
    `paged_attention`'s checks (the C entry checks the cluster and the
    window; scripts/sweep_clusters.py times other sizes so)."""
    B, H, D = q.shape
    P, Hkv, page, _ = k_pages.shape
    out = torch.empty_like(q)
    wb, masks = _mask_args(D, scale, softcap, window, exp_table, q.device)
    n_table = block_tables.shape[1]
    win = -(-n_table // cluster) if win_pages is None else win_pages
    lib = _build.library("paged_attention")
    rc = _fn(lib, "paged_attention", "p" * 9 + "i" * 7 + "ffiiffiiiii" + "p")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ptr(k_scales),
        ptr(v_scales), block_tables.data_ptr(), length.data_ptr(), wb,
        out.data_ptr(), B, H, Hkv, D, page, P, block_tables.shape[1], *masks,
        _DTYPE_CODE[q.dtype], fmt, cluster, win, _stream(q))
    _build.check(lib, "paged_attention", rc)
    paged_attention.launches += 1
    return out


def paged_attention_split(q, k_pages, v_pages, block_tables, length,
                          k_scales=None, v_scales=None, *, kv_splits: int,
                          scale: float | None = None,
                          exp_table: LutTable | None = None,
                          softcap: float | None = None,
                          window: int | None = None,
                          plan: tuple[int, int] | None = None):
    """Launch the KV-split kernel over min(kv_splits, n_pages) runs of
    pages: raw f32 partials m, l (B, Hkv, K, g, 1) and acc (B, Hkv, K, g,
    D). `plan` (cluster, window pages)
    replaces `split_plan`'s (scripts/sweep_clusters.py; the C entry checks
    it)."""
    fmt = check_paged_args("paged_attention_split", q, k_pages, v_pages,
                           block_tables, [("length", length)], k_scales, v_scales,
                           exp_table, window, softcap)
    B, H, D = q.shape
    P, Hkv, page, _ = k_pages.shape
    n_table = block_tables.shape[1]
    splits = max(1, min(kv_splits, n_table))
    g = H // Hkv
    m = torch.empty((B, Hkv, splits, g, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((B, Hkv, splits, g, D), dtype=torch.float32, device=q.device)
    if B == 0:
        return m, l, acc
    row_bytes = k_pages.shape[-1] * k_pages.element_size()
    cluster, win = plan or split_plan(B, Hkv, splits, n_table, g, D, page, row_bytes)
    wb, masks = _mask_args(D, scale, softcap, window, exp_table, q.device)
    lib = _build.library("paged_attention_split")
    rc = _fn(lib, "paged_attention_split", "p" * 11 + "i" * 8 + "ffiiffiii" + "iip")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ptr(k_scales),
        ptr(v_scales), block_tables.data_ptr(), length.data_ptr(), wb,
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), B, H, Hkv, D, page, P, n_table, splits,
        *masks, _DTYPE_CODE[q.dtype], fmt, cluster, win, _stream(q))
    _build.check(lib, "paged_attention_split", rc)
    paged_attention_split.launches += 1
    return m, l, acc


def merge_partials_plain(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of `merge_partials`: partials (B, Hkv, K, g, 1 | 1 |
    D) -> (B, Hkv * g, D) in out_dtype, the function of
    `merge_partial_softmax_stacked(m, l, acc, axis=2)` with l corr and acc
    corr added over the splits one at a time, in split order from 0 (a
    reduction kernel may add in another order)."""
    B, Hkv, K, g, D = acc.shape
    m_glob = torch.amax(m, dim=2, keepdim=True)
    m_glob = torch.where(m_glob <= -1e30, 0.0, m_glob)
    corr = torch.exp(m - m_glob)
    lc, ac = l * corr, acc * corr
    l_glob = torch.zeros_like(lc[:, :, 0])
    a_glob = torch.zeros_like(ac[:, :, 0])
    for k in range(K):
        l_glob = l_glob + lc[:, :, k]
        a_glob = a_glob + ac[:, :, k]
    out = a_glob / torch.clamp(l_glob, min=1e-9)
    return out.reshape(B, Hkv * g, D).to(out_dtype)


def merge_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                   out_dtype: torch.dtype, *, pdl: bool = True) -> torch.Tensor:
    """Launch the combine: partials (B, Hkv, K, g, 1 | 1 | D) -> (B, Hkv * g,
    D) in out_dtype, bit for bit `merge_partials_plain`; with `pdl`
    (programmatic stream serialization) it may start as the kernel before
    it drains (chip_smoke.py times both)."""
    B, Hkv, K, g, D = acc.shape
    for t_name, t, last in (("m", m, 1), ("l", l, 1), ("acc", acc, D)):
        if (t.device.type != "cuda" or t.dtype != torch.float32
                or tuple(t.shape) != (B, Hkv, K, g, last) or not t.is_contiguous()):
            raise ValueError(f"merge_partials: {t_name} must be contiguous "
                             f"({B}, {Hkv}, {K}, {g}, {last}) float32 on CUDA")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"merge_partials writes float32 or bfloat16, got {out_dtype}")
    out = torch.empty((B, Hkv * g, D), dtype=out_dtype, device=acc.device)
    if B == 0:
        return out
    lib = _build.library("paged_attention_split")
    rc = _fn(lib, "merge_partials", "p" * 4 + "i" * 6 + "p")(
        m.data_ptr(), l.data_ptr(), acc.data_ptr(), out.data_ptr(), B * Hkv, g, D,
        K, _DTYPE_CODE[out_dtype], int(pdl), _stream(acc))
    _build.check(lib, "paged_attention_split", rc)
    merge_partials.launches += 1
    return out


paged_attention.launches = 0
paged_attention_split.launches = 0
merge_partials.launches = 0
