"""Paged decode attention over a block-table KV pool.

`paged_attention` launches the CUDA kernel `csrc/paged_attention.cu`,
which replaces the TPU kernel
`src/repro/kernels/paged_attention.py::paged_attention` for fp pools;
`paged_attention_plain` is its plain PyTorch version, the twin of the JAX
oracle `repro.kernels.ref.paged_attention_ref` (gather the pages dense,
then masked softmax attention).

q (B, H, D) holds one query per sequence; the pools (P, Hkv, page, D) are
shared by all sequences and read through block_tables (B, n_pages);
length (B,) counts the valid keys. Optional LUT exp (`exp_table`),
softcap and sliding window. int8/int4 pools (scale rows) are not ported.

Bound on the H100: the valid K and V bytes over 3.35 TB/s; the note in
`csrc/paged_attention.cu` gives the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import lut as lut_lib
from repro_torch.core.lut import LutTable
from repro_torch.kernels import _build

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_TABLE_ROWS = 128


def gather_paged_kv(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """(P, Hkv, page, D) pool -> dense (B, Hkv, n_pages * page, D)."""
    B, n_pages = block_tables.shape
    Hkv, page, D = pages.shape[1:]
    x = pages[block_tables.long()]                  # (B, n_pages, Hkv, page, D)
    return x.permute(0, 2, 1, 3, 4).reshape(B, Hkv, n_pages * page, D)


def paged_attention_plain(q, k_pages, v_pages, block_tables, length, *,
                          scale: float | None = None,
                          exp_table: LutTable | None = None,
                          softcap: float | None = None,
                          window: int | None = None) -> torch.Tensor:
    """Plain version (mirrors `decode_attention_ref` on the gathered pages)."""
    B, H, D = q.shape
    k = gather_paged_kv(k_pages, block_tables).float()
    v = gather_paged_kv(v_pages, block_tables).float()
    Hkv, S = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    qf = q.float().reshape(B, Hkv, g, D)
    scores = torch.einsum("bhgd,bhsd->bhgs", qf, k) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    pos = torch.arange(S, device=q.device)
    lens = length.long().reshape(-1).expand(B)
    mask = pos[None, :] < lens[:, None]
    if window is not None:
        mask = mask & (pos[None, :] >= (lens[:, None] - window))
    mask_b = mask[:, None, None, :]
    scores = torch.where(mask_b, scores, -torch.inf)
    m = torch.amax(scores, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    if exp_table is not None:
        e = lut_lib.apply_table(scores - m, exp_table)
    else:
        e = torch.exp(scores - m)
    e = torch.where(mask_b, e, 0.0)
    l = torch.sum(e, dim=-1, keepdim=True)
    inv = 1.0 / torch.clamp(l, min=1e-9)
    out = torch.einsum("bhgs,bhsd->bhgd", e * inv, v)
    return out.reshape(B, H, D).to(q.dtype)


def check_paged_args(name, q, k_pages, v_pages, block_tables, ints,
                     k_scales, v_scales, exp_table, window, softcap):
    """Validation shared by the two paged attention launchers."""
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(
            f"{name}: int8/int4 pools (scale rows) are not ported yet")
    if q.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    for t_name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.device != q.device or t.dtype != q.dtype or t.dim() != 4:
            raise ValueError(f"{t_name} must be a 4-D {q.dtype} pool on {q.device}")
    if k_pages.shape != v_pages.shape or k_pages.shape[-1] != q.shape[-1]:
        raise ValueError(f"pools {tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
                         f"do not match head_dim {q.shape[-1]}")
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
    if exp_table is not None and exp_table.sections + 2 > _MAX_TABLE_ROWS:
        raise ValueError(f"LUT tables hold at most {_MAX_TABLE_ROWS - 2} sections")


def lut_args(exp_table, device):
    """(use_lut, table tensor or None, lo, inv_step, sections) for a launch."""
    if exp_table is None:
        return 0, None, -1.0, 1.0, 1
    return (1, exp_table.wb_on(device), exp_table.lo, exp_table.inv_step,
            exp_table.sections)


def _argtypes(lib):
    fn = lib.paged_attention
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, f, i, i, f,
                       f, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def paged_attention(q, k_pages, v_pages, block_tables, length,
                    k_scales=None, v_scales=None, *,
                    scale: float | None = None,
                    exp_table: LutTable | None = None,
                    softcap: float | None = None,
                    window: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: q (B, H, D) -> out (B, H, D) in q.dtype."""
    check_paged_args("paged_attention", q, k_pages, v_pages, block_tables,
                     [("length", length)], k_scales, v_scales, exp_table,
                     window, softcap)
    B, H, D = q.shape
    P, Hkv, page, _ = k_pages.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    use_lut, wb, lo, inv_step, sections = lut_args(exp_table, q.device)
    lib = _build.library("paged_attention")
    rc = _argtypes(lib)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), length.data_ptr(),
        wb.data_ptr() if wb is not None else None, out.data_ptr(),
        B, H, Hkv, D, page, P, block_tables.shape[1], scale,
        softcap if softcap is not None else 0.0,
        window if window is not None else 0, use_lut, lo, inv_step, sections,
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "paged_attention", rc)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
