"""Chunked paged prefill attention over a block-table KV pool.

`paged_prefill_attention` launches the CUDA kernel `csrc/paged_prefill.cu`,
which replaces the TPU kernel
`src/repro/kernels/paged_prefill.py::paged_prefill_attention` for fp
pools; `paged_prefill_attention_plain` is its plain PyTorch version, the
twin of the JAX oracle `repro.kernels.ref.paged_prefill_attention_ref`.

q (B, Sq, H, D) holds one prompt chunk per sequence at absolute positions
start[b] .. start[b] + Sq - 1; the pools already hold every key in
[0, length[b]), the chunk's own included. Queries attend causally at
their absolute positions. Optional LUT exp, softcap and sliding window.

Bound on the H100: the valid K and V bytes over 3.35 TB/s at the engine's
chunk sizes; the note in `csrc/paged_prefill.cu` gives the design.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import lut as lut_lib
from repro_torch.core.lut import LutTable
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import (
    _DTYPE_CODE, check_paged_args, gather_paged_kv, lut_args)


def paged_prefill_attention_plain(q, k_pages, v_pages, block_tables, length,
                                  start, *, scale: float | None = None,
                                  exp_table: LutTable | None = None,
                                  softcap: float | None = None,
                                  window: int | None = None) -> torch.Tensor:
    """Plain version (mirrors `paged_prefill_attention_ref`)."""
    B, Sq, H, D = q.shape
    # (B, Hkv, S, D) -> seq-major (B, S, Hkv, D), the dense prefill layout.
    k = gather_paged_kv(k_pages, block_tables).float().transpose(1, 2)
    v = gather_paged_kv(v_pages, block_tables).float().transpose(1, 2)
    S, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    qg = q.float().reshape(B, Sq, Hkv, g, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    starts = start.long().reshape(-1).expand(B)
    lens = length.long().reshape(-1).expand(B)
    q_pos = starts[:, None] + torch.arange(Sq, device=q.device)[None, :]
    k_pos = torch.arange(S, device=q.device)
    mask = (k_pos[None, None, :] <= q_pos[..., None]) & (
        k_pos[None, None, :] < lens[:, None, None])
    if window is not None:
        mask = mask & (k_pos[None, None, :] > q_pos[..., None] - window)
    mask_b = mask[:, None, None]                       # (B, 1, 1, Sq, S)
    scores = torch.where(mask_b, scores, -torch.inf)
    m = torch.amax(scores, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    if exp_table is not None:
        e = lut_lib.apply_table(scores - m, exp_table)
    else:
        e = torch.exp(scores - m)
    e = torch.where(mask_b, e, 0.0)
    s = torch.sum(e, dim=-1, keepdim=True)
    probs = e * (1.0 / torch.clamp(s, min=1e-9))
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def _argtypes(lib):
    fn = lib.paged_prefill_attention
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, f, i,
                       i, f, f, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def paged_prefill_attention(q, k_pages, v_pages, block_tables, length, start,
                            k_scales=None, v_scales=None, *,
                            scale: float | None = None,
                            exp_table: LutTable | None = None,
                            softcap: float | None = None,
                            window: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: q (B, Sq, H, D) -> out (B, Sq, H, D)."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, Sq, H, D), got {tuple(q.shape)}")
    check_paged_args("paged_prefill_attention", q, k_pages, v_pages,
                     block_tables, [("length", length), ("start", start)],
                     k_scales, v_scales, exp_table, window, softcap)
    B, Sq, H, D = q.shape
    P, Hkv, page, _ = k_pages.shape
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    use_lut, wb, lo, inv_step, sections = lut_args(exp_table, q.device)
    lib = _build.library("paged_prefill")
    rc = _argtypes(lib)(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), length.data_ptr(), start.data_ptr(),
        wb.data_ptr() if wb is not None else None, out.data_ptr(),
        B, Sq, H, Hkv, D, page, P, block_tables.shape[1], scale,
        softcap if softcap is not None else 0.0,
        window if window is not None else 0, use_lut, lo, inv_step, sections,
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "paged_prefill", rc)
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
