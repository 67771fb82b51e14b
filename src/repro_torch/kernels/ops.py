"""Dispatch by tensor device (the port of `repro.kernels.ops`).

A tensor on the CPU goes to the kernel's plain PyTorch version; any other
tensor goes to the CUDA kernel, whose launcher raises unless the tensor is
on a CUDA device. There is no fallback from the kernel to a plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.lut import LutTable
from repro_torch.kernels import gemv_pim as gemv_k
from repro_torch.kernels import paged_attention as paged_k
from repro_torch.kernels import paged_prefill as paged_pf_k


def pim_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
               *, act_table: LutTable | None = None,
               act: str | None = None) -> torch.Tensor:
    """(M, C) @ (R, C)^T with optional bias and fused activation."""
    if x.device.type == "cpu":
        return gemv_k.gemv_pim_plain(x, w, b, act_table=act_table, act=act)
    return gemv_k.gemv_pim_float(x, w, b, act_table=act_table, act=act)


def pim_linear_int8(x_i8: torch.Tensor, x_scale: torch.Tensor, w_i8: torch.Tensor,
                    w_scale: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """int8 (M, C) . int8 (R, C)^T with f32 row scales (and f32 bias) -> f32."""
    if x_i8.device.type == "cpu":
        return gemv_k.gemv_pim_int8_plain(x_i8, x_scale, w_i8, w_scale, b)
    return gemv_k.gemv_pim_int8(x_i8, x_scale, w_i8, w_scale, b)


def pim_linear_fixed(x_q: torch.Tensor, w_q: torch.Tensor, *, shift: int) -> torch.Tensor:
    """int16 (M, C) . int16 (R, C)^T, wrapping int32 sum >> shift, saturated."""
    if x_q.device.type == "cpu":
        return gemv_k.gemv_pim_fixed_plain(x_q, w_q, shift=shift)
    return gemv_k.gemv_pim_fixed(x_q, w_q, shift=shift)


def pim_paged_attention(q, k_pages, v_pages, block_tables, length,
                        k_scales=None, v_scales=None, *, scale=None,
                        exp_table: LutTable | None = None, softcap=None,
                        window=None, kv_splits=None) -> torch.Tensor:
    """Decode attention over a paged KV pool (see serving/kvcache.py).
    int8/int4 pools pass their (P, Hkv, page) scale rows; `kv_splits` > 1
    engages the KV-split path when `effective_kv_splits` says so."""
    kw = dict(scale=scale, exp_table=exp_table, softcap=softcap, window=window)
    if q.device.type == "cpu":
        splits = paged_k.effective_kv_splits(kv_splits, block_tables.shape[1],
                                             k_pages.shape[2])
        if splits is not None:
            return paged_k.paged_attention_split_plain(
                q, k_pages, v_pages, block_tables, length, k_scales, v_scales,
                kv_splits=splits, **kw)
        return paged_k.paged_attention_plain(q, k_pages, v_pages, block_tables,
                                             length, k_scales, v_scales, **kw)
    return paged_k.paged_attention(q, k_pages, v_pages, block_tables, length,
                                   k_scales, v_scales, kv_splits=kv_splits, **kw)


def pim_paged_prefill_attention(q, k_pages, v_pages, block_tables, length,
                                start, k_scales=None, v_scales=None, *,
                                scale=None, exp_table: LutTable | None = None,
                                softcap=None, window=None) -> torch.Tensor:
    """Chunked prefill attention over a paged KV pool: q (B, Sq, H, D) at
    absolute positions start..start+Sq-1."""
    kw = dict(scale=scale, exp_table=exp_table, softcap=softcap, window=window)
    if q.device.type == "cpu":
        return paged_pf_k.paged_prefill_attention_plain(
            q, k_pages, v_pages, block_tables, length, start, k_scales,
            v_scales, **kw)
    return paged_pf_k.paged_prefill_attention(
        q, k_pages, v_pages, block_tables, length, start, k_scales, v_scales,
        **kw)
