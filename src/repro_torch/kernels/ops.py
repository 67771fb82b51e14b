"""Dispatch by tensor device (the port of `repro.kernels.ops`).

A tensor on the CPU goes to the kernel's plain PyTorch version; any other
tensor goes to the CUDA kernel, whose launcher raises unless the tensor is
on a CUDA device. There is no fallback from the kernel to a plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.lut import LutTable
from repro_torch.kernels import decode_attention as attn_k
from repro_torch.kernels import gemv_pim as gemv_k
from repro_torch.kernels import layernorm_lut as ln_k
from repro_torch.kernels import lut_interp as lut_k
from repro_torch.kernels import paged_attention as paged_k
from repro_torch.kernels import paged_prefill as paged_pf_k
from repro_torch.kernels import softmax_lut as sm_k


def lut_apply(x: torch.Tensor, table: LutTable) -> torch.Tensor:
    """Apply a LUT table elementwise to x of any shape."""
    if x.device.type == "cpu":
        return lut_k.lut_interp_plain(x, table)
    return lut_k.lut_interp(x, table)


def pim_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
               *, act_table: LutTable | None = None,
               act: str | None = None) -> torch.Tensor:
    """(M, C) @ (R, C)^T with optional bias and fused activation."""
    if x.device.type == "cpu":
        return gemv_k.gemv_pim_plain(x, w, b, act_table=act_table, act=act)
    return gemv_k.gemv_pim_float(x, w, b, act_table=act_table, act=act)


def pim_linear_int8(x_i8: torch.Tensor, x_scale: torch.Tensor, w_i8: torch.Tensor,
                    w_scale: torch.Tensor, b: torch.Tensor | None = None, *,
                    out_dtype: torch.dtype = torch.float32,
                    act_table: LutTable | None = None) -> torch.Tensor:
    """int8 (M, C) . int8 (R, C)^T with row scales (and a bias) in f32 or
    bf16, the rescale and bias in f32, cast to `out_dtype`, then the LUT."""
    kw = dict(out_dtype=out_dtype, act_table=act_table)
    if x_i8.device.type == "cpu":
        return gemv_k.gemv_pim_int8_plain(x_i8, x_scale, w_i8, w_scale, b, **kw)
    return gemv_k.gemv_pim_int8(x_i8, x_scale, w_i8, w_scale, b, **kw)


def pim_int8_linear(x: torch.Tensor, w_i8: torch.Tensor, w_scale: torch.Tensor,
                    b: torch.Tensor | None = None, *, compute: torch.dtype | None = None,
                    act_table: LutTable | None = None) -> torch.Tensor:
    """The int8 linear layer: float x (M, C) quantized per row in `compute`
    (x's dtype by default), . int8 (R, C)^T with row scales (and a bias) in
    f32 or bf16, the rescale and bias in f32, cast to x's dtype, then the
    LUT; one kernel launch at decode widths."""
    kw = dict(compute=compute, act_table=act_table)
    if x.device.type == "cpu":
        return gemv_k.gemv_pim_int8_linear_plain(x, w_i8, w_scale, b, **kw)
    return gemv_k.gemv_pim_int8_linear(x, w_i8, w_scale, b, **kw)


def pim_quantize_int8_rows(x: torch.Tensor, *,
                           static_input: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., C) -> int8 (..., C) + (...) scale in x's dtype (symmetric, per
    row; `core.quant.quantize_int8_rows`); `static_input`: no kernel in
    flight writes x (a weight), so the kernel may read it early."""
    if x.device.type == "cpu":
        return gemv_k.quantize_int8_rows_plain(x)
    return gemv_k.quantize_int8_rows(x, static_input=static_input)


def pim_linear_fixed(x_q: torch.Tensor, w_q: torch.Tensor, *, shift: int) -> torch.Tensor:
    """int16 (M, C) . int16 (R, C)^T, wrapping int32 sum >> shift, saturated."""
    if x_q.device.type == "cpu":
        return gemv_k.gemv_pim_fixed_plain(x_q, w_q, shift=shift)
    return gemv_k.gemv_pim_fixed(x_q, w_q, shift=shift)


def pim_fixed_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
                     frac_x: int, frac_w: int,
                     act_table: LutTable | None = None) -> torch.Tensor:
    """The fixed16 linear layer: float x (M, C) and w (R, C) in Q(frac_x)
    and Q(frac_w), the fixed16 GEMV, dequantized to x's dtype, `+ b`, LUT."""
    kw = dict(frac_x=frac_x, frac_w=frac_w, act_table=act_table)
    if x.device.type == "cpu":
        return gemv_k.gemv_pim_fixed_linear_plain(x, w, b, **kw)
    return gemv_k.gemv_pim_fixed_linear(x, w, b, **kw)


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


def pim_decode_attention(q, k, v, length, k_scale=None, v_scale=None, *, scale=None,
                         exp_table: LutTable | None = None, softcap=None,
                         window=None) -> torch.Tensor:
    """Decode attention over a dense arena: q (B, H, D), k/v (B, Hkv, S, D);
    the int8 arena passes its (B, Hkv, S) bf16 scale rows."""
    kw = dict(scale=scale, exp_table=exp_table, softcap=softcap, window=window)
    if q.device.type == "cpu":
        return attn_k.decode_attention_plain(q, k, v, length, k_scale, v_scale, **kw)
    return attn_k.decode_attention(q, k, v, length, k_scale, v_scale, **kw)


def pim_layernorm(x, gamma, beta=None, *, eps: float = 1e-5,
                  rsqrt_table: LutTable | None = None, rms: bool = False,
                  plus_one: bool = False) -> torch.Tensor:
    """LayerNorm/RMSNorm over the last axis of x, LUT rsqrt with a table."""
    kw = dict(eps=eps, rsqrt_table=rsqrt_table, rms=rms, plus_one=plus_one)
    if x.device.type == "cpu":
        return ln_k.layernorm_lut_plain(x, gamma, beta, **kw)
    return ln_k.layernorm_lut(x, gamma, beta, **kw)


def pim_softmax(x: torch.Tensor, exp_table: LutTable, recip_table: LutTable, *,
                q_offset: int = 0, causal: bool = False,
                window: int | None = None) -> torch.Tensor:
    """Row softmax over the last axis by the LUT flow; `causal`/`window`
    mask queries at q_offset + i of the second-to-last axis."""
    kw = dict(q_offset=q_offset, causal=causal, window=window)
    if x.device.type == "cpu":
        return sm_k.softmax_lut_plain(x, exp_table, recip_table, **kw)
    return sm_k.softmax_lut(x, exp_table, recip_table, **kw)
