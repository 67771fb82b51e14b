"""Chunked paged prefill attention over a block-table KV pool.

`paged_prefill_attention` launches the CUDA kernel `csrc/paged_prefill.cu`,
which replaces the TPU kernel
`src/repro/kernels/paged_prefill.py::paged_prefill_attention`;
`paged_prefill_attention_plain` is its plain PyTorch version, the twin of
the JAX oracle `repro.kernels.ref.paged_prefill_attention_ref`.

q (B, Sq, H, D) holds one prompt chunk per sequence at absolute positions
start[b] .. start[b] + Sq - 1; the pools already hold every key in
[0, length[b]), the chunk's own included. Queries attend causally at
their absolute positions. The pools take the formats of
`paged_attention` (q's dtype, int8 with f32/bf16 scale rows, packed int4
with bf16 scale rows). Optional LUT exp, softcap and sliding window.

`paged_prefill_attention_online_plain` is the page-ordered online softmax
that the kernel and the TPU kernel compute in LUT mode, in plain PyTorch.

The kernel and both plain versions keep every sum in fp64 (a LUT is
evaluated in fp32 on its argument rounded to fp32, and the output is
rounded to fp32, then to q's dtype), so the kernel's output is the plain
version's bit for bit in practice: a quantized datapath's first logits
then stay those of the plain path over any depth.

Bound on the H100: the valid K and V bytes over 3.35 TB/s at the engine's
chunk sizes; the note in `csrc/paged_prefill.cu` gives the design.
"""
from __future__ import annotations

import torch

from repro_torch.core.lut import LutTable
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import (
    _DTYPE_CODE, _exp, _fn, _mask_args, _stream, check_paged_args,
    gather_paged_kv, online_walk, ptr)


def _f32(x: float | None) -> float | None:
    """x rounded to fp32, as the kernel takes its scale and softcap."""
    return None if x is None else float(torch.tensor(x, dtype=torch.float32))


def paged_prefill_attention_plain(q, k_pages, v_pages, block_tables, length,
                                  start, k_scales=None, v_scales=None, *,
                                  scale: float | None = None,
                                  exp_table: LutTable | None = None,
                                  softcap: float | None = None,
                                  window: int | None = None) -> torch.Tensor:
    """Plain version (mirrors `paged_prefill_attention_ref`), in fp64 on
    K and V dequantized in fp32, as the kernel: the LUT exp in fp32 on its
    argument rounded to fp32, the output rounded to fp32, then q's dtype."""
    B, Sq, H, D = q.shape
    # (B, Hkv, S, D) -> seq-major (B, S, Hkv, D), the dense prefill layout.
    k = gather_paged_kv(k_pages, block_tables, k_scales, D).float().double().transpose(1, 2)
    v = gather_paged_kv(v_pages, block_tables, v_scales, D).float().double().transpose(1, 2)
    S, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = _f32(scale if scale is not None else 1.0 / (D ** 0.5))
    softcap = _f32(softcap)
    qg = q.float().double().reshape(B, Sq, Hkv, g, D)
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
    x = scores - m
    e = _exp(x, None) if exp_table is None else _exp(x.float(), exp_table).double()
    e = torch.where(mask_b, e, 0.0)
    s = torch.sum(e, dim=-1, keepdim=True)
    probs = e * (1.0 / torch.clamp(s, min=1e-9))
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, H, D).float().to(q.dtype)


def paged_prefill_attention_online_plain(q, k_pages, v_pages, block_tables, length,
                                         start, k_scales=None, v_scales=None, *,
                                         scale: float | None = None,
                                         exp_table: LutTable | None = None,
                                         softcap: float | None = None,
                                         window: int | None = None) -> torch.Tensor:
    """`online_walk` for a prefill chunk: q (B, Sq, H, D) at positions
    start .. start + Sq - 1 over the gathered, dequantized pages, one walk
    over the whole table, in fp64 as the kernel -> (B, Sq, H, D) f32
    (rounded from fp64). In LUT mode the function the kernels and the TPU
    kernel compute."""
    B, Sq, H, D = q.shape
    Hkv, page = k_pages.shape[1], k_pages.shape[2]
    g = H // Hkv
    kd = gather_paged_kv(k_pages, block_tables, k_scales, D).float().double()
    vd = gather_paged_kv(v_pages, block_tables, v_scales, D).float().double()
    rows = q.float().double().reshape(B, Sq, Hkv, g, D).permute(0, 2, 1, 3, 4).reshape(
        B, Hkv, Sq * g, D)
    qpos = start.long()[:, None] + torch.arange(Sq * g, device=q.device)[None] // g
    out = online_walk(rows, kd, vd, qpos, length, page, 1,
                      scale=_f32(scale if scale is not None else D ** -0.5),
                      exp_table=exp_table, softcap=_f32(softcap), window=window)
    return out.reshape(B, Hkv, Sq, g, D).permute(0, 2, 1, 3, 4).reshape(B, Sq, H, D).float()


def paged_prefill_attention(q, k_pages, v_pages, block_tables, length, start,
                            k_scales=None, v_scales=None, *,
                            scale: float | None = None,
                            exp_table: LutTable | None = None,
                            softcap: float | None = None,
                            window: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: q (B, Sq, H, D) -> out (B, Sq, H, D)."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, Sq, H, D), got {tuple(q.shape)}")
    fmt = check_paged_args("paged_prefill_attention", q, k_pages, v_pages,
                           block_tables, [("length", length), ("start", start)],
                           k_scales, v_scales, exp_table, window, softcap)
    B, Sq, H, D = q.shape
    P, Hkv, page, _ = k_pages.shape
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    wb, masks = _mask_args(D, scale, softcap, window, exp_table, q.device)
    lib = _build.library("paged_prefill")
    rc = _fn(lib, "paged_prefill_attention", "p" * 10 + "i" * 8 + "ffiiffiii" + "p")(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ptr(k_scales), ptr(v_scales),
        block_tables.data_ptr(), length.data_ptr(), start.data_ptr(), wb, out.data_ptr(),
        B, Sq, H, Hkv, D, page, P, block_tables.shape[1], *masks, _DTYPE_CODE[q.dtype], fmt,
        _stream(q))
    _build.check(lib, "paged_prefill", rc)
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
