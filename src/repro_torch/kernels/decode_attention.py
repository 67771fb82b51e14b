"""Decode attention over a dense per-slot KV arena.

`decode_attention` launches the CUDA kernel `csrc/decode_attention.cu`,
which replaces the TPU kernel
`src/repro/kernels/decode_attention.py::decode_attention`;
`decode_attention_plain` is its plain PyTorch version, the twin of the JAX
oracle `repro.kernels.ref.decode_attention_ref` (one masked softmax over
all keys), and `decode_attention_online_plain` walks the keys in blocks of
256 with the TPU kernel's online softmax, the function the LUT-mode kernel
computes (LUT(a) LUT(b) != LUT(a + b), so the two LUT forms differ).

q (B, H, D) holds one query per sequence; k and v (B, Hkv, S, D) are the
arena of q's dtype, or the int8 arena with (B, Hkv, S) bf16 scale rows
`k_scale`/`v_scale`, read as `k.to(q.dtype) * k_scale[..., None].to(q.dtype)`
(the JAX package's eager dequantization, which the plain versions run and
the kernel matches bit for bit in registers); length (B,) counts the valid
keys. GQA: g = H // Hkv query heads share one K/V stream. Optional LUT exp
(`exp_table`), softcap and sliding window (key p valid when length - window
<= p < length).

Bound on the H100: the valid K and V bytes over 3.35 TB/s; the kernel is
the paged single walk's design over 256-key blocks of the arena
(`csrc/decode_walk.cuh`), planned by `paged_attention.arena_plan`.

`decode_attention_partials` is the same walk over one rank's slice of an
arena sharded along the sequence (the mesh decode's distributed
flash-decode): local key j is at position `key_offset + j`, the lengths and
the window are the whole arena's, and it returns the raw f32 online-softmax
partials m (B, H, 1), l (B, H, 1) and acc (B, H, D), with m = -inf, l = 0
and acc = 0 where the slice holds no valid key, for
`distributed.collectives.merge_partial_softmax` to merge across the ranks.
`decode_attention_partials_plain` is its plain version, the blocks of
`decode_attention_online_plain` in the same order, every row at once (no
read of the lengths on the host, so it also runs on `meta` tensors).
"""
from __future__ import annotations

import torch

from repro_torch.core import lut as lut_lib
from repro_torch.core.lut import LutTable
from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODE as _DTYPE_CODE

NEG_INF = -1e30
BLOCK_S = 256


def _exp(x: torch.Tensor, exp_table: LutTable | None) -> torch.Tensor:
    return lut_lib.apply_table(x, exp_table) if exp_table is not None else torch.exp(x)


def dequantize_arena(q, k, v, k_scale, v_scale):
    """k, v as the kernels read them: the int8 arena times its scale rows
    in q's dtype (unchanged without scale rows)."""
    if k_scale is None:
        return k, v
    return (k.to(q.dtype) * k_scale[..., None].to(q.dtype),
            v.to(q.dtype) * v_scale[..., None].to(q.dtype))


def decode_attention_plain(q, k, v, length, k_scale=None, v_scale=None, *,
                           scale: float | None = None,
                           exp_table: LutTable | None = None,
                           softcap: float | None = None,
                           window: int | None = None) -> torch.Tensor:
    """Plain version (mirrors `ref.decode_attention_ref` on the dequantized
    arena)."""
    k, v = dequantize_arena(q, k, v, k_scale, v_scale)
    B, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    qf = q.float().reshape(B, Hkv, g, D)
    scores = torch.einsum("bhgd,bhsd->bhgs", qf, k.float()) * scale
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
    e = torch.where(mask_b, _exp(scores - m, exp_table), 0.0)
    l = torch.sum(e, dim=-1, keepdim=True)
    inv = 1.0 / torch.clamp(l, min=1e-9)
    out = torch.einsum("bhgs,bhsd->bhgd", e * inv, v.float())
    return out.reshape(B, H, D).to(q.dtype)


def decode_attention_online_plain(q, k, v, length, k_scale=None, v_scale=None, *,
                                  scale: float | None = None,
                                  exp_table: LutTable | None = None,
                                  softcap: float | None = None,
                                  window: int | None = None) -> torch.Tensor:
    """The kernel's online softmax in plain PyTorch: per sequence, the
    blocks of BLOCK_S keys that hold a valid key, in order, with corr =
    exp(m_prev - m_new) or LUT(max(m_prev - m_new, lo)), then
    acc / max(l, 1e-9). Reads each length on the host."""
    k, v = dequantize_arena(q, k, v, k_scale, v_scale)
    B, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    qf = q.float().reshape(B, Hkv, g, D)
    out = torch.zeros((B, Hkv, g, D), dtype=torch.float32, device=q.device)
    for b, n in enumerate(length.reshape(-1).expand(B).tolist()):
        hi = max(0, min(n, S))
        lo = max(0, n - window) if window is not None else 0
        m = torch.full((Hkv, g, 1), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((Hkv, g, D), device=q.device)
        for s0 in range(lo // BLOCK_S * BLOCK_S, hi, BLOCK_S):
            kb, vb = k[b, :, s0:s0 + BLOCK_S].float(), v[b, :, s0:s0 + BLOCK_S].float()
            sc = torch.einsum("hgd,hkd->hgk", qf[b], kb) * scale
            if softcap is not None:
                sc = softcap * torch.tanh(sc / softcap)
            pos = s0 + torch.arange(kb.shape[1], device=q.device)
            mask = (pos >= lo) & (pos < hi)
            sc = torch.where(mask, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            if exp_table is not None:
                p = lut_lib.apply_table(sc - m_new, exp_table)
                corr = lut_lib.apply_table(torch.clamp(m - m_new, min=exp_table.lo),
                                           exp_table)
            else:
                p, corr = torch.exp(sc - m_new), torch.exp(m - m_new)
            p = torch.where(mask, p, 0.0)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + torch.einsum("hgk,hkd->hgd", p, vb)
            m = m_new
        out[b] = acc / torch.clamp(l, min=1e-9)
    return out.reshape(B, H, D).to(q.dtype)


def decode_attention_partials_plain(q, k, v, length, k_scale=None, v_scale=None, *,
                                    key_offset: int, scale: float | None = None,
                                    exp_table: LutTable | None = None,
                                    softcap: float | None = None,
                                    window: int | None = None):
    """The partials of a slice in plain PyTorch: the blocks of BLOCK_S
    local keys that hold a valid key, in order, as
    `decode_attention_online_plain` walks them (a block with none leaves
    m, l and acc as they were); key j valid when key_offset + j < length
    and, with a window, key_offset + j >= length - window. Returns (m, l,
    acc) in f32, m = -inf where the slice holds no valid key."""
    k, v = dequantize_arena(q, k, v, k_scale, v_scale)
    B, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    qf = q.float().reshape(B, Hkv, g, D)
    lens = length.long().reshape(-1).expand(B)
    hi = (lens - key_offset).clamp(0, S)
    lo = ((lens - window - key_offset).clamp(min=0) if window is not None
          else torch.zeros_like(lens))
    m = torch.full((B, Hkv, g, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, g, D), device=q.device)
    for s0 in range(0, S, BLOCK_S):
        kb, vb = k[:, :, s0:s0 + BLOCK_S].float(), v[:, :, s0:s0 + BLOCK_S].float()
        sc = torch.einsum("bhgd,bhkd->bhgk", qf, kb) * scale
        if softcap is not None:
            sc = softcap * torch.tanh(sc / softcap)
        pos = s0 + torch.arange(kb.shape[2], device=q.device)
        mask = (pos[None, :] >= lo[:, None]) & (pos[None, :] < hi[:, None])
        mask_b = mask[:, None, None, :]
        sc = torch.where(mask_b, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        if exp_table is not None:
            p = lut_lib.apply_table(sc - m_new, exp_table)
            corr = lut_lib.apply_table(torch.clamp(m - m_new, min=exp_table.lo), exp_table)
        else:
            p, corr = torch.exp(sc - m_new), torch.exp(m - m_new)
        p = torch.where(mask_b, p, 0.0)
        live = mask.any(-1)[:, None, None, None]
        l = torch.where(live, l * corr + p.sum(-1, keepdim=True), l)
        acc = torch.where(live, acc * corr + torch.einsum("bhgk,bhkd->bhgd", p, vb), acc)
        m = torch.where(live, m_new, m)
    m = torch.where(m <= NEG_INF, -torch.inf, m)
    return m.reshape(B, H, 1), l.reshape(B, H, 1), acc.reshape(B, H, D)


def _checked(name, q, k, v, length, k_scale, v_scale, exp_table, softcap, window):
    """The checks of both launches; returns fmt (1: the int8 arena)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, H, D) and k, v (B, Hkv, S, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k and v must be ({B}, Hkv, S, {D}), got {tuple(k.shape)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: pass both k_scale and v_scale or neither")
    fmt = int(k_scale is not None)
    arena_dtype = torch.int8 if fmt else q.dtype
    for tname, t in (("k", k), ("v", v)):
        if t.dtype != arena_dtype or t.device != q.device:
            raise ValueError(f"{tname} must be {arena_dtype} on {q.device}")
    scales = []
    if fmt:
        for tname, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (tuple(t.shape) != (B, Hkv, S) or t.dtype != torch.bfloat16
                    or t.device != q.device):
                raise ValueError(f"{tname} must be ({B}, {Hkv}, {S}) bfloat16 on {q.device}")
        scales = [("k_scale", k_scale), ("v_scale", v_scale)]
    if tuple(length.shape) != (B,) or length.dtype != torch.int32 \
            or length.device != q.device:
        raise ValueError(f"length must be ({B},) int32 on {q.device}")
    for tname, t in [("q", q), ("k", k), ("v", v), ("length", length)] + scales:
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")
    if H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    _build.check_table(exp_table)
    return fmt


def _launch_args(q, k, exp_table, plan, plan_kv_heads):
    """(cluster, window blocks) and the LUT table's arguments. The int8
    arena is planned, and staged, as the arena of q's dtype: the same walk,
    so the same sums. `plan_kv_heads` plans on a model's KV heads where q
    and the arena hold a rank's (the one-device walk's sums)."""
    from repro_torch.kernels.paged_attention import arena_plan
    B, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    cluster, win = plan or arena_plan(B, plan_kv_heads or Hkv, S, H // Hkv, D,
                                      D * q.element_size())
    if exp_table is None:
        lut = (None, -1.0, 1.0, 1)
    else:
        lut = (exp_table.wb_on(q.device), exp_table.lo, exp_table.inv_step, exp_table.sections)
    return cluster, win, lut


def decode_attention(q, k, v, length, k_scale=None, v_scale=None, *,
                     scale: float | None = None,
                     exp_table: LutTable | None = None,
                     softcap: float | None = None,
                     window: int | None = None,
                     plan: tuple[int, int] | None = None,
                     plan_kv_heads: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: q (B, H, D) -> out (B, H, D) in q.dtype.
    `plan` (cluster, window blocks) replaces `arena_plan`'s
    (scripts/sweep_clusters.py; the C entry checks it)."""
    fmt = _checked("decode_attention", q, k, v, length, k_scale, v_scale, exp_table, softcap,
                   window)
    B, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if B == 0 or S == 0:
        return torch.zeros_like(q)
    cluster, win, (wb, lo, inv_step, sections) = _launch_args(q, k, exp_table, plan,
                                                             plan_kv_heads)
    out = torch.empty_like(q)
    lib = _build.library("decode_attention")
    rc = _build.cfunc(lib, "decode_attention", "p" * 8 + "i" * 5 + "ffiiffiiiii" + "p")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(k_scale), _build.ptr(v_scale),
        length.data_ptr(), _build.ptr(wb), out.data_ptr(), B, H, Hkv, S, D,
        scale if scale is not None else 1.0 / (D ** 0.5),
        softcap if softcap is not None else 0.0, window if window is not None else 0,
        int(exp_table is not None), lo, inv_step, sections, _DTYPE_CODE[q.dtype], fmt,
        cluster, win, _build.stream(q))
    _build.check(lib, "decode_attention", rc)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_partials(q, k, v, length, k_scale=None, v_scale=None, *,
                              key_offset: int, scale: float | None = None,
                              exp_table: LutTable | None = None,
                              softcap: float | None = None,
                              window: int | None = None):
    """Launch the CUDA kernel over a slice of the arena whose local key 0
    is at position key_offset: q (B, H, D) -> (m (B, H, 1), l (B, H, 1),
    acc (B, H, D)) in f32 (see the module's docstring)."""
    _checked("decode_attention_partials", q, k, v, length, k_scale, v_scale, exp_table,
             softcap, window)
    fmt = int(k_scale is not None)
    if key_offset < 0:
        raise ValueError(f"key_offset must be >= 0, got {key_offset}")
    B, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    m = torch.full((B, H, 1), -torch.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    if B == 0 or S == 0:
        return m, l, acc
    cluster, win, (wb, lo, inv_step, sections) = _launch_args(q, k, exp_table, None, None)
    lib = _build.library("decode_attention")
    rc = _build.cfunc(lib, "decode_attention_partials",
                      "p" * 10 + "i" * 6 + "ffiiffiiiii" + "p")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _build.ptr(k_scale), _build.ptr(v_scale),
        length.data_ptr(), _build.ptr(wb), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        B, H, Hkv, S, D, int(key_offset),
        scale if scale is not None else 1.0 / (D ** 0.5),
        softcap if softcap is not None else 0.0, window if window is not None else 0,
        int(exp_table is not None), lo, inv_step, sections, _DTYPE_CODE[q.dtype], fmt,
        cluster, win, _build.stream(q))
    _build.check(lib, "decode_attention", rc)
    decode_attention_partials.launches += 1
    return m, l, acc


decode_attention_partials.launches = 0
