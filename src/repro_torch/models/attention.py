"""Multi-head attention, full-sequence and decode forms over the dense
per-slot arena, prefill-chunk and decode forms over the paged pools (the
port of `repro.models.attention`, without the mesh branch). With RoPE
(cos/sin given) q and k are rotated after the projection and before K is
returned or written to the arena or the pages.

The full-sequence form keeps the JAX package's two einsums (Q x K^T and
S x V over the same (B, S, Hkv, D) layout), outside any kernel as in the
JAX package; the softmax between them goes through the engine, the
`softmax_lut` kernel in LUT mode. Decode over the dense arena runs the
`decode_attention` kernel, which reads the int8 arena with its scale rows
itself, bit for bit as the JAX package's whole-arena dequantization before
the kernel (the plain version runs that dequantization)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.salpim import SalPimEngine
from repro_torch.models.config import ModelConfig
from repro_torch.models.rope import apply_rope
from repro_torch.serving import kvcache
from repro_torch.serving.quantize import quantize_vec


def init_attention(normal, zeros, cfg: ModelConfig, n_layers: int) -> dict:
    """Stacked (L, ...) attention weights with the JAX package's stds."""
    d = cfg.d_model
    n_q = cfg.n_heads * cfg.head_dim
    n_kv = cfg.n_kv_heads * cfg.head_dim
    L = n_layers
    p = {
        "wq": normal((L, n_q, d), d ** -0.5),
        "wk": normal((L, n_kv, d), d ** -0.5),
        "wv": normal((L, n_kv, d), d ** -0.5),
        "wo": normal((L, d, n_q), n_q ** -0.5),
    }
    if cfg.qkv_bias:
        p["bq"] = zeros((L, n_q))
        p["bk"] = zeros((L, n_kv))
        p["bv"] = zeros((L, n_kv))
    return p


def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 engine: SalPimEngine):
    """x (B, S, D) -> q (B, S, H, Dh), k/v (B, S, Hkv, Dh)."""
    B, S, _ = x.shape
    q = engine.linear(x, p["wq"], p.get("bq"))
    k = engine.linear(x, p["wk"], p.get("bk"))
    v = engine.linear(x, p["wv"], p.get("bv"))
    return (q.reshape(B, S, cfg.n_heads, cfg.head_dim),
            k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim),
            v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim))


def _decode_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig,
                engine: SalPimEngine, cos=None, sin=None):
    """x (B, D) -> q (B, H, Dh), k/v (B, Hkv, Dh), q and k rotated by
    cos/sin (B, Dh/2) when given."""
    B, _ = x.shape
    q = engine.linear(x, p["wq"], p.get("bq")).reshape(B, cfg.n_heads, cfg.head_dim)
    k = engine.linear(x, p["wk"], p.get("bk")).reshape(B, cfg.n_kv_heads, cfg.head_dim)
    v = engine.linear(x, p["wv"], p.get("bv")).reshape(B, cfg.n_kv_heads, cfg.head_dim)
    if cos is not None:
        q = apply_rope(q[:, None], cos[:, None], sin[:, None])[:, 0]
        k = apply_rope(k[:, None], cos[:, None], sin[:, None])[:, 0]
    return q, k, v


def _scale(cfg: ModelConfig) -> float:
    return cfg.attn_scale if cfg.attn_scale is not None else cfg.head_dim ** -0.5


def _masked_softmax_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         engine: SalPimEngine, cfg: ModelConfig, *, q_offset: int,
                         causal: bool, window: Optional[int]) -> torch.Tensor:
    """q (B, Sq, H, Dh) at positions q_offset.. against k/v (B, Sk, Hkv, Dh)
    -> (B, Sq, H, Dh): scores in f32, the engine's masked softmax, the
    probabilities cast to v's dtype for the S x V product."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    qg = q.reshape(B, Sq, Hkv, g, Dh)
    # Direction 1: contract head_dim (Q x K^T), no transpose of K.
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * _scale(cfg)
    if cfg.attn_softcap is not None:
        scores = engine.nl.softcap(scores, cfg.attn_softcap)
    probs = engine.attention_softmax(scores, q_offset=q_offset, causal=causal,
                                     window=window)
    # Direction 2: contract seq (S x V) over the same V layout.
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, Dh)


def attention_fullseq(p: dict, x: torch.Tensor, cfg: ModelConfig,
                      engine: SalPimEngine, *, cos=None, sin=None,
                      window: Optional[int] = None, causal: bool = True,
                      return_kv: bool = False):
    """x (B, S, D) -> out (B, S, D), and with return_kv the K/V (K
    rotated) in the arena layout (B, Hkv, S, Dh); cos/sin (S, Dh/2) or
    None. Queries run in chunks of cfg.attn_chunk when S is longer than
    and a multiple of it, as the JAX scan does."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, engine)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    chunk = cfg.attn_chunk
    if S > chunk and S % chunk == 0:
        out = torch.cat([
            _masked_softmax_attn(q[:, i:i + chunk], k, v, engine, cfg, q_offset=i,
                                 causal=causal, window=window)
            for i in range(0, S, chunk)], dim=1)
    else:
        out = _masked_softmax_attn(q, k, v, engine, cfg, q_offset=0, causal=causal,
                                   window=window)
    out = engine.linear(out.reshape(B, S, -1), p["wo"])
    if return_kv:
        return out, (k.transpose(1, 2), v.transpose(1, 2))
    return out


def attention_decode(
    p: dict,
    x: torch.Tensor,                 # (B, D) one new token per sequence
    cache_k: torch.Tensor,           # (B, Hkv, Smax, Dh) one layer's arena
    cache_v: torch.Tensor,
    lengths: torch.Tensor,           # (B,) int32 tokens already in cache
    cfg: ModelConfig,
    engine: SalPimEngine,
    *,
    cos: Optional[torch.Tensor] = None,  # (B, Dh/2) RoPE at each slot's length
    sin: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    kv_scales: Optional[tuple] = None,   # (k_scale, v_scale) (B, Hkv, Smax) bf16
):
    """One decode step against the dense arena: write each slot's K/V at
    its length (all at lengths[0] with cfg.decode_uniform), in place and,
    for the int8 arena, quantized with its bf16 scale; then attend over
    length + 1 keys. Returns (out, cache_k, cache_v[, k_scale, v_scale])."""
    B, _ = x.shape
    q, k, v = _decode_qkv(p, x, cfg, engine, cos, sin)
    int8_kv = kv_scales is not None
    if int8_kv:
        ksc, vsc = kv_scales
        (k_store, k_new_sc), (v_store, v_new_sc) = (quantize_vec(k, torch.bfloat16),
                                                    quantize_vec(v, torch.bfloat16))
        writes = [(cache_k, k_store), (cache_v, v_store), (ksc, k_new_sc),
                  (vsc, v_new_sc)]
    else:
        writes = [(cache_k, k), (cache_v, v)]
    if cfg.decode_uniform:
        pos = lengths[:1].long()
        for dst, src in writes:
            dst.index_copy_(2, pos, src[:, :, None].to(dst.dtype))
    else:
        b_idx = torch.arange(B, device=x.device)
        for dst, src in writes:
            dst[b_idx, :, lengths.long()] = src.to(dst.dtype)
    att = engine.decode_attention(q, cache_k, cache_v, lengths + 1,
                                  *(kv_scales if int8_kv else ()), scale=_scale(cfg),
                                  softcap=cfg.attn_softcap, window=window)
    out = engine.linear(att.reshape(B, -1), p["wo"])
    if int8_kv:
        return out, cache_k, cache_v, ksc, vsc
    return out, cache_k, cache_v


def attention_prefill_chunk_paged(
    p: dict,
    x: torch.Tensor,                 # (B, S, D) one prompt chunk per sequence
    k_pages: torch.Tensor,           # (P, Hkv, page, Dh) one layer's pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,      # (B, n_pages) int32
    start: torch.Tensor,             # (B,) int32 position of chunk token 0
    length: torch.Tensor,            # (B,) int32 valid KV after the chunk
    cfg: ModelConfig,
    engine: SalPimEngine,
    *,
    cos: Optional[torch.Tensor] = None,       # (B, S, Dh/2) RoPE at the chunk's positions
    sin: Optional[torch.Tensor] = None,
    window: Optional[int],
    k_scale: Optional[torch.Tensor] = None,   # (P, Hkv, page) int8/int4 scale rows
    v_scale: Optional[torch.Tensor] = None,
):
    """Write the chunk's K/V (K rotated) into its pool pages (in place; quantized with
    its scale rows in an int8/int4 pool), then attend over all resident KV
    [0, start+S) read back through the block table, the chunk's own
    included. Returns (out, k_pages, v_pages), plus (k_scale, v_scale)
    when the pool is quantized."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, engine)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    pools = kvcache.append_chunk_kv_pages(k_pages, v_pages, block_tables, start,
                                          k, v, k_scale, v_scale)
    att = engine.paged_prefill_attention(
        q, k_pages, v_pages, block_tables, length, start, k_scale, v_scale,
        scale=_scale(cfg), softcap=cfg.attn_softcap, window=window)
    out = engine.linear(att.reshape(B, S, -1), p["wo"])
    return (out, *pools)


def attention_decode_paged(
    p: dict,
    x: torch.Tensor,                 # (B, D) one new token per sequence
    k_pages: torch.Tensor,           # (P, Hkv, page, Dh) one layer's pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,      # (B, n_pages) int32
    lengths: torch.Tensor,           # (B,) int32 tokens already in cache
    cfg: ModelConfig,
    engine: SalPimEngine,
    *,
    cos: Optional[torch.Tensor] = None,       # (B, Dh/2) RoPE at each slot's length
    sin: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,   # (P, Hkv, page) int8/int4 scale rows
    v_scale: Optional[torch.Tensor] = None,
):
    """One decode step against a paged cache: append each slot's K/V at its
    length (in place; quantized in an int8/int4 pool), attend over
    length + 1 keys. Returns (out, k_pages, v_pages), plus
    (k_scale, v_scale) when the pool is quantized."""
    B, _ = x.shape
    q, k, v = _decode_qkv(p, x, cfg, engine, cos, sin)
    pools = kvcache.append_kv_pages(k_pages, v_pages, block_tables, lengths,
                                    k, v, k_scale, v_scale)
    att = engine.paged_decode_attention(
        q, k_pages, v_pages, block_tables, lengths + 1, k_scale, v_scale,
        scale=_scale(cfg), softcap=cfg.attn_softcap, window=window)
    out = engine.linear(att.reshape(B, -1), p["wo"])
    return (out, *pools)
