"""Paged multi-head attention, prefill-chunk and decode forms (the port of
`repro.models.attention`, without the mesh branch and without RoPE, which
GPT-2's learned positions do not use)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.salpim import SalPimEngine
from repro_torch.models.config import ModelConfig
from repro_torch.serving import kvcache


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
                engine: SalPimEngine):
    """x (B, D) -> q (B, H, Dh), k/v (B, Hkv, Dh)."""
    B, _ = x.shape
    q = engine.linear(x, p["wq"], p.get("bq")).reshape(B, cfg.n_heads, cfg.head_dim)
    k = engine.linear(x, p["wk"], p.get("bk")).reshape(B, cfg.n_kv_heads, cfg.head_dim)
    v = engine.linear(x, p["wv"], p.get("bv")).reshape(B, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _scale(cfg: ModelConfig) -> float:
    return cfg.attn_scale if cfg.attn_scale is not None else cfg.head_dim ** -0.5


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
    window: Optional[int],
    k_scale: Optional[torch.Tensor] = None,   # (P, Hkv, page) int8/int4 scale rows
    v_scale: Optional[torch.Tensor] = None,
):
    """Write the chunk's K/V into its pool pages (in place; quantized with
    its scale rows in an int8/int4 pool), then attend over all resident KV
    [0, start+S) read back through the block table, the chunk's own
    included. Returns (out, k_pages, v_pages), plus (k_scale, v_scale)
    when the pool is quantized."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, engine)
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
    window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,   # (P, Hkv, page) int8/int4 scale rows
    v_scale: Optional[torch.Tensor] = None,
):
    """One decode step against a paged cache: append each slot's K/V at its
    length (in place; quantized in an int8/int4 pool), attend over
    length + 1 keys. Returns (out, k_pages, v_pages), plus
    (k_scale, v_scale) when the pool is quantized."""
    B, _ = x.shape
    q, k, v = _decode_qkv(p, x, cfg, engine)
    pools = kvcache.append_kv_pages(k_pages, v_pages, block_tables, lengths,
                                    k, v, k_scale, v_scale)
    att = engine.paged_decode_attention(
        q, k_pages, v_pages, block_tables, lengths + 1, k_scale, v_scale,
        scale=_scale(cfg), softcap=cfg.attn_softcap, window=window)
    out = engine.linear(att.reshape(B, -1), p["wo"])
    return (out, *pools)
