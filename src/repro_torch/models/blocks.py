"""Decoder blocks, cache-free (`apply_decoder_block`, the training
forward) and over the dense arena and the paged KV cache: norm wiring,
residuals and the per-family FFN (the port of `repro.models.blocks`, dense
and MoE families: `p["moe"]` through `moe.apply_moe`, else `p["ffn"]`).
cos/sin are RoPE's (None with learned positions), passed to the
attention."""
from __future__ import annotations

import torch

from repro_torch.core.salpim import SalPimEngine
from repro_torch.models import attention as attn_lib
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig


def init_norm(cfg: ModelConfig, ones, zeros, lead: tuple = ()) -> dict:
    """Norm parameters, with optional leading (layer) dims."""
    shape = (*lead, cfg.d_model)
    if cfg.norm == "layernorm":
        return {"g": ones(shape), "b": zeros(shape)}
    if cfg.norm == "rmsnorm_plus1":   # gemma: store (weight), apply 1 + w
        return {"g": zeros(shape)}
    return {"g": ones(shape)}


def apply_norm(p: dict, x: torch.Tensor, cfg: ModelConfig,
               engine: SalPimEngine) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return engine.layernorm(x, p["g"], p["b"], cfg.norm_eps)
    if cfg.norm == "rmsnorm_plus1":
        return engine.rmsnorm(x, p["g"], cfg.norm_eps, plus_one=True)
    return engine.rmsnorm(x, p["g"], cfg.norm_eps)


def _decode_block_skeleton(p, x, cfg, engine, attn_fn, rows=None):
    """Shared block: norm/attn/residual/ffn around `attn_fn`, which maps the
    normed hidden to (attn_out, *cache_outputs). `rows`: x is a mesh decode
    rank's rows (`moe.apply_moe`)."""
    h = apply_norm(p["ln1"], x, cfg, engine)
    res = attn_fn(h)
    h, cache_out = res[0], res[1:]
    if cfg.post_norms:
        h = apply_norm(p["post_ln1"], h, cfg, engine)
    x = x + h
    h = apply_norm(p["ln2"], x, cfg, engine)
    h = (moe_lib.apply_moe(p["moe"], h, cfg, engine, rows=rows) if cfg.family == "moe"
         else ffn_lib.apply_ffn(p["ffn"], h, cfg, engine))
    if cfg.post_norms:
        h = apply_norm(p["post_ln2"], h, cfg, engine)
    return (x + h, *cache_out)


def apply_decoder_block(p: dict, x: torch.Tensor, cfg: ModelConfig, engine: SalPimEngine,
                        *, cos=None, sin=None, window) -> torch.Tensor:
    """Full-sequence block with no cache (the teacher-forced forward):
    x (B, S, D) -> (B, S, D)."""
    return _decode_block_skeleton(
        p, x, cfg, engine,
        lambda h: (attn_lib.attention_fullseq(p["attn"], h, cfg, engine, cos=cos, sin=sin,
                                              window=window, causal=cfg.causal),))[0]


def apply_decoder_block_prefill_chunk_paged(
    p: dict, x: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    block_tables: torch.Tensor, start: torch.Tensor, length: torch.Tensor,
    cfg: ModelConfig, engine: SalPimEngine, *, cos=None, sin=None, window,
    kv_scales=None,
):
    """Prefill block over one prompt chunk against the paged pool.
    Returns (x', k_pages, v_pages[, k_scale, v_scale]); the pools are
    written in place. kv_scales: (k_scale, v_scale) of an int8/int4 pool."""
    ksc, vsc = kv_scales if kv_scales is not None else (None, None)
    return _decode_block_skeleton(
        p, x, cfg, engine,
        lambda h: attn_lib.attention_prefill_chunk_paged(
            p["attn"], h, k_pages, v_pages, block_tables, start, length,
            cfg, engine, cos=cos, sin=sin, window=window, k_scale=ksc, v_scale=vsc))


def apply_decoder_block_decode_paged(
    p: dict, x: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    block_tables: torch.Tensor, lengths: torch.Tensor, cfg: ModelConfig,
    engine: SalPimEngine, *, cos=None, sin=None, window, kv_scales=None,
):
    """Single-token step against a paged cache. Returns (x', k', v'[,
    k_scale', v_scale'])."""
    ksc, vsc = kv_scales if kv_scales is not None else (None, None)
    return _decode_block_skeleton(
        p, x, cfg, engine,
        lambda h: attn_lib.attention_decode_paged(
            p["attn"], h, k_pages, v_pages, block_tables, lengths, cfg,
            engine, cos=cos, sin=sin, window=window, k_scale=ksc, v_scale=vsc))


def apply_decoder_block_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig,
                                engine: SalPimEngine, *, cos=None, sin=None, window):
    """Full-sequence block that also returns (k, v) (B, Hkv, S, Dh) for
    the dense arena."""
    return _decode_block_skeleton(
        p, x, cfg, engine,
        lambda h: attn_lib.attention_fullseq(p["attn"], h, cfg, engine, cos=cos, sin=sin,
                                             window=window, causal=cfg.causal,
                                             return_kv=True))


def apply_decoder_block_decode(p: dict, x: torch.Tensor, cache_k: torch.Tensor,
                               cache_v: torch.Tensor, lengths: torch.Tensor,
                               cfg: ModelConfig, engine: SalPimEngine, *, cos=None,
                               sin=None, window, kv_scales=None, split=None):
    """Single-token step against the dense arena. Returns (x', k', v'[,
    k_scale', v_scale']); the arena is written in place. `split`: the arena
    is a rank's shard (`attention.attention_decode`)."""
    return _decode_block_skeleton(
        p, x, cfg, engine,
        lambda h: attn_lib.attention_decode(p["attn"], h, cache_k, cache_v, lengths,
                                            cfg, engine, cos=cos, sin=sin, window=window,
                                            kv_scales=kv_scales, split=split),
        rows=split)
