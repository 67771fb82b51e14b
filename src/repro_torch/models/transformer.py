"""Decoder-only LM over the dense per-slot KV arena (`Cache`: `prefill`,
`decode_step`) and over a paged KV cache (`prefill_chunk`,
`verify_tokens`, the paged `decode_step`): the port of the dense family of `repro.models.transformer`.

Parameters are a plain dict with the JAX pytree's keys; each block weight
is stacked on a leading layer axis, and a Python loop over layers takes the
place of `lax.scan`. Each layer gets `cfg.window_for_layer(i)` (None for
global attention) where the JAX scan passes a traced sentinel width.

Positions are learned (`pos_embed`, GPT-2) or rotary: each entry point
computes RoPE's cos/sin once (`_rope`: over arange(S) for the dense
prefill, start + arange(S) per sequence for a paged chunk, the cache
lengths for a decode step) and every layer rotates its q and k with them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.salpim import SalPimEngine
from repro_torch.models import attention as attn_lib
from repro_torch.models import blocks as blk
from repro_torch.models import ffn as ffn_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.rope import rope_cos_sin
from repro_torch.serving.kvcache import PagedCache
from repro_torch.serving.quantize import QTensor, quantize_vec


@dataclasses.dataclass
class Cache:
    """Decode-time state over the dense per-slot arena.

    lengths:          (B,) int32                valid tokens per sequence
    k, v:             (L, B, Hkv, Smax, Dh)     the compute dtype, or int8
    k_scale, v_scale: (L, B, Hkv, Smax) bf16    dequant scales of the int8
                                                arena (cfg.kv_dtype "int8")
    """

    lengths: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    if cfg.mrope_sections is not None:
        raise NotImplementedError("M-RoPE (the VLM path) is not ported yet")


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> dict:
    """Random weights with the JAX package's stds, drawn from a
    torch.Generator seeded with `seed` (not JAX's numbers)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (x * std).to(cfg.pdtype)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=cfg.pdtype)

    def zeros(shape):
        return torch.zeros(shape, device=dev, dtype=cfg.pdtype)

    d, L = cfg.d_model, cfg.n_layers
    p = {
        "embed": normal((cfg.vocab, d), 0.02),
        "final_norm": blk.init_norm(cfg, ones, zeros),
        "lm_head": normal((cfg.vocab, d), d ** -0.5),
    }
    if cfg.learned_pos_emb:
        p["pos_embed"] = normal((cfg.max_seq, d), 0.02)
    blocks = {
        "ln1": blk.init_norm(cfg, ones, zeros, (L,)),
        "attn": attn_lib.init_attention(normal, zeros, cfg, L),
        "ln2": blk.init_norm(cfg, ones, zeros, (L,)),
        "ffn": ffn_lib.init_ffn(normal, cfg, L),
    }
    if cfg.post_norms:
        blocks["post_ln1"] = blk.init_norm(cfg, ones, zeros, (L,))
        blocks["post_ln2"] = blk.init_norm(cfg, ones, zeros, (L,))
    p["blocks"] = blocks
    return p


def _layers(blocks: dict, n_layers: int) -> list[dict]:
    """Stacked block params -> one dict of views per layer (a stacked
    QTensor of int8 serving splits into per-layer QTensors)."""
    def unbind(tree):
        if isinstance(tree, dict):
            parts = {k: unbind(v) for k, v in tree.items()}
            return [{k: parts[k][i] for k in parts} for i in range(n_layers)]
        if isinstance(tree, QTensor):
            return tree.unbind()
        return torch.unbind(tree, 0)
    return unbind(blocks)


def _rope(cfg: ModelConfig, positions: torch.Tensor):
    """positions (...,) -> cos/sin (..., Dh/2), (None, None) with learned
    positions (M-RoPE is refused by `_check_supported`)."""
    if cfg.learned_pos_emb:
        return None, None
    return rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)


def _embed(p: dict, tokens: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor) -> torch.Tensor:
    x = p["embed"][tokens.long()].to(cfg.cdtype)
    if cfg.embed_scale:
        # The JAX package rounds the scale to the compute dtype first.
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype))
    if cfg.learned_pos_emb:
        # A verify pass's padded rows can run past max_seq; they read the
        # last row (their logits and K/V are never used).
        pos = positions.long().clamp_max(p["pos_embed"].shape[0] - 1)
        x = x + p["pos_embed"][pos].to(cfg.cdtype)
    return x


def _logits(p: dict, x: torch.Tensor, cfg: ModelConfig,
            engine: SalPimEngine) -> torch.Tensor:
    x = blk.apply_norm(p["final_norm"], x, cfg, engine)
    logits = engine.linear(x, p["lm_head"])
    if cfg.final_softcap is not None:
        logits = engine.nl.softcap(logits.float(), cfg.final_softcap)
    return logits


def _check_scales(k_pages: torch.Tensor, k_scales) -> None:
    if k_pages.dtype == torch.int8 and k_scales is None:
        # Without this the fp write would cast float K/V to int8: garbage
        # instead of a quantized write (int4 pools are int8 too).
        raise ValueError("int8 page pools need their scale pools: pass "
                         "k_scales/v_scales from the PagedCache")


def _kv_scales(k_scales, v_scales, i: int):
    return (k_scales[i], v_scales[i]) if k_scales is not None else None


def _paged_chunk_forward(params: dict, tokens: torch.Tensor,
                         block_tables: torch.Tensor, start: torch.Tensor,
                         k_pages: torch.Tensor, v_pages: torch.Tensor,
                         cfg: ModelConfig, engine: SalPimEngine,
                         k_scales=None, v_scales=None) -> torch.Tensor:
    """Run tokens (B, S) at positions start..start+S-1 through the block
    stack, writing each layer's chunk K/V (and, for an int8/int4 pool, its
    scale rows in the (L, P, Hkv, page) scale pools) into its pages in
    place. Returns the hidden states (B, S, D)."""
    _check_supported(cfg)
    _check_scales(k_pages, k_scales)
    B, S = tokens.shape
    start = start.to(torch.int32)
    pos = start[:, None].long() + torch.arange(S, device=tokens.device)[None, :]
    x = _embed(params, tokens, cfg, pos)
    cos, sin = _rope(cfg, pos)
    length = start + S
    for i, bp in enumerate(_layers(params["blocks"], cfg.n_layers)):
        x, *_ = blk.apply_decoder_block_prefill_chunk_paged(
            bp, x, k_pages[i], v_pages[i], block_tables, start, length, cfg,
            engine, cos=cos, sin=sin, window=cfg.window_for_layer(i),
            kv_scales=_kv_scales(k_scales, v_scales, i))
    return x


def prefill_chunk(params: dict, tokens: torch.Tensor,
                  block_tables: torch.Tensor, start: torch.Tensor,
                  k_pages: torch.Tensor, v_pages: torch.Tensor,
                  cfg: ModelConfig, engine: SalPimEngine,
                  k_scales=None, v_scales=None):
    """One chunk of paged prefill, written directly into pool pages.

    tokens (B, S) are prompt positions start[b] .. start[b]+S-1 of B
    sequences whose earlier chunks' K/V already live in the pages mapped by
    block_tables (B, n_pages); the pools (L, P, Hkv, page, Dh) are updated
    in place. Returns (last-position logits (B, V), k_pages, v_pages);
    int8/int4 pools (k_scales/v_scales (L, P, Hkv, page) given) quantize
    each chunk at write time and return the 5-tuple with the scale pools.
    """
    x = _paged_chunk_forward(params, tokens, block_tables, start, k_pages,
                             v_pages, cfg, engine, k_scales, v_scales)
    logits = _logits(params, x[:, -1], cfg, engine)
    if k_scales is not None:
        return logits, k_pages, v_pages, k_scales, v_scales
    return logits, k_pages, v_pages


def verify_tokens(params: dict, tokens: torch.Tensor,
                  block_tables: torch.Tensor, start: torch.Tensor,
                  k_pages: torch.Tensor, v_pages: torch.Tensor,
                  cfg: ModelConfig, engine: SalPimEngine,
                  k_scales=None, v_scales=None):
    """Speculative verify pass: `prefill_chunk`'s forward with the LM head
    at all S positions. tokens (B, S = k+1) hold each slot's [t0, d1..dk]
    at positions start[b] .. start[b] + k; their K/V are written into the
    pages in place. Returns (logits (B, S, V), k_pages, v_pages[, k_scales,
    v_scales])."""
    x = _paged_chunk_forward(params, tokens, block_tables, start, k_pages,
                             v_pages, cfg, engine, k_scales, v_scales)
    logits = _logits(params, x, cfg, engine)
    if k_scales is not None:
        return logits, k_pages, v_pages, k_scales, v_scales
    return logits, k_pages, v_pages


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda") -> Cache:
    """Empty dense arena with room for max_len tokens a sequence; int8
    payload with bf16 scales when cfg.kv_dtype is "int8"."""
    _check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if cfg.kv_dtype == "int8":
        return Cache(lengths=lengths,
                     k=torch.zeros(shape, dtype=torch.int8, device=dev),
                     v=torch.zeros(shape, dtype=torch.int8, device=dev),
                     k_scale=torch.zeros(shape[:-1], dtype=torch.bfloat16, device=dev),
                     v_scale=torch.zeros(shape[:-1], dtype=torch.bfloat16, device=dev))
    return Cache(lengths=lengths, k=torch.zeros(shape, dtype=cfg.cdtype, device=dev),
                 v=torch.zeros(shape, dtype=cfg.cdtype, device=dev))


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            engine: SalPimEngine, *, max_len: int):
    """tokens (B, S) -> (last-position logits (B, V), a Cache of max_len
    positions holding the prompt's K/V, quantized in the int8 arena)."""
    _check_supported(cfg)
    B, S = tokens.shape
    if max_len < S:
        raise ValueError(f"max_len {max_len} is shorter than the prompt ({S})")
    pos = torch.arange(S, device=tokens.device)
    x = _embed(params, tokens, cfg, pos[None])
    cos, sin = _rope(cfg, pos)
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    cache.lengths.fill_(S)
    for i, bp in enumerate(_layers(params["blocks"], cfg.n_layers)):
        x, (k, v) = blk.apply_decoder_block_prefill(bp, x, cfg, engine, cos=cos, sin=sin,
                                                    window=cfg.window_for_layer(i))
        if cache.quantized:
            k, cache.k_scale[i, :, :, :S] = quantize_vec(k, torch.bfloat16)
            v, cache.v_scale[i, :, :, :S] = quantize_vec(v, torch.bfloat16)
        cache.k[i, :, :, :S] = k
        cache.v[i, :, :, :S] = v
    return _logits(params, x[:, -1], cfg, engine), cache


def _advance_lengths(lengths: torch.Tensor) -> torch.Tensor:
    """Advance only live sequences; released slots stay parked at 0."""
    return lengths + (lengths > 0).to(lengths.dtype)


def decode_step(params: dict, token: torch.Tensor, cache, cfg: ModelConfig,
                engine: SalPimEngine):
    """token (B,) -> (logits (B, V), cache with advanced lengths). `cache`
    is a dense `Cache` or a `PagedCache`; either is written in place."""
    if isinstance(cache, PagedCache):
        return _decode_step_paged(params, token, cache, cfg, engine)
    _check_supported(cfg)
    x = _embed(params, token[:, None], cfg, cache.lengths[:, None])[:, 0]
    cos, sin = _rope(cfg, cache.lengths)
    for i, bp in enumerate(_layers(params["blocks"], cfg.n_layers)):
        scales = (cache.k_scale[i], cache.v_scale[i]) if cache.quantized else None
        x, *_ = blk.apply_decoder_block_decode(
            bp, x, cache.k[i], cache.v[i], cache.lengths, cfg, engine, cos=cos, sin=sin,
            window=cfg.window_for_layer(i), kv_scales=scales)
    new_cache = dataclasses.replace(cache, lengths=_advance_lengths(cache.lengths))
    return _logits(params, x, cfg, engine), new_cache


def _decode_step_paged(params: dict, token: torch.Tensor, cache,
                       cfg: ModelConfig, engine: SalPimEngine):
    """token (B,) -> (logits (B, V), cache with advanced lengths). The pools
    (and an int8/int4 cache's scale pools) are updated in place; block
    tables are shared across layers."""
    _check_supported(cfg)
    _check_scales(cache.k_pages, cache.k_scale)
    x = _embed(params, token[:, None], cfg, cache.lengths[:, None])[:, 0]
    cos, sin = _rope(cfg, cache.lengths)
    for i, bp in enumerate(_layers(params["blocks"], cfg.n_layers)):
        x, *_ = blk.apply_decoder_block_decode_paged(
            bp, x, cache.k_pages[i], cache.v_pages[i], cache.block_tables,
            cache.lengths, cfg, engine, cos=cos, sin=sin, window=cfg.window_for_layer(i),
            kv_scales=_kv_scales(cache.k_scale, cache.v_scale, i))
    new_cache = dataclasses.replace(cache, lengths=_advance_lengths(cache.lengths))
    return _logits(params, x, cfg, engine), new_cache
