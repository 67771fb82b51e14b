"""Model API the serving engine and the tests use (the port of the dense
and paged entry points of `repro.models.api`).

    init_params(cfg, seed=0, device="cuda")
    prefill(params, {"tokens": tokens}, cfg, engine, max_len)
    init_cache(cfg, batch, max_len, device="cuda")
    prefill_chunk(params, tokens, block_tables, start, k_pages, v_pages, cfg, engine,
                  k_scales=None, v_scales=None)
    verify_tokens(params, tokens, block_tables, start, k_pages, v_pages, cfg, engine,
                  k_scales=None, v_scales=None)
    decode_step(params, token, cache, cfg, engine)
    init_paged_cache(cfg, batch, num_pages, page_size, max_pages, kv_dtype=None,
                     kv_scale_dtype="float32", device="cuda")
"""
from __future__ import annotations

import torch

from repro_torch.core.salpim import SalPimEngine
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.serving import kvcache


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> dict:
    return tf.init_params(cfg, seed=seed, device=device)


def prefill_chunk(params: dict, tokens: torch.Tensor,
                  block_tables: torch.Tensor, start: torch.Tensor,
                  k_pages: torch.Tensor, v_pages: torch.Tensor,
                  cfg: ModelConfig, engine: SalPimEngine,
                  k_scales=None, v_scales=None):
    """One chunk of paged prefill: tokens (B, S) at absolute positions
    start..start+S-1, K/V written into the pool pages in place, queries
    attending over all resident KV. Returns (last-position logits,
    k_pages, v_pages); int8/int4 pools pass their scale pools and get the
    5-tuple with them."""
    return tf.prefill_chunk(params, tokens, block_tables, start, k_pages,
                            v_pages, cfg, engine, k_scales, v_scales)


def verify_tokens(params: dict, tokens: torch.Tensor,
                  block_tables: torch.Tensor, start: torch.Tensor,
                  k_pages: torch.Tensor, v_pages: torch.Tensor,
                  cfg: ModelConfig, engine: SalPimEngine,
                  k_scales=None, v_scales=None):
    """Speculative verify pass: score each slot's k+1 candidate tokens
    [t0, d1..dk] at positions start..start+k in one paged-prefill-shaped
    forward, writing their K/V into the slot's pages in place. Returns
    (logits (B, k+1, V), k_pages, v_pages[, k_scales, v_scales]); the
    serving engine rolls rejected tail positions back in-pool."""
    if cfg.family == "encdec":
        raise ValueError("speculative verify unsupported for encdec")
    return tf.verify_tokens(params, tokens, block_tables, start, k_pages,
                            v_pages, cfg, engine, k_scales, v_scales)


def prefill(params: dict, batch: dict, cfg: ModelConfig, engine: SalPimEngine,
            max_len: int):
    """batch["tokens"] (B, S) -> (last-position logits (B, V), a dense
    `Cache` of max_len positions primed with the prompt)."""
    return tf.prefill(params, batch["tokens"], cfg, engine, max_len=max_len)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda") -> tf.Cache:
    """Empty dense arena (L, batch, Hkv, max_len, Dh); int8 with bf16
    scales when cfg.kv_dtype is "int8"."""
    return tf.init_cache(cfg, batch, max_len, device=device)


def decode_step(params: dict, token: torch.Tensor, cache, cfg: ModelConfig,
                engine: SalPimEngine):
    """token (B,) -> (logits (B, V), the dense `Cache` or `PagedCache` with
    advanced lengths)."""
    return tf.decode_step(params, token, cache, cfg, engine)


def init_paged_cache(cfg: ModelConfig, batch: int, num_pages: int,
                     page_size: int, max_pages: int,
                     kv_dtype: str | None = None,
                     kv_scale_dtype: str = "float32", *, device="cuda"):
    """Paged KV cache for the dense family (see serving/kvcache.py):
    kv_dtype None defers to cfg.kv_dtype ("model", "int8" or "int4")."""
    if cfg.family != "dense":
        raise NotImplementedError(f"paged cache for family {cfg.family!r}")
    return kvcache.init_paged_cache(
        cfg, batch, num_pages, page_size, max_pages,
        kv_dtype=kv_dtype if kv_dtype is not None else cfg.kv_dtype,
        kv_scale_dtype=kv_scale_dtype, device=device)
