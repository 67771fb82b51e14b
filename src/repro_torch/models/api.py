"""Model API the serving engine, the train loop and the tests use (the port
of `repro.models.api`; the SSM, hybrid and encoder-decoder families have
the dense entry points only, and the paged ones raise the reference's
ValueError for them).

    init_params(cfg, seed=0, device="cuda")
    loss_fn(params, batch, cfg, engine)          # train objective -> (loss, metrics)
    forward_logits(params, batch, cfg, engine)   # teacher-forced logits (B, S, V)
    prefill(params, {"tokens": tokens}, cfg, engine, max_len)
    prefill(params, {"tokens": tokens, "frames": frames}, ...)   # encdec
    init_cache(cfg, batch, max_len, device="cuda")
    prefill_chunk(params, tokens, block_tables, start, k_pages, v_pages, cfg, engine,
                  k_scales=None, v_scales=None, mesh=None)
    verify_tokens(params, tokens, block_tables, start, k_pages, v_pages, cfg, engine,
                  k_scales=None, v_scales=None, mesh=None)
    decode_step(params, token, cache, cfg, engine, mesh=None)
    init_paged_cache(cfg, batch, num_pages, page_size, max_pages, kv_dtype=None,
                     kv_scale_dtype="float32", device="cuda", mesh=None)

`mesh` (a `DeviceMesh`, on every rank of it) runs the paged entry points
tensor-parallel: the call runs under `distributed.api.use_mesh(mesh)`,
where each attention layer attends this rank's heads against its slice
of the pools and merges the heads by `collectives.gather_heads`, and an
MoE config with `moe_impl="shardmap"` runs its experts expert-parallel.
`decode_step(..., mesh=)` on a rank's shard of a dense cache
(`transformer.shard_cache`, by `cache_pspecs`) runs the mesh
decode of every family: the rank's rows, heads and sequence slice, the
sequence slices merged by `collectives.merge_partial_softmax`:

    shard = shard_cache(cache, mesh, seq_shard=B == 1)
    logits, shard = api.decode_step(params, token, shard, cfg, engine, mesh=mesh)
    whole = gather_cache(shard, mesh)

The VLM stub: when batch["patch_embeds"] (B, P, D) is given, it
overwrites the embeddings of the first P positions (`_splice_patches`,
training only: the serving entry points ignore it, as the reference's do).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.salpim import SalPimEngine
from repro_torch.distributed import api as dist_api
from repro_torch.distributed import sharding as shard_lib
from repro_torch.models import encdec
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.serving import kvcache


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> dict:
    if cfg.family == "encdec":
        return encdec.init_params(cfg, seed=seed, device=device)
    return tf.init_params(cfg, seed=seed, device=device)


def _splice_patches(batch: dict, x: torch.Tensor) -> torch.Tensor:
    """The first P positions of x (B, S, D) replaced by batch["patch_embeds"]
    (B, P, D) when it is given."""
    pe = batch.get("patch_embeds")
    if pe is None:
        return x
    return torch.cat([pe.to(x.dtype), x[:, pe.shape[1]:]], dim=1)


def _vlm_forward(params: dict, batch: dict, cfg: ModelConfig,
                 engine: SalPimEngine) -> torch.Tensor:
    params = shard_lib.use_params(params)
    tokens = batch["tokens"]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = _splice_patches(batch, tf._embed(params, tokens, cfg, pos[None]))
    cos, sin = tf._rope(cfg, pos)
    return tf._logits(params, tf.decoder_stack(params, x, cfg, engine, cos, sin), cfg, engine)


def forward_logits(params: dict, batch: dict, cfg: ModelConfig,
                   engine: SalPimEngine) -> torch.Tensor:
    """Teacher-forced logits (B, S, V) of a batch of tensors on the params'
    device: tokens, and frames (encdec) or patch_embeds (the VLM)."""
    if cfg.family == "encdec":
        return encdec.forward(params, batch["frames"], batch["tokens"], cfg, engine)
    if batch.get("patch_embeds") is not None:
        return _vlm_forward(params, batch, cfg, engine)
    return tf.forward(params, batch["tokens"], cfg, engine)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, engine: SalPimEngine):
    """The training objective: (masked mean NLL, metrics), as the reference's."""
    if cfg.family == "encdec":
        return encdec.loss_fn(params, batch, cfg, engine)
    if batch.get("patch_embeds") is not None:
        loss, _, _, mask, _ = tf.token_nll(_vlm_forward(params, batch, cfg, engine), batch)
        return loss, {"loss": loss.detach(), "tokens": mask.sum()}
    return tf.loss_fn(params, batch, cfg, engine)


def _under(mesh):
    """`use_mesh(mesh)` when a mesh is given; the current one stays else."""
    return dist_api.use_mesh(mesh) if mesh is not None else contextlib.nullcontext()


def prefill_chunk(params: dict, tokens: torch.Tensor,
                  block_tables: torch.Tensor, start: torch.Tensor,
                  k_pages: torch.Tensor, v_pages: torch.Tensor,
                  cfg: ModelConfig, engine: SalPimEngine,
                  k_scales=None, v_scales=None, *, mesh=None):
    """One chunk of paged prefill: tokens (B, S) at absolute positions
    start..start+S-1, K/V written into the pool pages in place, queries
    attending over all resident KV. Returns (last-position logits,
    k_pages, v_pages); int8/int4 pools pass their scale pools and get the
    5-tuple with them."""
    if cfg.family == "encdec":
        raise ValueError("paged prefill unsupported for encdec")
    with _under(mesh):
        return tf.prefill_chunk(params, tokens, block_tables, start, k_pages,
                                v_pages, cfg, engine, k_scales, v_scales)


def verify_tokens(params: dict, tokens: torch.Tensor,
                  block_tables: torch.Tensor, start: torch.Tensor,
                  k_pages: torch.Tensor, v_pages: torch.Tensor,
                  cfg: ModelConfig, engine: SalPimEngine,
                  k_scales=None, v_scales=None, *, mesh=None):
    """Speculative verify pass: score each slot's k+1 candidate tokens
    [t0, d1..dk] at positions start..start+k in one paged-prefill-shaped
    forward, writing their K/V into the slot's pages in place. Returns
    (logits (B, k+1, V), k_pages, v_pages[, k_scales, v_scales]); the
    serving engine rolls rejected tail positions back in-pool."""
    if cfg.family == "encdec":
        raise ValueError("speculative verify unsupported for encdec")
    with _under(mesh):
        return tf.verify_tokens(params, tokens, block_tables, start, k_pages,
                                v_pages, cfg, engine, k_scales, v_scales)


def prefill(params: dict, batch: dict, cfg: ModelConfig, engine: SalPimEngine,
            max_len: int):
    """batch["tokens"] (B, S) -> (last-position logits (B, V), a dense
    `Cache` of max_len positions primed with the prompt). The
    encoder-decoder family also takes batch["frames"] (B, enc_seq, D), the
    stub frontend's embeddings; other keys (the VLM's "patch_embeds") are
    ignored, as the reference's prefill ignores them."""
    if cfg.family == "encdec":
        return encdec.prefill(params, batch["frames"], batch["tokens"], cfg, engine,
                              max_len=max_len)
    return tf.prefill(params, batch["tokens"], cfg, engine, max_len=max_len)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda") -> tf.Cache:
    """Empty dense arena (L, batch, Hkv, max_len, Dh); int8 with bf16
    scales when cfg.kv_dtype is "int8"; the encoder-decoder's also holds
    its cross arenas (L, batch, Hkv, enc_seq, Dh)."""
    if cfg.family == "encdec":
        return encdec.init_cache(cfg, batch, max_len, device=device)
    return tf.init_cache(cfg, batch, max_len, device=device)


def decode_step(params: dict, token: torch.Tensor, cache, cfg: ModelConfig,
                engine: SalPimEngine, *, mesh=None):
    """token (B,) -> (logits (B, V), the dense `Cache` or `PagedCache` with
    advanced lengths). On a `mesh`, a dense cache that is this rank's shard
    (`transformer.shard_cache`) runs the mesh decode
    (`transformer.decode_step`): token whole, the logits gathered whole, the
    rank's shard returned; a whole dense cache runs whole on every rank."""
    with _under(mesh):
        if cfg.family == "encdec":
            return encdec.decode_step(params, token, cache, cfg, engine)
        return tf.decode_step(params, token, cache, cfg, engine)


def init_paged_cache(cfg: ModelConfig, batch: int, num_pages: int,
                     page_size: int, max_pages: int,
                     kv_dtype: str | None = None,
                     kv_scale_dtype: str = "float32", *, device="cuda", mesh=None):
    """Paged KV cache for the dense and MoE families (see
    serving/kvcache.py): kv_dtype None defers to cfg.kv_dtype ("model",
    "int8" or "int4"); on a `mesh` it holds this rank's KV heads. The
    SSM, hybrid and encoder-decoder families serve on the dense cache
    alone and raise the reference's ValueError."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"paged cache unsupported for family {cfg.family!r}")
    return kvcache.init_paged_cache(
        cfg, batch, num_pages, page_size, max_pages,
        kv_dtype=kv_dtype if kv_dtype is not None else cfg.kv_dtype,
        kv_scale_dtype=kv_scale_dtype, device=device, mesh=mesh)
