"""Decoder-only LM: the teacher-forced forward and its loss (`forward`,
`loss_fn`, the training objective), over the dense per-slot cache
(`Cache`: `prefill`, `decode_step`) and over a paged KV cache
(`prefill_chunk`, `verify_tokens`, the paged `decode_step`): the port of
the dense, MoE, SSM and hybrid families of `repro.models.transformer` (an MoE block's FFN is
`models/moe.py`, a Mamba2 block `models/mamba2.py`). The encoder-decoder
family is `models/encdec.py` on this module's `Cache`; `models/api.py`
dispatches to it.

The SSM family (mamba2) is a stack of `{"norm", "mamba"}` blocks; the
hybrid (zamba2) runs one shared, unstacked attention + MLP block
(`params["shared_attn"]`) before each segment of `hybrid_attn_every`
Mamba2 layers (`_hybrid_segments`), with a KV arena of its own for each
of those applications (`Cache.shared_k/v`). Both serve on the dense cache
only, as in the reference: the paged entry points raise its `ValueError`.

Parameters are a plain dict with the JAX pytree's keys; each block weight
is stacked on a leading layer axis, and a Python loop over layers takes the
place of `lax.scan`. Each layer gets `cfg.window_for_layer(i)` (None for
global attention) where the JAX scan passes a traced sentinel width.

Positions are learned (`pos_embed`, GPT-2) or rotary: each entry point
computes RoPE's cos/sin once (`_rope`: over arange(S) for the dense
prefill, start + arange(S) per sequence for a paged chunk, the cache
lengths for a decode step) and every layer rotates its q and k with them.
With M-RoPE (qwen2-vl, `cfg.mrope_sections`) `_rope` broadcasts those
positions to the three streams (temporal, height, width) of the text
path, as the reference does, on every path alike.

With `cfg.remat == "block"` a layer of `forward` that autograd records
runs under `torch.utils.checkpoint` (`use_reentrant=False`), as
`jax.checkpoint` wraps the JAX scan's body: its activations are
recomputed in the backward pass. The hybrid's shared block is not
rematerialized, as in the reference.

Under a sharded train step (`distributed.sharding.TrainPlan`, entered by
`runtime/train_loop.shard_train_step`) each rank holds its slices of the
parameters: `forward` gathers the leaves outside the layer stacks for use,
each layer gathers its own inside the checkpointed function (so the
backward gathers them again rather than keeping them), the attention, FFN
and experts compute tensor-parallel where the plan says so, and the LM
head vocab-parallel (its logits gathered over "model"). Without a plan
every function computes what it computes on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.core.salpim import SalPimEngine
from repro_torch.distributed import api as dist_api
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shard_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import blocks as blk
from repro_torch.models import ffn as ffn_lib
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.rope import mrope_cos_sin, rope_cos_sin
from repro_torch.serving.kvcache import PagedCache
from repro_torch.serving.quantize import QTensor, quantize_vec


@dataclasses.dataclass
class Cache:
    """Decode-time state over the dense per-slot arena. A field the family
    does not use is None.

    lengths:          (B,) int32                valid tokens per sequence
    k, v:             (L, B, Hkv, Smax, Dh)     the compute dtype, or int8
    k_scale, v_scale: (L, B, Hkv, Smax) bf16    dequant scales of the int8
                                                arena (cfg.kv_dtype "int8")
    ssm:              (L, B, H, N, P) f32       Mamba2 state
    conv:             (L, B, K-1, d_inner+2N)   Mamba2 conv window, compute dtype
    shared_k/v:       (A, B, Hkv, Smax, Dh)     the hybrid's shared block's KV,
                                                one arena an application
    cross_k/v:        (L, B, Hkv, Senc, Dh)     the encoder-decoder's cross-
                                                attention K/V, compute dtype,
                                                written at prefill, static after
    """

    lengths: torch.Tensor
    k: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    ssm: Optional[torch.Tensor] = None
    conv: Optional[torch.Tensor] = None
    shared_k: Optional[torch.Tensor] = None
    shared_v: Optional[torch.Tensor] = None
    cross_k: Optional[torch.Tensor] = None
    cross_v: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


@dataclasses.dataclass
class ShardedCache(Cache):
    """A rank's shard of a dense `Cache` on a mesh (`shard_cache`): each
    field is the rank's slice,
    and `specs`, the spec tree of the whole cache it was cut by, tells the
    decode step which dimensions are split. `specs` is not a leaf: the tree
    walkers leave it as it is."""

    specs: Optional[Cache] = dataclasses.field(default=None, repr=False, compare=False,
                                               metadata={"static": True})


def shard_cache(cache: Cache, mesh, *, seq_shard: bool = False) -> ShardedCache:
    """This rank's slice of a whole dense `Cache` by
    `sharding.cache_pspecs` (the counterpart of placing it with the
    reference's cache shardings), with the spec tree it was cut by in
    `specs`: the decode step reads there which dimensions are split
    (`sharding.cache_split`). Leaves that no mesh dimension splits are the
    whole cache's own tensors."""
    specs = shard_lib.cache_pspecs(cache, mesh, seq_shard=seq_shard)
    shard = shard_lib.shard_tree(cache, specs, mesh)
    return ShardedCache(**{f.name: getattr(shard, f.name) for f in dataclasses.fields(Cache)},
                        specs=specs)


def gather_cache(shard: ShardedCache, mesh) -> Cache:
    """The whole `Cache` of the ranks' shards, on every rank (a collective
    of every rank of the mesh): `shard_cache`'s inverse."""
    whole = shard_lib.gather_tree(shard, shard.specs, mesh)
    return Cache(**{f.name: getattr(whole, f.name) for f in dataclasses.fields(Cache)})


_SSM_FAMILIES = ("ssm", "hybrid")
# The families that serve on the dense cache alone, as in the reference.
_DENSE_ONLY_FAMILIES = (*_SSM_FAMILIES, "encdec")


def _check_supported(cfg: ModelConfig, paged: Optional[str] = None) -> None:
    """Refuse a family the JAX registry does not have; and, when `paged`
    names a paged entry point's structure, the SSM, hybrid and
    encoder-decoder families with the reference's ValueError."""
    if cfg.family not in ("dense", "moe", *_DENSE_ONLY_FAMILIES):
        raise ValueError(f"unknown model family {cfg.family!r}")
    if paged is not None and cfg.family in _DENSE_ONLY_FAMILIES:
        raise ValueError(f"{paged} unsupported for family {cfg.family!r}")


def _hybrid_segments(cfg: ModelConfig) -> list[tuple[int, int]]:
    """[(start, end)) Mamba2 layer segments: the whole stack for the SSM
    family; the hybrid's shared block runs before each of its segments."""
    if cfg.family != "hybrid":
        return [(0, cfg.n_layers)]
    every = max(cfg.hybrid_attn_every, 1)
    return [(s, min(s + every, cfg.n_layers)) for s in range(0, cfg.n_layers, every)]


def _unstack(tree: dict) -> dict:
    """The single layer of stacked (1, ...) parameters."""
    return {k: _unstack(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> dict:
    """Random weights with the JAX package's stds, drawn from a
    torch.Generator seeded with `seed` (not JAX's numbers); on the `meta`
    device their shapes and dtypes."""
    _check_supported(cfg)
    dev = resolve_device(device)
    # device="meta": the shapes alone (the sharding rules' input at full size).
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std, dtype=None):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return x.mul_(std).to(dtype or cfg.pdtype)

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
    if cfg.family in _SSM_FAMILIES:
        p["blocks"] = {"norm": blk.init_norm(cfg, ones, zeros, (L,)),
                       "mamba": m2.init_mamba2(normal, cfg, L)}
        if cfg.family == "hybrid":
            p["shared_attn"] = {
                "ln1": blk.init_norm(cfg, ones, zeros),
                "attn": _unstack(attn_lib.init_attention(normal, zeros, cfg, 1)),
                "ln2": blk.init_norm(cfg, ones, zeros),
                "ffn": _unstack(ffn_lib.init_ffn(normal, cfg, 1)),
            }
        return p
    blocks = {
        "ln1": blk.init_norm(cfg, ones, zeros, (L,)),
        "attn": attn_lib.init_attention(normal, zeros, cfg, L),
        "ln2": blk.init_norm(cfg, ones, zeros, (L,)),
    }
    if cfg.family == "moe":
        blocks["moe"] = moe_lib.init_moe(normal, cfg, L)
    else:
        blocks["ffn"] = ffn_lib.init_ffn(normal, cfg, L)
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
    positions and in the SSM family, which has no attention. With M-RoPE
    the text positions drive all three streams."""
    if cfg.learned_pos_emb or cfg.family == "ssm":
        return None, None
    if cfg.mrope_sections is not None:
        pos3 = positions[None].expand((3, *positions.shape))
        return mrope_cos_sin(pos3, cfg.head_dim, cfg.rope_theta, cfg.mrope_sections)
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
    tp = shard_lib.tensor_parallel("head")
    if tp is None:
        logits = engine.linear(x, p["lm_head"])
    else:   # vocab-parallel: this rank's rows of the head, the logits gathered
        group = tp[2]
        logits, = collectives.all_gather_grad(
            [engine.linear(collectives.tp_enter(x, group), p["lm_head"])], group, [-1],
            backward="slice")
    if cfg.final_softcap is not None:
        logits = engine.nl.softcap(logits.float(), cfg.final_softcap)
    return logits


def _records(tree) -> bool:
    """Whether autograd records an op on any tensor of a nested structure."""
    if isinstance(tree, dict):
        return any(_records(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_records(v) for v in tree)
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def remat(fn, cfg: ModelConfig):
    """fn(layer_params, *args) under `torch.utils.checkpoint` when
    cfg.remat is "block" and autograd records the call, else fn itself."""
    if cfg.remat != "block":
        return fn

    def run(*args, **kw):
        if not (torch.is_grad_enabled() and _records(args)):
            return fn(*args, **kw)
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, **kw)
    return run


def decoder_stack(params: dict, x: torch.Tensor, cfg: ModelConfig, engine: SalPimEngine,
                  cos, sin) -> torch.Tensor:
    """The dense / MoE block stack of the teacher-forced forward."""
    block = remat(shard_lib.use_layer(blk.apply_decoder_block, "blocks"), cfg)
    for i, bp in enumerate(_layers(params["blocks"], cfg.n_layers)):
        x = block(bp, x, cfg, engine, cos=cos, sin=sin, window=cfg.window_for_layer(i))
    return x


def _mamba_layer(bp: dict, x: torch.Tensor, cfg: ModelConfig,
                 engine: SalPimEngine) -> torch.Tensor:
    r = blk.apply_norm(bp["norm"], x, cfg, engine)
    return x + m2.apply_mamba2(bp["mamba"], r, cfg, engine)


def _hybrid_fullseq(params: dict, x: torch.Tensor, cfg: ModelConfig, engine: SalPimEngine,
                    cos, sin) -> torch.Tensor:
    """The SSM family's Mamba2 stack; the hybrid's shared block before each
    of its segments."""
    layers = _layers(params["blocks"], cfg.n_layers)
    mamba = remat(shard_lib.use_layer(_mamba_layer, "blocks"), cfg)
    for s, e in _hybrid_segments(cfg):
        if cfg.family == "hybrid":
            x = blk.apply_decoder_block(params["shared_attn"], x, cfg, engine, cos=cos,
                                        sin=sin, window=None)
        for i in range(s, e):
            x = mamba(layers[i], x, cfg, engine)
    return x


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
            engine: SalPimEngine) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V), every position (teacher forcing)."""
    _check_supported(cfg)
    if cfg.family == "encdec":
        raise ValueError("forward of the encoder-decoder family is encdec.forward")
    params = shard_lib.use_params(params)
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    x = _embed(params, tokens, cfg, pos[None])
    cos, sin = _rope(cfg, pos)
    if cfg.family in _SSM_FAMILIES:
        x = _hybrid_fullseq(params, x, cfg, engine, cos, sin)
    else:
        x = decoder_stack(params, x, cfg, engine, cos, sin)
    return _logits(params, x, cfg, engine)


def token_nll(logits: torch.Tensor, batch: dict):
    """The masked mean next-token NLL of logits (B, S, V) against
    batch["labels"] (B, S) and batch.get("mask") (B, S; all ones when
    absent), in f32. Returns (loss, logits in f32, labels, mask, denom).
    Under a sharded train step (`distributed.sharding.TrainPlan`) the
    denominator is the global batch's, so the loss is this rank's share of
    the global mean."""
    logits = logits.float()
    labels = batch["labels"].long()
    mask = batch.get("mask")
    mask = torch.ones_like(labels, dtype=torch.float32) if mask is None else mask.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    denom = shard_lib.global_mean_denominator(mask.sum())
    return ((logz - gold) * mask).sum() / denom, logits, labels, mask, denom


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, engine: SalPimEngine):
    """batch {tokens (B, S), labels (B, S), mask (B, S)} on the params'
    device -> (loss, metrics): the reference's loss, ppl_proxy, tokens and
    accuracy (detached)."""
    loss, logits, labels, mask, denom = token_nll(
        forward(params, batch["tokens"], cfg, engine), batch)
    with torch.no_grad():
        metrics = {
            "loss": loss.detach(),
            "ppl_proxy": torch.exp(torch.clamp(loss.detach(), max=20.0)),
            "tokens": mask.sum(),
            "accuracy": ((torch.argmax(logits, -1) == labels) * mask).sum() / denom,
        }
    return loss, metrics


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
    _check_supported(cfg, paged="paged prefill")
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
    payload with bf16 scales when cfg.kv_dtype is "int8". The SSM family
    gets its state and conv window, the hybrid also its shared block's
    KV arenas, always in the compute dtype (as in the reference)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if cfg.family in _SSM_FAMILIES:
        L = cfg.n_layers
        cache = Cache(
            lengths=lengths,
            ssm=torch.zeros((L, batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_headdim),
                            dtype=torch.float32, device=dev),
            conv=torch.zeros((L, batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
                             dtype=cfg.cdtype, device=dev))
        if cfg.family == "hybrid":
            shared = (len(_hybrid_segments(cfg)),) + shape[1:]
            cache.shared_k = torch.zeros(shared, dtype=cfg.cdtype, device=dev)
            cache.shared_v = torch.zeros(shared, dtype=cfg.cdtype, device=dev)
        return cache
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
    if cfg.family in _SSM_FAMILIES:
        x = _ssm_stack(params, x, cache, cfg, engine, cos, sin, prefill=True)
        return _logits(params, x[:, -1], cfg, engine), cache
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
    is a dense `Cache` or a `PagedCache`; either is written in place.

    A rank's shard of a dense cache on the current mesh (`shard_cache`)
    runs the mesh decode: token (B,)
    whole, the rank runs its rows of the batch where the cache splits it
    over "data" (every row otherwise), each arena's attention on the
    rank's heads or slice of the sequence (`attention.attention_decode`),
    the SSM state and conv window gathered whole but for the rows and cut
    back after the step; the logits (B, V) are gathered whole on every
    rank, and the cache returned is the rank's shard."""
    if isinstance(cache, PagedCache):
        return _decode_step_paged(params, token, cache, cfg, engine)
    _check_supported(cfg)
    split = shard_lib.cache_split(cache, dist_api.current_mesh())
    lengths = cache.lengths
    if split is not None:
        token, lengths = split.own_rows(token), split.own_rows(lengths)
    x = _embed(params, token[:, None], cfg, lengths[:, None])[:, 0]
    cos, sin = _rope(cfg, lengths)
    if cfg.family in _SSM_FAMILIES:
        x = _ssm_decode(params, x, cache, lengths, split, cfg, engine, cos, sin)
    else:
        arena = None if split is None else shard_lib.cache_split(cache, split.mesh, "k")
        for i, bp in enumerate(_layers(params["blocks"], cfg.n_layers)):
            scales = (cache.k_scale[i], cache.v_scale[i]) if cache.quantized else None
            x, *_ = blk.apply_decoder_block_decode(
                bp, x, cache.k[i], cache.v[i], lengths, cfg, engine, cos=cos, sin=sin,
                window=cfg.window_for_layer(i), kv_scales=scales, split=arena)
    logits = _logits(params, x, cfg, engine)
    if split is not None:
        logits = split.gather_rows(logits)
    new_cache = dataclasses.replace(cache, lengths=_advance_lengths(cache.lengths))
    return logits, new_cache


def _ssm_decode(params: dict, x: torch.Tensor, cache: Cache, lengths: torch.Tensor,
                split, cfg: ModelConfig, engine: SalPimEngine, cos, sin) -> torch.Tensor:
    """The SSM or hybrid stack's decode step on x (the rank's rows). On a
    rank's shard the SSM state and conv window are gathered whole but for
    the rows (the layer computes on whole heads and channels), stepped, and
    the rank's slices written back in place."""
    if split is None:
        return _ssm_stack(params, x, cache, cfg, engine, cos, sin, prefill=False)
    mesh = split.mesh
    # Each leaf's spec less its batch rows (dimension 1), which stay the rank's.
    rest = {name: (spec[0], None, *spec[2:]) for name, spec in
            (("ssm", cache.specs.ssm), ("conv", cache.specs.conv))}
    work = dataclasses.replace(
        cache, lengths=lengths,
        **{name: shard_lib.gather_whole(getattr(cache, name), spec, mesh)
           for name, spec in rest.items()})
    x = _ssm_stack(params, x, work, cfg, engine, cos, sin, prefill=False,
                   split=shard_lib.cache_split(cache, mesh, "shared_k")
                   if cache.shared_k is not None else None)
    for name, spec in rest.items():
        getattr(cache, name).copy_(shard_lib.shard_of(getattr(work, name), spec, mesh))
    return x


def _decode_step_paged(params: dict, token: torch.Tensor, cache,
                       cfg: ModelConfig, engine: SalPimEngine):
    """token (B,) -> (logits (B, V), cache with advanced lengths). The pools
    (and an int8/int4 cache's scale pools) are updated in place; block
    tables are shared across layers."""
    _check_supported(cfg, paged="paged cache")
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


def _ssm_stack(params: dict, x: torch.Tensor, cache: Cache, cfg: ModelConfig,
               engine: SalPimEngine, cos, sin, *, prefill: bool, split=None) -> torch.Tensor:
    """The SSM or hybrid block stack over the prompt (`prefill`: x (B, S,
    D), the cache's rows filled from empty) or one decode step (x (B, D),
    the cache written in place): each Mamba2 layer's state and conv
    window, and the hybrid's shared block before each segment, its KV in
    `shared_k/v[a]` for application a (`split`: a rank's shard of those
    arenas). Returns the hidden states."""
    layers = _layers(params["blocks"], cfg.n_layers)
    S = x.shape[1] if prefill else None
    for a, (s, e) in enumerate(_hybrid_segments(cfg)):
        if cfg.family == "hybrid":
            shared = params["shared_attn"]
            if prefill:
                x, (k, v) = blk.apply_decoder_block_prefill(shared, x, cfg, engine, cos=cos,
                                                            sin=sin, window=None)
                cache.shared_k[a, :, :, :S] = k
                cache.shared_v[a, :, :, :S] = v
            else:
                x, *_ = blk.apply_decoder_block_decode(
                    shared, x, cache.shared_k[a], cache.shared_v[a], cache.lengths, cfg,
                    engine, cos=cos, sin=sin, window=None, split=split)
        for i in range(s, e):
            bp = layers[i]
            r = blk.apply_norm(bp["norm"], x, cfg, engine)
            if prefill:
                o, cache.ssm[i], cache.conv[i] = m2.apply_mamba2(bp["mamba"], r, cfg, engine,
                                                                 return_state=True)
            else:
                o, *_ = m2.mamba2_decode_step(bp["mamba"], r, cache.ssm[i], cache.conv[i],
                                              cfg, engine)
            x = x + o
    return x
