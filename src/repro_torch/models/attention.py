"""Multi-head attention, full-sequence and decode forms over the dense
per-slot arena, prefill-chunk and decode forms over the paged pools (the
port of `repro.models.attention`). With RoPE
(cos/sin given) q and k are rotated after the projection and before K is
returned or written to the arena or the pages.

The full-sequence form keeps the JAX package's two einsums (Q x K^T and
S x V over the same (B, S, Hkv, D) layout), outside any kernel as in the
JAX package; the softmax between them goes through the engine, the
`softmax_lut` kernel in LUT mode. Decode over the dense arena runs the
`decode_attention` kernel, which reads the int8 arena with its scale rows
itself, bit for bit as the JAX package's whole-arena dequantization before
the kernel (the plain version runs that dequantization).

Cross-attention (the encoder-decoder's): the full-sequence form takes
`kv_x`, the encoder output, as the source of K and V, and the decode form
with `update_cache=False` attends over a static arena (the cross K/V
written at prefill) of `lengths` keys without writing it. There the new
token's own K and V would be thrown away, as the reference throws them
away, so only q is projected: a cross block's decode costs two GEMVs (q,
o), not four.

Under a mesh (`distributed.api.use_mesh`, which the paged entry points
enter with `mesh=`) the paged forms run tensor-parallel, the twin of the
reference's `_paged_tp_axis` / `_shard_map_paged`: q, k and v are projected
replicated, as on one device; the rank takes its contiguous block of
(Hkv/tp)*g query heads and Hkv/tp KV heads (q's head axis orders as (kv
head, group)), appends into its slice of the pools and runs the same
kernel on it; `collectives.gather_heads` concatenates the ranks' heads and
`wo` runs replicated on them. No float add crosses ranks, so the output is
bit for bit one device's. A mesh whose "model" extent is 1 or does not
divide Hkv leaves the layer on the whole heads, as the reference's.

On a rank's shard of a dense cache (`transformer.shard_cache`,
the mesh decode: `attention_decode(split=...)`) the decode form follows
the arena's split (`sharding.CacheSplit`). The rows are the rank's already.
KV heads split over "model" are attended as in the paged form: the rank's
block of heads, the walk planned on the model's KV heads, the heads
gathered, bit for bit one device's. A sequence split over one or more
mesh dimensions is the distributed flash-decode: the new K/V is written
only by the rank whose slice holds its position, each rank takes the
online-softmax partials of its slice (`decode_attention_partials` at its
key offset), and `collectives.merge_partial_softmax` merges them over the
ranks of those dimensions, the C-ALU's merge of the banks' partials; the
merge adds in rank order, so the output is one device's within rounding,
not in bits. It is cast to the compute dtype before `wo`.

Under a sharded train step (`distributed.sharding.TrainPlan`) the
full-sequence form computes tensor-parallel where the plan splits the
attention (the KV heads divide over "model"): the weights are the rank's
slices, the rank attends its heads, and the ranks' `wo` products are
summed (`collectives.tp_sum`, in mathematics the one-device output, not
in bits)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.salpim import SalPimEngine
from repro_torch.distributed import api as dist_api
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shard_lib
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
                 engine: SalPimEngine, kv_x: Optional[torch.Tensor] = None):
    """x (B, S, D) -> q (B, S, H, Dh), k/v (B, Skv, Hkv, Dh) projected from
    kv_x (B, Skv, D), the cross-attention source, when given, else from x."""
    B, S, _ = x.shape
    kv_in = x if kv_x is None else kv_x
    Skv = kv_in.shape[1]
    q = engine.linear(x, p["wq"], p.get("bq"))
    k = engine.linear(kv_in, p["wk"], p.get("bk"))
    v = engine.linear(kv_in, p["wv"], p.get("bv"))
    # The head counts are the weights' (a rank's under tensor parallelism).
    return (q.reshape(B, S, -1, cfg.head_dim), k.reshape(B, Skv, -1, cfg.head_dim),
            v.reshape(B, Skv, -1, cfg.head_dim))


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
                      kv_x: Optional[torch.Tensor] = None, return_kv: bool = False):
    """x (B, S, D) -> out (B, S, D), and with return_kv the K/V (K
    rotated) in the arena layout (B, Hkv, Skv, Dh); cos/sin (S, Dh/2) or
    None. With kv_x (B, Skv, D), the cross-attention source, K and V are
    projected from it, and K is not rotated (the reference rotates it only
    by positions of the source, which no caller has). Queries run in
    chunks of cfg.attn_chunk when S is longer than and a multiple of it,
    as the JAX scan does. Under a train plan that splits the attention
    (`sharding.tensor_parallel("attn")`) the weights are the rank's column
    block of wq/wk/wv (whole KV heads with their query groups) and row
    block of wo: the rank attends its heads, and the ranks' wo products
    are summed."""
    B, S, _ = x.shape
    tp = shard_lib.tensor_parallel("attn")
    if tp is not None:
        x = collectives.tp_enter(x, tp[2])
    q, k, v = _project_qkv(p, x, cfg, engine, kv_x)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        if kv_x is None:
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
    if tp is not None:
        out = collectives.tp_sum(out, tp[2])
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
    update_cache: bool = True,
    kv_scales: Optional[tuple] = None,   # (k_scale, v_scale) (B, Hkv, Smax) bf16
    split: Optional[shard_lib.CacheSplit] = None,
):
    """One decode step against the dense arena: write each slot's K/V at
    its length (all at lengths[0] with cfg.decode_uniform), in place and,
    for the int8 arena, quantized with its bf16 scale; then attend over
    length + 1 keys. Returns (out, cache_k, cache_v[, k_scale, v_scale]).
    With update_cache=False the arena is static (cross-attention): only q
    is projected, nothing is written, and each slot attends over its
    `lengths` keys. `split`: the arena is a rank's shard that splits its
    KV heads or its sequence (see the module's docstring)."""
    B, _ = x.shape
    int8_kv = kv_scales is not None
    if split is not None and (split.heads or split.seq):
        return _attention_decode_split(p, x, cache_k, cache_v, lengths, cfg, engine, cos,
                                       sin, window, update_cache, kv_scales, split)
    if update_cache:
        q, k, v = _decode_qkv(p, x, cfg, engine, cos, sin)
        _write_decode_kv(cache_k, cache_v, kv_scales, k, v, lengths, cfg)
        valid = lengths + 1
    else:
        q = engine.linear(x, p["wq"], p.get("bq")).reshape(B, cfg.n_heads, cfg.head_dim)
        if cos is not None:
            q = apply_rope(q[:, None], cos[:, None], sin[:, None])[:, 0]
        valid = lengths
    att = engine.decode_attention(q, cache_k, cache_v, valid,
                                  *(kv_scales if int8_kv else ()), scale=_scale(cfg),
                                  softcap=cfg.attn_softcap, window=window)
    out = engine.linear(att.reshape(B, -1), p["wo"])
    return (out, cache_k, cache_v, *(kv_scales if int8_kv else ()))


def _attention_decode_split(p, x, cache_k, cache_v, lengths, cfg: ModelConfig,
                            engine: SalPimEngine, cos, sin, window, update_cache: bool,
                            kv_scales, split: shard_lib.CacheSplit):
    """`attention_decode` on a rank's shard of an arena whose KV heads or
    sequence a mesh splits (the module's docstring)."""
    B, _ = x.shape
    if update_cache:
        q, k, v = _decode_qkv(p, x, cfg, engine, cos, sin)
        valid = lengths + 1
    else:
        q = engine.linear(x, p["wq"], p.get("bq")).reshape(B, cfg.n_heads, cfg.head_dim)
        if cos is not None:
            q = apply_rope(q[:, None], cos[:, None], sin[:, None])[:, 0]
        k = v = None
        valid = lengths
    plan_kv_heads = None
    if split.heads:
        r, tp = split.index(split.heads)
        hq, hk = cfg.n_heads // tp, cfg.n_kv_heads // tp
        q = q.narrow(1, r * hq, hq).contiguous()
        if update_cache:
            k, v = k.narrow(1, r * hk, hk), v.narrow(1, r * hk, hk)
        plan_kv_heads = cfg.n_kv_heads
    scales = kv_scales if kv_scales is not None else ()
    kw = dict(scale=_scale(cfg), softcap=cfg.attn_softcap, window=window)
    if split.seq:
        offset = split.index(split.seq)[0] * cache_k.shape[2]
        if update_cache:
            _write_decode_kv(cache_k, cache_v, kv_scales, k, v, lengths, cfg, offset=offset)
        m, l, acc = engine.decode_attention_partials(q, cache_k, cache_v, valid, *scales,
                                                     key_offset=offset, **kw)
        att = collectives.merge_partial_softmax(m, l, acc, split.groups(split.seq)).to(q.dtype)
    else:
        if update_cache:
            _write_decode_kv(cache_k, cache_v, kv_scales, k, v, lengths, cfg)
        att = engine.decode_attention(q, cache_k, cache_v, valid, *scales,
                                      plan_kv_heads=plan_kv_heads, **kw)
    for group in reversed(split.groups(split.heads)):
        att = collectives.gather_heads(att, group, 1)
    out = engine.linear(att.reshape(B, -1), p["wo"])
    return (out, cache_k, cache_v, *scales)


def _write_decode_kv(cache_k, cache_v, kv_scales, k, v, lengths, cfg: ModelConfig,
                     offset: Optional[int] = None) -> None:
    """Write each slot's new K/V (B, Hkv, Dh) at its length (all at
    lengths[0] with cfg.decode_uniform), in place; quantized with its bf16
    scale into the int8 arena when kv_scales are given. With `offset` the
    arena is a rank's slice of the sequence from that position: a row
    whose position falls outside it writes nothing here."""
    if kv_scales is not None:
        ksc, vsc = kv_scales
        (k_store, k_new_sc), (v_store, v_new_sc) = (quantize_vec(k, torch.bfloat16),
                                                    quantize_vec(v, torch.bfloat16))
        writes = [(cache_k, k_store), (cache_v, v_store), (ksc, k_new_sc),
                  (vsc, v_new_sc)]
    else:
        writes = [(cache_k, k), (cache_v, v)]
    if offset is not None:
        S = cache_k.shape[2]
        pos = (lengths[:1].expand(k.shape[0]) if cfg.decode_uniform else lengths).long()
        pos = pos - offset
        mine = (pos >= 0) & (pos < S)
        at = pos.clamp(0, S - 1)
        b_idx = torch.arange(k.shape[0], device=k.device)
        for dst, src in writes:
            keep = mine.reshape(-1, *([1] * (src.dim() - 1)))
            dst[b_idx, :, at] = torch.where(keep, src.to(dst.dtype), dst[b_idx, :, at])
        return
    if cfg.decode_uniform:
        pos = lengths[:1].long()
        for dst, src in writes:
            dst.index_copy_(2, pos, src[:, :, None].to(dst.dtype))
    else:
        b_idx = torch.arange(k.shape[0], device=k.device)
        for dst, src in writes:
            dst[b_idx, :, lengths.long()] = src.to(dst.dtype)


def _shard_heads(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                axis: int):
    """(q, k, v, plan_kv_heads, merge): under an active mesh that shards
    the KV heads, this rank's block of query and KV heads along `axis`,
    the model's KV-head count to plan the decode walk on, and the merge of
    the ranks' outputs; else the whole heads, None and the identity."""
    mesh = dist_api.current_mesh()
    tp = dist_api.axis_size(mesh, "model")
    if tp <= 1 or cfg.n_kv_heads % tp:
        return q, k, v, None, lambda att: att
    rank, _, group = dist_api.model_shard(mesh)
    hq, hk = cfg.n_heads // tp, cfg.n_kv_heads // tp
    return (q.narrow(axis, rank * hq, hq).contiguous(), k.narrow(axis, rank * hk, hk),
            v.narrow(axis, rank * hk, hk), cfg.n_kv_heads,
            lambda att: collectives.gather_heads(att, group, axis))


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
    when the pool is quantized. Under a mesh the pools are this rank's
    slice (see the module's docstring)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, engine)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    q, k, v, _, merge = _shard_heads(cfg, q, k, v, axis=2)
    pools = kvcache.append_chunk_kv_pages(k_pages, v_pages, block_tables, start,
                                          k, v, k_scale, v_scale)
    att = merge(engine.paged_prefill_attention(
        q, k_pages, v_pages, block_tables, length, start, k_scale, v_scale,
        scale=_scale(cfg), softcap=cfg.attn_softcap, window=window))
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
    (k_scale, v_scale) when the pool is quantized. Under a mesh the pools
    are this rank's slice (see the module's docstring)."""
    B, _ = x.shape
    q, k, v = _decode_qkv(p, x, cfg, engine, cos, sin)
    q, k, v, plan_kv_heads, merge = _shard_heads(cfg, q, k, v, axis=1)
    pools = kvcache.append_kv_pages(k_pages, v_pages, block_tables, lengths,
                                    k, v, k_scale, v_scale)
    att = merge(engine.paged_decode_attention(
        q, k_pages, v_pages, block_tables, lengths + 1, k_scale, v_scale,
        scale=_scale(cfg), softcap=cfg.attn_softcap, window=window,
        plan_kv_heads=plan_kv_heads))
    out = engine.linear(att.reshape(B, -1), p["wo"])
    return (out, *pools)
