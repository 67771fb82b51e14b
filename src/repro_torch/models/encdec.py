"""Encoder-decoder transformer, the whisper-large-v3 backbone (the port of
`repro.models.encdec`: `init_params`, `encode`, `prefill`, `decode_step`,
and the teacher-forced `forward` and `loss_fn` of training).

The audio conv frontend is a stub, as in the reference: `encode` takes
precomputed frame embeddings (B, enc_seq, d_model). The encoder is
pre-norm self-attention (not causal) and a GELU MLP a layer; the decoder
adds a cross-attention over the encoder output between its self-attention
and its MLP, with learned positions (`pos_embed`) and no RoPE.

`prefill` encodes the frames, runs the prompt through the decoder and
writes a dense `Cache`: the self K/V of the prompt in an arena of max_len
positions, and each layer's cross K/V, projected once from the encoder
output (`cross_k/v`, (L, B, Hkv, enc_seq, Dh) in the compute dtype). It
returns the LM head's logits at the last position only. `decode_step`
appends one token's self K/V and attends over the cross arena as a static
one of enc_seq keys: the new token's cross K/V are not projected (the
reference projects and discards them), so a decoder layer runs 8 linears
at decode (self q, k, v, o; cross q, o; w_up; w_down), not 10. The arena
is always in the compute dtype (the reference gives this family no int8
arena), and every sequence's length advances by one a step.

Every linear here is `SalPimEngine.linear` on a parameter of the tree, so
the `quant="int8"` route's weight quantization (`static_input=True`: no
kernel in flight writes the weight) holds for all of them. The norms are
`blocks.apply_norm` and the MLPs `ffn.apply_ffn`. Training (`forward`,
`loss_fn`) is not ported.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core.salpim import SalPimEngine
from repro_torch.distributed import api as dist_api
from repro_torch.distributed import sharding as shard_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import blocks as blk
from repro_torch.models import ffn as ffn_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Cache, _layers, remat, token_nll
from repro_torch.serving.kvcache import PagedCache


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> dict:
    """Random weights with the reference's tree and stds, drawn from a
    torch.Generator seeded with `seed` (not JAX's numbers)."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)

    def normal(shape, std, dtype=None):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return x.mul_(std).to(dtype or cfg.pdtype)

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=cfg.pdtype)

    def zeros(shape):
        return torch.zeros(shape, device=dev, dtype=cfg.pdtype)

    d, Le, Ld = cfg.d_model, cfg.n_enc_layers, cfg.n_layers
    return {
        "enc_pos": normal((cfg.enc_seq, d), 0.02),
        "enc_blocks": {
            "ln1": blk.init_norm(cfg, ones, zeros, (Le,)),
            "attn": attn_lib.init_attention(normal, zeros, cfg, Le),
            "ln2": blk.init_norm(cfg, ones, zeros, (Le,)),
            "ffn": ffn_lib.init_ffn(normal, cfg, Le),
        },
        "enc_norm": blk.init_norm(cfg, ones, zeros),
        "embed": normal((cfg.vocab, d), 0.02),
        "pos_embed": normal((cfg.max_seq, d), 0.02),
        "dec_blocks": {
            "ln1": blk.init_norm(cfg, ones, zeros, (Ld,)),
            "attn": attn_lib.init_attention(normal, zeros, cfg, Ld),
            "ln_x": blk.init_norm(cfg, ones, zeros, (Ld,)),
            "xattn": attn_lib.init_attention(normal, zeros, cfg, Ld),
            "ln2": blk.init_norm(cfg, ones, zeros, (Ld,)),
            "ffn": ffn_lib.init_ffn(normal, cfg, Ld),
        },
        "final_norm": blk.init_norm(cfg, ones, zeros),
        "lm_head": normal((cfg.vocab, d), d ** -0.5),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda") -> Cache:
    """Empty self arenas of max_len positions and cross arenas of enc_seq,
    all in the compute dtype."""
    dev = resolve_device(device)
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim

    def zeros(S):
        return torch.zeros((L, batch, Hkv, S, Dh), dtype=cfg.cdtype, device=dev)

    return Cache(lengths=torch.zeros((batch,), dtype=torch.int32, device=dev),
                 k=zeros(max_len), v=zeros(max_len),
                 cross_k=zeros(cfg.enc_seq), cross_v=zeros(cfg.enc_seq))


def encode_layer(bp: dict, h: torch.Tensor, cfg: ModelConfig,
                 engine: SalPimEngine) -> torch.Tensor:
    """One encoder layer: pre-norm self-attention over every frame (not
    causal), then the MLP, each with its residual."""
    r = blk.apply_norm(bp["ln1"], h, cfg, engine)
    h = h + attn_lib.attention_fullseq(bp["attn"], r, cfg, engine, causal=False)
    r = blk.apply_norm(bp["ln2"], h, cfg, engine)
    return h + ffn_lib.apply_ffn(bp["ffn"], r, cfg, engine)


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig,
           engine: SalPimEngine) -> torch.Tensor:
    """frames (B, enc_seq, D) stub embeddings -> encoder output (B, enc_seq, D)."""
    x = frames.to(cfg.cdtype) + params["enc_pos"][None].to(cfg.cdtype)
    layer = remat(shard_lib.use_layer(encode_layer, "enc_blocks"), cfg)
    for bp in _layers(params["enc_blocks"], cfg.n_enc_layers):
        x = layer(bp, x, cfg, engine)
    return blk.apply_norm(params["enc_norm"], x, cfg, engine)


def _dec_embed(params: dict, tokens: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(cfg.cdtype)
    return x + params["pos_embed"][positions.long()].to(cfg.cdtype)


def decode_layer_prefill(bp: dict, h: torch.Tensor, enc: torch.Tensor, cfg: ModelConfig,
                         engine: SalPimEngine):
    """One decoder layer over the prompt: causal self-attention, the
    cross-attention over the encoder output enc, the MLP. Returns (h', (self
    k, v), (cross k, v)), the K/V in the arena layout (B, Hkv, S, Dh)."""
    r = blk.apply_norm(bp["ln1"], h, cfg, engine)
    r, self_kv = attn_lib.attention_fullseq(bp["attn"], r, cfg, engine, causal=True,
                                            return_kv=True)
    h = h + r
    r = blk.apply_norm(bp["ln_x"], h, cfg, engine)
    r, cross_kv = attn_lib.attention_fullseq(bp["xattn"], r, cfg, engine, causal=False,
                                             kv_x=enc, return_kv=True)
    h = h + r
    r = blk.apply_norm(bp["ln2"], h, cfg, engine)
    return h + ffn_lib.apply_ffn(bp["ffn"], r, cfg, engine), self_kv, cross_kv


def _decode_layer(bp: dict, h: torch.Tensor, enc: torch.Tensor, cfg: ModelConfig,
                  engine: SalPimEngine) -> torch.Tensor:
    return decode_layer_prefill(bp, h, enc, cfg, engine)[0]


def forward(params: dict, frames: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig,
            engine: SalPimEngine) -> torch.Tensor:
    """Teacher-forced decoder over the encoder output of frames (B,
    enc_seq, D): tokens (B, S) -> logits (B, S, V)."""
    params = shard_lib.use_params(params)
    enc = encode(params, frames, cfg, engine)
    B, S = tokens.shape
    x = _dec_embed(params, tokens, torch.arange(S, device=tokens.device)[None].expand(B, S),
                   cfg)
    layer = remat(shard_lib.use_layer(_decode_layer, "dec_blocks"), cfg)
    for bp in _layers(params["dec_blocks"], cfg.n_layers):
        x = layer(bp, x, enc, cfg, engine)
    return _logits(params, x, cfg, engine)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, engine: SalPimEngine):
    """batch {frames, tokens, labels, mask} -> (loss, {loss, tokens})."""
    loss, _, _, mask, _ = token_nll(
        forward(params, batch["frames"], batch["tokens"], cfg, engine), batch)
    return loss, {"loss": loss.detach(), "tokens": mask.sum()}


def _logits(params: dict, x: torch.Tensor, cfg: ModelConfig,
            engine: SalPimEngine) -> torch.Tensor:
    x = blk.apply_norm(params["final_norm"], x, cfg, engine)
    return engine.linear(x, params["lm_head"])


def prefill(params: dict, frames: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig,
            engine: SalPimEngine, *, max_len: int):
    """Encode the frames (a tensor or an array, moved to the tokens'
    device), run the prompt tokens (B, S) through the decoder. Returns
    (last-position logits (B, V), a Cache with the prompt's self K/V in
    max_len positions and the cross K/V)."""
    B, S = tokens.shape
    if max_len < S:
        raise ValueError(f"max_len {max_len} is shorter than the prompt ({S})")
    enc = encode(params, torch.as_tensor(frames, device=tokens.device), cfg, engine)
    pos = torch.arange(S, device=tokens.device)
    x = _dec_embed(params, tokens, pos[None].expand(B, S), cfg)
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    cache.lengths.fill_(S)
    for i, bp in enumerate(_layers(params["dec_blocks"], cfg.n_layers)):
        x, (sk, sv), (xk, xv) = decode_layer_prefill(bp, x, enc, cfg, engine)
        cache.k[i, :, :, :S] = sk
        cache.v[i, :, :, :S] = sv
        cache.cross_k[i] = xk
        cache.cross_v[i] = xv
    return _logits(params, x[:, -1], cfg, engine), cache


def decode_layer_step(bp: dict, h: torch.Tensor, cache: Cache, i: int, enc_len: torch.Tensor,
                      cfg: ModelConfig, engine: SalPimEngine, lengths=None,
                      splits=(None, None)) -> torch.Tensor:
    """One decoder layer for one token a sequence: self-attention appending
    to layer i's arena in place, cross-attention over its static arena of
    enc_len keys, the MLP. On a rank's shard of the cache `lengths` are its
    rows' and `splits` the self and cross arenas' (`attention_decode`)."""
    lengths = cache.lengths if lengths is None else lengths
    r = blk.apply_norm(bp["ln1"], h, cfg, engine)
    r, *_ = attn_lib.attention_decode(bp["attn"], r, cache.k[i], cache.v[i], lengths,
                                      cfg, engine, split=splits[0])
    h = h + r
    r = blk.apply_norm(bp["ln_x"], h, cfg, engine)
    r, *_ = attn_lib.attention_decode(bp["xattn"], r, cache.cross_k[i], cache.cross_v[i],
                                      enc_len, cfg, engine, update_cache=False,
                                      split=splits[1])
    h = h + r
    r = blk.apply_norm(bp["ln2"], h, cfg, engine)
    return h + ffn_lib.apply_ffn(bp["ffn"], r, cfg, engine)


def decode_step(params: dict, token: torch.Tensor, cache: Cache, cfg: ModelConfig,
                engine: SalPimEngine):
    """token (B,) -> (logits (B, V), the cache with lengths + 1); the self
    arenas are written in place, the cross arenas only read. A rank's shard
    of the cache on the current mesh runs the mesh decode as
    `transformer.decode_step` does: its rows, each arena (self and cross)
    split by its own spec, the logits gathered whole."""
    if isinstance(cache, PagedCache):
        raise ValueError("paged cache unsupported for family 'encdec'")
    mesh = dist_api.current_mesh()
    split = shard_lib.cache_split(cache, mesh)
    lengths, splits = cache.lengths, (None, None)
    if split is not None:
        token, lengths = split.own_rows(token), split.own_rows(lengths)
        splits = (split, shard_lib.cache_split(cache, mesh, "cross_k"))
    B = token.shape[0]
    x = _dec_embed(params, token[:, None], lengths[:, None], cfg)[:, 0]
    enc_len = torch.full((B,), cfg.enc_seq, dtype=torch.int32, device=token.device)
    for i, bp in enumerate(_layers(params["dec_blocks"], cfg.n_layers)):
        x = decode_layer_step(bp, x, cache, i, enc_len, cfg, engine, lengths, splits)
    logits = _logits(params, x, cfg, engine)
    if split is not None:
        logits = split.gather_rows(logits)
    new_cache = dataclasses.replace(cache, lengths=cache.lengths + 1)
    return logits, new_cache
