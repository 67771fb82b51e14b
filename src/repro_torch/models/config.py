"""Model configuration: the fields of `repro.models.config.ModelConfig`
that the serving and training paths read (the paged pools and the dense arena of the
dense and MoE families; the dense cache of the SSM, hybrid and
encoder-decoder families), with the same names and defaults, and its
analytic parameter counts (the roofline cost model's weight stream,
`serving/costmodel.py`)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # the port serves "dense" (RoPE, M-RoPE or
                                     # learned positions), "moe", "ssm"
                                     # (Mamba2), "hybrid" (zamba2: Mamba2 + one
                                     # shared attention block) and "encdec"
                                     # (whisper: an encoder over stub frames,
                                     # a decoder with cross-attention)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads

    # attention flavour
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope_sections: Optional[tuple[int, ...]] = None  # qwen2-vl M-RoPE
    sliding_window: Optional[int] = None
    local_global_pattern: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    attn_scale: Optional[float] = None
    learned_pos_emb: bool = False
    causal: bool = True

    # block flavour
    activation: str = "silu"
    gated_mlp: bool = True
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    post_norms: bool = False
    embed_scale: bool = False
    tie_embeddings: bool = False

    # MoE (family "moe"): n_experts experts of width moe_d_ff (d_ff when 0),
    # top_k a token; each group's expert takes at most its capacity
    # (models/moe.py `_capacity`, router_cap_factor). moe_impl "shardmap"
    # is the reference's expert-parallel dispatch under a mesh with a
    # "model" dimension (models/moe.py); without one it runs the grouped
    # dispatch, as "gspmd".
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    router_cap_factor: float = 1.25
    moe_impl: str = "gspmd"

    # SSM (Mamba2 / SSD, families "ssm" and "hybrid"): state size N, d_inner
    # = ssm_expand * d_model in heads of ssm_headdim, prefill in chunks of
    # ssm_chunk, a causal conv of width ssm_conv
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4

    # hybrid (zamba2): the shared attention block runs before each segment
    # of hybrid_attn_every Mamba2 layers
    hybrid_attn_every: int = 0

    # encdec (whisper): n_enc_layers encoder layers over enc_seq frame
    # embeddings, the audio frontend's output, given precomputed
    n_enc_layers: int = 0
    enc_seq: int = 1500

    # dtypes
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # attention chunking for long-context prefill: queries in chunks of
    # attn_chunk when the prompt is longer and a multiple of it
    attn_chunk: int = 1024

    max_seq: int = 131072
    # dense arena storage: "model" (= compute dtype) or "int8" (per-vector
    # bf16 scales); the paged pools take EngineConfig.kv_cache_dtype
    kv_dtype: str = "model"

    # training: "block" recomputes each layer in the backward pass
    # (`torch.utils.checkpoint`, as `jax.checkpoint` on the JAX scan's body);
    # "none" keeps every activation
    remat: str = "block"

    # dense decode cache append: True = every sequence writes at lengths[0]
    # (steady-state batch decode); False = each at its own length
    decode_uniform: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def moe_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def window_for_layer(self, i: int) -> Optional[int]:
        """SWA width for layer i (gemma2 alternates local/global)."""
        if self.local_global_pattern:
            return self.sliding_window if i % 2 == 0 else None
        return self.sliding_window

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), the JAX
        package's formula: q, k, v, o (+ QKV bias), the MLP's two or three
        matrices (MoE: every expert's, and the router) and two norm scales
        a layer, the embedding, the LM head and the final norm. A Mamba2
        layer counts in_proj, out_proj, the conv's weights, A_log, D, the
        gated norm and its block norm (not the conv bias or dt_bias); the
        hybrid's shared attention block counts once. An encoder-decoder
        counts its encoder layers, its decoder layers with a second
        (cross) attention and a third norm, and the encoder's positions
        (enc_seq x d), but not the encoder's final norm. Learned decoder
        positions, linear biases other than QKV's and LayerNorm shifts are
        not counted, as in the reference."""
        if self.family not in ("dense", "moe", "ssm", "hybrid", "encdec"):
            raise ValueError(f"unknown model family {self.family!r}")
        d, v = self.d_model, self.vocab
        n_q = self.n_heads * self.head_dim
        n_kv = self.n_kv_heads * self.head_dim
        attn = d * n_q + 2 * d * n_kv + n_q * d
        if self.qkv_bias:
            attn += n_q + 2 * n_kv
        mats = 3 if self.gated_mlp else 2
        if self.family == "moe":
            mlp = self.n_experts * mats * d * self.moe_ff + d * self.n_experts  # + router
        else:
            mlp = mats * d * self.d_ff
        if self.family in ("ssm", "hybrid"):
            din, nh, N = self.d_inner, self.ssm_heads, self.ssm_state
            ssm = (d * (2 * din + 2 * N + nh) + din * d + self.ssm_conv * (din + 2 * N)
                   + 2 * nh + din)
            blocks = self.n_layers * (ssm + d)
            if self.family == "hybrid":
                blocks += attn + mlp + 2 * d
        elif self.family == "encdec":
            blocks = (self.n_enc_layers * (attn + mlp + 2 * d)
                      + self.n_layers * (2 * attn + mlp + 3 * d))
        else:
            blocks = self.n_layers * (attn + mlp + 2 * d)
        enc_pos = self.enc_seq * d if self.family == "encdec" else 0
        return v * d + enc_pos + blocks + v * d + d

    def active_param_count(self) -> int:
        """Parameters one token reads: all of them, less the experts it
        does not route to (n_experts - top_k a layer) in the MoE family."""
        total = self.param_count()
        if self.family != "moe":
            return total
        per_expert = (3 if self.gated_mlp else 2) * self.d_model * self.moe_ff
        return total - self.n_layers * (self.n_experts - self.top_k) * per_expert
