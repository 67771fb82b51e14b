"""Model configuration: the fields of `repro.models.config.ModelConfig`
that the dense serving paths (paged pools and the dense arena) read, with
the same names and defaults."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # the port serves "dense" only (RoPE or
                                     # learned positions)
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

    def window_for_layer(self, i: int) -> Optional[int]:
        """SWA width for layer i (gemma2 alternates local/global)."""
        if self.local_global_pattern:
            return self.sliding_window if i % 2 == 0 else None
        return self.sliding_window
