"""Qwen2-1.5B: 28L d1536 12H GQA(kv=2) ff8960 v151936, head_dim 128 (as
`repro.configs.qwen2_1_5b`).

GQA with QKV bias; RoPE theta 1e6; SwiGLU; RMSNorm; tied embeddings in the
release, kept untied in params as the JAX package keeps them."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab=151936, head_dim=128,
        qkv_bias=True, rope_theta=1_000_000.0,
        activation="silu", gated_mlp=True, norm="rmsnorm", norm_eps=1e-6,
        tie_embeddings=True, max_seq=131072,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab=512, head_dim=16,
        qkv_bias=True, rope_theta=1_000_000.0,
        activation="silu", gated_mlp=True, norm="rmsnorm",
        param_dtype="float32", compute_dtype="float32",
        max_seq=256, attn_chunk=32, remat="none",
    )
