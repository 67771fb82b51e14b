"""GPT-2 medium (345M), the paper's evaluation model: 24L d1024 16H ff4096
v50257, learned positions, LayerNorm, GELU (as `repro.configs.gpt2_medium`)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gpt2-medium", family="dense",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
        d_ff=4096, vocab=50257, head_dim=64,
        qkv_bias=True, learned_pos_emb=True,
        activation="gelu", gated_mlp=False, norm="layernorm", norm_eps=1e-5,
        max_seq=1024, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gpt2-medium-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab=512, head_dim=16,
        qkv_bias=True, learned_pos_emb=True,
        activation="gelu", gated_mlp=False, norm="layernorm",
        param_dtype="float32", compute_dtype="float32",
        max_seq=256, attn_chunk=32, remat="none",
    )
