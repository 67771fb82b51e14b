"""Zamba2-1.2B [arXiv:2411.15242; hf]: 38 Mamba2 layers (state 64) and one
SHARED attention + GeGLU block run before each segment of 6 layers (as
`repro.configs.zamba2_1_2b`: the shared block's LoRA specialization is
left out there too)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32000, head_dim=64,
        ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
        hybrid_attn_every=6, rope_theta=10000.0,
        activation="gelu", gated_mlp=True, norm="rmsnorm",
        max_seq=1 << 20,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, head_dim=16,
        ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_chunk=8,
        hybrid_attn_every=2,
        activation="gelu", gated_mlp=True, norm="rmsnorm",
        param_dtype="float32", compute_dtype="float32",
        max_seq=256, attn_chunk=32, remat="none",
    )
