"""Mamba2-370M [arXiv:2405.21060]: 48L d1024 SSD state 128, attention-free
(as `repro.configs.mamba2_370m`). Decode is GEMVs and elementwise work;
the LUT path carries softplus, SiLU and the norms' rsqrt."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        n_layers=48, d_model=1024, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab=50280,
        ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
        activation="silu", norm="rmsnorm", max_seq=1 << 20,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab=512,
        ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_chunk=8,
        activation="silu", norm="rmsnorm",
        param_dtype="float32", compute_dtype="float32",
        max_seq=256, remat="none",
    )
