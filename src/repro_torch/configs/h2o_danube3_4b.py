"""H2O-Danube3-4B: 24L d3840 32H GQA(kv=8) ff10240 v32000, head_dim 120
(as `repro.configs.h2o_danube3_4b`): Llama/Mistral-style with a
4096-token sliding window."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b", family="dense",
        n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
        d_ff=10240, vocab=32000, head_dim=120,
        rope_theta=500000.0, sliding_window=4096,
        activation="silu", gated_mlp=True, norm="rmsnorm",
        max_seq=131072,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-3-4b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab=512, head_dim=16, sliding_window=16,
        activation="silu", gated_mlp=True, norm="rmsnorm",
        param_dtype="float32", compute_dtype="float32",
        max_seq=256, attn_chunk=32,
    )
