"""OLMoE-1B-7B [arXiv:2409.02060; hf]: 16L d2048 16H, MoE 64 experts top-8,
expert d_ff 1024 (as `repro.configs.olmoe_1b_7b`). The router's softmax
rides the LUT-exp path."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=1024, vocab=50304, head_dim=128,
        rope_theta=10000.0,
        n_experts=64, top_k=8, moe_d_ff=1024,
        activation="silu", gated_mlp=True, norm="rmsnorm",
        max_seq=4096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab=512, head_dim=16,
        n_experts=8, top_k=2, moe_d_ff=96, router_cap_factor=64.0,
        activation="silu", gated_mlp=True, norm="rmsnorm",
        param_dtype="float32", compute_dtype="float32",
        max_seq=256, attn_chunk=32, remat="none",
    )
