"""Phi-3.5-MoE-42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct]:
32L d4096 32H GQA(kv=8), MoE 16 experts top-2, expert d_ff 6400, LayerNorm
(as `repro.configs.phi35_moe_42b`)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=6400, vocab=32064, head_dim=128,
        rope_theta=10000.0,
        n_experts=16, top_k=2, moe_d_ff=6400,
        activation="silu", gated_mlp=True, norm="layernorm", norm_eps=1e-5,
        max_seq=131072,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=512, head_dim=16,
        n_experts=4, top_k=2, moe_d_ff=96, router_cap_factor=64.0,
        activation="silu", gated_mlp=True, norm="layernorm",
        param_dtype="float32", compute_dtype="float32",
        max_seq=256, attn_chunk=32, remat="none",
    )
