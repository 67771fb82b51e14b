"""Qwen2-VL-2B [arXiv:2409.12191; hf]: the qwen2 backbone (28L d1536 12H
GQA(kv=2) ff8960 v151936, head_dim 128) with M-RoPE sections (16, 24, 24)
(as `repro.configs.qwen2_vl_2b`).

The vision frontend is a stub, and serving is the text path: the three
M-RoPE position streams are each token's position, so M-RoPE is RoPE."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab=151936, head_dim=128,
        qkv_bias=True, rope_theta=1_000_000.0, mrope_sections=(16, 24, 24),
        activation="silu", gated_mlp=True, norm="rmsnorm",
        tie_embeddings=True, max_seq=131072,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab=512, head_dim=16,
        qkv_bias=True, mrope_sections=(2, 3, 3),
        activation="silu", gated_mlp=True, norm="rmsnorm",
        param_dtype="float32", compute_dtype="float32",
        max_seq=256, attn_chunk=32, remat="none",
    )
