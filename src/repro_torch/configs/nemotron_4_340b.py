"""Nemotron-4-340B: 96L d18432 96H GQA(kv=8) ff73728 v256000, head_dim 192
(as `repro.configs.nemotron_4_340b`): a plain squared-ReLU MLP, LayerNorm,
no biases."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b", family="dense",
        n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
        d_ff=73728, vocab=256000, head_dim=192,
        rope_theta=10000.0,
        activation="squared_relu", gated_mlp=False, norm="layernorm",
        norm_eps=1e-5, max_seq=4096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b-smoke", family="dense",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
        d_ff=384, vocab=512, head_dim=16,
        activation="squared_relu", gated_mlp=False, norm="layernorm",
        param_dtype="float32", compute_dtype="float32",
        max_seq=256, attn_chunk=32,
    )
