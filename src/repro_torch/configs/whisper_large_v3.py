"""Whisper-large-v3 [arXiv:2212.04356]: encoder-decoder, 32 + 32 layers,
d1280 20H ff5120 v51866 (as `repro.configs.whisper_large_v3`).

The audio conv frontend is a stub: the encoder takes (B, 1500, d) frame
embeddings. LayerNorm, GELU (a plain MLP), learned positions, biases on
the q/k/v projections. max_seq is raised past the release's 448 as in the
JAX package."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="encdec",
        n_layers=32, n_enc_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
        d_ff=5120, vocab=51866, head_dim=64,
        qkv_bias=True, learned_pos_emb=True, enc_seq=1500,
        activation="gelu", gated_mlp=False, norm="layernorm", norm_eps=1e-5,
        max_seq=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3-smoke", family="encdec",
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, head_dim=16,
        qkv_bias=True, learned_pos_emb=True, enc_seq=16,
        activation="gelu", gated_mlp=False, norm="layernorm",
        param_dtype="float32", compute_dtype="float32",
        max_seq=256, attn_chunk=32, remat="none",
    )
