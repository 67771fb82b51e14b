"""Gemma2-2B: 26L d2304 8H GQA(kv=4) ff9216 v256000, head_dim 256 (as
`repro.configs.gemma2_2b`).

Alternating local (4096-token sliding window) and global attention,
attention softcap 50, final softcap 30, RMSNorm(1 + w) with pre- and
post-norms, GeGLU, embedding scaling."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", family="dense",
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
        d_ff=9216, vocab=256000, head_dim=256,
        rope_theta=10000.0, sliding_window=4096, local_global_pattern=True,
        attn_softcap=50.0, final_softcap=30.0, attn_scale=256**-0.5,
        activation="gelu", gated_mlp=True, norm="rmsnorm_plus1",
        post_norms=True, embed_scale=True, tie_embeddings=True,
        max_seq=131072,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab=512, head_dim=16,
        sliding_window=16, local_global_pattern=True,
        attn_softcap=50.0, final_softcap=30.0, attn_scale=16**-0.5,
        activation="gelu", gated_mlp=True, norm="rmsnorm_plus1",
        post_norms=True, embed_scale=True,
        param_dtype="float32", compute_dtype="float32",
        max_seq=256, attn_chunk=32, remat="none",
    )
