"""Model configurations the port serves, by name (the port's own copy of
the registry part of `repro.configs`, which imports JAX).

    get_config("qwen2-1.5b")                 # the published widths
    get_config("qwen2_1_5b", smoke=True)     # the CPU-sized twin

Each module has `config()` and `smoke_config()` with the JAX package's
fields that the port's `ModelConfig` carries (`remat` among them: the
smoke twins set "none", as the JAX package's do).

The dry run's cells (`launch/dryrun.py`) come from here too, with the
reference's names and values: `SHAPES`, `LONG_CONTEXT_OK`,
`LONG_CONTEXT_SKIP_REASON`, `cells()` and `input_specs()`, whose stand-ins
are `meta` tensors (shapes and dtypes, no storage).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch

from repro_torch.models.config import ModelConfig

# The models of the JAX package's registry, in its order, all of which the
# port serves: the dense (with the VLM's text path) and MoE families, and
# the SSM, hybrid and encoder-decoder families (the dense cache only).
ARCHS = ["qwen2_1_5b", "gemma2_2b", "nemotron_4_340b", "h2o_danube3_4b",
         "whisper_large_v3", "mamba2_370m", "qwen2_vl_2b", "zamba2_1_2b",
         "olmoe_1b_7b", "phi35_moe_42b", "gpt2_medium"]

# Published names that do not map to a module by "-"/"." -> "_".
ALIASES = {"h2o-danube-3-4b": "h2o_danube3_4b",
           "phi3.5-moe-42b": "phi35_moe_42b",
           "phi3.5-moe-42b-a6.6b": "phi35_moe_42b"}


def normalize(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod_name = normalize(name)
    if mod_name not in ARCHS:
        raise NotImplementedError(f"model {name!r} is not ported yet "
                                  f"(ported: {', '.join(ARCHS)})")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.smoke_config() if smoke else mod.config()


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Archs that run long_500k (sub-quadratic or windowed attention).
LONG_CONTEXT_OK = {
    "mamba2_370m",      # O(1) SSM state
    "zamba2_1_2b",      # hybrid: SSM + shared-attn KV (sequence-sharded)
    "gemma2_2b",        # alternating local(SWA)/global
    "h2o_danube3_4b",   # SWA
}
# Pure full-attention archs skip long_500k.
LONG_CONTEXT_SKIP_REASON = {
    "qwen2_1_5b": "pure full attention",
    "nemotron_4_340b": "pure full attention",
    "whisper_large_v3": "decoder context architecturally capped (448)",
    "qwen2_vl_2b": "pure full attention",
    "olmoe_1b_7b": "pure full attention",
    "phi35_moe_42b": "pure full attention",
    "gpt2_medium": "pure full attention (learned pos emb, 1024 cap)",
}


def cells(include_skipped: bool = False) -> list[tuple[str, str]]:
    """All (arch, shape) dry-run cells: 40, of which 34 live. GPT-2 medium,
    the paper's model, is not a cell."""
    out = []
    for arch in ARCHS:
        if arch == "gpt2_medium":
            continue
        for shape in SHAPES.values():
            skipped = shape.name == "long_500k" and arch not in LONG_CONTEXT_OK
            if skipped and not include_skipped:
                continue
            out.append((arch, shape.name))
    return out


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *,
                batch_override: Optional[int] = None) -> dict:
    """`meta` stand-ins for every model input of a cell (no storage): for
    train and prefill the global batch of sequences, for decode one token a
    sequence; the reference's shapes, its int32/float32 in torch's dtypes
    and the compute dtype for frames and patch embeddings."""
    B = batch_override or shape.global_batch
    S = shape.seq_len

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    f, i32 = cfg.cdtype, torch.int32
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": sds((B, S), i32)}
        if shape.kind == "train":
            specs["labels"] = sds((B, S), i32)
            specs["mask"] = sds((B, S), torch.float32)
        if cfg.family == "encdec":
            specs["frames"] = sds((B, cfg.enc_seq, cfg.d_model), f)
        if cfg.mrope_sections is not None:
            specs["patch_embeds"] = sds((B, 256, cfg.d_model), f)
        return specs
    if shape.kind == "decode":
        return {"token": sds((B,), i32)}
    raise ValueError(shape.kind)
