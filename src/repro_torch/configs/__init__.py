"""Model configurations the port serves, by name (the port's own copy of
the registry part of `repro.configs`, which imports JAX).

    get_config("qwen2-1.5b")                 # the published widths
    get_config("qwen2_1_5b", smoke=True)     # the CPU-sized twin

Each module has `config()` and `smoke_config()` with the JAX package's
fields that the port's `ModelConfig` carries (`remat` among them: the
smoke twins set "none", as the JAX package's do).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# The models of the JAX package's registry, all of which the port serves:
# the dense (with the VLM's text path) and MoE families, and the SSM,
# hybrid and encoder-decoder families (the dense cache only).
ARCHS = ["qwen2_1_5b", "gemma2_2b", "nemotron_4_340b", "h2o_danube3_4b",
         "gpt2_medium", "olmoe_1b_7b", "phi35_moe_42b", "mamba2_370m", "zamba2_1_2b",
         "whisper_large_v3", "qwen2_vl_2b"]

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
