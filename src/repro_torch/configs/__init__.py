"""Model configurations the port serves, by name (the port's own copy of
the registry part of `repro.configs`, which imports JAX).

    get_config("qwen2-1.5b")                 # the published widths
    get_config("qwen2_1_5b", smoke=True)     # the CPU-sized twin

Each module has `config()` and `smoke_config()` with the JAX package's
fields, less those the port's `ModelConfig` does not carry (`remat`).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# The dense models of the JAX package's registry that the port serves.
ARCHS = ["qwen2_1_5b", "gemma2_2b", "nemotron_4_340b", "h2o_danube3_4b",
         "gpt2_medium"]

# Published names that do not map to a module by "-"/"." -> "_".
ALIASES = {"h2o-danube-3-4b": "h2o_danube3_4b"}


def normalize(name: str) -> str:
    return ALIASES.get(name, name.replace("-", "_").replace(".", "_"))


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod_name = normalize(name)
    if mod_name not in ARCHS:
        raise NotImplementedError(f"model {name!r} is not ported yet "
                                  f"(ported: {', '.join(ARCHS)})")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.smoke_config() if smoke else mod.config()
