"""Feed-forward networks, gated and plain (the port of `repro.models.ffn`).
`engine.linear(..., act=...)` fuses the activation into the GEMV epilogue."""
from __future__ import annotations

import torch

from repro_torch.core.salpim import SalPimEngine
from repro_torch.models.config import ModelConfig


def init_ffn(normal, cfg: ModelConfig, n_layers: int) -> dict:
    """Stacked (L, ...) FFN weights with the JAX package's stds."""
    d, f, L = cfg.d_model, cfg.d_ff, n_layers
    p = {
        "w_up": normal((L, f, d), d ** -0.5),
        "w_down": normal((L, d, f), f ** -0.5),
    }
    if cfg.gated_mlp:
        p["w_gate"] = normal((L, f, d), d ** -0.5)
    return p


def apply_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig,
              engine: SalPimEngine) -> torch.Tensor:
    """x (..., D) -> (..., D)."""
    if cfg.gated_mlp:
        h = (engine.linear(x, p["w_gate"], act=cfg.activation)
             * engine.linear(x, p["w_up"]))
    else:
        h = engine.linear(x, p["w_up"], act=cfg.activation)
    return engine.linear(h, p["w_down"])
