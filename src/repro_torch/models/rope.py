"""Rotary position embeddings, standard RoPE and Qwen2-VL's M-RoPE (the
port of `repro.models.rope`, op for op).

The angles are taken in f32; `apply_rope` casts cos and sin to x's dtype
before the products, and pairs the halves x[..., :D/2] and x[..., D/2:]
(the rotate-half convention of llama and qwen). M-RoPE splits the
rotation frequencies into (temporal, height, width) sections, each driven
by its own position stream; for text alone the three streams are equal
and M-RoPE is RoPE.

These are plain PyTorch operations on the device, as the JAX package
computes them in XLA and not in a Pallas kernel: a model computes cos and
sin once a step and every layer rotates its q and k with them.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) f32 inverse frequencies."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) int -> cos/sin (..., head_dim/2) f32."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  sections: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (3, ...) temporal/height/width ids -> cos/sin (...,
    head_dim/2): section i of the half-dim takes stream i's angles."""
    assert sum(sections) == head_dim // 2, (sections, head_dim)
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang_all = positions[..., None].to(torch.float32) * freqs   # (3, ..., half)
    parts_c, parts_s = [], []
    start = 0
    for axis, width in enumerate(sections):
        sl = ang_all[axis, ..., start:start + width]
        parts_c.append(torch.cos(sl))
        parts_s.append(torch.sin(sl))
        start += width
    return torch.cat(parts_c, -1), torch.cat(parts_s, -1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D); cos/sin (..., S, D/2), broadcast over the heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
