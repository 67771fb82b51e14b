"""Token sampling: greedy, or temperature / top-k from a torch.Generator
(the port of `repro.serving.sampling`; sampled tokens differ from JAX's,
whose random bits come from `jax.random`)."""
from __future__ import annotations

import torch


def sample(logits: torch.Tensor, generator: torch.Generator | None = None, *,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits (B, V) -> tokens (B,) int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
