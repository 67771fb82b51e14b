"""PyTorch/CUDA port of the SAL-PIM serving path (`repro` is the JAX reference).

The package mirrors `repro`'s module names so each port module sits beside
its counterpart: `core/` (LUT tables, nonlinear policy, the SAL-PIM
engine), `kernels/` (hand-written CUDA kernels for Hopper with their plain
PyTorch versions), `models/` (the dense decoder over a paged KV cache) and
`serving/` (the paged continuous-batching engine).

It imports torch and numpy only. Entry points run on `cuda` unless the
caller passes `device="cpu"`; with no GPU they raise instead of falling
back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device with its index ("cuda" -> "cuda:<current>",
    the form tensors report); raises when CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
