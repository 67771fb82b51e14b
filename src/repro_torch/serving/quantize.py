"""Write-time KV quantization (the KV part of `repro.serving.quantize`).

One K or V vector per (token, head) is quantized with one symmetric amax
scale, at the moment it is written into a page pool; the paged kernels
dequantize it as they stage pages, and the plain versions after their
gather, both as `q * scale` in fp32, so every read agrees bit for bit.

  * int8: scale = max(amax, 1e-8) / 127, q = clip(round(x / scale), ±127);
  * int4: scale = max(amax, 1e-8) / 7, q = clip(round(x / scale), ±7),
    two values a byte (`pack_int4`).

`q` is computed with the f32 scale, and only then is the scale cast to
its storage dtype (f32 or bf16). `torch.round` rounds half to even, as
`jnp.round` does.
"""
from __future__ import annotations

import torch


def quantize_vec(x: torch.Tensor, scale_dtype=torch.float32):
    """(..., D) -> (int8 payload (..., D), scale (...) in `scale_dtype`)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(scale_dtype)


def dequantize_vec(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Exact inverse read of `quantize_vec`: payload * scale, cast."""
    return (q.float() * scale[..., None].float()).to(dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., D) values in [-8, 7] -> (..., D/2) int8, two nibbles a byte.

    Halves convention: byte i holds element i in its low nibble and
    element i + D/2 in its high nibble. The byte is hi * 16 + (lo & 0xF),
    formed in int16, which is the two's-complement int8 of
    (hi << 4) | (lo & 0xF) without a shift of an int8 tensor.
    """
    d = q.shape[-1]
    if d % 2:
        raise ValueError("int4 packing needs an even head_dim")
    lo = q[..., : d // 2].to(torch.int16)
    hi = q[..., d // 2:].to(torch.int16)
    return (hi * 16 + (lo & 0xF)).to(torch.int8)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """(..., D/2) packed int8 -> (..., D) int8 in [-8, 7]; exact inverse of
    `pack_int4`. Nibbles are sign-extended in int16 arithmetic: the low one
    as ((p & 0xF) ^ 8) - 8, the high one by the arithmetic shift p >> 4."""
    w = p.to(torch.int16)
    lo = ((w & 0xF) ^ 8) - 8
    hi = w >> 4
    return torch.cat([lo, hi], dim=-1).to(torch.int8)


def quantize_vec_int4(x: torch.Tensor, scale_dtype=torch.float32):
    """(..., D) -> (packed int8 payload (..., D/2), scale (...))."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 7.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -7, 7).to(torch.int8)
    return pack_int4(q), scale.to(scale_dtype)


def dequantize_vec_int4(p: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Exact inverse read of `quantize_vec_int4`: unpack, scale, cast."""
    return (unpack_int4(p).float() * scale[..., None].float()).to(dtype)
