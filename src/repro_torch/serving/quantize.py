"""Serving-time int8 quantization (the port of `repro.serving.quantize`):
int8 weights with one scale a row, and write-time KV quantization.

Weights. `quantize_params_int8` rewrites every matmul weight leaf of a
parameter tree (keys matching `_QUANT_PATHS`: the attention projections,
the FFN and the LM head; not `embed` or `pos_embed`) into a `QTensor`,
int8 `w_i8` (..., R, C) with f32 `scale` (..., R), in the same place of
the tree. `quantize_leaf` works in f32: scale = max(amax, 1e-8) / 127,
w_i8 = clip(round(w / scale), +-127), each operation rounded on its own
as in the JAX function run eagerly. `qtensor_linear` is
`kernels.ops.pim_int8_linear` with f32 compute: x (..., C) quantized the
same way in f32, the s8 x s8 product (`gemv_pim_int8_ref`'s function
exactly: int32 sum, `* x_scale * scale`, `+ b` in f32), the result cast
to x's dtype and, given a table, the LUT; on the card one kernel launch
at decode widths, with no cast of x, b or the result around it.

KV. One K or V vector per (token, head) is quantized with one symmetric
amax scale, at the moment it is written into a page pool; the paged
kernels dequantize it as they stage pages, and the plain versions after
their gather, both as `q * scale` in fp32, so every read agrees bit for
bit.

  * int8: scale = max(amax, 1e-8) / 127, q = clip(round(x / scale), ±127);
  * int4: scale = max(amax, 1e-8) / 7, q = clip(round(x / scale), ±7),
    two values a byte (`pack_int4`).

`q` is computed with the f32 scale, and only then is the scale cast to
its storage dtype (f32 or bf16). `torch.round` rounds half to even, as
`jnp.round` does.
"""
from __future__ import annotations

import dataclasses
import re

import torch

from repro_torch.core import quant as quant_lib

# weight leaves that are matmul operands (rows = output features)
_QUANT_PATHS = re.compile(
    r"(w[qkv]|wo|w_up|w_gate|w_down|in_proj|out_proj|lm_head)$")


@dataclasses.dataclass
class QTensor:
    """int8 weight + per-output-row scale; drop-in for a (R, C) matrix."""

    w_i8: torch.Tensor       # (..., R, C) int8
    scale: torch.Tensor      # (..., R) float32

    @property
    def shape(self):
        return self.w_i8.shape

    @property
    def ndim(self):
        return self.w_i8.ndim

    def to(self, device) -> "QTensor":
        return QTensor(self.w_i8.to(device), self.scale.to(device))

    def unbind(self) -> list["QTensor"]:
        """A stacked (L, R, C) QTensor -> L per-layer (R, C) QTensors."""
        return [QTensor(w, s) for w, s in zip(torch.unbind(self.w_i8, 0),
                                              torch.unbind(self.scale, 0))]


def quantize_leaf(w: torch.Tensor) -> QTensor:
    w_i8, scale = quant_lib.quantize_int8_rows(w.float())
    return QTensor(w_i8=w_i8, scale=scale)


def quantize_params_int8(params, path: str = ""):
    """Rewrite matmul weights to QTensor; leave everything else alone.
    `params` is a nested dict; a leaf's path joins its keys with "/"."""
    if isinstance(params, dict):
        return {k: quantize_params_int8(v, f"{path}/{k}" if path else str(k))
                for k, v in params.items()}
    if _QUANT_PATHS.search(path) and params.ndim >= 2:
        return quantize_leaf(params)
    return params


def qtensor_linear(x: torch.Tensor, q: QTensor, b: torch.Tensor | None = None, *,
                   act_table=None) -> torch.Tensor:
    """x (..., C) @ QTensor (R, C) -> (..., R) in x's dtype: s8 x s8 -> s32
    product, the bias (in its own dtype) added in f32, then the LUT
    `act_table` on the cast value."""
    # Imported here: kernels.paged_attention imports this module.
    from repro_torch.kernels import ops
    lead = x.shape[:-1]
    out = ops.pim_int8_linear(x.reshape(-1, x.shape[-1]), q.w_i8, q.scale, b,
                              compute=torch.float32, act_table=act_table)
    return out.reshape(*lead, -1)


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
