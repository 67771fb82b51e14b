"""Fixed-point and int8 arithmetic of SAL-PIM's S-ALU datapath (the port of
`repro.core.quant`).

The S-ALU (paper Sec. 4.1) multiplies 16-bit fixed-point values into
32-bit accumulators, then shifts right by the fraction width and
saturates back to 16 bits. Two paths, as in the JAX package:

  * Q-format int16 (faithful): `QFormat`, `fixed_gemv`, `fixed_linear`;
    int32 accumulation that wraps modulo 2^32 (as XLA's int32 einsum
    does), arithmetic right shift, saturation to [-32768, 32767];
  * int8 with one symmetric scale a row: `quantize_int8_rowwise`,
    `int8_linear`; int32 accumulation, then `acc * x_scale * w_scale` in
    f32, left to right.

Semantics kept exactly, because the serving tests compare bits:

  * `QFormat.quantize` works in f32 (`round(x * 2^f)`, half to even, clip
    to the format's range); `dequantize` is `q / 2^f` in f32.
  * `quantize_int8_rowwise` works in the weight's own dtype: with bf16
    weights `absmax`, `max(absmax, 1e-8) / 127` and `w / scale` are bf16
    values, and only the returned scale is cast to f32. `int8_linear`
    quantizes x in x's dtype the same way.
  * Every operation rounds on its own, as the JAX functions do op by op:
    `/ 127.0` is a division and the bias add is not fused into the
    rescale. Inside `jit`, XLA on the CPU turns the division by the
    constant into a multiplication by f32(1/127) and contracts
    `acc * x_scale * w_scale + b` into an FMA, which moves the last f32
    bit of some values. So the port equals the JAX functions run eagerly
    bit for bit, and the jitted JAX engine in its greedy tokens. torch on
    CUDA would also multiply by the reciprocal of a Python-number
    divisor, so the divisor 127 is a tensor filled on the device (no copy
    from the host, which a CUDA graph could not capture): the division
    stays a division on the card.
  * `int32_matmul` is the integer product of every plain path: computed
    in float64, which is exact here (|acc| <= 2^42 < 2^53 for int16
    operands at C <= 4096, < 2^26 for int8), then wrapped to int32
    through int64. It runs on the CPU and on the card alike (torch has
    no int32 matmul on CUDA).
"""
from __future__ import annotations

import dataclasses

import torch

I16_MIN = -32768
I16_MAX = 32767


def int32_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Integer x (..., C) . w (R, C)^T -> int32 (..., R), wrapping modulo
    2^32 like an int32 accumulator."""
    acc = torch.matmul(x.double(), w.double().t()).to(torch.int64)
    return wrap_int32(acc)


def wrap_int32(acc: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 modulo 2^32 (two's complement)."""
    return (((acc + 2 ** 31) & (2 ** 32 - 1)) - 2 ** 31).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class QFormat:
    """Qm.f fixed point in `bits` total (default S-ALU: 16-bit)."""

    frac_bits: int
    bits: int = 16

    @property
    def scale(self) -> float:
        return float(1 << self.frac_bits)

    @property
    def min_int(self) -> int:
        return -(1 << (self.bits - 1))

    @property
    def max_int(self) -> int:
        return (1 << (self.bits - 1)) - 1

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        q = torch.round(x.float() * self.scale)
        q = torch.clamp(q, self.min_int, self.max_int)
        return q.to(torch.int16 if self.bits == 16 else torch.int32)

    def dequantize(self, q: torch.Tensor) -> torch.Tensor:
        return q.float() / self.scale


# Default S-ALU formats: weights Q3.12, activations Q5.10.
DEFAULT_WEIGHT_Q = QFormat(frac_bits=12)
DEFAULT_ACT_Q = QFormat(frac_bits=10)


def requantize_i32_to_i16(acc: torch.Tensor, shift: int) -> torch.Tensor:
    """The S-ALU writeback: arithmetic right shift + saturate to int16."""
    return torch.clamp(acc >> shift, I16_MIN, I16_MAX).to(torch.int16)


def fixed_gemv(w_q: torch.Tensor, x_q: torch.Tensor, *, shift: int) -> torch.Tensor:
    """int16 W (R, C) @ int16 x (C,) -> int16 (R,) with int32 accumulation."""
    return requantize_i32_to_i16(int32_matmul(x_q, w_q), shift)


def fixed_linear(x: torch.Tensor, w_q: torch.Tensor, b_q: torch.Tensor | None, *,
                 w_fmt: QFormat = DEFAULT_WEIGHT_Q, x_fmt: QFormat = DEFAULT_ACT_Q,
                 out_fmt: QFormat = DEFAULT_ACT_Q) -> torch.Tensor:
    """Float-in/float-out wrapper over the fixed-point datapath.

    x: (..., C) float; w_q int16 (R, C); b_q int32 in the accumulator
    scale (w_fmt.frac_bits + x_fmt.frac_bits), added into the wrapping
    int32 accumulator as the S-ALU's 32-bit bias add."""
    x_q = x_fmt.quantize(x)
    acc = int32_matmul(x_q, w_q)
    if b_q is not None:
        acc = wrap_int32(acc.long() + b_q.long())
    shift = w_fmt.frac_bits + x_fmt.frac_bits - out_fmt.frac_bits
    return out_fmt.dequantize(requantize_i32_to_i16(acc, shift)).to(x.dtype)


def quantize_weights_fixed(w: torch.Tensor, fmt: QFormat = DEFAULT_WEIGHT_Q) -> torch.Tensor:
    return fmt.quantize(w)


def quantize_bias_fixed(b: torch.Tensor, w_fmt: QFormat = DEFAULT_WEIGHT_Q,
                        x_fmt: QFormat = DEFAULT_ACT_Q) -> torch.Tensor:
    scale = float(1 << (w_fmt.frac_bits + x_fmt.frac_bits))
    return torch.round(b.float() * scale).to(torch.int32)


# ---------------------------------------------------------------------------
# int8 path (per-row symmetric scales)
# ---------------------------------------------------------------------------

def quantize_int8_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., C) -> int8 (..., C) + (...) scale, both computed in x's dtype:
    scale = max(absmax, 1e-8) / 127, q = clip(round(x / scale), +-127)."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def quantize_int8_rowwise(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, C) float -> int8 (R, C) + float32 (R,) scales (symmetric)."""
    w_i8, scale = quantize_int8_rows(w)
    return w_i8, scale.float()


def int8_linear(x: torch.Tensor, w_i8: torch.Tensor, scale: torch.Tensor,
                b: torch.Tensor | None = None) -> torch.Tensor:
    """x (..., C) float @ int8 W (R, C) with int32 accum, fp32 rescale."""
    x_i8, x_scale = quantize_int8_rows(x)
    out = int32_matmul(x_i8, w_i8).float() * x_scale[..., None] * scale
    if b is not None:
        out = out + b
    return out.to(x.dtype)
