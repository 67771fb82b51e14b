"""LUT-based linear interpolation (SAL-PIM's C2), the port of `repro.core.lut`.

Tables are built with numpy exactly as the JAX package builds them: per
section a (slope, intercept) row connecting fn's values at the section
edges, with a left and a right guard row, so ``y = W[sec(x)] * x + B[sec(x)]``
needs no branch. `apply_table` is the plain PyTorch application; the CUDA
kernels read the same `wb` rows from shared memory.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

DEFAULT_SECTIONS = 64  # paper Table 2


@dataclasses.dataclass(frozen=True)
class LutTable:
    """Piecewise-linear table for one scalar function.

    wb: (sections + 2, 2) float32 numpy — column 0 slope, column 1
        intercept; rows 0 and -1 are the out-of-range guards.
    lo/hi: calibrated interpolation range.
    """

    name: str
    lo: float
    hi: float
    wb: np.ndarray
    _on_device: dict = dataclasses.field(default_factory=dict, compare=False,
                                         repr=False)

    @property
    def sections(self) -> int:
        return self.wb.shape[0] - 2

    @property
    def inv_step(self) -> float:
        return self.sections / (self.hi - self.lo)

    def wb_on(self, device) -> torch.Tensor:
        """The (S+2, 2) float32 table as a tensor on `device` (copied once)."""
        dev = torch.device(device)
        key = str(dev)
        if key not in self._on_device:
            self._on_device[key] = torch.from_numpy(
                np.ascontiguousarray(self.wb, np.float32)).to(dev)
        return self._on_device[key]


def build_table(
    fn: Callable[[np.ndarray], np.ndarray],
    lo: float,
    hi: float,
    sections: int,
    *,
    name: str = "fn",
    left: str | float = "line",
    right: str | float = "line",
) -> LutTable:
    """Build (slope, intercept) rows connecting fn's values at section edges.

    left/right: guard behaviour outside [lo, hi]: "line" extends the
    boundary section's line, "identity" is y = x, a float c is y = c.
    """
    xs = np.linspace(lo, hi, sections + 1, dtype=np.float64)
    ys = np.asarray(fn(xs), dtype=np.float64)
    w = (ys[1:] - ys[:-1]) / (xs[1:] - xs[:-1])
    b = ys[:-1] - w * xs[:-1]

    def guard(spec, edge_w, edge_b):
        if spec == "line":
            return edge_w, edge_b
        if spec == "identity":
            return 1.0, 0.0
        return 0.0, float(spec)

    lw, lb = guard(left, w[0], b[0])
    rw, rb = guard(right, w[-1], b[-1])
    wb = np.stack(
        [np.concatenate([[lw], w, [rw]]), np.concatenate([[lb], b, [rb]])],
        axis=-1,
    )
    return LutTable(name=name, lo=float(lo), hi=float(hi),
                    wb=wb.astype(np.float32))


def section_index(x: torch.Tensor, table: LutTable) -> torch.Tensor:
    """The 'decoding unit': map x to a guarded section row index.

    floor((x - lo) * S / (hi - lo)) + 1 clamped into [0, S+1], in f32
    whatever x's dtype, as in the kernels. The clamp happens before the
    integer conversion so that huge or infinite inputs convert safely.
    """
    xf = x.float()
    raw = torch.floor((xf - table.lo) * table.inv_step)
    raw = torch.clamp(raw, -1.0, float(table.sections))
    return raw.to(torch.int64) + 1


def apply_table(x: torch.Tensor, table: LutTable) -> torch.Tensor:
    """Reference LUT interpolation: y = W[sec(x)] * x + B[sec(x)]."""
    idx = section_index(x, table)
    wb = table.wb_on(x.device)
    return (wb[idx, 0] * x.float() + wb[idx, 1]).to(x.dtype)


# ---------------------------------------------------------------------------
# Standard tables (same ranges as the JAX package)
# ---------------------------------------------------------------------------

def _np_gelu(x):
    return 0.5 * x * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x**3)))


def _np_silu(x):
    return x / (1.0 + np.exp(-x))


def _np_softplus(x):
    return np.log1p(np.exp(-np.abs(x))) + np.maximum(x, 0.0)


def gelu_table(sections: int = 64) -> LutTable:
    return build_table(_np_gelu, -8.0, 8.0, sections, name="gelu", left=0.0,
                       right="identity")


def silu_table(sections: int = 64) -> LutTable:
    return build_table(_np_silu, -8.0, 8.0, sections, name="silu", left=0.0,
                       right="identity")


def exp_table(sections: int = 64, reach: float = 12.0) -> LutTable:
    """exp on [-reach, 0]: softmax inputs are max-subtracted."""
    return build_table(np.exp, -reach, 0.0, sections, name="exp", left=0.0,
                       right="line")


def tanh_table(sections: int = 64) -> LutTable:
    return build_table(np.tanh, -4.0, 4.0, sections, name="tanh", left=-1.0,
                       right=1.0)


def softplus_table(sections: int = 64) -> LutTable:
    return build_table(_np_softplus, -10.0, 10.0, sections, name="softplus",
                       left=0.0, right="identity")


def sigmoid_table(sections: int = 64) -> LutTable:
    return build_table(lambda x: 1.0 / (1.0 + np.exp(-x)), -8.0, 8.0,
                       sections, name="sigmoid", left=0.0, right=1.0)


def recip_table(sections: int = 64) -> LutTable:
    """1/m for mantissa m in [0.5, 1] — used with power-of-two range reduction."""
    return build_table(lambda m: 1.0 / m, 0.5, 1.0, sections, name="recip")


def rsqrt_table(sections: int = 64) -> LutTable:
    """1/sqrt(m) for m in [0.25, 1] — covers both exponent parities."""
    return build_table(lambda m: 1.0 / np.sqrt(m), 0.25, 1.0, sections,
                       name="rsqrt")


# ---------------------------------------------------------------------------
# Range reduction by exponent extraction on the float32 bit pattern
# ---------------------------------------------------------------------------

def _frexp(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = m * 2**e with m in [0.5, 1). Positive finite x only."""
    bits = x.float().contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 126
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    return m, e


def lut_reciprocal(x: torch.Tensor, table: LutTable) -> torch.Tensor:
    """1/x via LUT on the mantissa: 1/x = (1/m) * 2**-e. x > 0."""
    m, e = _frexp(x)
    r = apply_table(m, table)
    return (r * torch.exp2(-e.float())).to(x.dtype)


def lut_rsqrt(x: torch.Tensor, table: LutTable) -> torch.Tensor:
    """1/sqrt(x) via LUT: fold exponent parity into a [0.25, 1) mantissa."""
    m, e = _frexp(x)
    odd = (e & 1) == 1
    m2 = torch.where(odd, m * 0.5, m)
    e2 = torch.where(odd, e + 1, e)
    r = apply_table(m2, table)
    return (r * torch.exp2(-(e2 // 2).float())).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class LutBank:
    """All tables one model needs — the 'LUT-embedded subarrays' content."""

    gelu: LutTable
    silu: LutTable
    exp: LutTable
    tanh: LutTable
    softplus: LutTable
    sigmoid: LutTable
    recip: LutTable
    rsqrt: LutTable

    @classmethod
    def create(cls, sections: int = DEFAULT_SECTIONS) -> "LutBank":
        return cls(
            gelu=gelu_table(sections),
            silu=silu_table(sections),
            exp=exp_table(sections),
            tanh=tanh_table(sections),
            softplus=softplus_table(sections),
            sigmoid=sigmoid_table(sections),
            recip=recip_table(sections),
            rsqrt=rsqrt_table(sections),
        )
