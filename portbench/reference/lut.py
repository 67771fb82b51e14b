"""LUT interpolation tables, a frozen copy of the construction the paper's
C2 unit uses (64 sections by default, Table 2): per section a (slope,
intercept) row connecting the function's values at the section edges,
with a guard row on each side, so y = W[sec(x)] * x + B[sec(x)].

Kept apart from the program so that the yardstick does not move when the
program's tables do. float32 throughout, as the program evaluates them.
"""
from __future__ import annotations

import numpy as np
import torch


class Table:
    """(sections + 2, 2) float32 rows over [lo, hi]."""

    def __init__(self, fn, lo: float, hi: float, sections: int, left, right):
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
        self.wb = np.stack([np.concatenate([[lw], w, [rw]]),
                            np.concatenate([[lb], b, [rb]])], axis=-1).astype(np.float32)
        self.lo, self.hi, self.sections = float(lo), float(hi), sections
        self._dev = {}

    def rows(self, device) -> torch.Tensor:
        key = str(device)
        if key not in self._dev:
            self._dev[key] = torch.from_numpy(self.wb).to(device)
        return self._dev[key]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """y = W[sec(x)] * x + B[sec(x)] in float32; the section index is
        floor((x - lo) * S / (hi - lo)) + 1 clamped into [0, S + 1]."""
        xf = x.float()
        inv_step = self.sections / (self.hi - self.lo)
        raw = torch.clamp(torch.floor((xf - self.lo) * inv_step), -1.0, float(self.sections))
        idx = raw.to(torch.int64) + 1
        wb = self.rows(x.device)
        return wb[idx, 0] * xf + wb[idx, 1]


def _gelu(x):
    return 0.5 * x * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x ** 3)))


class Bank:
    """The tables one served model reads: GELU, exp (softmax inputs are
    max-subtracted, so [-12, 0]) and rsqrt on a [0.25, 1) mantissa."""

    def __init__(self, sections: int = 64):
        self.gelu = Table(_gelu, -8.0, 8.0, sections, 0.0, "identity")
        self.exp = Table(np.exp, -12.0, 0.0, sections, 0.0, "line")
        self.rsqrt_m = Table(lambda m: 1.0 / np.sqrt(m), 0.25, 1.0, sections, "line", "line")

    def rsqrt(self, x: torch.Tensor) -> torch.Tensor:
        """1/sqrt(x), x > 0: x = m * 2**e from the float32 bits, the
        exponent's parity folded into m in [0.25, 1), the table on m."""
        bits = x.float().contiguous().view(torch.int32)
        e = ((bits >> 23) & 0xFF) - 126
        m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
        odd = (e & 1) == 1
        m2 = torch.where(odd, m * 0.5, m)
        e2 = torch.where(odd, e + 1, e)
        return self.rsqrt_m(m2) * torch.exp2(-(e2 // 2).float())
