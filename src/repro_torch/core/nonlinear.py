"""Non-linear ops with a switchable policy: exact torch vs SAL-PIM LUT path
(the port of `repro.core.nonlinear`).

Softmax follows the paper's PIM flow: max -> subtract -> LUT exp ->
reduce-sum -> LUT reciprocal (range-reduced) -> multiply. The norms, the
LUT activations and the LUT attention softmax go through `kernels.ops`,
so a CUDA tensor runs the port's kernels (`layernorm_lut` in both modes,
`lut_interp`, `softmax_lut`) and a CPU tensor their plain versions, which
are op for op the code the JAX package's `Nonlinear` runs inline.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import lut as lut_lib
from repro_torch.core.lut import LutBank
from repro_torch.kernels import ops
from repro_torch.kernels.softmax_lut import attention_mask


@dataclasses.dataclass(frozen=True)
class Nonlinear:
    """Policy object. mode: 'exact' | 'lut'."""

    mode: str = "exact"
    bank: LutBank | None = None
    sections: int = lut_lib.DEFAULT_SECTIONS

    @classmethod
    def create(cls, mode: str = "exact",
               sections: int = lut_lib.DEFAULT_SECTIONS) -> "Nonlinear":
        if mode not in ("exact", "lut"):
            raise ValueError(f"unknown nonlinear mode {mode!r}")
        bank = LutBank.create(sections) if mode == "lut" else None
        return cls(mode=mode, bank=bank, sections=sections)

    # -- scalar activations -------------------------------------------------
    def gelu(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "lut":
            return ops.lut_apply(x, self.bank.gelu)
        return F.gelu(x, approximate="tanh")

    def silu(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "lut":
            return ops.lut_apply(x, self.bank.silu)
        return F.silu(x)

    def tanh(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "lut":
            return ops.lut_apply(x, self.bank.tanh)
        return torch.tanh(x)

    def sigmoid(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "lut":
            return ops.lut_apply(x, self.bank.sigmoid)
        return torch.sigmoid(x)

    def softplus(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "lut":
            return ops.lut_apply(x, self.bank.softplus)
        return F.softplus(x)

    def exp_neg(self, x: torch.Tensor) -> torch.Tensor:
        """exp for max-subtracted inputs (x <= 0)."""
        if self.mode == "lut":
            return lut_lib.apply_table(x, self.bank.exp)
        return torch.exp(x)

    def reciprocal_pos(self, x: torch.Tensor) -> torch.Tensor:
        """1/x for x > 0 (softmax denominators, LN variances)."""
        if self.mode == "lut":
            return lut_lib.lut_reciprocal(x, self.bank.recip)
        return 1.0 / x

    def squared_relu(self, x: torch.Tensor) -> torch.Tensor:
        r = torch.clamp(x, min=0.0)
        return r * r

    def activation(self, kind: str):
        return {
            "gelu": self.gelu,
            "silu": self.silu,
            "squared_relu": self.squared_relu,
            "tanh": self.tanh,
        }[kind]

    # -- composite ops ------------------------------------------------------
    def softmax(self, x: torch.Tensor, axis: int = -1,
                where: torch.Tensor | None = None) -> torch.Tensor:
        """PIM-flow softmax: max -> LUT exp -> sum -> LUT recip -> mul."""
        if where is not None:
            x = torch.where(where, x, -torch.inf)
        m = torch.amax(x, dim=axis, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)   # fully-masked rows
        e = self.exp_neg(x - m)
        if where is not None:
            e = torch.where(where, e, 0.0)
        s = torch.sum(e, dim=axis, keepdim=True)
        return e * self.reciprocal_pos(torch.clamp(s, min=1e-9))

    def attention_softmax(self, scores: torch.Tensor, *, q_offset: int = 0,
                          causal: bool = True,
                          window: int | None = None) -> torch.Tensor:
        """Softmax of attention scores (..., Sq, Sk) over keys visible to
        the queries at q_offset + i: (not causal or k <= q) and (window is
        None or k > q - window). LUT mode takes `ops.pim_softmax`, which
        derives the mask per row; exact mode is `softmax(where=mask)`."""
        if self.mode == "lut":
            return ops.pim_softmax(scores, self.bank.exp, self.bank.recip,
                                   q_offset=q_offset, causal=causal, window=window)
        mask = attention_mask(scores.shape[-2], scores.shape[-1], q_offset,
                              causal, window, scores.device)
        return self.softmax(scores, where=mask)

    def _rsqrt_table(self):
        return self.bank.rsqrt if self.mode == "lut" else None

    def layernorm(self, x: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
        return ops.pim_layernorm(x, gamma, beta, eps=eps,
                                 rsqrt_table=self._rsqrt_table())

    def rmsnorm(self, x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6,
                *, plus_one: bool = False) -> torch.Tensor:
        return ops.pim_layernorm(x, gamma, None, eps=eps,
                                 rsqrt_table=self._rsqrt_table(), rms=True,
                                 plus_one=plus_one)

    def softcap(self, x: torch.Tensor, cap: float) -> torch.Tensor:
        """Logit soft-capping: cap * tanh(x / cap) via LUT tanh."""
        return cap * self.tanh(x / cap)
