"""The SAL-PIM engine (the port of `repro.core.salpim`): the linear layers,
the paged attention calls and the nonlinear policy behind one object.

Every linear goes through `kernels.ops.pim_linear` (the GEMV kernel on the
card); an activation fuses into the GEMV epilogue, as a LUT table in LUT
mode or as the tanh GELU in exact mode. Paged decode and prefill attention
go through the two paged kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.nonlinear import Nonlinear
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class SalPimConfig:
    """Technique knobs (paper Table 2 defaults)."""

    nonlinear_mode: str = "exact"   # "exact" | "lut"
    lut_sections: int = 64          # paper: 64; >=32 keeps accuracy
    quant: str = "none"             # only "none" is ported
    kv_splits: Optional[int] = None  # KV-split decode is not ported


@dataclasses.dataclass(frozen=True)
class SalPimEngine:
    config: SalPimConfig
    nl: Nonlinear

    @classmethod
    def create(cls, config: SalPimConfig | None = None) -> "SalPimEngine":
        config = config or SalPimConfig()
        if config.quant != "none":
            raise NotImplementedError(
                f"quant={config.quant!r}: the int8 and fixed16 GEMV kernels "
                "are not ported yet")
        if config.kv_splits is not None and config.kv_splits > 1:
            raise NotImplementedError(
                "kv_splits > 1: the KV-split decode kernel is not ported yet")
        nl = Nonlinear.create(config.nonlinear_mode, config.lut_sections)
        return cls(config=config, nl=nl)

    # -- C1: linear ----------------------------------------------------------
    def linear(self, x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor | None = None, *,
               act: str | None = None) -> torch.Tensor:
        """y = act(x @ w^T + b). x: (..., C), w: (R, C)."""
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        if act is None:
            out = ops.pim_linear(x2, w, b)
        elif self.nl.mode == "lut":
            out = ops.pim_linear(x2, w, b, act_table=getattr(self.nl.bank, act))
        elif act == "gelu":
            out = ops.pim_linear(x2, w, b, act="gelu")
        else:
            out = self.nl.activation(act)(ops.pim_linear(x2, w, b))
        return out.reshape(*lead, -1)

    # -- C3: paged attention ---------------------------------------------------
    def _exp_table(self):
        return self.nl.bank.exp if self.nl.mode == "lut" else None

    def paged_decode_attention(self, q, k_pages, v_pages, block_tables, length,
                               *, scale: Optional[float] = None,
                               softcap: Optional[float] = None,
                               window: Optional[int] = None) -> torch.Tensor:
        """Decode attention reading K/V through a block table."""
        return ops.pim_paged_attention(
            q, k_pages, v_pages, block_tables, length, scale=scale,
            exp_table=self._exp_table(), softcap=softcap, window=window)

    def paged_prefill_attention(self, q, k_pages, v_pages, block_tables,
                                length, start, *,
                                scale: Optional[float] = None,
                                softcap: Optional[float] = None,
                                window: Optional[int] = None) -> torch.Tensor:
        """Chunked prefill attention; the chunk's own K/V must already be
        in the pool."""
        return ops.pim_paged_prefill_attention(
            q, k_pages, v_pages, block_tables, length, start, scale=scale,
            exp_table=self._exp_table(), softcap=softcap, window=window)

    # -- C2: norms -------------------------------------------------------------
    def layernorm(self, x, gamma, beta, eps: float = 1e-5) -> torch.Tensor:
        return self.nl.layernorm(x, gamma, beta, eps)

    def rmsnorm(self, x, gamma, eps: float = 1e-6, *,
                plus_one: bool = False) -> torch.Tensor:
        return self.nl.rmsnorm(x, gamma, eps, plus_one=plus_one)

    def softmax(self, x, axis: int = -1, where=None) -> torch.Tensor:
        return self.nl.softmax(x, axis=axis, where=where)
