"""The SAL-PIM engine (the port of `repro.core.salpim`): the linear layers,
the paged attention calls and the nonlinear policy behind one object.

Every linear goes through `kernels.ops.pim_linear` (the GEMV kernel on the
card); an activation fuses into the GEMV epilogue, as a LUT table in LUT
mode or as the tanh GELU in exact mode. Paged decode and prefill attention
go through the paged kernels, over fp, int8 or int4 pools; `kv_splits`
engages the KV-split decode kernel at long context.
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
    # KV-split (flash-decode) knob for paged decode attention: None/1 = one
    # page walk; K > 1 = K partials merged by the combine, engaged only for
    # block tables of at least KV_SPLIT_MIN_CONTEXT tokens.
    kv_splits: Optional[int] = None


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
                               k_scales=None, v_scales=None, *,
                               scale: Optional[float] = None,
                               softcap: Optional[float] = None,
                               window: Optional[int] = None) -> torch.Tensor:
        """Decode attention reading K/V through a block table; int8/int4
        pools pass their scale rows. `config.kv_splits` rides along."""
        return ops.pim_paged_attention(
            q, k_pages, v_pages, block_tables, length, k_scales, v_scales,
            scale=scale, exp_table=self._exp_table(), softcap=softcap,
            window=window, kv_splits=self.config.kv_splits)

    def paged_prefill_attention(self, q, k_pages, v_pages, block_tables,
                                length, start, k_scales=None, v_scales=None, *,
                                scale: Optional[float] = None,
                                softcap: Optional[float] = None,
                                window: Optional[int] = None) -> torch.Tensor:
        """Chunked prefill attention; the chunk's own K/V (quantized, with
        its scale rows, in an int8/int4 pool) must already be in the pool."""
        return ops.pim_paged_prefill_attention(
            q, k_pages, v_pages, block_tables, length, start, k_scales,
            v_scales, scale=scale, exp_table=self._exp_table(),
            softcap=softcap, window=window)

    # -- C2: norms -------------------------------------------------------------
    def layernorm(self, x, gamma, beta, eps: float = 1e-5) -> torch.Tensor:
        return self.nl.layernorm(x, gamma, beta, eps)

    def rmsnorm(self, x, gamma, eps: float = 1e-6, *,
                plus_one: bool = False) -> torch.Tensor:
        return self.nl.rmsnorm(x, gamma, eps, plus_one=plus_one)

    def softmax(self, x, axis: int = -1, where=None) -> torch.Tensor:
        return self.nl.softmax(x, axis=axis, where=where)
