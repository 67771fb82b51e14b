"""The SAL-PIM engine (the port of `repro.core.salpim`): the linear layers,
the paged attention calls and the nonlinear policy behind one object.

`linear` takes one of four datapaths, in the JAX engine's order:

  * a `QTensor` weight (`serving.quantize.quantize_params_int8`):
    `qtensor_linear`, the int8 linear layer (`kernels.ops.pim_int8_linear`)
    with x quantized per row in f32, the bias added in f32, the result
    cast to x's dtype and, in LUT mode, the activation's table: one kernel
    launch at decode widths;
  * `quant="int8"`: the weight quantized per row on every call in its own
    dtype (`core.quant.quantize_int8_rows`, one kernel launch on the card,
    which reads the weight while the kernel before it runs; bf16 weights
    give bf16 scales), then the int8 linear layer with x
    quantized per row in x's dtype (in the GEMV's load path at decode
    widths), whose epilogue takes the scales as they are, adds `b` in f32,
    casts to x's dtype and, in LUT mode, applies the activation's table;
  * `quant="fixed16"`: one launch on the card (`kernels.ops.
    pim_fixed_linear`): x in Q(`fixed_frac_x`) and the weight in
    Q(`fixed_frac_w`), quantized on every call as the kernel loads them,
    the fixed16 product shifting by `fixed_frac_w` so its int16 result is
    in x's format, dequantized, cast to x's dtype, `+ b` in x's dtype and,
    in LUT mode, the activation's table;
  * otherwise the float GEMV, `kernels.ops.pim_linear`, with the bias and
    activation fused into its epilogue (a LUT table in LUT mode, the tanh
    GELU in exact mode).

On the quantized routes an exact-mode activation runs after the GEMV,
`self.nl.activation(act)`.

The weights are quantized on every call, as the JAX package does; caching
them is the pre-quantized path's job. Decode attention over the dense
arena goes through the `decode_attention` kernel, paged decode and prefill
attention through the paged kernels over fp, int8 or int4 pools;
`kv_splits` engages the KV-split decode kernel at long context. The norms
and the LUT softmax of the dense prefill go through `Nonlinear`, which
routes them to their kernels.

Training: on the card, while autograd records, the float route runs in
`Linear`, a `torch.autograd.Function` whose forward is the float GEMV
with its bias and no epilogue (the backward needs the pre-activation) and
whose backward is dX, dW and db as `torch.matmul` and a sum, products the
JAX package leaves to XLA; the activation then runs on its own, a LUT
table through `Nonlinear`'s `LutApply` and the exact GELU as PyTorch's
tanh GELU. With no recording the fused launch stays. The quantized
routes and `QTensor` weights refuse to train: their gradient would be a
rounding's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import nonlinear as nl_lib
from repro_torch.core.nonlinear import Nonlinear
from repro_torch.kernels import ops
from repro_torch.serving.quantize import QTensor, qtensor_linear


class Linear(torch.autograd.Function):
    """x2 (M, C) @ w (R, C)^T + b through `ops.pim_linear`; the gradients
    as `torch.matmul` in x's dtype (f32 accumulation), db summed in f32."""

    @staticmethod
    def forward(ctx, x2, w, b):
        ctx.save_for_backward(x2, w)
        ctx.b_dtype = b.dtype if b is not None else None
        return ops.pim_linear(x2.contiguous(), w, b)

    @staticmethod
    def backward(ctx, dy):
        x2, w = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(dy, w.to(dy.dtype))
        if ctx.needs_input_grad[1]:
            dw = torch.matmul(dy.t(), x2.to(dy.dtype)).to(w.dtype)
        if ctx.b_dtype is not None and ctx.needs_input_grad[2]:
            db = dy.float().sum(0).to(ctx.b_dtype)
        return dx, dw, db


@dataclasses.dataclass(frozen=True)
class SalPimConfig:
    """Technique knobs (paper Table 2 defaults)."""

    nonlinear_mode: str = "exact"   # "exact" | "lut"
    lut_sections: int = 64          # paper: 64; >=32 keeps accuracy
    quant: str = "none"             # "none" | "int8" | "fixed16"
    fixed_frac_w: int = 12          # Q-format fraction bits (weights)
    fixed_frac_x: int = 10          # Q-format fraction bits (activations)
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
        nl = Nonlinear.create(config.nonlinear_mode, config.lut_sections)
        return cls(config=config, nl=nl)

    # -- C1: linear ----------------------------------------------------------
    def linear(self, x: torch.Tensor, w: torch.Tensor | QTensor,
               b: torch.Tensor | None = None, *,
               act: str | None = None) -> torch.Tensor:
        """y = act(x @ w^T + b). x: (..., C), w: (R, C) or a QTensor."""
        lead = x.shape[:-1]
        cfg = self.config
        if (isinstance(w, QTensor) or cfg.quant != "none") and nl_lib.records(
                x, w if isinstance(w, torch.Tensor) else None, b):
            raise ValueError("training runs the float datapath only: quant="
                             f"{cfg.quant!r} and QTensor weights have no gradient but a "
                             "rounding's")
        # The activation's LUT rides the quantized GEMV's epilogue.
        table = getattr(self.nl.bank, act, None) if act and self.nl.mode == "lut" else None
        if isinstance(w, QTensor):
            out = qtensor_linear(x, w, b, act_table=table)
        elif cfg.quant not in ("int8", "fixed16"):
            x2 = x.reshape(-1, x.shape[-1])
            return self._float_linear(x2, w, b, act, table).reshape(*lead, -1)
        elif cfg.quant == "int8":
            w_i8, w_scale = ops.pim_quantize_int8_rows(w, static_input=True)
            out = ops.pim_int8_linear(x.reshape(-1, x.shape[-1]), w_i8, w_scale, b,
                                      act_table=table).reshape(*lead, -1)
        else:
            out = ops.pim_fixed_linear(x.reshape(-1, x.shape[-1]), w, b,
                                       frac_x=cfg.fixed_frac_x, frac_w=cfg.fixed_frac_w,
                                       act_table=table).reshape(*lead, -1)
        if act is None or table is not None:
            return out
        return self.nl.activation(act)(out)

    def _float_linear(self, x2, w, b, act, table):
        """The float GEMV with the activation fused into its epilogue: the
        LUT `table`, or the exact GELU; an activation with neither (exact
        SiLU, squared ReLU, which has no table) runs after the GEMV. While
        autograd records on the card, `Linear` and then the activation."""
        if nl_lib.autograd_route(x2, w, b):
            out = Linear.apply(x2, w, b)
            return self.nl.activation(act)(out) if act is not None else out
        if act is None or table is not None:
            return ops.pim_linear(x2, w, b, act_table=table)
        if act == "gelu" and self.nl.mode == "exact":
            return ops.pim_linear(x2, w, b, act="gelu")
        return self.nl.activation(act)(ops.pim_linear(x2, w, b))

    # -- C3: decode attention, dense arena and paged ---------------------------
    def _exp_table(self):
        return self.nl.bank.exp if self.nl.mode == "lut" else None

    def decode_attention(self, q, k, v, length, k_scale=None, v_scale=None, *,
                         scale: Optional[float] = None,
                         softcap: Optional[float] = None,
                         window: Optional[int] = None,
                         plan_kv_heads: Optional[int] = None) -> torch.Tensor:
        """Decode attention over a dense per-slot arena k/v (B, Hkv, S, D);
        the int8 arena passes its scale rows; `plan_kv_heads` plans the
        kernel's walk (a mesh rank's: the model's KV heads)."""
        return ops.pim_decode_attention(q, k, v, length, k_scale, v_scale, scale=scale,
                                        exp_table=self._exp_table(),
                                        softcap=softcap, window=window,
                                        plan_kv_heads=plan_kv_heads)

    def decode_attention_partials(self, q, k, v, length, k_scale=None, v_scale=None, *,
                                  key_offset: int, scale: Optional[float] = None,
                                  softcap: Optional[float] = None,
                                  window: Optional[int] = None):
        """The (m, l, acc) partials of one rank's slice of a sequence-sharded
        arena, its local key 0 at position key_offset, for the merge across
        the ranks."""
        return ops.pim_decode_attention_partials(q, k, v, length, k_scale, v_scale,
                                                 key_offset=key_offset, scale=scale,
                                                 exp_table=self._exp_table(),
                                                 softcap=softcap, window=window)

    def paged_decode_attention(self, q, k_pages, v_pages, block_tables, length,
                               k_scales=None, v_scales=None, *,
                               scale: Optional[float] = None,
                               softcap: Optional[float] = None,
                               window: Optional[int] = None,
                               plan_kv_heads: Optional[int] = None) -> torch.Tensor:
        """Decode attention reading K/V through a block table; int8/int4
        pools pass their scale rows. `config.kv_splits` rides along;
        `plan_kv_heads` plans the kernel's walk (a mesh rank's: the model's
        KV heads)."""
        return ops.pim_paged_attention(
            q, k_pages, v_pages, block_tables, length, k_scales, v_scales,
            scale=scale, exp_table=self._exp_table(), softcap=softcap,
            window=window, kv_splits=self.config.kv_splits,
            plan_kv_heads=plan_kv_heads)

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

    def attention_softmax(self, scores, *, q_offset: int = 0, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
        return self.nl.attention_softmax(scores, q_offset=q_offset, causal=causal,
                                         window=window)
