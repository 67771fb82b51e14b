"""GPT-2-medium end-to-end latency on SAL-PIM (paper Sec. 5.3 workload).

Composes per-op costs into the decoder stack for both stages:
  summarization — n_in tokens processed as a batch (PIM has no weight
  reuse advantage: weights stream once per token-vector, the paper's
  stated reason GPU wins this stage);
  generation    — one token per iteration, context grows.
"""
from __future__ import annotations

import dataclasses

from repro_torch.pimsim.hbm import SalPimConfigHW
from repro_torch.pimsim import ops


@dataclasses.dataclass(frozen=True)
class Gpt2Medium:
    n_layers: int = 24
    d_model: int = 1024
    n_heads: int = 16
    d_ff: int = 4096
    vocab: int = 50257

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def decoder_layer_cost(hw: SalPimConfigHW, m: Gpt2Medium, ctx: int,
                       n_tokens: int = 1) -> ops.Cost:
    """One decoder layer for n_tokens input vectors with ctx cached KV."""
    d, h, hd, f = m.d_model, m.n_heads, m.head_dim, m.d_ff
    c = ops.Cost()
    for _ in range(1):  # structure, per token batch
        # layerNorm 1
        c = c + ops.layernorm(hw, d) * n_tokens
        # QKV projections (weights stream once per token in PIM)
        c = c + ops.gemv(hw, 3 * d, d) * n_tokens
        # Q x K^T per head (multi-head mapping: heads on channels)
        c = c + ops.gemv(hw, ctx, hd, multihead_parallel=h) * n_tokens
        # softmax over ctx per head
        c = c + ops.softmax(hw, ctx, heads=h) * n_tokens
        # S x V per head
        c = c + ops.gemv(hw, hd, ctx, multihead_parallel=h) * n_tokens
        # output projection + residual
        c = c + ops.gemv(hw, d, d) * n_tokens
        c = c + ops.elementwise(hw, d) * n_tokens
        # layerNorm 2
        c = c + ops.layernorm(hw, d) * n_tokens
        # FFN with GELU LUT + residual
        c = c + ops.gemv(hw, f, d) * n_tokens
        c = c + ops.lut_op(hw, f) * n_tokens
        c = c + ops.gemv(hw, d, f) * n_tokens
        c = c + ops.elementwise(hw, d) * n_tokens
    return c


def iteration_cost(hw: SalPimConfigHW, m: Gpt2Medium, ctx: int,
                   n_tokens: int = 1, *, with_logits: bool = True) -> ops.Cost:
    c = ops.Cost()
    for layer in range(m.n_layers):
        c = c + decoder_layer_cost(hw, m, ctx, n_tokens)
    c = c + ops.layernorm(hw, m.d_model) * n_tokens
    if with_logits:
        c = c + ops.gemv(hw, m.vocab, m.d_model)  # final token only
    return c


def text_generation_cost(hw: SalPimConfigHW, m: Gpt2Medium,
                         n_in: int, n_out: int) -> dict:
    """End-to-end (summarization + generation), seconds + energy."""
    summ = iteration_cost(hw, m, ctx=n_in, n_tokens=n_in, with_logits=True)
    gen = ops.Cost()
    for i in range(max(n_out - 1, 0)):
        ctx = n_in + i + 1
        gen = gen + iteration_cost(hw, m, ctx=ctx, n_tokens=1)
    total = summ + gen
    return {
        "summarize_s": summ.time_ns * 1e-9,
        "generate_s": gen.time_ns * 1e-9,
        "total_s": total.time_ns * 1e-9,
        "energy_j": total.energy_pj * 1e-12,
        "bytes": total.bytes_read,
        "avg_bandwidth_gbps": total.bytes_read / max(total.time_ns, 1e-9),
    }


def average_power_w(hw: SalPimConfigHW, m: Gpt2Medium, n_in: int,
                    n_out: int) -> dict:
    """Paper Fig. 15: average power during generation, incl. the 26%
    refresh share of the 60 W budget and peripheral standby."""
    r = text_generation_cost(hw, m, n_in, n_out)
    refresh = hw.refresh_fraction * hw.power_budget_w
    compute = r["energy_j"] / r["total_s"]
    total = compute + refresh
    return {
        "compute_w": compute,
        "refresh_w": refresh,
        "total_w": total,
        "budget_w": hw.power_budget_w,
        "over_budget_frac": total / hw.power_budget_w - 1.0,
    }
