"""Mamba2 blocks (SSD, state-space duality): the chunked prefill and the
one-token decode recurrence (the port of `repro.models.mamba2`).

Per head h, with state size N and head dim P:
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t x_t^T        (N x P state)
    y_t = C_t h_t + D * x_t

The prefill runs the chunked dual form (arXiv:2405.21060 Listing 1): inside
a chunk an attention-like quadratic form, across chunks a short scan that
carries the state. The decode step is one recurrence step.

The reference computes SSD, the causal conv and the recurrence with XLA
ops outside any Pallas kernel, so here they are PyTorch operations
(`torch.einsum`, `cumsum`, elementwise), in f32 as there; TF32 stays off
(PyTorch's default for matmul), so the card computes them in f32. What the
reference sends through its engine goes through the port's kernels:
`in_proj` and `out_proj` through `engine.linear` (the float GEMV, or the
int8 one for `QTensor` weights), the gated norm over d_inner through
`engine.rmsnorm` (`layernorm_lut`) and, in LUT mode, SiLU and softplus
through `lut_interp`.

`engine.linear` is given parameters alone here (in_proj, out_proj), so
`quant="int8"`'s `quantize_int8_rows(..., static_input=True)`, which may
read its input before the kernel ahead of it has finished, stays sound.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.salpim import SalPimEngine
from repro_torch.models.config import ModelConfig


def init_mamba2(normal, cfg: ModelConfig, n_layers: int) -> dict:
    """Stacked (L, ...) Mamba2 weights with the JAX package's stds and
    constants: in_proj d^-0.5, conv_w 0.1, zero conv_b, A_log =
    log(linspace(1, 16, nh)), D ones and dt_bias = log(expm1(0.01)) in f32,
    norm_g ones, out_proj d_inner^-0.5."""
    d, din, nh, N, L = cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, n_layers
    conv_dim = din + 2 * N
    # in_proj emits [z (din), x (din), B (N), C (N), dt (nh)]
    d_in_proj = 2 * din + 2 * N + nh
    w = normal((L, d_in_proj, d), d ** -0.5)
    dev = w.device

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32, device=dev))
    return {
        "in_proj": w,
        "conv_w": normal((L, cfg.ssm_conv, conv_dim), 0.1),
        "conv_b": full((L, conv_dim), 0.0, cfg.pdtype),
        "A_log": a_log.expand(L, nh).contiguous(),
        "D": full((L, nh), 1.0, torch.float32),
        "dt_bias": full((L, nh), math.log(math.expm1(0.01)), torch.float32),
        "norm_g": full((L, din), 1.0, cfg.pdtype),
        "out_proj": normal((L, d, din), din ** -0.5),
    }


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    din, N = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :din]
    x = zxbcdt[..., din:2 * din]
    B = zxbcdt[..., 2 * din:2 * din + N]
    C = zxbcdt[..., 2 * din + N:2 * din + 2 * N]
    dt = zxbcdt[..., 2 * din + 2 * N:]
    return z, x, B, C, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with kernel (K, C): K unrolled
    taps over the input zero-padded on the left."""
    K, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(K):
        out = out + pad[:, i:i + S] * w[i]
    return out + b


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int, initial_state: torch.Tensor | None = None):
    """Chunked SSD scan, in the dtype of its inputs (f32 on every path).

    x (B, S, H, P); dt (B, S, H), post-softplus, >= 0; A (H,), negative;
    Bm/Cm (B, S, N). Returns y (B, S, H, P) and the final state (B, H, N, P).
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        # Zero padding to a chunk multiple: dt = 0 on the padding adds
        # nothing to the state and decays it by 1, so this is exact.
        pad = chunk - S % chunk
        y, final = ssd_chunked(F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), A,
                               F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad)), chunk,
                               initial_state)
        return y[:, :S], final
    nc = S // chunk
    xc = x.reshape(Bsz, nc, chunk, H, P)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, N)
    Cc = Cm.reshape(Bsz, nc, chunk, N)

    dA = dtc * A[None, None, None, :]                   # (B, nc, L, H), <= 0
    dA_cum = torch.cumsum(dA, dim=2)

    # Inside a chunk: M[i, j] = C_i . B_j * exp(dA_cum_i - dA_cum_j) * dt_j
    # for j <= i. The min keeps the masked-out upper triangle finite: its
    # exp would overflow to inf, and inf * 0 is NaN.
    seg = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]   # (B, nc, L, L, H)
    li = torch.arange(chunk, device=x.device)
    causal = (li[:, None] >= li[None, :])[None, None, :, :, None]
    decay = torch.where(causal, torch.exp(torch.clamp(seg, max=0.0)), 0.0)
    cb = torch.einsum("bnic,bnjc->bnij", Cc, Bc)
    M = cb[..., None] * decay * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", M, xc)

    # Chunk states: S_n = sum_j exp(dA_cum_last - dA_cum_j) dt_j B_j x_j^T
    last = dA_cum[:, :, -1:, :]
    w_state = torch.exp(torch.clamp(last - dA_cum, max=0.0)) * dtc
    states = torch.einsum("bnlh,bnlc,bnlhp->bnhcp", w_state, Bc, xc)   # (B, nc, H, N, P)

    # Across chunks: the running state with each chunk's decay.
    chunk_decay = torch.exp(torch.sum(dA, dim=2))                      # (B, nc, H)
    h = (torch.zeros((Bsz, H, N, P), dtype=x.dtype, device=x.device)
         if initial_state is None else initial_state)
    h_prevs = []
    for n in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, n, :, None, None] + states[:, n]
    h_prevs = torch.stack(h_prevs, dim=1)                              # (B, nc, H, N, P)

    # The carried state's contribution: y_j += C_j exp(dA_cum_j) h_prev
    y_inter = torch.einsum("bnlc,bnlh,bnhcp->bnlhp", Cc, torch.exp(dA_cum), h_prevs)
    return (y_intra + y_inter).reshape(Bsz, S, H, P), h


def apply_mamba2(p: dict, x: torch.Tensor, cfg: ModelConfig, engine: SalPimEngine, *,
                 return_state: bool = False):
    """Full-sequence Mamba2 block, x (B, S, D) -> (B, S, D). With
    return_state also the final SSM state (B, H, N, P) f32 and the conv
    window's continuation (B, K-1, d_inner + 2N): the last K-1 rows of the
    conv's input. A prompt shorter than K-1 tokens gets them zero-padded
    on the left, as the conv pads (the reference keeps fewer rows there,
    and its next decode step fails on the shape)."""
    Bsz, S, _ = x.shape
    din, N, nh, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    zxbcdt = engine.linear(x, p["in_proj"])
    z, xs, Bm, Cm, dt = _split_proj(zxbcdt, cfg)

    xbc_raw = torch.cat([xs, Bm, Cm], dim=-1)
    xbc = engine.nl.silu(_causal_conv(xbc_raw, p["conv_w"].to(x.dtype),
                                      p["conv_b"].to(x.dtype)))
    xs, Bm, Cm = xbc[..., :din], xbc[..., din:din + N], xbc[..., din + N:]

    dt = engine.nl.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(Bsz, S, nh, P)
    y, state = ssd_chunked(xh.float(), dt, A, Bm.float(), Cm.float(), cfg.ssm_chunk)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.reshape(Bsz, S, din).to(x.dtype)
    y = engine.rmsnorm(y * engine.nl.silu(z), p["norm_g"], cfg.norm_eps)
    out = engine.linear(y, p["out_proj"])
    if return_state:
        K = cfg.ssm_conv
        tail = xbc_raw[:, max(S - (K - 1), 0):]
        if tail.shape[1] < K - 1:
            tail = F.pad(tail, (0, 0, K - 1 - tail.shape[1], 0))
        return out, state, tail
    return out


def mamba2_decode_step(p: dict, x: torch.Tensor, ssm_state: torch.Tensor,
                       conv_state: torch.Tensor, cfg: ModelConfig, engine: SalPimEngine):
    """One-token recurrence. x (B, D); ssm_state (B, H, N, P) f32 and
    conv_state (B, K-1, d_inner + 2N), the raw window before the conv: one
    layer's rows of the cache, both written in place. Returns
    (out (B, D), ssm_state, conv_state)."""
    Bsz, _ = x.shape
    din, N, nh, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    zxbcdt = engine.linear(x, p["in_proj"])
    z, xs, Bm, Cm, dt = _split_proj(zxbcdt, cfg)

    xbc_new = torch.cat([xs, Bm, Cm], dim=-1)                          # (B, conv_dim)
    window = torch.cat([conv_state, xbc_new[:, None].to(conv_state.dtype)], dim=1)
    conv = (torch.sum(window * p["conv_w"].to(x.dtype)[None], dim=1)
            + p["conv_b"].to(x.dtype))
    conv = engine.nl.silu(conv)
    xs, Bm, Cm = conv[..., :din], conv[..., din:din + N], conv[..., din + N:]
    conv_state.copy_(window[:, 1:])

    dt = engine.nl.softplus(dt.float() + p["dt_bias"])                # (B, nh)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A[None, :])
    xh = xs.reshape(Bsz, nh, P).float()
    # h = h * dA + dt * B x^T: an outer product a head
    upd = dt[:, :, None, None] * Bm[:, None, :, None].float() * xh[:, :, None, :]
    ssm_state.copy_(ssm_state * dA[:, :, None, None] + upd)
    y = torch.einsum("bhcp,bc->bhp", ssm_state, Cm.float())
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(Bsz, din).to(x.dtype)
    y = engine.rmsnorm(y * engine.nl.silu(z), p["norm_g"], cfg.norm_eps)
    out = engine.linear(y, p["out_proj"])
    return out, ssm_state, conv_state
