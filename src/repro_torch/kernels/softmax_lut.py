"""Row softmax by the paper's PIM flow (SAL-PIM C2 + C3): max -> LUT exp ->
sum -> range-reduced LUT reciprocal -> multiply.

`softmax_lut` launches the CUDA kernel `csrc/softmax_lut.cu`, which
replaces the TPU kernel `src/repro/kernels/softmax_lut.py::softmax_lut`;
`softmax_lut_plain` is its plain PyTorch version, the twin of the
reference branch of the JAX package's `ops.pim_softmax` and, with a mask,
op for op the code of `Nonlinear.softmax(where=...)` in LUT mode.

x (..., Sq, Sk) scores over the last axis. With `causal` or `window`
the rows are queries at absolute positions q_offset + i (i < Sq, the
second-to-last axis) and key k is kept when (not causal or k <= qpos) and
(window is None or k > qpos - window), the mask of the dense prefill's
`_masked_softmax_attn`; masked entries come out 0, and a row with no valid
key comes out all zeros. Without a mask it is the TPU kernel's function.

Bound on the H100: one read of the valid keys and one write of the scores
over 3.35 TB/s. `softmax_plan` shapes the launch: a warp a row up to 1024
keys (a call of few rows spreads a row over more warps), the row held in
registers and read once; a group of up to 8 warps a row up to 8192 keys;
a block a row, streamed, past that.

`softmax_lut_backward` (`csrc/backward.cu`, which replaces no TPU kernel:
the JAX package differentiates `Nonlinear.softmax` with XLA's autodiff)
is the gradient for training, what `softmax_lut_backward_plain` (autograd
of `softmax_lut_plain`) computes: r = 1/sum is a constant under the
gradient (the LUT reciprocal reads the float's bits), a visible key gets
t_j = dy_j * r * W_exp[sec(x_j - m)], the row's max element(s) also
-sum_j t_j, shared equally among ties (the gradient of the max), and a
masked key 0. A warp a row, over the row's visible keys only.
"""
from __future__ import annotations

import torch

from repro_torch.core import lut as lut_lib
from repro_torch.core.lut import LutTable
from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODE as _DTYPE_CODE

# The most values of a row a lane holds in registers (8 f32 or 4 bf16
# pieces of 16 bytes); ptxas fits that with no spill.
MAX_VALUES_PER_LANE = 32


def softmax_plan(n_rows: int, S: int, itemsize: int) -> tuple[int, int, int]:
    """(chunks, warps_per_row, rows_per_block) of the kernel's launch
    (`_build.row_plan`); chunks 0 streams each row through a block."""
    plan = _build.row_plan(n_rows, S, itemsize, MAX_VALUES_PER_LANE * itemsize // 16)
    return plan if plan is not None else (0, _build.BLOCK_WARPS, 1)


def attention_mask(Sq: int, Sk: int, q_offset: int, causal: bool,
                   window: int | None, device) -> torch.Tensor | None:
    """(Sq, Sk) bool: key k visible to the query at q_offset + i; None
    when nothing is masked."""
    if not causal and window is None:
        return None
    q_pos = torch.arange(Sq, device=device) + q_offset
    k_pos = torch.arange(Sk, device=device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return mask


def softmax_lut_plain(x: torch.Tensor, exp_table: LutTable, recip_table: LutTable,
                      *, q_offset: int = 0, causal: bool = False,
                      window: int | None = None) -> torch.Tensor:
    """Plain version: the masked LUT softmax of `Nonlinear.softmax`."""
    where = attention_mask(x.shape[-2] if x.dim() > 1 else 1, x.shape[-1], q_offset,
                           causal, window, x.device)
    xf = x.float()
    if where is not None:
        xf = torch.where(where, xf, -torch.inf)
    m = torch.amax(xf, dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)   # fully-masked rows
    e = lut_lib.apply_table(xf - m, exp_table)
    if where is not None:
        e = torch.where(where, e, 0.0)
    s = torch.sum(e, dim=-1, keepdim=True)
    return (e * lut_lib.lut_reciprocal(torch.clamp(s, min=1e-9), recip_table)).to(x.dtype)


def softmax_lut(x: torch.Tensor, exp_table: LutTable, recip_table: LutTable,
                *, q_offset: int = 0, causal: bool = False,
                window: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel over the rows of x (..., Sk): out in x's dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"softmax_lut takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"softmax_lut takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    _build.check_table(exp_table)
    _build.check_table(recip_table)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    masked = causal or window is not None
    if masked and x.dim() < 2:
        raise ValueError("a causal or window mask needs x (..., Sq, Sk)")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    Sk = x.shape[-1]
    Sq = x.shape[-2] if masked else 1
    n_rows = x.numel() // Sk
    chunks, warps, rows = softmax_plan(n_rows, Sk, x.element_size())
    vec = _build.vector_ok(x.element_size(), (Sk,), x, out)
    lib = _build.library("softmax_lut")
    rc = _build.cfunc(lib, "softmax_lut", "pppp" + "li" + "ffi" * 2 + "iiiii" + "iiiii" + "p")(
        x.data_ptr(), out.data_ptr(), exp_table.wb_on(x.device).data_ptr(),
        recip_table.wb_on(x.device).data_ptr(), n_rows, Sk,
        exp_table.lo, exp_table.inv_step, exp_table.sections,
        recip_table.lo, recip_table.inv_step, recip_table.sections,
        int(masked), q_offset, Sq, int(causal), window if window is not None else 0,
        chunks, warps, rows, int(vec), _DTYPE_CODE[x.dtype], _build.stream(x))
    _build.check(lib, "softmax_lut", rc)
    softmax_lut.launches += 1
    return out


softmax_lut.launches = 0


def softmax_lut_backward_plain(x: torch.Tensor, dy: torch.Tensor, exp_table: LutTable,
                               recip_table: LutTable, *, q_offset: int = 0,
                               causal: bool = False, window: int | None = None) -> torch.Tensor:
    """Plain version of the backward: autograd of `softmax_lut_plain`."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        out = softmax_lut_plain(xr, exp_table, recip_table, q_offset=q_offset, causal=causal,
                                window=window)
        (dx,) = torch.autograd.grad(out, xr, dy)
    return dx


def softmax_lut_backward(x: torch.Tensor, dy: torch.Tensor, exp_table: LutTable,
                         recip_table: LutTable, *, q_offset: int = 0, causal: bool = False,
                         window: int | None = None) -> torch.Tensor:
    """Launch the backward kernel over the rows of x (..., Sk): dx in x's dtype."""
    if x.device.type != "cuda" or dy.device != x.device:
        raise ValueError(f"softmax_lut_backward takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE or dy.dtype != x.dtype or dy.shape != x.shape:
        raise TypeError(f"softmax_lut_backward takes x and dy of one shape and dtype (float32 "
                        f"or bfloat16), got {x.dtype}, {dy.dtype}")
    _build.check_table(exp_table)
    _build.check_table(recip_table)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    masked = causal or window is not None
    if masked and x.dim() < 2:
        raise ValueError("a causal or window mask needs x (..., Sq, Sk)")
    x, dy = x.contiguous(), dy.contiguous()
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    Sk = x.shape[-1]
    Sq = x.shape[-2] if masked else 1
    lib = _build.library("backward")
    rc = _build.cfunc(lib, "softmax_lut_backward", "ppppp" + "li" + "ffi" * 2 + "iiiii" + "ip")(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), exp_table.wb_on(x.device).data_ptr(),
        recip_table.wb_on(x.device).data_ptr(), x.numel() // Sk, Sk,
        exp_table.lo, exp_table.inv_step, exp_table.sections,
        recip_table.lo, recip_table.inv_step, recip_table.sections,
        int(masked), q_offset, Sq, int(causal), window if window is not None else 0,
        _DTYPE_CODE[x.dtype], _build.stream(x))
    _build.check(lib, "backward", rc)
    softmax_lut_backward.launches += 1
    return dx


softmax_lut_backward.launches = 0
