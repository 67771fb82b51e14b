"""Row LayerNorm / RMSNorm with the LUT reciprocal square root (SAL-PIM C2).

`layernorm_lut` launches the CUDA kernel `csrc/layernorm_lut.cu`, which
replaces the TPU kernel `src/repro/kernels/layernorm_lut.py::layernorm_lut`;
`layernorm_lut_plain` is its plain PyTorch version, the twin of the JAX
oracle `repro.kernels.ref.layernorm_lut_ref` (with `plus_one` applied to
gamma, as `ops.pim_layernorm` does) and of the JAX package's
`Nonlinear.layernorm` and `Nonlinear.rmsnorm`.

x (..., d) in float32 or bf16, gamma and beta (d,): fp32 statistics, the
mean, then the centred variance (RMSNorm: the mean square), rsqrt of
var + eps from the range-reduced `rsqrt_table` or exactly when it is None,
then xc * inv * g (+ beta), g = gamma or 1 + gamma, cast to x's dtype.
The kernel adds each mean's fp32 terms in fp64 and rounds to fp32 once, so
its order of summation does not show. The plain version adds them in fp32
by default, as the JAX package and the CPU path do; with `wide_sums` it
adds them as the kernel does and is its bit-exact twin (the two forms can
differ in the last bit of a mean).

Bound on the H100: one read and one write of every row over 3.35 TB/s.
`layernorm_plan` shapes the launch: the row, gamma and beta held in the
registers of a group of warps and read once, a warp a row up to d = 2048
in bf16 (1024 in f32) and up to 8 warps past it; a call of few rows (a
decode step's 4) spreads each row until a lane holds 8 values. Rows past
8 warps' registers (d > 16384 in bf16, 8192 in f32) take a block a row
and are streamed, one read of the row a pass, with the same sums.

`layernorm_lut_backward` (`csrc/backward.cu`, which replaces no TPU
kernel: the JAX package differentiates `Nonlinear.layernorm` and
`rmsnorm` with XLA's autodiff) is the gradient for training, what
`layernorm_lut_backward_plain` (autograd of `layernorm_lut_plain`)
computes: dx, dgamma and dbeta. With the LUT rsqrt, inv is a constant
under the gradient (the range reduction reads the float's bits), so dx =
inv * (g dy - mean(g dy)) for LayerNorm and inv * g dy for RMSNorm; with
the exact rsqrt the full derivative. dgamma and dbeta are reduced over
rows in chunks of `BACKWARD_CHUNK_ROWS`, each into its own partial row,
then the partials in order: no atomics, the same bits on every run.
"""
from __future__ import annotations

import torch

from repro_torch.core import lut as lut_lib
from repro_torch.core.lut import LutTable
from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODE as _DTYPE_CODE

# The most 16-byte pieces of a row a lane holds in registers, beside as
# many of gamma and of beta: 64 bf16 or 32 f32 values of x.
MAX_CHUNKS = 8
# Rows a block of the backward's column sums adds into one partial row.
BACKWARD_CHUNK_ROWS = 64


def layernorm_plan(n_rows: int, d: int, itemsize: int) -> tuple[int, int, int]:
    """(chunks, warps_per_row, rows_per_block) of the kernel's launch
    (`_build.row_plan`); chunks 0 streams each row through a block."""
    plan = _build.row_plan(n_rows, d, itemsize, MAX_CHUNKS)
    return plan if plan is not None else (0, _build.BLOCK_WARPS, 1)


def layernorm_lut_plain(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor | None = None, *, eps: float = 1e-5,
                        rsqrt_table: LutTable | None = None, rms: bool = False,
                        plus_one: bool = False, wide_sums: bool = False) -> torch.Tensor:
    """Plain version (mirrors `ref.layernorm_lut_ref`); `wide_sums` sums
    each mean in fp64, as the kernel does."""
    xf = x.float()
    d = x.shape[-1]

    def mean(t):
        if wide_sums:
            return (t.double().sum(dim=-1, keepdim=True) / d).float()
        return t.mean(dim=-1, keepdim=True)

    if rms:
        var = mean(xf * xf)
        xc = xf
    else:
        xc = xf - mean(xf)
        var = mean(xc * xc)
    if rsqrt_table is not None:
        inv = lut_lib.lut_rsqrt(var + eps, rsqrt_table)
    else:
        inv = torch.rsqrt(var + eps)
    g = gamma.float()
    if plus_one:
        g = 1.0 + g
    out = xc * inv * g
    if beta is not None:
        out = out + beta.float()
    return out.to(x.dtype)


def layernorm_lut(x: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor | None = None, *, eps: float = 1e-5,
                  rsqrt_table: LutTable | None = None, rms: bool = False,
                  plus_one: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel over the rows of x (..., d): out in x's dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"layernorm_lut takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE or gamma.dtype not in _DTYPE_CODE:
        raise TypeError(f"layernorm_lut takes float32 or bfloat16, got x {x.dtype}, "
                        f"gamma {gamma.dtype}")
    d = x.shape[-1]
    params = [("gamma", gamma)] + ([("beta", beta)] if beta is not None else [])
    for name, t in params:
        if (tuple(t.shape) != (d,) or t.device != x.device or t.dtype != gamma.dtype
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({d},) {gamma.dtype} "
                             f"tensor on {x.device}")
    _build.check_table(rsqrt_table)
    x2 = x.reshape(-1, d)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    n = x2.shape[0]
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    if n == 0 or d == 0:
        return out.reshape(x.shape)
    chunks, warps, rows = layernorm_plan(n, d, x.element_size())
    vec = _build.vector_ok(x.element_size(), (d, x2.stride(0)), x2, gamma, beta, out)
    wb = rsqrt_table.wb_on(x.device) if rsqrt_table is not None else None
    lo, inv_step, sections = ((rsqrt_table.lo, rsqrt_table.inv_step, rsqrt_table.sections)
                              if rsqrt_table is not None else (0.25, 1.0, 1))
    lib = _build.library("layernorm_lut")
    rc = _build.cfunc(lib, "layernorm_lut", "p" * 5 + "lilfiffiii" + "iiii" + "iip")(
        x2.data_ptr(), gamma.data_ptr(), _build.ptr(beta), _build.ptr(wb), out.data_ptr(),
        n, d, x2.stride(0), eps, int(rsqrt_table is not None), lo, inv_step, sections,
        int(rms), int(plus_one), chunks, warps, rows, int(vec), _DTYPE_CODE[x.dtype],
        _DTYPE_CODE[gamma.dtype], _build.stream(x))
    _build.check(lib, "layernorm_lut", rc)
    layernorm_lut.launches += 1
    return out.reshape(x.shape)


layernorm_lut.launches = 0


def layernorm_lut_backward_plain(x: torch.Tensor, gamma: torch.Tensor,
                                 beta: torch.Tensor | None, dy: torch.Tensor, *,
                                 eps: float = 1e-5, rsqrt_table: LutTable | None = None,
                                 rms: bool = False, plus_one: bool = False):
    """Plain version of the backward: autograd of `layernorm_lut_plain` ->
    (dx, dgamma, dbeta or None)."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        gr = gamma.detach().requires_grad_(True)
        br = beta.detach().requires_grad_(True) if beta is not None else None
        out = layernorm_lut_plain(xr, gr, br, eps=eps, rsqrt_table=rsqrt_table, rms=rms,
                                  plus_one=plus_one)
        grads = torch.autograd.grad(out, [t for t in (xr, gr, br) if t is not None], dy)
    return grads[0], grads[1], grads[2] if beta is not None else None


def layernorm_lut_backward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor | None,
                           dy: torch.Tensor, *, eps: float = 1e-5,
                           rsqrt_table: LutTable | None = None, rms: bool = False,
                           plus_one: bool = False):
    """Launch the backward kernels over the rows of x (..., d) -> (dx in x's
    dtype, dgamma and dbeta (or None without beta) in gamma's)."""
    if x.device.type != "cuda" or dy.device != x.device:
        raise ValueError(f"layernorm_lut_backward takes CUDA tensors, got {x.device}")
    if (x.dtype not in _DTYPE_CODE or gamma.dtype not in _DTYPE_CODE or dy.dtype != x.dtype
            or dy.shape != x.shape):
        raise TypeError(f"layernorm_lut_backward takes x and dy of one shape and dtype "
                        f"(float32 or bfloat16), got x {x.dtype}, dy {dy.dtype}, "
                        f"gamma {gamma.dtype}")
    d = x.shape[-1]
    for name, t in [("gamma", gamma)] + ([("beta", beta)] if beta is not None else []):
        if tuple(t.shape) != (d,) or t.device != x.device or t.dtype != gamma.dtype:
            raise ValueError(f"{name} must be a ({d},) {gamma.dtype} tensor on {x.device}")
    _build.check_table(rsqrt_table)
    x2, dy2 = x.reshape(-1, d).contiguous(), dy.reshape(-1, d).contiguous()
    n = x2.shape[0]
    dx = torch.empty_like(x2)
    dgamma = torch.zeros_like(gamma)
    dbeta = torch.zeros_like(beta) if beta is not None else None
    if n == 0 or d == 0:
        return dx.reshape(x.shape), dgamma, dbeta
    rows = max(BACKWARD_CHUNK_ROWS, -(-n // 65535))
    chunks = -(-n // rows)
    dev = x.device
    mean = torch.empty(n, dtype=torch.float32, device=dev)
    inv = torch.empty(n, dtype=torch.float32, device=dev)
    partial = torch.empty((2 if beta is not None else 1, chunks, d), dtype=torch.float32,
                          device=dev)
    wb = rsqrt_table.wb_on(dev) if rsqrt_table is not None else None
    lo, inv_step, sections = ((rsqrt_table.lo, rsqrt_table.inv_step, rsqrt_table.sections)
                              if rsqrt_table is not None else (0.25, 1.0, 1))
    lib = _build.library("backward")
    rc = _build.cfunc(lib, "layernorm_lut_backward", "p" * 10 + "li" + "fffi" + "iiiii" + "p")(
        x2.data_ptr(), dy2.data_ptr(), gamma.contiguous().data_ptr(), _build.ptr(wb),
        dx.data_ptr(), dgamma.data_ptr(), _build.ptr(dbeta), mean.data_ptr(), inv.data_ptr(),
        partial.data_ptr(), n, d, eps, lo, inv_step, sections, int(rms), int(plus_one), rows,
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[gamma.dtype], _build.stream(x))
    _build.check(lib, "backward", rc)
    layernorm_lut_backward.launches += 1
    return dx.reshape(x.shape), dgamma, dbeta


layernorm_lut_backward.launches = 0
