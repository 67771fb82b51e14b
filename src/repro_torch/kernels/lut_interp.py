"""Elementwise LUT interpolation, the SAL-PIM nonlinearity applied on its
own (where no GEMV epilogue can carry it).

`lut_interp` launches the CUDA kernel `csrc/lut_interp.cu`, which replaces
the TPU kernel `src/repro/kernels/lut_interp.py::lut_interp_2d`;
`lut_interp_plain` is its plain PyTorch version, `core.lut.apply_table`,
the twin of the JAX oracle `repro.kernels.ref.lut_interp_ref`. Both take
any shape: y = W[sec(x)] * x + B[sec(x)] in fp32, cast to x's dtype. The
kernel rounds each operation on its own, so it is bit-exact to the plain
version.

Bound on the H100: one read and one write of every element over 3.35 TB/s.
At a decode step's (4, 4096) that is 0.02 us, far under a launch; since
the quantized GEMVs evaluate the table in their epilogues, no main path
launches `lut_interp`. `empty_kernel` launches a kernel that does nothing,
the launch floor that `chip_smoke.py` times beside it.

`lut_interp_backward` (`csrc/backward.cu`, which replaces no TPU kernel:
the JAX package differentiates `apply_table` with XLA's autodiff) is the
gradient for training: dx = dy * W[sec(x)] in fp32, cast to x's dtype,
bit for bit `lut_interp_backward_plain`, autograd of `lut_interp_plain`.
Bound: one read of x and dy and one write of dx.
"""
from __future__ import annotations

import torch

from repro_torch.core import lut as lut_lib
from repro_torch.core.lut import LutTable
from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODE as _DTYPE_CODE


def lut_interp_plain(x: torch.Tensor, table: LutTable) -> torch.Tensor:
    """Plain version: `apply_table` (mirrors `ref.lut_interp_ref`)."""
    return lut_lib.apply_table(x, table)


def lut_interp(x: torch.Tensor, table: LutTable) -> torch.Tensor:
    """Launch the CUDA kernel: `table` applied to every element of x."""
    if x.device.type != "cuda":
        raise ValueError(f"lut_interp takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"lut_interp takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    _build.check_table(table)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.library("lut_interp")
    rc = _build.cfunc(lib, "lut_interp", "ppplffiip")(
        x.data_ptr(), out.data_ptr(), table.wb_on(x.device).data_ptr(), x.numel(),
        table.lo, table.inv_step, table.sections, _DTYPE_CODE[x.dtype], _build.stream(x))
    _build.check(lib, "lut_interp", rc)
    lut_interp.launches += 1
    return out


def lut_interp_backward_plain(x: torch.Tensor, dy: torch.Tensor,
                              table: LutTable) -> torch.Tensor:
    """Plain version of the backward: autograd of `lut_interp_plain`."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        (dx,) = torch.autograd.grad(lut_interp_plain(xr, table), xr, dy)
    return dx


def lut_interp_backward(x: torch.Tensor, dy: torch.Tensor, table: LutTable) -> torch.Tensor:
    """Launch the backward kernel: dx (x's shape and dtype) = dy * W[sec(x)]."""
    if x.device.type != "cuda" or dy.device != x.device:
        raise ValueError(f"lut_interp_backward takes CUDA tensors, got {x.device}, {dy.device}")
    if x.dtype not in _DTYPE_CODE or dy.dtype != x.dtype or dy.shape != x.shape:
        raise TypeError(f"lut_interp_backward takes x and dy of one shape in float32 or "
                        f"bfloat16, got {x.dtype} {tuple(x.shape)}, {dy.dtype} {tuple(dy.shape)}")
    _build.check_table(table)
    x, dy = x.contiguous(), dy.contiguous()
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    lib = _build.library("backward")
    rc = _build.cfunc(lib, "lut_interp_backward", "pppplffiip")(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), table.wb_on(x.device).data_ptr(),
        x.numel(), table.lo, table.inv_step, table.sections, _DTYPE_CODE[x.dtype],
        _build.stream(x))
    _build.check(lib, "backward", rc)
    lut_interp_backward.launches += 1
    return dx


def empty_kernel(device) -> None:
    """Launch an empty kernel on `device`'s current stream."""
    lib = _build.library("lut_interp")
    rc = _build.cfunc(lib, "empty_kernel", "p")(
        torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, "lut_interp", rc)


lut_interp.launches = 0
lut_interp_backward.launches = 0
