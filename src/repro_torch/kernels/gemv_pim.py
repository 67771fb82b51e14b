"""GEMV with fp32 accumulation and a fused bias + activation epilogue.

`gemv_pim_float` launches the CUDA kernel `csrc/gemv_pim.cu`, which
replaces the TPU kernel `src/repro/kernels/gemv_pim.py::gemv_pim_float`;
`gemv_pim_plain` is its plain PyTorch version, the twin of the JAX oracle
`repro.kernels.ref.gemv_pim_ref`.

x (M, C) @ w (R, C)^T with fp32 accumulation, optional bias, then an
optional activation applied to the fp32 sum before the cast to x's dtype:
the LUT interpolation of `act_table` (the paper's nonlinearity riding the
GEMV datapath) or, with act="gelu", the exact tanh GELU.

Bound on the H100: the weight stream (R * C * itemsize bytes over
3.35 TB/s) at decode widths; the note in `csrc/gemv_pim.cu` gives the
design. Unlike the TPU kernel, which asserts that R and C divide its
blocks, the CUDA kernel masks the ragged edge, so GPT-2's 50257-row LM
head runs through it.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core import lut as lut_lib
from repro_torch.core.lut import LutTable
from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODE = {None: 0, "lut": 1, "gelu": 2}
_MAX_TABLE_ROWS = 128


def gemv_pim_plain(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor | None = None, *,
                   act_table: LutTable | None = None,
                   act: str | None = None) -> torch.Tensor:
    """Plain version: fp32 product, fp32 bias, activation, cast to x.dtype."""
    out = torch.matmul(x.float(), w.float().t())
    if b is not None:
        out = out + b.float()
    if act_table is not None:
        out = lut_lib.apply_table(out, act_table)
    elif act == "gelu":
        out = F.gelu(out, approximate="tanh")
    return out.to(x.dtype)


def _argtypes(lib):
    fn = lib.gemv_pim_float
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, f, f, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check_args(x, w, b, act_table, act):
    if x.device.type != "cuda":
        raise ValueError(f"gemv_pim_float takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"gemv_pim_float takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"need x (M, C) and w (R, C), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if x.shape[1] == 0:
        raise ValueError("gemv_pim_float needs C >= 1")
    tensors = [("w", w)] + ([("b", b)] if b is not None else [])
    for name, t in tensors:
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name} must be a {x.dtype} tensor on {x.device}, "
                             f"got {t.dtype} on {t.device}")
    if b is not None and tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"bias must be ({w.shape[0]},), got {tuple(b.shape)}")
    for name, t in [("x", x)] + tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if act not in (None, "gelu"):
        raise ValueError(f"unknown epilogue activation {act!r}")
    if act_table is not None:
        if act is not None:
            raise ValueError("pass act_table or act, not both")
        if act_table.sections + 2 > _MAX_TABLE_ROWS:
            raise ValueError(f"LUT tables hold at most {_MAX_TABLE_ROWS - 2} sections")


def gemv_pim_float(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor | None = None, *,
                   act_table: LutTable | None = None,
                   act: str | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: x (M, C) @ w (R, C)^T -> (M, R) in x.dtype."""
    _check_args(x, w, b, act_table, act)
    M, C = x.shape
    R = w.shape[0]
    out = torch.empty((M, R), dtype=x.dtype, device=x.device)
    if M == 0 or R == 0:
        return out
    if act_table is not None:
        table = act_table.wb_on(x.device)
        code, lo, inv_step, sections = (_ACT_CODE["lut"], act_table.lo,
                                        act_table.inv_step, act_table.sections)
    else:
        table, code, lo, inv_step, sections = None, _ACT_CODE[act], 0.0, 1.0, 1
    lib = _build.library("gemv_pim")
    rc = _argtypes(lib)(
        x.data_ptr(), w.data_ptr(), b.data_ptr() if b is not None else None,
        table.data_ptr() if table is not None else None, out.data_ptr(),
        M, C, R, _DTYPE_CODE[x.dtype], code, lo, inv_step, sections,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, "gemv_pim", rc)
    gemv_pim_float.launches += 1
    return out


gemv_pim_float.launches = 0
