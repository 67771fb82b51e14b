"""The GEMV kernels of the SAL-PIM linear datapaths: float, int8 and
Q-format fixed16.

`gemv_pim_float` launches the CUDA kernel `csrc/gemv_pim.cu`, which
replaces the TPU kernel `src/repro/kernels/gemv_pim.py::gemv_pim_float`;
`gemv_pim_plain` is its plain PyTorch version, the twin of the JAX oracle
`repro.kernels.ref.gemv_pim_ref`. `gemv_pim_int8` and `gemv_pim_fixed`
launch the two entry points of `csrc/gemv_pim_quant.cu`, which replace
`gemv_pim_int8` and `gemv_pim_fixed` of the same TPU file; their plain
versions `gemv_pim_int8_plain` and `gemv_pim_fixed_plain` are the twins
of `ref.gemv_pim_int8_ref` and `ref.gemv_pim_fixed_ref`.

x (M, C) @ w (R, C)^T with fp32 accumulation, optional bias, then an
optional activation applied to the fp32 sum before the cast to x's dtype:
the LUT interpolation of `act_table` (the paper's nonlinearity riding the
GEMV datapath) or, with act="gelu", the exact tanh GELU.

The quantized GEMVs, bit for bit (their plain versions compute the
integer product exactly in float64, `core.quant.int32_matmul`):

  * int8: x_i8 (M, C) . w_i8 (R, C) summed in int32, then
    `(acc * x_scale[m]) * w_scale[r]` in f32, then `+ b[r]` in f32 when a
    bias is given, each operation rounded on its own; f32 (M, R) out;
  * fixed16: x_q (M, C) . w_q (R, C) as int16 products summed in an
    int32 accumulator that wraps modulo 2^32, then an arithmetic shift
    right by `shift` and saturation to int16; int16 (M, R) out.

Bound on the H100: the weight stream (R * C * itemsize bytes over
3.35 TB/s) at decode widths; the notes in `csrc/gemv_pim.cu` and
`csrc/gemv_pim_quant.cu` give the designs. Unlike the TPU kernels, which
assert that R and C divide their blocks, the CUDA kernels mask the ragged
edge, so GPT-2's 50257-row LM head runs through them.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core import lut as lut_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core.lut import LutTable
from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODE as _DTYPE_CODE

_ACT_CODE = {None: 0, "lut": 1, "gelu": 2}


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
        _build.check_table(act_table)


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


# ---------------------------------------------------------------------------
# Quantized datapaths: int8 and Q-format fixed16
# ---------------------------------------------------------------------------

def gemv_pim_int8_plain(x_i8: torch.Tensor, x_scale: torch.Tensor,
                        w_i8: torch.Tensor, w_scale: torch.Tensor,
                        b: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: int32 product, `(acc * x_scale) * w_scale`, `+ b`,
    all in f32 -> f32 (M, R)."""
    acc = quant_lib.int32_matmul(x_i8, w_i8)
    out = acc.float() * x_scale[:, None].float() * w_scale[None, :].float()
    if b is not None:
        out = out + b.float()
    return out


def gemv_pim_fixed_plain(x_q: torch.Tensor, w_q: torch.Tensor, *,
                         shift: int) -> torch.Tensor:
    """Plain version: wrapping int32 product, shift, saturate -> int16."""
    return quant_lib.requantize_i32_to_i16(quant_lib.int32_matmul(x_q, w_q), shift)


def _check_quant(name, x, w, dtype, vectors):
    """The checks of `_check_args` for a quantized GEMV: x (M, C) and w
    (R, C) of `dtype`, each (name, tensor, length) of `vectors` an f32
    vector of that length, all contiguous on one CUDA device."""
    if x.dtype != dtype or w.dtype != dtype:
        raise TypeError(f"{name} takes {dtype} x and w, got {x.dtype} and {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"need x (M, C) and w (R, C), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if x.shape[1] == 0:
        raise ValueError(f"{name} needs C >= 1")
    for vname, t, n in vectors:
        if t.dtype != torch.float32:
            raise TypeError(f"{vname} must be torch.float32, got {t.dtype}")
        if tuple(t.shape) != (n,):
            raise ValueError(f"{vname} must be ({n},), got {tuple(t.shape)}")
    tensors = [("x", x), ("w", w)] + [(v[0], v[1]) for v in vectors]
    for tname, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{tname} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {x.device}")


def _quant_fn(lib, name, argtypes):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def gemv_pim_int8(x_i8: torch.Tensor, x_scale: torch.Tensor, w_i8: torch.Tensor,
                  w_scale: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the CUDA kernel: int8 x (M, C) . int8 w (R, C) with f32 row
    scales x_scale (M,), w_scale (R,) and optional f32 bias (R,) -> f32
    (M, R)."""
    M, R = x_i8.shape[0], w_i8.shape[0]
    vectors = [("x_scale", x_scale, M), ("w_scale", w_scale, R)]
    if b is not None:
        vectors.append(("bias", b, R))
    _check_quant("gemv_pim_int8", x_i8, w_i8, torch.int8, vectors)
    out = torch.empty((M, R), dtype=torch.float32, device=x_i8.device)
    if M == 0 or R == 0:
        return out
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = _build.library("gemv_pim_quant")
    rc = _quant_fn(lib, "gemv_pim_int8", [p, p, p, p, p, p, i, i, i, p])(
        x_i8.data_ptr(), x_scale.data_ptr(), w_i8.data_ptr(), w_scale.data_ptr(),
        b.data_ptr() if b is not None else None, out.data_ptr(),
        M, x_i8.shape[1], R, torch.cuda.current_stream(x_i8.device).cuda_stream)
    _build.check(lib, "gemv_pim_quant", rc)
    gemv_pim_int8.launches += 1
    return out


def gemv_pim_fixed(x_q: torch.Tensor, w_q: torch.Tensor, *, shift: int) -> torch.Tensor:
    """Launch the CUDA kernel: int16 x (M, C) . int16 w (R, C), wrapping
    int32 sum >> shift, saturated -> int16 (M, R)."""
    if not 0 <= shift < 32:
        raise ValueError(f"shift must be in [0, 32), got {shift}")
    _check_quant("gemv_pim_fixed", x_q, w_q, torch.int16, [])
    M, R = x_q.shape[0], w_q.shape[0]
    out = torch.empty((M, R), dtype=torch.int16, device=x_q.device)
    if M == 0 or R == 0:
        return out
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = _build.library("gemv_pim_quant")
    rc = _quant_fn(lib, "gemv_pim_fixed", [p, p, p, i, i, i, i, p])(
        x_q.data_ptr(), w_q.data_ptr(), out.data_ptr(), M, x_q.shape[1], R, shift,
        torch.cuda.current_stream(x_q.device).cuda_stream)
    _build.check(lib, "gemv_pim_quant", rc)
    gemv_pim_fixed.launches += 1
    return out


gemv_pim_int8.launches = 0
gemv_pim_fixed.launches = 0
