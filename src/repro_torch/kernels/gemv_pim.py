"""The GEMV kernels of the SAL-PIM linear datapaths: float, int8 and
Q-format fixed16.

`gemv_pim_float` launches the CUDA kernel `csrc/gemv_pim.cu`, which
replaces the TPU kernel `src/repro/kernels/gemv_pim.py::gemv_pim_float`;
`gemv_pim_plain` is its plain PyTorch version, the twin of the JAX oracle
`repro.kernels.ref.gemv_pim_ref`. `gemv_pim_int8`, `gemv_pim_int8_linear`,
`gemv_pim_fixed` and `gemv_pim_fixed_linear` launch the entry points of
`csrc/gemv_pim_quant.cu`, which replace `gemv_pim_int8` and
`gemv_pim_fixed` of the same TPU file; their plain versions
`gemv_pim_int8_plain` and `gemv_pim_fixed_plain` are the twins of
`ref.gemv_pim_int8_ref` and `ref.gemv_pim_fixed_ref`.

x (M, C) @ w (R, C)^T with fp32 accumulation, optional bias, then an
optional activation applied to the fp32 sum before the cast to x's dtype:
the LUT interpolation of `act_table` (the paper's nonlinearity riding the
GEMV datapath) or, with act="gelu", the exact tanh GELU.

The quantized GEMVs, bit for bit (their plain versions compute the
integer product exactly in float64, `core.quant.int32_matmul`):

  * int8: x_i8 (M, C) . w_i8 (R, C) summed in int32, then
    `(acc * x_scale[m]) * w_scale[r]` in f32, then `+ b[r]` in f32 when a
    bias is given, each operation rounded on its own (scales and bias f32
    or bf16), cast to `out_dtype` (f32 or bf16), then the LUT
    `act_table` on the cast value;
  * the int8 linear layer (`gemv_pim_int8_linear`): float x quantized per
    row (`quantize_int8_rows`, in x's dtype or in f32) and the int8 GEMV
    above with out in x's dtype: `SalPimEngine.linear`'s int8 route after
    its weight's quantization, and `qtensor_linear`, in one launch at
    decode widths (`gemv_int8_linear_plan`), x's quantization then running
    in the kernel's load path;
  * fixed16: x_q (M, C) . w_q (R, C) as int16 products summed in an
    int32 accumulator that wraps modulo 2^32, then an arithmetic shift
    right by `shift` and saturation to int16; int16 (M, R) out;
  * the fixed16 linear layer (`gemv_pim_fixed_linear`): x and w in f32 or
    bf16 quantized to Q(frac_x) and Q(frac_w) as the kernel loads them,
    the fixed16 product shifting by frac_w, dequantized, cast to x's
    dtype, `+ b` in x's dtype and the LUT, all in one launch
    (`gemv_pim_fixed_linear_plain` composes the same steps op for op).

Bound on the H100: the weight stream (R * C * itemsize bytes over
3.35 TB/s) at decode widths; the notes in `csrc/gemv_pim.cu` and
`csrc/gemv_pim_quant.cu` give the designs. Unlike the TPU kernels, which
assert that R and C divide their blocks, the CUDA kernels mask the ragged
edge, so GPT-2's 50257-row LM head runs through them.

`gemv_pim_float` has two kernels. bf16 operands with C a multiple of 8
and 16-byte aligned rows take the tensor-core kernel (wgmma fed by TMA, C
split over a thread-block cluster); f32, or any other C, takes the
CUDA-core kernel. `gemv_plan` makes that choice and the tensor-core
kernel's tiling in plain Python; `gemv_pim_float.launches` counts every
launch, `gemv_pim_float.tc_launches` those of the tensor-core kernel.
The quantized GEMVs have the same two routes (`gemv_int8_plan`,
`gemv_fixed_plan`): C a multiple of 16 and 16-byte aligned rows on the
8-bit tensor cores (int8 on s8 operands; fixed16 on the four byte-plane
products of each int16 one), any other C on the CUDA cores (`__dp4a` for
int8); each wrapper's `tc_launches` counts the first.
`quantize_int8_rows` is the per-row int8 quantization of
`core.quant.quantize_int8_rows` (`quantize_int8_rows_plain`) in one
launch, bit for bit, in x's dtype or in f32 (`compute`); it replaces XLA
ops of the JAX package, not a Pallas kernel. `quant_plan` shapes it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import lut as lut_lib
from repro_torch.core import quant as quant_lib
from repro_torch.core.lut import LutTable
from repro_torch.kernels import _build
from repro_torch.kernels._build import DTYPE_CODE as _DTYPE_CODE

_ACT_CODE = {None: 0, "lut": 1, "gelu": 2}

# The tensor-core kernel's tiling (csrc/gemv_pim.cu): 64 weight rows a
# block (the wgmma M side), 64-element K tiles (one 128-byte TMA swizzle
# row), token tiles of one of TC_N (the wgmma N side; M is covered by
# ceil(M / N) tiles), and clusters of up to TC_MAX_CLUSTER blocks that
# split the K tiles. `gemv_plan` takes the largest grid of at most
# `_build.SMS` blocks: one wave on the card. A cluster's partial tiles hold
# at most TC_CLUSTER_TOKENS token columns in all, since the reduction over
# distributed shared memory grows with both (scripts/sweep_clusters.py,
# H100 80GB HBM3 at 700 W: at M=64 w_down took 9.55 us with 4 blocks a
# cluster and 13.20 us with 8; at M=512 the d x d projection took 20.09 us
# on 32 blocks of 256 tokens and 10.04 us on 128 blocks of 128 tokens in
# clusters of 2).
TC_ROWS = 64
TC_K = 64
TC_K_INT8 = 128                # one 128-byte swizzle row of int8
TC_N = (8, 16, 32, 64, 128, 256)
# The fixed16 kernel keeps three accumulator sets of N / 2 registers a
# thread (csrc/gemv_pim_quant.cu), so its token tile stops at 64.
TC_N_FIXED = (8, 16, 32, 64)
TC_MAX_CLUSTER = 8
TC_CLUSTER_TOKENS = 256
# The int8 linear layer's consumer threads quantize their block's share of
# x into shared memory, at most INT8_LINEAR_PIECES pieces of 16 elements
# (16 a thread: 4 held in registers from the start, the rest loaded as
# they are quantized); its token tile holds every row, at most
# INT8_LINEAR_ROWS.
INT8_LINEAR_PIECES = 2048
INT8_LINEAR_ROWS = 32
# quantize_int8_rows (csrc/gemv_pim_quant.cu) holds a row in the registers
# of 1-8 warps, at most QUANT_MAX_CHUNKS pieces of 16 bytes a lane, spread
# over more warps until a lane holds QUANT_LANE_VALUES values (a weight's
# rows all load at once, so its arithmetic is shared among as many warps
# as its rows allow), in blocks of QUANT_BLOCK_WARPS warps.
QUANT_MAX_CHUNKS = 8
QUANT_LANE_VALUES = 16
QUANT_BLOCK_WARPS = 4


@dataclasses.dataclass(frozen=True)
class GemvPlan:
    """Which kernel runs a GEMV, and the tensor-core kernel's grid: blocks
    (row_tiles * cluster, n_tiles), each cluster splitting k_tiles."""
    route: str                 # "tensor_core" or "cuda_core"
    n_tile: int = 0
    n_tiles: int = 0
    row_tiles: int = 0
    cluster: int = 1
    k_tiles: int = 0


def _tc_tiling(M: int, C: int, R: int, k_tile: int, tiles=TC_N) -> GemvPlan:
    """The tensor-core kernels' tiling for x (M, C) @ w (R, C)^T in K tiles
    of `k_tile` elements over token tiles `tiles` (`gemv_plan`)."""
    fit = next((t for t in tiles if t >= M), tiles[-1])
    row_tiles, k_tiles = -(-R // TC_ROWS), -(-C // k_tile)
    n, cluster, blocks = fit, 1, 0
    for t in tiles[:tiles.index(fit) + 1]:
        grid = row_tiles * -(-M // t)
        if grid > _build.SMS:
            continue
        cs = 1
        while (cs < TC_MAX_CLUSTER and 2 * cs <= k_tiles and 2 * cs * t <= TC_CLUSTER_TOKENS
               and 2 * cs * grid <= _build.SMS):
            cs *= 2
        if cs * grid >= blocks:
            n, cluster, blocks = t, cs, cs * grid
    return GemvPlan("tensor_core", n, -(-M // n), row_tiles, cluster, k_tiles)


def gemv_plan(M: int, C: int, R: int, dtype: torch.dtype, *,
              aligned: bool = True) -> GemvPlan:
    """The kernel and tiling for x (M, C) @ w (R, C)^T: the tensor-core
    kernel for bf16 with C % 8 == 0 and 16-byte aligned x and w (TMA's
    stride and address rules), else the CUDA-core kernel. Over the token
    tiles no larger than the least of TC_N that holds M (256 beyond), each
    with the largest cluster that keeps the grid within `_build.SMS`
    blocks, gives each block a K tile and holds at most TC_CLUSTER_TOKENS
    tokens, the plan takes the largest grid, ties to the larger tile; a
    shape whose grid exceeds `_build.SMS` blocks at any tile takes the
    least tile that holds M and no cluster."""
    if dtype != torch.bfloat16 or C % 8 or not aligned:
        return GemvPlan("cuda_core")
    return _tc_tiling(M, C, R, TC_K)


def gemv_int8_plan(M: int, C: int, R: int, *, aligned: bool = True) -> GemvPlan:
    """`gemv_plan` for the int8 GEMV: the s8 tensor-core kernel, in K tiles
    of TC_K_INT8 elements, when C % 16 == 0 and x and w are 16-byte aligned
    (a TMA stride is a multiple of 16 bytes), else the `__dp4a` kernel on
    the CUDA cores."""
    if C % 16 or not aligned:
        return GemvPlan("cuda_core")
    return _tc_tiling(M, C, R, TC_K_INT8)


def gemv_int8_linear_plan(M: int, C: int, R: int, *,
                          aligned: bool = True) -> GemvPlan | None:
    """The one-launch int8 linear layer's tiling (`gemv_pim_int8_linear`):
    the s8 tensor-core kernel with x quantized in its load path, where
    `gemv_int8_plan` takes the tensor cores: the least tile of TC_N that
    holds all M <= INT8_LINEAR_ROWS rows, with `_tc_tiling`'s cluster,
    while a block's share of x (M rows x its K tiles of 128) is at most
    INT8_LINEAR_PIECES pieces of 16 elements (a decode step; M * K tiles a
    block <= 256). None otherwise: x is then quantized by its own
    `quantize_int8_rows` launch before `gemv_pim_int8` (a prefill chunk,
    C % 16 != 0, a misaligned row); a wider share would keep the block's
    wgmmas waiting on more of x than its quantization takes from the launch
    it saves."""
    if C % 16 or not aligned or M < 1 or M > INT8_LINEAR_ROWS:
        return None
    fit = next(t for t in TC_N if t >= M)
    plan = _tc_tiling(M, C, R, TC_K_INT8, (fit,))
    per_block = -(-plan.k_tiles // plan.cluster)
    return plan if M * per_block * TC_K_INT8 // 16 <= INT8_LINEAR_PIECES else None


def quant_plan(n_rows: int, C: int, itemsize: int) -> tuple[int, int, int]:
    """(chunks, warps_per_row, rows_per_block) of `quantize_int8_rows` for
    rows of C elements of `itemsize` bytes: `_build.row_plan`'s pieces a
    lane and warps a row (a call of few rows, as x of a decode step, is
    spread over more warps), spread further while a lane holds more than
    QUANT_LANE_VALUES values, and as many row groups a block as fill
    QUANT_BLOCK_WARPS warps while the grid still gives every SM a block.
    chunks 0 when 8 warps cannot hold a row: a block streams each row,
    reading it twice."""
    plan = _build.row_plan(n_rows, C, itemsize, QUANT_MAX_CHUNKS)
    if plan is None:
        return 0, _build.BLOCK_WARPS, 1
    chunks, warps, _ = plan
    n = 16 // itemsize
    while warps < _build.ROW_GROUP_WARPS[-1] and chunks * n > QUANT_LANE_VALUES:
        warps *= 2
        chunks = _build._pow2_at_least(-(-C // (32 * warps * n)))
    rows = max(1, QUANT_BLOCK_WARPS // warps)
    while rows > 1 and -(-n_rows // rows) < _build.SMS:
        rows //= 2
    return chunks, warps, rows


def gemv_fixed_plan(M: int, C: int, R: int, *, aligned: bool = True) -> GemvPlan:
    """`gemv_plan` for the fixed16 GEMVs (int16 operands, or f32/bf16 ones
    quantized as they load): the kernel on the 8-bit tensor cores, in K
    tiles of 128 elements and token tiles of at most 64 (TC_N_FIXED), when
    C % 16 == 0 and x and w are 16-byte aligned, else the CUDA-core
    kernel."""
    if C % 16 or not aligned:
        return GemvPlan("cuda_core")
    return _tc_tiling(M, C, R, TC_K_INT8, TC_N_FIXED)


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
    """Launch the CUDA kernel: x (M, C) @ w (R, C)^T -> (M, R) in x.dtype,
    on the kernel and tiling of `gemv_plan`."""
    _check_args(x, w, b, act_table, act)
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    plan = gemv_plan(x.shape[0], x.shape[1], w.shape[0], x.dtype, aligned=aligned)
    return launch_float(x, w, b, plan, act_table=act_table, act=act)


def launch_float(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                 plan: GemvPlan, *, act_table: LutTable | None = None,
                 act: str | None = None) -> torch.Tensor:
    """`gemv_pim_float` on a given plan, after its checks (the C entries
    check the plan; scripts/sweep_clusters.py times other tilings so)."""
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
    args = (x.data_ptr(), w.data_ptr(), _build.ptr(b), _build.ptr(table), out.data_ptr(),
            M, C, R)
    epi = (code, lo, inv_step, sections)
    tc = plan.route == "tensor_core"
    if tc:
        rc = _build.cfunc(lib, "gemv_pim_float_tc", "ppppp" + "iiiiffi" + "ii" + "p")(
            *args, *epi, plan.n_tile, plan.cluster, _build.stream(x))
    else:
        rc = _build.cfunc(lib, "gemv_pim_float", "ppppp" + "iiii" + "iffi" + "p")(
            *args, _DTYPE_CODE[x.dtype], *epi, _build.stream(x))
    _build.check(lib, "gemv_pim", rc)
    gemv_pim_float.launches += 1
    gemv_pim_float.tc_launches += tc
    return out


gemv_pim_float.launches = 0
gemv_pim_float.tc_launches = 0


# ---------------------------------------------------------------------------
# Quantized datapaths: int8 and Q-format fixed16
# ---------------------------------------------------------------------------

def gemv_pim_int8_plain(x_i8: torch.Tensor, x_scale: torch.Tensor,
                        w_i8: torch.Tensor, w_scale: torch.Tensor,
                        b: torch.Tensor | None = None, *,
                        out_dtype: torch.dtype = torch.float32,
                        act_table: LutTable | None = None) -> torch.Tensor:
    """Plain version: int32 product, `(acc * x_scale) * w_scale`, `+ b`,
    all in f32 (the scales and the bias in f32 or bf16), cast to
    `out_dtype`, then the LUT on the cast value."""
    acc = quant_lib.int32_matmul(x_i8, w_i8)
    out = acc.float() * x_scale[:, None].float() * w_scale[None, :].float()
    if b is not None:
        out = out + b.float()
    out = out.to(out_dtype)
    if act_table is not None:
        out = lut_lib.apply_table(out, act_table)
    return out


def gemv_pim_int8_linear_plain(x: torch.Tensor, w_i8: torch.Tensor, w_scale: torch.Tensor,
                               b: torch.Tensor | None = None, *,
                               compute: torch.dtype | None = None,
                               act_table: LutTable | None = None) -> torch.Tensor:
    """Plain version of the int8 linear layer: x quantized per row in
    `compute` (x's dtype by default) by `quantize_int8_rows_plain`, then
    `gemv_pim_int8_plain` with out in x's dtype and the LUT."""
    x_i8, x_scale = quantize_int8_rows_plain(x.to(compute or x.dtype))
    return gemv_pim_int8_plain(x_i8, x_scale, w_i8, w_scale, b, out_dtype=x.dtype,
                               act_table=act_table)


def gemv_pim_fixed_plain(x_q: torch.Tensor, w_q: torch.Tensor, *,
                         shift: int) -> torch.Tensor:
    """Plain version: wrapping int32 product, shift, saturate -> int16."""
    return quant_lib.requantize_i32_to_i16(quant_lib.int32_matmul(x_q, w_q), shift)


def gemv_pim_fixed_linear_plain(x: torch.Tensor, w: torch.Tensor,
                                b: torch.Tensor | None = None, *, frac_x: int,
                                frac_w: int,
                                act_table: LutTable | None = None) -> torch.Tensor:
    """Plain version of the fixed16 linear layer, op for op the JAX
    engine's: x in Q(frac_x) and w in Q(frac_w), the fixed GEMV shifting
    by frac_w, dequantized to f32, cast to x's dtype, `+ b` in x's dtype,
    then the LUT on that value."""
    x_fmt, w_fmt = quant_lib.QFormat(frac_x), quant_lib.QFormat(frac_w)
    out_q = gemv_pim_fixed_plain(x_fmt.quantize(x), w_fmt.quantize(w), shift=frac_w)
    out = x_fmt.dequantize(out_q).to(x.dtype)
    if b is not None:
        out = out + b.to(x.dtype)
    if act_table is not None:
        out = lut_lib.apply_table(out, act_table)
    return out


def _check_quant(name, x, w, dtypes, vectors, w_dtype=None):
    """The checks of `_check_args` for a quantized GEMV: x (M, C) of a
    dtype among `dtypes` and w (R, C) of x's dtype (or `w_dtype`), each
    (name, tensor, length) of `vectors` an f32 or bf16 vector of that
    length, all contiguous on one CUDA device."""
    if x.dtype not in dtypes or w.dtype != (w_dtype or x.dtype):
        want = " or ".join(str(d).split(".")[1] for d in dtypes)
        w_want = "w" if w_dtype is None else f"{str(w_dtype).split('.')[1]} w"
        raise TypeError(f"{name} takes {want} x and {w_want}, got {x.dtype} and {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"need x (M, C) and w (R, C), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if x.shape[1] == 0:
        raise ValueError(f"{name} needs C >= 1")
    for vname, t, n in vectors:
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{vname} must be torch.float32 or torch.bfloat16, got {t.dtype}")
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


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _lut_args(act_table: LutTable | None, device):
    """(table, act, lo, inv_step, sections) of a quantized GEMV's LUT."""
    if act_table is None:
        return None, 0, 0.0, 1.0, 1
    _build.check_table(act_table)
    return (act_table.wb_on(device), 1, act_table.lo, act_table.inv_step,
            act_table.sections)


def _tiles(plan: GemvPlan) -> tuple[int, int]:
    """(n_tile, cluster) of a C entry: n_tile 0 takes the CUDA-core kernel."""
    return (plan.n_tile, plan.cluster) if plan.route == "tensor_core" else (0, 1)



def gemv_pim_int8(x_i8: torch.Tensor, x_scale: torch.Tensor, w_i8: torch.Tensor,
                  w_scale: torch.Tensor, b: torch.Tensor | None = None, *,
                  out_dtype: torch.dtype = torch.float32,
                  act_table: LutTable | None = None) -> torch.Tensor:
    """Launch the CUDA kernel of `gemv_int8_plan`: int8 x (M, C) . int8 w
    (R, C) with row scales x_scale (M,), w_scale (R,) and optional bias
    (R,), each f32 or bf16 -> (M, R) in `out_dtype` (f32 or bf16), the LUT
    `act_table` applied to the cast value in the epilogue."""
    M, R = x_i8.shape[0], w_i8.shape[0]
    vectors = [("x_scale", x_scale, M), ("w_scale", w_scale, R)]
    if b is not None:
        vectors.append(("bias", b, R))
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"gemv_pim_int8 writes float32 or bfloat16, not {out_dtype}")
    _check_quant("gemv_pim_int8", x_i8, w_i8, (torch.int8,), vectors)
    table, act, lo, inv_step, sections = _lut_args(act_table, x_i8.device)
    out = torch.empty((M, R), dtype=out_dtype, device=x_i8.device)
    if M == 0 or R == 0:
        return out
    C = x_i8.shape[1]
    plan = gemv_int8_plan(M, C, R, aligned=_aligned(x_i8, w_i8))
    lib = _build.library("gemv_pim_quant")
    code = _DTYPE_CODE
    rc = _build.cfunc(lib, "gemv_pim_int8", "ppppppp" + "iii" + "iiiii" + "ffi" + "ii" + "p")(
        x_i8.data_ptr(), x_scale.data_ptr(), w_i8.data_ptr(), w_scale.data_ptr(),
        _build.ptr(b), _build.ptr(table), out.data_ptr(), M, C, R,
        code[x_scale.dtype], code[w_scale.dtype], code[b.dtype] if b is not None else 0,
        code[out_dtype], act, lo, inv_step, sections, *_tiles(plan), _build.stream(x_i8))
    _build.check(lib, "gemv_pim_quant", rc)
    gemv_pim_int8.launches += 1
    gemv_pim_int8.tc_launches += plan.route == "tensor_core"
    return out


def gemv_pim_int8_linear(x: torch.Tensor, w_i8: torch.Tensor, w_scale: torch.Tensor,
                         b: torch.Tensor | None = None, *,
                         compute: torch.dtype | None = None,
                         act_table: LutTable | None = None) -> torch.Tensor:
    """The int8 linear layer of `gemv_pim_int8_linear_plain`: x (M, C) f32
    or bf16, quantized per row in `compute` (x's dtype, or f32 for bf16
    x), . int8 w (R, C) with row scales w_scale (R,) and optional bias
    (R,), each f32 or bf16 -> (M, R) in x's dtype, the LUT `act_table`
    applied to the cast value. One launch with x's quantization in the
    kernel's load path where `gemv_int8_linear_plan` gives a tiling, else
    `quantize_int8_rows` then `gemv_pim_int8`."""
    compute = _compute_dtype("gemv_pim_int8_linear", x, compute)
    M, R = x.shape[0], w_i8.shape[0]
    vectors = [("w_scale", w_scale, R)] + ([("bias", b, R)] if b is not None else [])
    _check_quant("gemv_pim_int8_linear", x, w_i8, tuple(_DTYPE_CODE), vectors, torch.int8)
    C = x.shape[1]
    plan = gemv_int8_linear_plan(M, C, R, aligned=_aligned(x, w_i8))
    if plan is None:
        x_i8, x_scale = quantize_int8_rows(x, compute=compute)
        return gemv_pim_int8(x_i8, x_scale, w_i8, w_scale, b, out_dtype=x.dtype,
                             act_table=act_table)
    table, act, lo, inv_step, sections = _lut_args(act_table, x.device)
    out = torch.empty((M, R), dtype=x.dtype, device=x.device)
    if R == 0:
        return out
    code = _DTYPE_CODE
    lib = _build.library("gemv_pim_quant")
    rc = _build.cfunc(lib, "gemv_pim_int8_linear",
                      "pppppp" + "iii" + "iiiiii" + "ffi" + "ii" + "p")(
        x.data_ptr(), w_i8.data_ptr(), w_scale.data_ptr(), _build.ptr(b), _build.ptr(table),
        out.data_ptr(), M, C, R, code[x.dtype], code[compute], code[w_scale.dtype],
        code[b.dtype] if b is not None else 0, code[x.dtype], act, lo, inv_step, sections,
        plan.n_tile, plan.cluster, _build.stream(x))
    _build.check(lib, "gemv_pim_quant", rc)
    gemv_pim_int8_linear.launches += 1
    gemv_pim_int8_linear.tc_launches += 1
    return out


quantize_int8_rows_plain = quant_lib.quantize_int8_rows


def _compute_dtype(name: str, x: torch.Tensor, compute: torch.dtype | None) -> torch.dtype:
    """The dtype a row quantization computes in: x's, or f32 for bf16 x."""
    compute = x.dtype if compute is None else compute
    if compute not in _DTYPE_CODE or (compute == torch.bfloat16 and x.dtype != compute):
        raise TypeError(f"{name} quantizes {x.dtype} x in its own dtype or in float32, "
                        f"not {compute}")
    return compute


def quantize_int8_rows(x: torch.Tensor, *, compute: torch.dtype | None = None,
                       static_input: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel of `quant_plan`: x (..., C) f32 or bf16 ->
    int8 (..., C) and scale (...) in `compute` (x's dtype, or f32 for bf16
    x), bit for bit `quantize_int8_rows_plain(x.to(compute))` in one pass
    a row. The kernel may start while the kernel before it runs
    (programmatic dependent launch) and waits for it before it writes;
    `static_input` says that no kernel in flight writes x (a weight), so
    the kernel reads x before that wait too."""
    if x.device.type != "cuda":
        raise ValueError(f"quantize_int8_rows takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"quantize_int8_rows takes float32 or bfloat16, got {x.dtype}")
    compute = _compute_dtype("quantize_int8_rows", x, compute)
    if x.dim() < 1 or x.shape[-1] == 0:
        raise ValueError(f"quantize_int8_rows needs rows of C >= 1, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(x.shape[:-1], dtype=compute, device=x.device)
    rows, C = scale.numel(), x.shape[-1]
    if rows == 0:
        return q, scale
    chunks, warps, rows_per_block = quant_plan(rows, C, x.element_size())
    vec = _build.vector_ok(x.element_size(), [C], x)
    lib = _build.library("gemv_pim_quant")
    rc = _build.cfunc(lib, "quantize_int8_rows", "ppp" + "l" + "i" * 8 + "p")(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, C, _DTYPE_CODE[x.dtype],
        _DTYPE_CODE[compute], chunks, warps, rows_per_block, int(vec), int(static_input),
        _build.stream(x))
    _build.check(lib, "gemv_pim_quant", rc)
    quantize_int8_rows.launches += 1
    return q, scale


def gemv_pim_fixed(x_q: torch.Tensor, w_q: torch.Tensor, *, shift: int) -> torch.Tensor:
    """Launch the CUDA kernel of `gemv_fixed_plan`: int16 x (M, C) . int16
    w (R, C), wrapping int32 sum >> shift, saturated -> int16 (M, R)."""
    if not 0 <= shift < 32:
        raise ValueError(f"shift must be in [0, 32), got {shift}")
    _check_quant("gemv_pim_fixed", x_q, w_q, (torch.int16,), [])
    (M, C), R = x_q.shape, w_q.shape[0]
    out = torch.empty((M, R), dtype=torch.int16, device=x_q.device)
    if M == 0 or R == 0:
        return out
    plan = gemv_fixed_plan(M, C, R, aligned=_aligned(x_q, w_q))
    lib = _build.library("gemv_pim_quant")
    rc = _build.cfunc(lib, "gemv_pim_fixed", "ppp" + "iiii" + "ii" + "p")(
        x_q.data_ptr(), w_q.data_ptr(), out.data_ptr(), M, C, R, shift, *_tiles(plan),
        _build.stream(x_q))
    _build.check(lib, "gemv_pim_quant", rc)
    gemv_pim_fixed.launches += 1
    gemv_pim_fixed.tc_launches += plan.route == "tensor_core"
    return out


def gemv_pim_fixed_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
                          frac_x: int, frac_w: int,
                          act_table: LutTable | None = None) -> torch.Tensor:
    """Launch the CUDA kernel of `gemv_fixed_plan`: the fixed16 linear
    layer of `gemv_pim_fixed_linear_plain` in one launch, x (M, C) and w
    (R, C) in one dtype (f32 or bf16) quantized as they load, optional
    bias (R,) in f32 or bf16 -> (M, R) in x's dtype."""
    for name, frac in (("frac_x", frac_x), ("frac_w", frac_w)):
        if not 0 <= frac <= 30:
            raise ValueError(f"{name} must be in [0, 30], got {frac}")
    vectors = [("bias", b, w.shape[0])] if b is not None else []
    _check_quant("gemv_pim_fixed_linear", x, w, tuple(_DTYPE_CODE), vectors)
    plan = gemv_fixed_plan(x.shape[0], x.shape[1], w.shape[0], aligned=_aligned(x, w))
    return launch_fixed_linear(x, w, b, plan, frac_x=frac_x, frac_w=frac_w,
                               act_table=act_table)


def launch_fixed_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                        plan: GemvPlan, *, frac_x: int, frac_w: int,
                        act_table: LutTable | None = None) -> torch.Tensor:
    """`gemv_pim_fixed_linear` on a given plan, after its checks (the C
    entry checks the plan; chip_smoke.py times the CUDA-core route so)."""
    table, act, lo, inv_step, sections = _lut_args(act_table, x.device)
    (M, C), R = x.shape, w.shape[0]
    out = torch.empty((M, R), dtype=x.dtype, device=x.device)
    if M == 0 or R == 0:
        return out
    lib = _build.library("gemv_pim_quant")
    rc = _build.cfunc(lib, "gemv_pim_fixed_linear",
                      "ppppp" + "iii" + "iiiii" + "ffi" + "ii" + "p")(
        x.data_ptr(), w.data_ptr(), _build.ptr(b), _build.ptr(table), out.data_ptr(), M, C, R,
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[b.dtype] if b is not None else 0, frac_x, frac_w,
        act, lo, inv_step, sections, *_tiles(plan), _build.stream(x))
    _build.check(lib, "gemv_pim_quant", rc)
    gemv_pim_fixed_linear.launches += 1
    gemv_pim_fixed_linear.tc_launches += plan.route == "tensor_core"
    return out


gemv_pim_int8.launches = 0
gemv_pim_int8.tc_launches = 0
gemv_pim_int8_linear.launches = 0
gemv_pim_int8_linear.tc_launches = 0
quantize_int8_rows.launches = 0
gemv_pim_fixed.launches = 0
gemv_pim_fixed.tc_launches = 0
gemv_pim_fixed_linear.launches = 0
gemv_pim_fixed_linear.tc_launches = 0
