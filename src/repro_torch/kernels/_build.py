"""Build the CUDA sources in `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain C
interface, `build/repro_torch/<name>-<hash>.so` under the repository root,
keyed by a hash of the sources and flags. The build runs at first use
(`library(name)`), never at import; the first use builds every source, one
nvcc process each, all at once. `build_all()` does the same and returns
ptxas' register and shared-memory report for each library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("gemv_pim", "gemv_pim_quant", "paged_attention", "paged_attention_split",
           "paged_prefill", "decode_attention", "softmax_lut", "layernorm_lut",
           "lut_interp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C entries, and the most table rows (sections + 2) a
# kernel stages in shared memory (lut.cuh's kMaxTableRows).
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_TABLE_ROWS = 128

# The H100 SXM's multiprocessors: the GEMV and paged-decode planners grow
# their clusters until a grid covers them (a heuristic tuned on that card;
# any other count still computes the same function).
SMS = 132

# Row kernels (softmax_lut, layernorm_lut): a row belongs to a group of 1,
# 2, 4 or 8 warps of a block of at most 8 warps, each lane holding pieces of
# 16 bytes of it in registers. A call of few rows is bound by one row's
# latency, so its rows are spread over more warps until the card holds 8
# warps an SM or a lane holds 8 values.
ROW_GROUP_WARPS = (1, 2, 4, 8)
BLOCK_WARPS = 8
SPREAD_WARPS_PER_SM = 8
SPREAD_LANE_VALUES = 8


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def row_plan(n_rows: int, width: int, itemsize: int,
             max_chunks: int) -> tuple[int, int, int] | None:
    """(chunks, warps_per_row, rows_per_block) for rows of `width` elements
    of `itemsize` bytes: the fewest warps a row whose lanes hold it in at
    most `max_chunks` pieces of 16 bytes (a power of two of them), spread
    over more warps while the call has fewer than 8 warps an SM and a lane
    holds more than 8 values. Rows of one warp and fewer than 16 values a
    lane share a block, as many as still give every SM a block; any other
    row takes a block. None when 8 warps cannot hold the row."""
    n = 16 // itemsize

    def chunks_for(warps):
        return _pow2_at_least(-(-width // (32 * warps * n)))

    warps = next((w for w in ROW_GROUP_WARPS if chunks_for(w) <= max_chunks), None)
    if warps is None:
        return None
    while (warps < ROW_GROUP_WARPS[-1] and chunks_for(warps) * n > SPREAD_LANE_VALUES
           and n_rows * warps < SPREAD_WARPS_PER_SM * SMS):
        warps *= 2
    chunks = chunks_for(warps)
    rows = 1
    if warps == 1 and chunks * n < 16:
        rows = BLOCK_WARPS
        while rows > 1 and -(-n_rows // rows) < SMS:
            rows //= 2
    return chunks, warps, rows


def vector_ok(itemsize: int, counts, *tensors) -> bool:
    """Whether a row kernel may move 16-byte pieces: every tensor given
    (None skipped) starts on a 16-byte boundary and every count of
    elements of `itemsize` bytes (a row's length, a stride) spans a
    multiple of 16 bytes."""
    return (all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)
            and all(n * itemsize % 16 == 0 for n in counts))


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
ptxas_reports: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _compile(name: str, nvcc: str) -> str:
    out = _lib_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def build_all() -> dict[str, str]:
    """Compile every source whose library is missing, in parallel; return
    ptxas' report per source compiled by this call."""
    with _lock:
        todo = [n for n in SOURCES if not _lib_path(n).exists()]
        if todo:
            nvcc = _nvcc()
            results: dict[str, object] = {}

            def run(n):
                try:
                    results[n] = _compile(n, nvcc)
                except (RuntimeError, OSError) as e:   # re-raised below
                    results[n] = e

            threads = [threading.Thread(target=run, args=(n,)) for n in todo]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for n in todo:
                if isinstance(results[n], Exception):
                    raise results[n]
                ptxas_reports[n] = results[n]
        return {n: ptxas_reports.get(n, "") for n in todo}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(name)))
                _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise when a C entry returned a CUDA error code."""
    if rc != 0:
        err = getattr(lib, f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel failed: CUDA error {rc} "
                           f"({err(rc).decode()})")


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
           "l": ctypes.c_longlong}


def cfunc(lib: ctypes.CDLL, name: str, argtypes: str):
    """The C entry `name` with its argument types set once: p = pointer,
    i = int, l = 64-bit int, f = float, one letter per argument."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [_CTYPES[c] for c in argtypes]
        fn.restype = ctypes.c_int
    return fn


def ptr(t):
    """A tensor's device address, or None (a null pointer) for None."""
    return t.data_ptr() if t is not None else None


def stream(t) -> int:
    """The handle of PyTorch's current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_table(table) -> None:
    """Raise when a LUT table has more rows than the kernels stage."""
    if table is not None and table.sections + 2 > MAX_TABLE_ROWS:
        raise ValueError(f"LUT tables hold at most {MAX_TABLE_ROWS - 2} sections")
