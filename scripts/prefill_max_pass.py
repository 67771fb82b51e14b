#!/usr/bin/env python3
"""Time what the tensor-core paged prefill's first pass costs, on one GPU.

    python3 scripts/prefill_max_pass.py

Every run of pages but the last reads its K twice in
`csrc/paged_prefill.cu`: once for its maximum a row (so that the later
runs start their walk from the earlier runs' maximum and the LUT sees the
page walk's own arguments), once in the walk. This script builds the
source a second time with -DPREFILL_NO_MAX_PASS, which drops that first
pass (its output is not the function), and times both builds on GPT-2
medium's prefill chunk: B=1, Sq=64, 16 heads, head_dim 64, page 16, bf16
pools rotating over 24 layers (cold in L2), at start 64 and start 896,
exact and LUT. Each time is the median of 20 replays of a CUDA graph of 24
launches (`chip_smoke.time_graph`). Prints the card, then one line per
case; needs a CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
L = 24


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("prefill_max_pass.py: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import time_graph
    from repro_torch.core import lut as tlut
    from repro_torch.kernels import _build, paged_prefill
    from repro_torch.kernels.paged_attention import _mask_args

    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _build.BUILD_DIR / "paged_prefill-no-max-pass.so"
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-DPREFILL_NO_MAX_PASS", "-o", str(so),
                    str(_build.CSRC / "paged_prefill.cu")], check=True, capture_output=True)
    variant = ctypes.CDLL(str(so))

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, Sq, H, D, page, n_tbl = 1, 64, 16, 64, 16, 64
    bank = tlut.LutBank.create(64)
    q = torch.randn((B, Sq, H, D), generator=gen, device=dev).bfloat16()
    table = (torch.randperm(n_tbl, generator=gen, device=dev) + 1)[None].to(torch.int32)
    pools = [tuple(torch.randn((1 + n_tbl, H, page, D), generator=gen, device=dev).bfloat16()
                   for _ in range(2)) for _ in range(L)]
    plan = paged_prefill.prefill_plan(B, Sq, H, H, D, page, page * D * 2, torch.bfloat16)

    def without_max_pass(k, v, length, start, exp_table):
        """The tensor-core C entry of the variant build, called as
        `paged_prefill_attention` calls the real one."""
        out = torch.empty_like(q)
        wb, masks = _mask_args(D, None, None, None, exp_table, dev)
        fn = _build.cfunc(variant, "paged_prefill_attention_tc",
                          "p" * 10 + "i" * 8 + "ffiiffiii" + "p")
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, table.data_ptr(),
                length.data_ptr(), start.data_ptr(), wb, out.data_ptr(), B, Sq, H, H, D,
                page, k.shape[0], n_tbl, *masks, 0, plan.cluster,
                torch.cuda.current_stream().cuda_stream)
        _build.check(variant, "paged_prefill", rc)
        return out

    for s0 in (64, 896):
        start = torch.tensor([s0], dtype=torch.int32, device=dev)
        length = start + Sq
        for exp_table in (None, bank.exp):
            kw = {} if exp_table is None else {"exp_table": exp_table}
            t = time_graph(torch, lambda i: paged_prefill.paged_prefill_attention(
                q, *pools[i], table, length, start, **kw), L)
            t0 = time_graph(torch, lambda i: without_max_pass(*pools[i], length, start,
                                                             exp_table), L)
            mode = "LUT" if exp_table is not None else "exact"
            print(f"prefill start {s0} ({s0 + Sq} keys) {mode}, cluster {plan.cluster}: "
                  f"{t * 1e3:.2f} us with the first pass, {t0 * 1e3:.2f} us without "
                  f"(the second read of K costs {(t - t0) * 1e3:.2f} us)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
