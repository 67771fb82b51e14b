#!/usr/bin/env python3
"""Time the port's clustered kernels at every cluster size, on one GPU.

    python3 scripts/sweep_clusters.py

The single-walk paged decode (`kernels/paged_attention.py`) at 4 slots x
16 heads x head_dim 64, bf16 pools, page 16, over a 16-page table (64..256
keys) and a 64-page table (16, 256 and 960..1024 keys), with the cluster
forced to 1, 2, 4 and 8 blocks; the same walk over the dense arena
(`kernels/decode_attention.py`) at 128..160 keys of a 256 arena and
960..1020 of a 1024 arena, and the KV split with its combine
(`merge_partials`) at K = 4 and 8 over the 960..1024-key table, with each split's cluster
forced to 1, 2, 4 and 8 where it has the pages (the planners' choices
named). The tensor-core GEMV (`kernels/gemv_pim.py`)
over GPT-2 medium's d x d, w_up and w_down shapes: at M=4 (a decode step)
with the cluster forced to 1, 2, 4 and 8, and at M=64 (a prefill chunk),
128, 256 and 512 (a 4 x 128-token prefill) over token tiles from 16 to
the least that holds M and clusters 1..8, beside `F.linear` and the
bound, with the tiling `gemv_plan` picks named. Each time is the median
of 20 replays of a CUDA graph of 24 launches (`chip_smoke.time_graph`):
"cold" rotates over 24 sets of pools or weights (cold in L2, as in a
decode step), "warm" reuses one set. Prints one line per case; needs a
CUDA device.
"""
from __future__ import annotations

import dataclasses
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
L = 24


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("sweep_clusters.py: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import bound_ms, time_graph
    from repro_torch.kernels import decode_attention, gemv_pim, paged_attention

    def us(fn):
        return 1e3 * time_graph(torch, fn, L)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, D, page = 4, 16, 64, 16
    for n_tbl, lens in [(16, [64, 128, 200, 256]), (64, [16] * 4), (64, [256] * 4),
                        (64, [960, 981, 1003, 1024])]:
        P = 1 + B * n_tbl
        tables = ((torch.randperm(P - 1, generator=gen, device=dev) + 1)
                  .reshape(B, n_tbl).to(torch.int32))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((B, H, D), generator=gen, device=dev).bfloat16()
        pools = [tuple(torch.randn((P, H, page, D), generator=gen, device=dev).bfloat16()
                       for _ in range(2)) for _ in range(L)]
        for cs in (1, 2, 4, 8):
            def run(i, cs=cs):
                return paged_attention.launch_decode(q, *pools[i], tables, lengths,
                                                     None, None, 0, cs)
            cold, warm = us(run), us(lambda i: run(0))
            print(f"paged decode, {n_tbl}-page table, lengths {lens}, cluster {cs}: "
                  f"cold {cold:.2f} us, warm {warm:.2f} us", flush=True)
        if lens[0] < 960:
            continue
        for K in (4, 8):
            planned = paged_attention.split_plan(B, H, K, n_tbl, 1, D, page, 2 * D)
            for cs in (c for c in (1, 2, 4, 8) if c <= n_tbl // K):
                def run(i, cs=cs, K=K):
                    return paged_attention.merge_partials(*paged_attention.paged_attention_split(
                        q, *pools[i], tables, lengths, kv_splits=K,
                        plan=(cs, -(-n_tbl // K // cs))), q.dtype)
                print(f"split K={K} + merge_partials, {n_tbl}-page table, lengths {lens}, "
                      f"cluster {cs} (planned {planned[0]}): cold {us(run):.2f} us",
                      flush=True)
    for S, lens in ((256, [128, 137, 151, 160]), (1024, [960, 981, 1003, 1020])):
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((B, H, D), generator=gen, device=dev).bfloat16()
        arenas = [tuple(torch.randn((B, H, S, D), generator=gen, device=dev).bfloat16()
                        for _ in range(2)) for _ in range(L)]
        planned = paged_attention.arena_plan(B, H, S, 1, D, 2 * D)
        for cs in (c for c in (1, 2, 4, 8) if c <= S // 256):
            def run(i, cs=cs):
                return decode_attention.decode_attention(q, *arenas[i], lengths,
                                                         plan=(cs, -(-S // 256 // cs)))
            cold, warm = us(run), us(lambda i: run(0))
            print(f"dense decode, arena {S}, lengths {lens}, cluster {cs} (planned "
                  f"{planned[0]}): cold {cold:.2f} us, warm {warm:.2f} us", flush=True)
    for R, C in [(1024, 1024), (4096, 1024), (1024, 4096)]:
        ws = [torch.randn((R, C), generator=gen, device=dev).bfloat16() for _ in range(L)]
        x = torch.randn((4, C), generator=gen, device=dev).bfloat16()
        plan = gemv_pim.gemv_plan(4, C, R, torch.bfloat16)
        for cs in (1, 2, 4, 8):
            forced = dataclasses.replace(plan, cluster=cs)

            def run(i, forced=forced):
                return gemv_pim.launch_float(x, ws[i], None, forced)
            cold, warm = us(run), us(lambda i: run(0))
            print(f"tensor-core GEMV M=4 R={R} C={C}, cluster {cs}: cold {cold:.2f} "
                  f"us, warm {warm:.2f} us", flush=True)
        for M in (64, 128, 256, 512):
            x = torch.randn((M, C), generator=gen, device=dev).bfloat16()
            plan = gemv_pim.gemv_plan(M, C, R, torch.bfloat16)
            lib = us(lambda i: F.linear(x, ws[i]))
            bnd, by = bound_ms(2 * (M * C + R * C + M * R), 2 * M * R * C, "bfloat16")
            print(f"tensor-core GEMV M={M} R={R} C={C}: F.linear {lib:.2f} us, bound "
                  f"{1e3 * bnd:.2f} us by {by}, planned n_tile {plan.n_tile} cluster "
                  f"{plan.cluster}", flush=True)
            for n in (t for t in gemv_pim.TC_N if 16 <= t <= max(M, 16)):
                for cs in (1, 2, 4, 8):
                    forced = dataclasses.replace(plan, n_tile=n, cluster=cs)

                    def run(i, forced=forced):
                        return gemv_pim.launch_float(x, ws[i], None, forced)
                    print(f"tensor-core GEMV M={M} R={R} C={C}, n_tile {n}, cluster {cs}: "
                          f"cold {us(run):.2f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
