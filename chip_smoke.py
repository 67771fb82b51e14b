#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. Phases, each of which fails the run:

  1. card   — the GPU's name and power limit (nvidia-smi);
  2. build  — nvcc builds every kernel of the serving path for sm_90a from
              the sources in the checkout, with ptxas' register report;
  3. kernels — each CUDA kernel against its plain PyTorch version at the
              main path's shapes in f32 and bf16: the paged kernels on fp,
              int8 (f32/bf16 scale rows) and int4 pools, and the KV-split
              kernel at K in {2, 4, 7, 16} on a 1024-token table, with its
              combine (merge_partials, bit for bit its split-order plain
              twin, and the two replayed in a CUDA graph on their
              programmatic edge), also against the unsplit kernel,
              and, through `paged_attention(..., kv_splits=K)` (the route),
              on planted keys at K 4/8/16 and at qwen2-1.5B's 131072 keys
              (K 8); the dense path's decode
              attention (arenas of 256, 161 and 1024 positions, GQA with a
              window and a softcap; the int8 arena bit for bit to the
              kernel on the dequantized arena; planted keys over 4100 and
              131072 positions), LUT softmax (causal and not),
              LayerNorm/RMSNorm and LUT interpolation (both bit for
              bit); the float GEMV over M 1..512 x R 1000..50257 x C
              1024/4096 with every epilogue, bf16 on the tensor-core
              kernel and f32 on the CUDA-core one (the wrapper's counter
              must show the route); the single-walk decode over lengths
              1..1024 at g 1 and 2 on every pool format, LUT mode held to
              the page walk (`paged_attention_online_plain`); then
              each is timed (CUDA graphs of many launches, median of 20
              replays) beside its plain version, the matching PyTorch call
              where there is one, and its bound on the card, the
              long-context decode kernels at 960..1024 tokens, the 145
              GEMVs of a decode step (M=4) and of a 64-token chunk, and
              the GEMV at `generate()`'s prefill width (M=512, d x d,
              w_up and w_down), and the two row kernels at every width the
              main paths launch them (the norm at 4, 64 and 512 rows, the LUT
              softmax at 128 and 960 keys) under each launch shape their
              planner could pick;
  4. serve  — GPT-2 medium at full width with seeded random weights serves
              8 requests through `ServingEngine` on the GPU, once with exact
              nonlinearities and once with the LUT ones; every request must
              finish, every page must come back, every kernel of the path
              must have been launched (counts checked at every step; every
              bf16 GEMV on the tensor-core kernel), and
              each request's first logits must agree with a one-shot
              prefill computed through the plain versions; then a decode
              step and a prefill chunk are timed on the host clock and,
              replayed as a CUDA graph, on the device alone;
  5. long   — the same model at max_len 1024 serves 4 requests of 896..960
              prompt tokens in four drains: fp pools with and without
              kv_splits=4, int8 pools (bf16 scale rows) with kv_splits=4,
              int4 pools with LUT nonlinearities and kv_splits=4, with the
              checks of phase 4 (24 split and 24 combine launches and no
              single-walk launch a decode step where the split is on) and
              each drain's decode step timed on the device;
  6. quant  — the quantized S-ALU datapaths: GPT-2 medium at max_len 256
              serves phase 4's requests in three drains, q1 with
              `quantize_params_int8` weights and int8 pools, q2 with
              `SalPimConfig(quant="fixed16")`, q3 with `quant="int8"` and LUT
              nonlinearities, with phase 4's checks (145 `gemv_pim_int8` or
              `gemv_pim_fixed_linear` launches, all on the 8-bit tensor
              cores, and no float GEMV a step and a chunk; on q1 and q3
              `gemv_pim_int8_linear`, x quantized in its load path, so no
              quantize_int8_rows launch for x (q3's 145 are its weights);
              each datapath's decode step and chunk run the fp path's
              PyTorch operations plus only the eager GELUs, the QTensor
              scales' unbind (q1) or the weights' quantization outputs
              (q3), so no cast, quantization or bias op is left around a
              quantized GEMV)
              and the first logits held to a one-shot prefill through
              the plain versions on the same datapath; each drain's share of
              greedy tokens with phase 4's exact drain, its decode step and
              prefill chunk on the host clock and the device, and the device
              time of the per-call weight quantization;
  7. dense  — the dense per-slot arena: `generate()` on 4 prompts of 128
              tokens, 32 new, exact and LUT (launches checked in total,
              first logits against a plain prefill); ServingEngine with
              paged=False on phase 4's requests at max_len 256, exact, LUT
              and with the int8 arena, and on phase 5's requests at
              max_len 1024, exact: every request finishes, every slot parks
              at length 0, 145 GEMV + 24 decode_attention + 49
              layernorm_lut launches a decode step and 145 GEMV + 49
              layernorm_lut (+ 24 softmax_lut in LUT mode) an admission,
              no paged kernel (checked every step), first logits within
              3e-2 of a plain prefill; each drain's share of tokens with
              the paged drain on the same requests, its decode step on
              the host clock and on the device, and the int8 arena's
              eager dequantization, which the kernel's int8 read
              replaces, timed for comparison; and a 128-token admission's
              prefill, exact and LUT, on the device;
  8. qwen2 — qwen2-1.5B at full width (28 layers, GQA 12/2, head_dim 128,
              vocab 151936, RoPE, QKV bias, SwiGLU, RMSNorm; bf16, seeded
              random weights) serves 8 requests of 32..128 prompt tokens
              through ServingEngine as phase 4 does (page 16, 64-token
              chunks), exact, LUT, with kv_splits=4 at max_len 1024, and
              with int8 weights and pools (q1), with phase 4's checks at
              197 linears, 28 attention and 57 layernorm_lut launches a
              decode step; then its decode step and chunk on the host
              clock and on the device;
  9. gemma2/danube — gemma2-2B (head_dim 256, softcaps, local/global
              windows, RMSNorm(1 + w), post-norms, embedding scale, GeGLU)
              and h2o-danube3-4B (head_dim 120, a 4096-token window) at
              their published widths, the depth cut to 2 layers, each
              serving three short requests and one of 4200 prompt tokens
              (past the window) exact and in LUT mode (gemma2's LUT final
              softcap: one lut_interp a step and a chunk);
 10. nemotron — nemotron-4-340B at its published widths (d 18432, the
              streamed layernorm_lut; head_dim 192, g 12, squared ReLU,
              vocab 256000), one layer (13 B parameters), serving 2 short
              requests, exact;
 11. share/spec — prefix sharing and speculative decoding on the paged
              engine, GPT-2 medium at full width (4 slots, page 16, 64-token
              chunks, max_len 256): sharing drains of 8 requests (four on one
              64-token prefix with 16..48-token tails, two exact repeats of
              the 80-token one: the fully covered path, its last token
              recomputed through a COW fork; two unrelated) with sharing on
              and off, fp and int8/bf16 pools; speculative drains on phase
              4's requests, spec off and `ngram` k=4 on fp and int8/bf16
              pools, self-draft (the target as its own draft model, on the
              dense cache) and an all-rejecting drafter (every round
              rewound); an `ngram` k=4 drain of 2 requests whose prompt +
              max_new - 1 is max_len, so that their last verify passes pad
              positions past the block table (into the trash columns);
              qwen2-1.5B at full width, `ngram` k=4 with sharing.
              Gates: every request finishes with no page in use, reserved
              or pinned; every step's launches (a verify pass: a chunk's
              launches over (4 slots, 5 tokens), so M = 20 at every linear,
              and no paged_attention; a draft model's counted apart, as
              phase 7's dense prefills and decode steps); first logits
              within FIRST_LOGITS_LIMIT of a plain one-shot prefill; the
              donor's pages bit for bit at every COW fork and after every
              chunk and step (`DonorWatch`); verify logits at 5 positions
              within FIRST_LOGITS_LIMIT of five sequential decode steps'
              from one resident state, on copies of the pools (GPT-2 fp and
              int8/bf16, exact and LUT; qwen2 fp). Reported: token shares
              between spec on and off and sharing on and off (the same pool
              format), with the first divergent position and the off
              drain's top-2 logit gap there; each drain's stats(); a verify
              pass against a decode step on the host clock and the device;
 12. the kernels line, a JSON object with each kernel's error, times,
     bound and launches, then the card line and the result line.

Phases 8-10 count every kernel's launches at every step, as phases 4-6
do, and hold each request's first logits within FIRST_LOGITS_LIMIT of a
one-shot prefill through the plain versions. Phase 3 also
holds the kernels at those models' shapes (the float GEMV over their
linears up to 256000 x 18432; the decode, prefill and arena walks at g x
head_dim 6 x 128, 2 x 256 with softcap 50 and window 4096, 4 x 120 with
the window, 12 x 192, over 4800 keys on every pool format; the norm's
streamed rows at d 16392/18432 bf16 and 8200 f32, bit for bit) and times
them (`time_model_kernels`: qwen2-1.5B's 197 GEMVs of a decode step, the
decode and the chunk at each model's heads, the norm at (4, 18432)).

Phases 4-6 also check the norms (49 layernorm_lut launches a decode step
and a chunk) and that no path launches lut_interp (q3's LUT GELU rides the
int8 GEMV's epilogue).

For phase 11's paths phase 3 also holds the prefill kernel as a verify pass
runs it (B 4 x Sq 5 at a different start a row, two rows on the same
physical pages, a parked all-trash row; Sq 1 at a fully shared prompt's
last token), bit for bit with the plain versions on every pool format, and
the float and int8 GEMVs and the int8 linear layer at M = 20.

Phase 3 also holds the int8 and fixed16 GEMVs bit for bit to their plain
versions (int8 over M 1..512 x R 1000..50257 x C 1024/4096 on the s8
tensor cores and C 1000 on the __dp4a kernel, with and without bias, and
with q3's epilogue: bf16 scales and bias, bf16 out, the LUT GELU; fixed16
at M 1, 4, 64, shift 10 and 12, with rows that saturate both ways and one
whose int32 sum wraps; then the int16 kernel and the fused fixed16 linear
layer, bf16 and f32, bias and LUT, at M 1..512 over the model's shapes on
the 8-bit tensor cores and at C 1000 and a misaligned x on the CUDA
cores, sums planted to saturate both ways and to wrap past +-2^31, two
launches bit for bit), `quantize_int8_rows` bit for bit on f32 and bf16
rows, in x's dtype and in f32, aligned and misaligned, 4..50257 rows of
1024..4096 and rows streamed past 8 warps' registers (zero rows and .5
ties), and the int8 linear layer (`gemv_pim_int8_linear`) over the
GPT-2's and qwen2-1.5B's shapes at M 1..512 in q1's and q3's forms, bit
for bit its two launches and its plain version; the prefill kernel (fp64
sums) over g 1 and 2, Sq 1/17/64 and starts 0/15/64/896 on every pool
format (bf16; the elements off the plain version's bits counted); the
single walk at qwen2-1.5B's widths over 131072
keys (in windows), at g 12 x D 192, and forced into windows of 1 and 3
pages at 384 keys on every pool format, all on planted keys that keep
the outputs O(1); and times the int8 GEMV over a
decode step and at `w_up`, the per-call quantization on the kernel, the
prefill at start 896 and the 131072-key walk beside SDPA and the split.
Phases 4-6 count every tensor-core launch: all 145 linears of q1 and q3
one `gemv_pim_int8_linear` launch each on the s8 tensor cores (x
quantized in its load path; q3's 145 quantize_int8_rows launches are its
weights') and of q2 on the 8-bit ones. Phase 3 also times the int8 linear layer over
a decode step against the two launches it replaces, each weight shape's
quantization against its bound, and the KV split's route with and
without the combine's programmatic launch.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM
# CUDA cores f32; bf16 and int8 dense tensor cores. An int16 product is
# four 8-bit ones (hi.hi, hi.lo, lo.hi, lo.lo byte planes), which the
# fixed16 kernel runs on the int8 tensor cores: a quarter of their rate.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12, "int16": 1979e12 / 4}
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# In LUT mode the paged kernels run the TPU kernels' online softmax
# (corr = LUT(max(m_prev - m_new, lo)) page by page), a different function
# from the dense LUT softmax of the plain versions: LUT(a) LUT(b) != LUT(a + b).
# The JAX package bounds that gap by 3e-3 at <= 23 keys; at the main
# path's 64..1024 keys it reaches 5e-3. So a LUT-mode kernel is held, at
# the exact-mode tolerances, to `paged_attention_online_plain`, the same page
# walk in plain PyTorch, and its gap from the dense plain version is printed.
# First logits of a drain against a one-shot prefill through the plain
# versions: max |diff| / max |logit|. A LUT-mode paged drain is held to the
# plain page walk at FIRST_LOGITS_LIMIT and to the dense LUT softmax, the
# oracle's function, at DENSE_LUT_GAP_LIMIT; scripts/first_logits_seeds.py
# reads both over several seeds.
FIRST_LOGITS_LIMIT = 3e-2
DENSE_LUT_GAP_LIMIT = 4e-2
SOURCE = {
    "gemv_pim_float": ("src/repro_torch/kernels/csrc/gemv_pim.cu",
                       "src/repro/kernels/gemv_pim.py:72"),
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:272"),
    "paged_prefill_attention": ("src/repro_torch/kernels/csrc/paged_prefill.cu",
                                "src/repro/kernels/paged_prefill.py:126"),
    "paged_attention_split": ("src/repro_torch/kernels/csrc/paged_attention_split.cu",
                              "src/repro/kernels/paged_attention.py:372"),
    "merge_partials": ("src/repro_torch/kernels/csrc/paged_attention_split.cu",
                       "src/repro/kernels/paged_attention.py:440"),
    "gemv_pim_int8": ("src/repro_torch/kernels/csrc/gemv_pim_quant.cu",
                      "src/repro/kernels/gemv_pim.py:151"),
    "gemv_pim_fixed": ("src/repro_torch/kernels/csrc/gemv_pim_quant.cu",
                       "src/repro/kernels/gemv_pim.py:208"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:112"),
    "softmax_lut": ("src/repro_torch/kernels/csrc/softmax_lut.cu",
                    "src/repro/kernels/softmax_lut.py:61"),
    "layernorm_lut": ("src/repro_torch/kernels/csrc/layernorm_lut.cu",
                      "src/repro/kernels/layernorm_lut.py:73"),
    "lut_interp": ("src/repro_torch/kernels/csrc/lut_interp.cu",
                   "src/repro/kernels/lut_interp.py:45"),
    # Not a TPU kernel: XLA ops of the JAX package (quantize_int8_rowwise,
    # and int8_linear's quantization of x) in one CUDA kernel.
    "quantize_int8_rows": ("src/repro_torch/kernels/csrc/gemv_pim_quant.cu",
                           "src/repro/core/quant.py:125"),
}
NOT_TPU_KERNELS = {"quantize_int8_rows"}
# The model's GEMV shapes (R, C): q/k/v/o projections, w_up, w_down, LM head.
QUANT_SHAPES = [(1024, 1024), (4096, 1024), (1024, 4096), (50257, 1024)]
# The RoPE models' attention shapes: (model, g = query heads a kv head,
# head_dim, the options their layers pass: gemma2-2B's softcap and
# 4096-token window, h2o-danube3-4B's window).
MODEL_HEADS = [("qwen2-1.5b", 6, 128, {}),
               ("gemma2-2b", 2, 256, {"softcap": 50.0, "window": 4096}),
               ("h2o-danube3-4b", 4, 120, {"window": 4096}),
               ("nemotron-4-340b", 12, 192, {})]
# Their linears (R, C): q, k/v, o, w_gate/w_up, w_down, LM head.
MODEL_GEMV_SHAPES = [
    (1536, 1536), (256, 1536), (8960, 1536), (1536, 8960), (151936, 1536),      # qwen2
    (2048, 2304), (1024, 2304), (2304, 2048), (9216, 2304), (2304, 9216),       # gemma2
    (256000, 2304),
    (3840, 3840), (960, 3840), (10240, 3840), (3840, 10240), (32000, 3840),     # danube
    (18432, 18432), (1536, 18432), (73728, 18432), (18432, 73728),              # nemotron
    (256000, 18432)]
# Pool formats: (kv_cache_dtype, kv_scale_dtype); fp pools hold q's dtype.
POOLS = {"fp": ("model", "float32"), "int8/f32": ("int8", "float32"),
         "int8/bf16": ("int8", "bfloat16"), "int4/bf16": ("int4", "bfloat16")}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def time_graph(torch, fn, n_calls: int, reps: int = 20) -> float:
    """Median ms per call of `fn(i)`, i = 0..n_calls-1, captured in one CUDA
    graph so that host launch overhead does not count."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(min(n_calls, 3)):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / n_calls)
    del graph
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def compare(torch, name: str, got, want, tol: float) -> float:
    err = (got.float() - want.float()).abs()
    bad = err > tol + tol * want.float().abs()
    max_err = float(err.max())
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside "
                             f"atol=rtol={tol}; max abs err {max_err:.3e}")
    return max_err


def make_pools(torch, quantize, k32, v32, fmt: str, dtype):
    """(k_pages, v_pages, k_scales, v_scales) in pool format `fmt` from f32
    K/V, quantized by the port's write-time quantization; fp pools take
    `dtype`."""
    kv, sd = POOLS[fmt]
    if kv == "model":
        return k32.to(dtype), v32.to(dtype), None, None
    quant = quantize.quantize_vec_int4 if kv == "int4" else quantize.quantize_vec
    (k, ks), (v, vs) = quant(k32, getattr(torch, sd)), quant(v32, getattr(torch, sd))
    return k, v, ks, vs


def check_kernels(torch, tlut, quantize, collectives, gemv_pim, paged_attention,
                  paged_prefill, seed):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    bank = tlut.LutBank.create(64)
    errs = {name: 0.0 for name in SOURCE}

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    gemv_cases = [
        ((4, 1024, 1024), True, None),       # q/k/v projections
        ((4, 1024, 4096), False, "gelu"),    # w_up, exact GELU epilogue
        ((4, 1024, 4096), False, "lut"),     # w_up, LUT GELU epilogue
        ((4, 4096, 1024), False, None),      # w_down
        ((4, 1024, 50257), False, None),     # LM head (ragged R)
        ((64, 1024, 4096), False, "lut"),    # w_up over a 64-token chunk
        ((3, 1001, 777), True, None),        # ragged C, scalar path
    ]
    for (M, C, R), has_bias, act in gemv_cases:
        x32, w32 = randn(M, C, std=0.5), randn(R, C, std=C ** -0.5)
        b32 = randn(R, std=0.5) if has_bias else None
        kw = dict(act_table=bank.gelu if act == "lut" else None,
                  act="gelu" if act == "gelu" else None)
        for dtype in (torch.float32, torch.bfloat16):
            x, w = x32.to(dtype), w32.to(dtype)
            b = b32.to(dtype) if b32 is not None else None
            got = gemv_pim.gemv_pim_float(x, w, b, **kw)
            torch.cuda.synchronize()
            want = gemv_pim.gemv_pim_plain(x, w, b, **kw)
            dname = str(dtype).split(".")[1]
            e = compare(torch, f"gemv {M}x{C}x{R} {act} {dname}", got, want, TOL[dname])
            errs["gemv_pim_float"] = max(errs["gemv_pim_float"], e)
            log(f"  gemv_pim_float M={M} C={C} R={R} bias={has_bias} act={act} "
                f"{dname}: max_abs_err {e:.3e} (tol {TOL[dname]})")

    gaps: dict[str, float] = {}     # LUT mode: gap from the dense plain version

    def check(name, label, got, dense, online, dname, lut):
        """Hold a kernel to its plain version, or in LUT mode to the online
        walk (recording its gap from the plain version); return the error."""
        if lut:
            e = compare(torch, label + " vs online walk", got, online, TOL[dname])
            key = f"{name} ({dname})"
            gaps[key] = max(gaps.get(key, 0.0), float((got.float() - dense.float()).abs().max()))
        else:
            e = compare(torch, label, got, dense, TOL[dname])
        errs[name] = max(errs[name], e)
        return e

    def walk_args(opts):
        return {k: v for k, v in opts.items() if k in ("exp_table", "softcap", "window")}

    # Paged decode: 4 slots, 16 heads, head_dim 64, page 16, mixed lengths,
    # on every pool format.
    B, H, D, page, n_tbl = 4, 16, 64, 16, 16
    P = 1 + B * n_tbl
    lens_list = [1, 77, 200, 256]
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    tables = perm.reshape(B, n_tbl).to(torch.int32)
    lengths = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    k32, v32, q32 = randn(P, H, page, D), randn(P, H, page, D), randn(B, H, D)
    decode_opts = [{}, {"exp_table": bank.exp}, {"window": 40, "softcap": 30.0}]
    for fmt in POOLS:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            q = q32.to(dtype)
            k, v, ks, vs = make_pools(torch, quantize, k32, v32, fmt, dtype)
            worst = 0.0
            for opts in decode_opts:
                lut = "exp_table" in opts
                got = paged_attention.paged_attention(q, k, v, tables, lengths, ks, vs, **opts)
                torch.cuda.synchronize()
                dense = paged_attention.paged_attention_plain(q, k, v, tables, lengths,
                                                              ks, vs, **opts)
                online = (paged_attention.paged_attention_online_plain(
                    q, k, v, tables, lengths, ks, vs, **walk_args(opts)) if lut else None)
                worst = max(worst, check("paged_attention", f"paged decode {fmt} "
                                         f"{sorted(opts)} {dname}", got, dense, online,
                                         dname, lut))
            log(f"  paged_attention B={B} H={H} D={D} page={page} lengths={lens_list} "
                f"{fmt} pools, q {dname}, exact/LUT/window+softcap: max_abs_err "
                f"{worst:.3e} (tol {TOL[dname]})")

    # Paged prefill: one 64-token chunk, at the prompt start and one chunk in.
    Sq = 64
    pf_tables = tables[:1].contiguous()
    qp32 = randn(1, Sq, H, D)
    for fmt in POOLS:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            q = qp32.to(dtype)
            k, v, ks, vs = make_pools(torch, quantize, k32, v32, fmt, dtype)
            worst = 0.0
            for start in (0, 64):
                st = torch.tensor([start], dtype=torch.int32, device=dev)
                ln = st + Sq
                for opts in ({}, {"exp_table": bank.exp}):
                    lut = bool(opts)
                    got = paged_prefill.paged_prefill_attention(q, k, v, pf_tables, ln, st,
                                                                ks, vs, **opts)
                    torch.cuda.synchronize()
                    dense = paged_prefill.paged_prefill_attention_plain(
                        q, k, v, pf_tables, ln, st, ks, vs, **opts)
                    online = (paged_prefill.paged_prefill_attention_online_plain(
                        q, k, v, pf_tables, ln, st, ks, vs, **opts) if lut else None)
                    worst = max(worst, check("paged_prefill_attention",
                                             f"paged prefill {fmt} start={start} "
                                             f"{sorted(opts)} {dname}", got, dense, online,
                                             dname, lut))
            log(f"  paged_prefill_attention B=1 Sq={Sq} start 0/64 {fmt} pools, q {dname}, "
                f"exact/LUT: max_abs_err {worst:.3e} (tol {TOL[dname]})")

    # KV-split decode on a 1024-token table (64 pages of 16): K = 2, 4 and
    # 7 (trash-padded to 70 pages), against the plain split (the online
    # walk over K runs in LUT mode), the unsplit kernel on the same pools
    # (exact mode; in LUT mode the two walks are different functions and
    # their gap is printed), and the combine against its plain twin.
    n_tbl = 64
    P = 1 + B * n_tbl
    tables = ((torch.randperm(P - 1, generator=gen, device=dev) + 1)
              .reshape(B, n_tbl).to(torch.int32))
    lens_list = [0, 333, 777, 1024]
    lengths = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    k32, v32 = randn(P, H, page, D), randn(P, H, page, D)
    for fmt in POOLS:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            q = q32.to(dtype)
            k, v, ks, vs = make_pools(torch, quantize, k32, v32, fmt, dtype)
            worst = 0.0
            for opts in ({}, {"exp_table": bank.exp}, {"window": 300, "softcap": 30.0},
                         {"exp_table": bank.exp, "window": 300, "softcap": 30.0}):
                lut = "exp_table" in opts
                unsplit = paged_attention.paged_attention(q, k, v, tables, lengths, ks, vs,
                                                          **opts)
                for splits in (2, 4, 7, 16):
                    m, l, acc = paged_attention.paged_attention_split(
                        q, k, v, tables, lengths, ks, vs, kv_splits=splits, **opts)
                    got = paged_attention.merge_partials(m, l, acc, dtype)
                    routed = paged_attention.paged_attention(
                        q, k, v, tables, lengths, ks, vs, kv_splits=splits, **opts)
                    torch.cuda.synchronize()
                    name = f"split K={splits} {fmt} {sorted(opts)} {dname}"
                    dense = paged_attention.paged_attention_split_plain(
                        q, k, v, tables, lengths, ks, vs, kv_splits=splits, **opts)
                    online = (paged_attention.paged_attention_online_plain(
                        q, k, v, tables, lengths, ks, vs, splits=splits, **walk_args(opts))
                        if lut else None)
                    e = check("paged_attention_split", name, got, dense, online, dname, lut)
                    if not torch.equal(routed, got):
                        raise AssertionError(f"{name}: paged_attention(kv_splits={splits}) "
                                             f"differs from the split kernel + merge_partials")
                    if lut:
                        key = f"split vs unsplit ({dname})"
                        gaps[key] = max(gaps.get(key, 0.0),
                                        float((got.float() - unsplit.float()).abs().max()))
                    else:
                        e = max(e, compare(torch, name + " vs unsplit", got, unsplit,
                                           TOL[dname]))
                    merged = collectives.merge_partial_softmax_stacked(m, l, acc, axis=2)
                    e_m = compare(torch, name + " combine", got,
                                  merged.reshape(got.shape).to(dtype), TOL[dname])
                    errs["merge_partials"] = max(errs["merge_partials"], e_m)
                    if not torch.equal(got, paged_attention.merge_partials_plain(m, l, acc,
                                                                                 dtype)):
                        raise AssertionError(f"{name}: merge_partials differs from "
                                             "merge_partials_plain")
                    worst = max(worst, e)
            log(f"  paged_attention_split + merge_partials (also through "
                f"paged_attention(kv_splits=K), the same bits), B={B} H={H} D={D} 64 "
                f"pages lengths={lens_list} K=2/4/7/16 {fmt} pools, q {dname}, exact/LUT "
                f"x window+softcap, vs plain (and vs unsplit, exact): max_abs_err "
                f"{worst:.3e} (tol {TOL[dname]})")
    log(f"  merge_partials (launched to overlap the split kernel's tail) on the kernel's "
        f"partials: bit-exact to merge_partials_plain (split order); vs "
        f"merge_partial_softmax_stacked max_abs_err {errs['merge_partials']:.3e}")
    # The route in a CUDA graph: the programmatic edge between the split
    # kernel and the combine survives capture.
    q = q32.to(torch.bfloat16)
    k, v, ks, vs = make_pools(torch, quantize, k32, v32, "fp", torch.bfloat16)
    want = paged_attention.paged_attention(q, k, v, tables, lengths, ks, vs, kv_splits=4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_attention.paged_attention(q, k, v, tables, lengths, ks, vs, kv_splits=4)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = paged_attention.paged_attention(q, k, v, tables, lengths, ks, vs, kv_splits=4)
    for _ in range(3):
        got.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("paged_attention(kv_splits=4) replayed in a CUDA graph differs "
                                 "from the eager call")
    del graph
    log("  paged_attention(kv_splits=4) (split kernel + merge_partials on a programmatic "
        "edge) captured in a CUDA graph: 3 replays bit-exact to the eager call")
    log("  LUT mode, online page walk vs the dense LUT plain versions (the TPU "
        "kernels' algebra, not a kernel error; the JAX package bounds it by 3e-3 at "
        "<= 23 keys): max gap " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    return errs


def check_gemv_grid(torch, tlut, gemv_pim, seed):
    """The float GEMV over the path's widths and their ragged edges: M in
    {1, 4, 8, 9, 20, 64, 65, 512} (20: a speculative verify pass, 4 slots x
    5 tokens) x R in {1000, 1024, 4096, 50257} x C in {1024, 4096}, no
    activation, LUT and GELU, with and without bias, bf16 (the tensor-core
    kernel, which the wrapper's counter must show) and f32 (the CUDA-core
    kernel), each against the plain version at TOL; then the RoPE models'
    linears at M 1, 4, 20 and 64."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    bank = tlut.LutBank.create(64)
    fn = gemv_pim.gemv_pim_float
    worst = {"bfloat16": 0.0, "float32": 0.0}
    routes = {"bfloat16": set(), "float32": set()}
    calls = 0
    for C in (1024, 4096):
        for R in (1000, 1024, 4096, 50257):
            w32 = torch.randn((R, C), generator=gen, device=dev) * C ** -0.5
            b32 = torch.randn((R,), generator=gen, device=dev) * 0.5
            for M in (1, 4, 8, 9, 20, 64, 65, 512):
                x32 = torch.randn((M, C), generator=gen, device=dev) * 0.5
                for dtype in (torch.bfloat16, torch.float32):
                    dname = str(dtype).split(".")[1]
                    x, w, b = x32.to(dtype), w32.to(dtype), b32.to(dtype)
                    for act in (None, "lut", "gelu"):
                        kw = dict(act_table=bank.gelu if act == "lut" else None,
                                  act="gelu" if act == "gelu" else None)
                        for bias in (None, b):
                            tc = fn.tc_launches
                            got = fn(x, w, bias, **kw)
                            torch.cuda.synchronize()
                            route = "tensor cores" if fn.tc_launches > tc else "CUDA cores"
                            if route != ("tensor cores" if dtype == torch.bfloat16
                                         else "CUDA cores"):
                                raise AssertionError(f"gemv {M}x{C}x{R} {dname} ran on {route}")
                            routes[dname].add(route)
                            want = gemv_pim.gemv_pim_plain(x, w, bias, **kw)
                            e = compare(torch, f"gemv {M}x{C}x{R} {act} bias="
                                        f"{bias is not None} {dname}", got, want, TOL[dname])
                            worst[dname] = max(worst[dname], e)
                            calls += 1
            del w32
    for dname, e in worst.items():
        log(f"  gemv_pim_float grid ({calls // 2} shapes x options) {dname}, on the "
            f"{'/'.join(sorted(routes[dname]))} (the wrapper's route): max_abs_err {e:.3e} "
            f"(tol {TOL[dname]})")
    # The RoPE models' linears in bf16 at decode (M 1, 4), verify (M 20)
    # and chunk (M 64) widths, up to nemotron-4-340B's 256000 x 18432 LM
    # head.
    model_worst, model_calls = 0.0, 0
    for R, C in MODEL_GEMV_SHAPES:
        w = (torch.randn((R, C), generator=gen, device=dev) * C ** -0.5).bfloat16()
        b = (torch.randn((R,), generator=gen, device=dev) * 0.5).bfloat16()
        for M in (1, 4, 20, 64):
            x = (torch.randn((M, C), generator=gen, device=dev) * 0.5).bfloat16()
            for act in (None, "lut", "gelu"):
                kw = dict(act_table=bank.gelu if act == "lut" else None,
                          act="gelu" if act == "gelu" else None)
                for bias in (None, b):
                    tc = fn.tc_launches
                    got = fn(x, w, bias, **kw)
                    torch.cuda.synchronize()
                    if fn.tc_launches != tc + 1:
                        raise AssertionError(f"gemv {M}x{C}x{R} bf16 ran on the CUDA cores")
                    want = gemv_pim.gemv_pim_plain(x, w, bias, **kw)
                    model_worst = max(model_worst, compare(
                        torch, f"gemv {M}x{C}x{R} {act} bias={bias is not None} bf16", got,
                        want, TOL["bfloat16"]))
                    model_calls += 1
                    del want
        del w, b
    log(f"  gemv_pim_float over the RoPE models' linears ({len(MODEL_GEMV_SHAPES)} (R, C) "
        f"shapes, R up to 256000, C up to 73728, x M 1/4/20/64 x 6 epilogues = {model_calls} "
        f"launches), bf16, all on the tensor cores: max_abs_err "
        f"{model_worst:.3e} (tol {TOL['bfloat16']})")
    return max(max(worst.values()), model_worst)


def check_decode_grid(torch, tlut, quantize, paged_attention, seed):
    """The single-walk decode kernel over a 64-page table (page 16, D 64)
    at lengths {1, 15, 16, 17, 200, 960, 1024}, g in {1, 2} (16 query
    heads over 16 or 8 kv heads), on every pool format, exact and LUT, with
    and without window 300 and softcap 30: exact mode against the plain
    version, LUT mode against the page-ordered walk it computes
    (`paged_attention_online_plain`), both at TOL."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    bank = tlut.LutBank.create(64)
    lens_list = [1, 15, 16, 17, 200, 960, 1024]
    B, H, D, page, n_tbl = len(lens_list), 16, 64, 16, 64
    P = 1 + B * n_tbl
    tables = ((torch.randperm(P - 1, generator=gen, device=dev) + 1)
              .reshape(B, n_tbl).to(torch.int32))
    lengths = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    worst = 0.0
    opts_list = [{}, {"exp_table": bank.exp}, {"window": 300, "softcap": 30.0},
                 {"exp_table": bank.exp, "window": 300, "softcap": 30.0}]
    for Hkv in (16, 8):
        k32 = torch.randn((P, Hkv, page, D), generator=gen, device=dev)
        v32 = torch.randn((P, Hkv, page, D), generator=gen, device=dev)
        q32 = torch.randn((B, H, D), generator=gen, device=dev)
        for fmt in POOLS:
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).split(".")[1]
                q = q32.to(dtype)
                k, v, ks, vs = make_pools(torch, quantize, k32, v32, fmt, dtype)
                for opts in opts_list:
                    got = paged_attention.paged_attention(q, k, v, tables, lengths, ks, vs,
                                                          **opts)
                    torch.cuda.synchronize()
                    walk = "exp_table" in opts
                    plain = (paged_attention.paged_attention_online_plain if walk
                             else paged_attention.paged_attention_plain)
                    want = plain(q, k, v, tables, lengths, ks, vs, **opts)
                    worst = max(worst, compare(
                        torch, f"paged decode g={H // Hkv} {fmt} {sorted(opts)} {dname}",
                        got, want, TOL[dname]))
    log(f"  paged_attention (new single walk) lengths {lens_list}, 64-page table, g 1 and "
        f"2, every pool format, f32 and bf16, exact (vs plain) and LUT (vs the page walk) "
        f"x window 300 + softcap 30: max_abs_err {worst:.3e} (tol 1e-4 f32, 3e-2 bf16)")
    # The RoPE models' heads, bf16 on planted keys, past the 4096-token
    # window of gemma2-2B and h2o-danube3-4B.
    for model, g, D, mopts in MODEL_HEADS:
        lens = [4700, 1500, 1]
        q, k32, v32, tables, lengths = wide_decode_case(torch, gen, 3, 2 * g, 2, D, 300, lens,
                                                        hot=8)
        cs, win = paged_attention.decode_plan(3, 2, 300, g, D, 16, 2 * D)
        m_worst = 0.0
        for fmt in POOLS:
            k, v, ks, vs = make_pools(torch, quantize, k32, v32, fmt, torch.bfloat16)
            for opts in (dict(mopts), dict(mopts, exp_table=bank.exp)):
                got = paged_attention.paged_attention(q, k, v, tables, lengths, ks, vs, **opts)
                torch.cuda.synchronize()
                walk = "exp_table" in opts
                plain = (paged_attention.paged_attention_online_plain if walk
                         else paged_attention.paged_attention_plain)
                want = plain(q, k, v, tables, lengths, ks, vs, **opts)
                label = f"paged decode {model} g={g} D={D} {fmt} {sorted(opts)}"
                if float(want.float().abs().amax()) <= 0.5:
                    raise AssertionError(f"{label}: the planted keys did not dominate")
                m_worst = max(m_worst, compare(torch, label, got, want, TOL["bfloat16"]))
        log(f"  paged_attention at {model}'s heads (g {g}, D {D}, {mopts or 'no options'}), "
            f"2 kv heads, lengths {lens} (cluster {cs}, runs of {win} pages), every pool "
            f"format, bf16, planted keys, exact (vs plain) and LUT (vs the page walk): "
            f"max_abs_err {m_worst:.3e} (tol {TOL['bfloat16']})")
        worst = max(worst, m_worst)
        del q, k32, v32, k, v, ks, vs
    return worst


def time_kernels(torch, F, params, cfg, gemv_pim, paged_attention, paged_prefill, seed):
    """Times at the main path's shapes in bf16, beside the plain versions and
    the matching PyTorch call. Inputs rotate over one set per layer, so a
    launch finds its weights or pools cold in L2 as in a decode step."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    out = {}
    L = cfg.n_layers
    bl = params["blocks"]

    # GEMV: the 145 launches of one decode step at 4 slots, real weights.
    x_d = (torch.randn((4, cfg.d_model), generator=gen, device=dev) * 0.5).to(cfg.cdtype)
    x_f = (torch.randn((4, cfg.d_ff), generator=gen, device=dev) * 0.5).to(cfg.cdtype)
    step = []
    for i in range(L):
        a = bl["attn"]
        step += [(x_d, a["wq"][i], a["bq"][i], None), (x_d, a["wk"][i], a["bk"][i], None),
                 (x_d, a["wv"][i], a["bv"][i], None), (x_d, a["wo"][i], None, None),
                 (x_d, bl["ffn"]["w_up"][i], None, "gelu"),
                 (x_f, bl["ffn"]["w_down"][i], None, None)]
    step.append((x_d, params["lm_head"], None, None))
    nbytes = flops = 0
    for x, w, b, _ in step:
        M, C = x.shape
        R = w.shape[0]
        nbytes += 2 * (M * C + R * C + (R if b is not None else 0) + M * R)
        flops += 2 * M * R * C

    def run(fn):
        return lambda i: fn(*step[i])

    ms = time_graph(torch, run(lambda x, w, b, act: gemv_pim.gemv_pim_float(x, w, b, act=act)),
                    len(step)) * len(step)
    plain = time_graph(torch, run(lambda x, w, b, act: gemv_pim.gemv_pim_plain(x, w, b, act=act)),
                       len(step)) * len(step)
    lib = time_graph(torch, run(lambda x, w, b, act: F.linear(x, w, b)), len(step)) * len(step)
    bnd, by = bound_ms(nbytes, flops, "bfloat16")
    out["gemv_pim_float"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                                 bound_by=by, shape="one decode step: 145 launches, M=4")
    # Per-shape times, cold weights (one set per layer).
    for (C, R, key, act) in [(cfg.d_model, cfg.d_model, "wq", None),
                             (cfg.d_model, cfg.d_ff, "w_up", "gelu"),
                             (cfg.d_ff, cfg.d_model, "w_down", None)]:
        ws = bl["attn"][key] if key == "wq" else bl["ffn"][key]
        xx = x_d if C == cfg.d_model else x_f
        t = time_graph(torch, lambda i: gemv_pim.gemv_pim_float(xx, ws[i], act=act), L)
        tl = time_graph(torch, lambda i: F.linear(xx, ws[i]), L)
        b1, _ = bound_ms(2 * (4 * C + R * C + 4 * R), 2 * 4 * R * C, "bfloat16")
        log(f"  gemv_pim_float M=4 C={C} R={R} act={act} bf16: {t * 1e3:.2f} us "
            f"(bound {b1 * 1e3:.2f} us, F.linear {tl * 1e3:.2f} us)")
    t = time_graph(torch, lambda i: gemv_pim.gemv_pim_float(x_d, params["lm_head"]), 4)
    tl = time_graph(torch, lambda i: F.linear(x_d, params["lm_head"]), 4)
    d, f = cfg.d_model, cfg.d_ff
    b1, _ = bound_ms(2 * (4 * d + cfg.vocab * d + 4 * cfg.vocab), 2 * 4 * cfg.vocab * d,
                     "bfloat16")
    log(f"  gemv_pim_float M=4 C={cfg.d_model} R={cfg.vocab} (LM head) bf16: "
        f"{t * 1e3:.2f} us (bound {b1 * 1e3:.2f} us, F.linear {tl * 1e3:.2f} us)")
    x64 = (torch.randn((64, cfg.d_model), generator=gen, device=dev) * 0.5).to(cfg.cdtype)
    t = time_graph(torch, lambda i: gemv_pim.gemv_pim_float(
        x64, bl["ffn"]["w_up"][i], act="gelu"), L)
    tl = time_graph(torch, lambda i: F.linear(x64, bl["ffn"]["w_up"][i]), L)
    b1, by1 = bound_ms(2 * (64 * d + f * d + 64 * f), 2 * 64 * f * d, "bfloat16")
    log(f"  gemv_pim_float M=64 C={d} R={f} act=gelu bf16: {t * 1e3:.2f} us "
        f"(bound {b1 * 1e3:.2f} us by {by1}, F.linear {tl * 1e3:.2f} us)")
    # generate()'s prefill of 4 x 128 tokens: M=512 on d x d, w_up and w_down.
    for (C, R, key, act) in [(d, d, "wq", None), (d, f, "w_up", "gelu"), (f, d, "w_down", None)]:
        ws = bl["attn"][key] if key == "wq" else bl["ffn"][key]
        x512 = (torch.randn((512, C), generator=gen, device=dev) * 0.5).to(cfg.cdtype)
        t = time_graph(torch, lambda i: gemv_pim.gemv_pim_float(x512, ws[i], act=act), L)
        tl = time_graph(torch, lambda i: F.linear(x512, ws[i]), L)
        b1, by1 = bound_ms(2 * (512 * C + R * C + 512 * R), 2 * 512 * R * C, "bfloat16")
        log(f"  gemv_pim_float M=512 C={C} R={R} act={act} bf16: {t * 1e3:.2f} us "
            f"(bound {b1 * 1e3:.2f} us by {by1}, F.linear {tl * 1e3:.2f} us)")
    # The 145 GEMVs of one 64-token prefill chunk: 144 at M=64, the LM head
    # at M=1 (the chunk's last position).
    x_cf = (torch.randn((64, f), generator=gen, device=dev) * 0.5).to(cfg.cdtype)
    chunk = [(x64 if x is x_d else x_cf, w, b, act) for x, w, b, act in step[:-1]]
    chunk.append((x_d[:1], params["lm_head"], None, None))
    c_bytes = c_flops = 0
    for x, w, b, _ in chunk:
        M, C = x.shape
        R = w.shape[0]
        c_bytes += 2 * (M * C + R * C + (R if b is not None else 0) + M * R)
        c_flops += 2 * M * R * C

    def run_chunk(fn):
        return lambda i: fn(*chunk[i])

    n = len(chunk)
    t = time_graph(torch, run_chunk(lambda x, w, b, act: gemv_pim.gemv_pim_float(
        x, w, b, act=act)), n) * n
    tp = time_graph(torch, run_chunk(lambda x, w, b, act: gemv_pim.gemv_pim_plain(
        x, w, b, act=act)), n) * n
    tl = time_graph(torch, run_chunk(lambda x, w, b, act: F.linear(x, w, b)), n) * n
    b1, by1 = bound_ms(c_bytes, c_flops, "bfloat16")
    log(f"  gemv_pim_float, one 64-token chunk's {n} launches (144 at M=64, LM head at "
        f"M=1) bf16: {t:.3f} ms (bound {b1:.3f} ms by {by1}, plain {tp:.3f} ms, F.linear "
        f"{tl:.3f} ms)")
    out["gemv_chunk"] = dict(ms=t, plain_ms=tp, library_ms=tl, bound_ms=b1)

    # Paged decode at 4 slots with mixed lengths, one pool per layer.
    H, D, page, n_tbl, B = cfg.n_heads, cfg.head_dim, 16, 16, 4
    P = 1 + B * n_tbl
    tables = (torch.randperm(P - 1, generator=gen, device=dev) + 1).reshape(B, n_tbl)
    tables = tables.to(torch.int32).contiguous()
    lens_list = [64, 128, 200, 256]
    lengths = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    pools = [(torch.randn((P, H, page, D), generator=gen, device=dev).to(cfg.cdtype),
              torch.randn((P, H, page, D), generator=gen, device=dev).to(cfg.cdtype))
             for _ in range(L)]
    q = torch.randn((B, H, D), generator=gen, device=dev).to(cfg.cdtype)
    ms = time_graph(torch, lambda i: paged_attention.paged_attention(
        q, *pools[i], tables, lengths), L)
    plain = time_graph(torch, lambda i: paged_attention.paged_attention_plain(
        q, *pools[i], tables, lengths), L)
    # Yardstick: SDPA over the same keys gathered dense beforehand (the
    # gather is not timed), with the length mask.
    dense = [(paged_attention.gather_paged_kv(k, tables),
              paged_attention.gather_paged_kv(v, tables)) for k, v in pools]
    key_ok = torch.arange(n_tbl * page, device=dev)[None, :] < lengths[:, None].long()

    def sdpa_decode(i):
        return F.scaled_dot_product_attention(q[:, :, None], *dense[i],
                                              attn_mask=key_ok[:, None, None])[:, :, 0]

    compare(torch, "sdpa decode yardstick", sdpa_decode(0),
            paged_attention.paged_attention_plain(q, *pools[0], tables, lengths), TOL["bfloat16"])
    lib = time_graph(torch, sdpa_decode, L)
    kv = sum(lens_list) * H * D * 2 * 2
    nbytes = kv + 2 * (2 * B * H * D) + 4 * (tables.numel() + B)
    bnd, by = bound_ms(nbytes, sum(lens_list) * H * D * 4, "bfloat16")
    out["paged_attention"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                                  bound_by=by, shape=f"B=4 H=16 D=64 page 16 lengths {lens_list}")

    # Paged prefill: one 64-token chunk at start 64 (128 keys), per layer.
    Sq, start = 64, 64
    qp = torch.randn((1, Sq, H, D), generator=gen, device=dev).to(cfg.cdtype)
    st = torch.tensor([start], dtype=torch.int32, device=dev)
    ln = st + Sq
    t1 = tables[:1].contiguous()
    ms = time_graph(torch, lambda i: paged_prefill.paged_prefill_attention(
        qp, *pools[i], t1, ln, st), L)
    plain = time_graph(torch, lambda i: paged_prefill.paged_prefill_attention_plain(
        qp, *pools[i], t1, ln, st), L)
    n_keys = start + Sq
    dense = [(k[:1, :, :n_keys], v[:1, :, :n_keys]) for k, v in dense]
    causal = (torch.arange(n_keys, device=dev)[None, :]
              <= start + torch.arange(Sq, device=dev)[:, None])
    qh = qp.transpose(1, 2)

    def sdpa_prefill(i):
        return F.scaled_dot_product_attention(qh, *dense[i], attn_mask=causal).transpose(1, 2)

    compare(torch, "sdpa prefill yardstick", sdpa_prefill(0),
            paged_prefill.paged_prefill_attention_plain(qp, *pools[0], t1, ln, st),
            TOL["bfloat16"])
    lib = time_graph(torch, sdpa_prefill, L)
    keys = sum(start + r + 1 for r in range(Sq))
    nbytes = n_keys * H * D * 2 * 2 + 2 * (2 * Sq * H * D) + 4 * (t1.numel() + 2)
    bnd, by = bound_ms(nbytes, keys * H * D * 4, "bfloat16")
    # The same chunk at start 896 (960 keys) of a 64-page table, per layer.
    start9 = 896
    t64 = (torch.randperm(64, generator=gen, device=dev) + 1)[None].to(torch.int32)
    pools64 = [(torch.randn((65, H, page, D), generator=gen, device=dev).to(cfg.cdtype),
                torch.randn((65, H, page, D), generator=gen, device=dev).to(cfg.cdtype))
               for _ in range(L)]
    st9 = torch.tensor([start9], dtype=torch.int32, device=dev)
    ln9 = st9 + Sq
    ms9 = time_graph(torch, lambda i: paged_prefill.paged_prefill_attention(
        qp, *pools64[i], t64, ln9, st9), L)
    plain9 = time_graph(torch, lambda i: paged_prefill.paged_prefill_attention_plain(
        qp, *pools64[i], t64, ln9, st9), L)
    n9 = start9 + Sq
    dense9 = [(paged_attention.gather_paged_kv(k, t64)[:, :, :n9],
               paged_attention.gather_paged_kv(v, t64)[:, :, :n9]) for k, v in pools64]
    causal9 = (torch.arange(n9, device=dev)[None, :]
               <= start9 + torch.arange(Sq, device=dev)[:, None])

    def sdpa_prefill9(i):
        return F.scaled_dot_product_attention(qh, *dense9[i], attn_mask=causal9).transpose(1, 2)

    compare(torch, "sdpa prefill yardstick at 896", sdpa_prefill9(0),
            paged_prefill.paged_prefill_attention_plain(qp, *pools64[0], t64, ln9, st9),
            TOL["bfloat16"])
    lib9 = time_graph(torch, sdpa_prefill9, L)
    bnd9, by9 = bound_ms(n9 * H * D * 2 * 2 + 2 * (2 * Sq * H * D) + 4 * (t64.numel() + 2),
                         sum(start9 + r + 1 for r in range(Sq)) * H * D * 4, "bfloat16")
    log(f"  paged_prefill_attention B=1 Sq=64 start=896 (960 keys) bf16: {ms9 * 1e3:.2f} us, "
        f"plain {plain9 * 1e3:.2f} us, SDPA on pre-gathered K/V {lib9 * 1e3:.2f} us, bound "
        f"{bnd9 * 1e3:.2f} us ({by9})")
    out["paged_prefill_attention"] = dict(
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
        shape=f"B=1 Sq=64 start=64 H=16 D=64 page 16; start 896: {ms9 * 1e3:.2f} us, plain "
              f"{plain9 * 1e3:.2f} us, SDPA {lib9 * 1e3:.2f} us, bound {bnd9 * 1e3:.2f} us")
    for name, r in out.items():
        if "shape" not in r:
            continue
        lib = "none" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f} us"
        log(f"  {name} [{r['shape']}]: {r['ms'] * 1e3:.2f} us, plain "
            f"{r['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
    return out


def time_model_kernels(torch, F, gemv_pim, paged_attention, paged_prefill, seed):
    """Times at the RoPE models' shapes in bf16, beside the plain versions,
    the matching PyTorch call and the bound: the 197 GEMVs of a
    qwen2-1.5B decode step (M=4, seeded random weights of its shapes, one
    set per layer, so every launch finds its weight cold in L2) and per
    shape; the paged decode at 4 slots x 128..160 keys and the 64-token
    chunk at start 64 at each model's heads (g x head_dim, 2 kv heads),
    one pool per layer; SDPA on K/V gathered beforehand (GQA) as the
    library yardstick."""
    from repro_torch.configs import get_config
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    out = {}
    cfg = get_config("qwen2_1_5b")
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    q_n, kv_n = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim

    def randw(R, C):
        return (torch.randn((R, C), generator=gen, device=dev) * C ** -0.5).bfloat16()

    x_d = (torch.randn((4, d), generator=gen, device=dev) * 0.5).bfloat16()
    x_f = (torch.randn((4, f), generator=gen, device=dev) * 0.5).bfloat16()
    bias = {n: (torch.randn((n,), generator=gen, device=dev) * 0.5).bfloat16()
            for n in (q_n, kv_n)}
    step = []
    for _ in range(L):
        step += [(x_d, randw(q_n, d), bias[q_n]), (x_d, randw(kv_n, d), bias[kv_n]),
                 (x_d, randw(kv_n, d), bias[kv_n]), (x_d, randw(d, q_n), None),
                 (x_d, randw(f, d), None), (x_d, randw(f, d), None), (x_f, randw(d, f), None)]
    step.append((x_d, randw(cfg.vocab, d), None))
    nbytes = sum(2 * (x.shape[0] * x.shape[1] + w.numel() + (0 if b is None else b.numel())
                      + x.shape[0] * w.shape[0]) for x, w, b in step)
    flops = sum(2 * x.shape[0] * w.numel() for x, w, _ in step)
    n = len(step)
    ms = time_graph(torch, lambda i: gemv_pim.gemv_pim_float(*step[i]), n) * n
    plain = time_graph(torch, lambda i: gemv_pim.gemv_pim_plain(*step[i]), n) * n
    lib = time_graph(torch, lambda i: F.linear(*step[i]), n) * n
    bnd, by = bound_ms(nbytes, flops, "bfloat16")
    log(f"  gemv_pim_float, a qwen2-1.5B decode step's {n} launches (M=4, bf16, cold "
        f"weights): {ms:.3f} ms, plain {plain:.3f} ms, F.linear {lib:.3f} ms, bound "
        f"{bnd:.3f} ms ({by})")
    out["gemv_pim_float"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                                 bound_by=by, shape=f"qwen2-1.5B decode step: {n} launches, M=4")
    for label, k in (("q", 0), ("k", 1), ("w_gate", 4), ("w_down", 6)):
        ws = [step[7 * i + k] for i in range(L)]
        t = time_graph(torch, lambda i: gemv_pim.gemv_pim_float(*ws[i]), L)
        tl = time_graph(torch, lambda i: F.linear(*ws[i]), L)
        x, w, _ = ws[0]
        b1, _ = bound_ms(2 * (x.numel() + w.numel() + 4 * w.shape[0]), 2 * 4 * w.numel(),
                         "bfloat16")
        log(f"  gemv_pim_float qwen2 {label} M=4 C={w.shape[1]} R={w.shape[0]} bf16: "
            f"{t * 1e3:.2f} us (bound {b1 * 1e3:.2f} us, F.linear {tl * 1e3:.2f} us)")
    head = step[-1]
    t = time_graph(torch, lambda i: gemv_pim.gemv_pim_float(*head), 4)
    tl = time_graph(torch, lambda i: F.linear(*head), 4)
    b1, _ = bound_ms(2 * (4 * d + head[1].numel() + 4 * cfg.vocab), 8 * head[1].numel(),
                     "bfloat16")
    log(f"  gemv_pim_float qwen2 LM head M=4 C={d} R={cfg.vocab} bf16: {t * 1e3:.2f} us "
        f"(bound {b1 * 1e3:.2f} us, F.linear {tl * 1e3:.2f} us)")
    # q1's wide linears of a decode step (f32 weight scales, x quantized in
    # f32): one launch each (w_down's share of x past the 4 pieces a thread
    # holds in registers), against quantize_int8_rows + gemv_pim_int8.
    f32 = torch.float32
    for label, idx in (("w_gate", [7 * i + 4 for i in range(L)]),
                       ("w_down", [7 * i + 6 for i in range(L)]), ("LM head", [n - 1])):
        qs = [(step[i][0], *gemv_pim.quantize_int8_rows_plain(step[i][1].float()), step[i][2])
              for i in idx]
        x, w8 = qs[0][0], qs[0][1]
        if gemv_pim.gemv_int8_linear_plan(*x.shape, w8.shape[0]) is None:
            raise AssertionError(f"qwen2 q1 {label}: not one launch at M=4")
        one = time_graph(torch, lambda i: gemv_pim.gemv_pim_int8_linear(*qs[i], compute=f32),
                         len(qs))
        two = time_graph(torch, lambda i: gemv_pim.gemv_pim_int8(
            *gemv_pim.quantize_int8_rows(qs[i][0], compute=f32), *qs[i][1:], out_dtype=x.dtype),
            len(qs))
        b1, _ = bound_ms(w8.numel() + 4 * w8.shape[0] + 2 * x.numel() + 8 * w8.shape[0],
                         2 * 4 * w8.numel(), "int8")
        log(f"  gemv_pim_int8_linear qwen2 q1 {label} M=4 C={x.shape[1]} R={w8.shape[0]}: "
            f"{one * 1e3:.2f} us in one launch, {two * 1e3:.2f} us as quantize_int8_rows + "
            f"gemv_pim_int8 (bound {b1 * 1e3:.2f} us)")
        del qs
    del step, head

    # RoPE in a decode step: cos/sin once over the 4 slots' lengths, then q
    # (12 heads) and k (2) rotated in each of the 28 layers, eager PyTorch.
    from repro_torch.models.rope import apply_rope, rope_cos_sin
    pos = torch.tensor([128, 137, 151, 160], dtype=torch.int32, device=dev)
    qd = torch.randn((4, cfg.n_heads, cfg.head_dim), generator=gen, device=dev).bfloat16()
    kd = torch.randn((4, cfg.n_kv_heads, cfg.head_dim), generator=gen, device=dev).bfloat16()

    def rope_step(_=0):
        cos, sin = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)
        for _ in range(L):
            apply_rope(qd[:, None], cos[:, None], sin[:, None])[:, 0]
            apply_rope(kd[:, None], cos[:, None], sin[:, None])[:, 0]

    n_ops = sum(eager_ops(torch, rope_step).values())
    t = time_graph(torch, rope_step, 1)
    log(f"  RoPE of a qwen2-1.5B decode step (cos/sin once, q and k in each of {L} layers): "
        f"{n_ops} PyTorch operations, {t:.3f} ms on the device as a CUDA graph")
    out["rope_step"] = dict(ops=n_ops, ms=t)

    # Attention at each model's heads: 4 slots x 128..160 keys (decode) and
    # a 64-token chunk at start 64 (prefill), 2 kv heads, page 16.
    B, page, n_tbl, Hkv = 4, 16, 16, 2
    P = 1 + B * n_tbl
    tables = ((torch.randperm(P - 1, generator=gen, device=dev) + 1)
              .reshape(B, n_tbl).to(torch.int32))
    lens_list = [128, 137, 151, 160]
    lengths = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    key_ok = torch.arange(n_tbl * page, device=dev)[None, :] < lengths[:, None].long()
    for model, g, D, opts in MODEL_HEADS:
        H = g * Hkv
        pools = [tuple(torch.randn((P, Hkv, page, D), generator=gen, device=dev).bfloat16()
                       for _ in range(2)) for _ in range(8)]
        q = torch.randn((B, H, D), generator=gen, device=dev).bfloat16()
        ms = time_graph(torch, lambda i: paged_attention.paged_attention(
            q, *pools[i], tables, lengths, **opts), 8)
        plain = time_graph(torch, lambda i: paged_attention.paged_attention_plain(
            q, *pools[i], tables, lengths, **opts), 8)
        dense = [tuple(paged_attention.gather_paged_kv(t, tables) for t in pl) for pl in pools]

        def sdpa_decode(i):
            return F.scaled_dot_product_attention(q[:, :, None], *dense[i], enable_gqa=True,
                                                  attn_mask=key_ok[:, None, None])[:, :, 0]

        if not opts:
            compare(torch, f"sdpa decode yardstick at {model}'s heads", sdpa_decode(0),
                    paged_attention.paged_attention_plain(q, *pools[0], tables, lengths),
                    TOL["bfloat16"])
        lib = time_graph(torch, sdpa_decode, 8)
        kv = sum(lens_list) * Hkv * D * 2 * 2
        bnd, by = bound_ms(kv + 2 * 2 * B * H * D + 4 * (tables.numel() + B),
                           sum(lens_list) * H * D * 4, "bfloat16")
        dec = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by)
        # The chunk: 64 queries at start 64 of slot 0's table.
        Sq, start = 64, 64
        qp = torch.randn((1, Sq, H, D), generator=gen, device=dev).bfloat16()
        st = torch.tensor([start], dtype=torch.int32, device=dev)
        ln, t1 = st + Sq, tables[:1].contiguous()
        pms = time_graph(torch, lambda i: paged_prefill.paged_prefill_attention(
            qp, *pools[i], t1, ln, st, **opts), 8)
        pplain = time_graph(torch, lambda i: paged_prefill.paged_prefill_attention_plain(
            qp, *pools[i], t1, ln, st, **opts), 8)
        n_keys = start + Sq
        causal = (torch.arange(n_keys, device=dev)[None, :]
                  <= start + torch.arange(Sq, device=dev)[:, None])
        dense1 = [tuple(t[:1, :, :n_keys] for t in dd) for dd in dense]
        qh = qp.transpose(1, 2)

        def sdpa_prefill(i):
            return F.scaled_dot_product_attention(qh, *dense1[i], attn_mask=causal,
                                                  enable_gqa=True).transpose(1, 2)

        plib = time_graph(torch, sdpa_prefill, 8)
        keys = sum(start + r + 1 for r in range(Sq))
        pbnd, pby = bound_ms(n_keys * Hkv * D * 2 * 2 + 2 * 2 * Sq * H * D + 4 * (n_tbl + 2),
                             keys * H * D * 4, "bfloat16")
        pre = dict(ms=pms, plain_ms=pplain, library_ms=plib, bound_ms=pbnd, bound_by=pby)
        log(f"  {model}'s heads (g {g}, D {D}, {opts or 'no options'}) bf16: paged_attention "
            f"4 x {lens_list} keys {ms * 1e3:.2f} us (plain {plain * 1e3:.2f}, SDPA "
            f"{lib * 1e3:.2f}, bound {bnd * 1e3:.2f} us {by}); paged_prefill_attention Sq 64 "
            f"at start 64 {pms * 1e3:.2f} us (plain {pplain * 1e3:.2f}, SDPA "
            f"{plib * 1e3:.2f}, bound {pbnd * 1e3:.2f} us {pby})")
        out[f"{model} heads"] = dict(decode=dec, prefill=pre)
        del pools, dense, dense1
    return out


def time_long_kernels(torch, F, cfg, quantize, collectives, paged_attention, seed):
    """Decode attention at long context: B=4, H=16, D=64, page 16, a
    64-page table, lengths 960..1024, one pool set per layer (cold in L2 as
    in a decode step). The single walk and the split at K = 4 and 8 (split
    kernel + combine) on every pool format beside the KV-bytes bound; on fp
    (bf16) pools also the split kernel alone, the combine alone, the plain
    split and SDPA on pre-gathered K/V."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    L, H, D, page, n_tbl, B = cfg.n_layers, cfg.n_heads, cfg.head_dim, 16, 64, 4
    P = 1 + B * n_tbl
    tables = ((torch.randperm(P - 1, generator=gen, device=dev) + 1)
              .reshape(B, n_tbl).to(torch.int32).contiguous())
    lens_list = [960, 981, 1003, 1024]
    lengths = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    q = torch.randn((B, H, D), generator=gen, device=dev).to(cfg.cdtype)
    raw = [(torch.randn((P, H, page, D), generator=gen, device=dev),
            torch.randn((P, H, page, D), generator=gen, device=dev)) for _ in range(L)]
    keys = sum(lens_list) * H
    fixed = 2 * (2 * B * H * D) + 4 * (tables.numel() + B)      # q, out, table, lengths
    out, rows = {}, []

    def kv_bound(fmt):
        kv, sd = POOLS[fmt]
        vec = paged_attention.kv_vector_bytes(D, kv, sd, payload_dtype=cfg.cdtype)
        return bound_ms(2 * keys * vec + fixed, 4 * keys * D, "bfloat16")

    for fmt in POOLS:
        pools = [make_pools(torch, quantize, k, v, fmt, cfg.cdtype) for k, v in raw]
        one = time_graph(torch, lambda i: paged_attention.paged_attention(
            q, pools[i][0], pools[i][1], tables, lengths, pools[i][2], pools[i][3]), L)
        split4, split8 = (time_graph(torch, lambda i, K=K: paged_attention.paged_attention(
            q, pools[i][0], pools[i][1], tables, lengths, pools[i][2], pools[i][3],
            kv_splits=K), L) for K in (4, 8))
        bnd, by = kv_bound(fmt)
        rows.append(f"{fmt}: single walk {one * 1e3:.2f} us, split K=4 {split4 * 1e3:.2f} us, "
                    f"K=8 {split8 * 1e3:.2f} us, bound {bnd * 1e3:.2f} us ({by})")
        if fmt != "fp":
            continue
        kernel4 = time_graph(torch, lambda i: paged_attention.paged_attention_split(
            q, *pools[i][:2], tables, lengths, kv_splits=4), L)
        parts = paged_attention.paged_attention_split(q, *pools[0][:2], tables, lengths,
                                                      kv_splits=4)
        merge = time_graph(torch, lambda i: paged_attention.merge_partials(*parts, q.dtype), L)
        merge_plain = time_graph(torch, lambda i: paged_attention.merge_partials_plain(
            *parts, q.dtype), L)
        merge_stacked = time_graph(torch, lambda i: collectives.merge_partial_softmax_stacked(
            *parts, axis=2), L)
        # The route with the combine launched after the split kernel has
        # finished (no programmatic edge), in the same harness.
        no_pdl = time_graph(torch, lambda i: paged_attention.merge_partials(
            *paged_attention.paged_attention_split(q, *pools[i][:2], tables, lengths,
                                                   kv_splits=4), q.dtype, pdl=False), L)
        plain = time_graph(torch, lambda i: paged_attention.paged_attention_split_plain(
            q, *pools[i][:2], tables, lengths, kv_splits=4), L)
        dense = [(paged_attention.gather_paged_kv(k, tables),
                  paged_attention.gather_paged_kv(v, tables)) for k, v, _, _ in pools]
        key_ok = (torch.arange(n_tbl * page, device=dev)[None, :]
                  < lengths[:, None].long())

        def sdpa(i):
            return F.scaled_dot_product_attention(q[:, :, None], *dense[i],
                                                  attn_mask=key_ok[:, None, None])[:, :, 0]

        compare(torch, "sdpa long-context yardstick", sdpa(0),
                paged_attention.paged_attention_plain(q, *pools[0][:2], tables, lengths),
                TOL["bfloat16"])
        lib = time_graph(torch, sdpa, L)
        part_bytes = 4 * B * H * 4 * (D + 2)                  # K=4 partials, f32
        m_bnd, m_by = bound_ms(part_bytes + 2 * B * H * D, 4 * 4 * B * H * D, "float32")
        shape = f"B=4 H=16 D=64 page 16, 64-page table, lengths {lens_list}, bf16"
        out["paged_attention_split"] = dict(
            ms=split4, plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
            shape=f"split K=4 + merge_partials (the route), {shape}; K=8 "
                  f"{split8 * 1e3:.2f} us; split kernel alone {kernel4 * 1e3:.2f} us")
        out["merge_partials"] = dict(
            ms=merge, plain_ms=merge_plain, library_ms=None, bound_ms=m_bnd, bound_by=m_by,
            route_ms=split4, route_no_pdl_ms=no_pdl,
            shape=f"K=4 partials of {shape}, launches back to back; the route (split K=4 + "
                  f"combine) {split4 * 1e3:.2f} us with the combine on a programmatic edge, "
                  f"{no_pdl * 1e3:.2f} us without; merge_partial_softmax_stacked "
                  f"{merge_stacked * 1e3:.2f} us")
        rows.append(f"fp: split kernel alone (K=4) "
                    f"{kernel4 * 1e3:.2f} us, combine {merge * 1e3:.2f} us (plain "
                    f"{merge_plain * 1e3:.2f} us, bound {m_bnd * 1e3:.2f} us); the route "
                    f"K=4 {split4 * 1e3:.2f} us with the combine's programmatic launch, "
                    f"{no_pdl * 1e3:.2f} us without; plain split "
                    f"{plain * 1e3:.2f} us; SDPA on pre-gathered K/V {lib * 1e3:.2f} us")
    for r in rows:
        log(f"  long-context decode attention [{lens_list}]: {r}")
    out["wide"] = time_wide_decode(torch, F, paged_attention, seed)
    return out


def time_wide_decode(torch, F, paged_attention, seed):
    """The single walk at qwen2-1.5B's widths, B=1, 12 query heads over 2
    kv heads, D 128, 131072 keys of a bf16 pool (walked in windows), beside
    its byte bound, SDPA on K/V gathered beforehand (the 6 query heads of a
    kv head as 6 queries, no mask: every key is valid) and the split kernel
    at K = 8 with its combine."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    n_pages, D = 8192, 128
    q, k32, v32, tables, lengths = wide_decode_case(torch, gen, 1, 12, 2, D, n_pages,
                                                    [16 * n_pages])
    k, v = k32.bfloat16(), v32.bfloat16()
    del k32, v32
    cs, win = paged_attention.decode_plan(1, 2, n_pages, 6, D, 16, 2 * D)
    one = time_graph(torch, lambda i: paged_attention.paged_attention(q, k, v, tables, lengths),
                     2)
    split8 = time_graph(torch, lambda i: paged_attention.paged_attention(
        q, k, v, tables, lengths, kv_splits=8), 2)
    kd = paged_attention.gather_paged_kv(k, tables)
    vd = paged_attention.gather_paged_kv(v, tables)
    qs = q.reshape(1, 2, 6, D)

    def sdpa(i):
        return F.scaled_dot_product_attention(qs, kd, vd).reshape(1, 12, D)

    compare(torch, "sdpa 131072-key yardstick", sdpa(0),
            paged_attention.paged_attention_plain(q, k, v, tables, lengths), TOL["bfloat16"])
    lib = time_graph(torch, sdpa, 2)
    keys = 16 * n_pages * 2                          # (key, kv head) vectors
    bnd, by = bound_ms(2 * keys * D * 2 + 2 * 2 * 12 * D + 4 * (n_pages + 1),
                       4 * 6 * keys * D, "bfloat16")
    log(f"  paged_attention B=1 H=12 Hkv=2 D=128, 131072 keys, bf16 pool (cluster {cs}, "
        f"windows of {win} pages): {one * 1e3:.2f} us, bound {bnd * 1e3:.2f} us ({by}), "
        f"SDPA on pre-gathered K/V {lib * 1e3:.2f} us, split K=8 + combine "
        f"{split8 * 1e3:.2f} us (split clusters of "
        f"{paged_attention.split_plan(1, 2, 8, n_pages, 6, D, 16, 2 * D)})")
    return dict(ms=one, bound_ms=bnd, library_ms=lib, split8_ms=split8, cluster=cs, win=win)


def check_dense_kernels(torch, tlut, quantize, attn, paged_attention, softmax_lut,
                        layernorm_lut, lut_interp, seed):
    """The dense-cache path's four kernels against their plain versions at
    the main path's shapes, in f32 and bf16: decode attention over 256-,
    161- (a ragged last block) and 1024-position arenas, exact and LUT (LUT
    held to the online block walk, its gap to the dense LUT softmax
    printed), once with GQA, a window and a softcap; on the int8 arena bit
    for bit to the kernel on the dequantized arena; on planted keys over
    4100- and 131072-position arenas at g 6, D 128; the LUT softmax of a
    128- and a 960-token prefill's scores, causal and unmasked, two
    launches bit for bit; LayerNorm and RMSNorm, LUT and exact, on
    contiguous and strided rows, and the LUT interpolation, both bit for
    bit."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    bank = tlut.LutBank.create(64)
    errs = {"decode_attention": 0.0, "softmax_lut": 0.0, "layernorm_lut": 0.0,
            "lut_interp": 0.0}
    gaps = {}

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    def record(name, label, got, want, tol):
        e = compare(torch, label, got, want, tol)
        errs[name] = max(errs[name], e)
        return e

    cases = [(256, [128, 137, 151, 160], 16, {}), (161, [96, 120, 150, 161], 16, {}),
             (1024, [960, 981, 1003, 1020], 16, {}),
             (256, [1, 100, 200, 256], 4, {"window": 90, "softcap": 30.0})]
    for S, lens, Hkv, extra in cases:
        q32, k32, v32 = randn(4, 16, 64), randn(4, Hkv, S, 64), randn(4, Hkv, S, 64)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            worst = 0.0
            for lut in (False, True):
                kw = dict(extra, exp_table=bank.exp if lut else None)
                got = attn.decode_attention(q, k, v, lengths, **kw)
                torch.cuda.synchronize()
                dense = attn.decode_attention_plain(q, k, v, lengths, **kw)
                label = f"decode_attention S={S} Hkv={Hkv} {sorted(extra)} lut={lut} {dname}"
                if lut:
                    online = attn.decode_attention_online_plain(q, k, v, lengths, **kw)
                    worst = max(worst, record("decode_attention", label + " vs online walk",
                                              got, online, TOL[dname]))
                    key = f"decode_attention ({dname})"
                    gaps[key] = max(gaps.get(key, 0.0),
                                    float((got.float() - dense.float()).abs().max()))
                else:
                    worst = max(worst, record("decode_attention", label, got, dense,
                                              TOL[dname]))
            log(f"  decode_attention B=4 H=16 Hkv={Hkv} D=64 arena {S} lengths {lens} "
                f"{extra or ''} {dname}, exact/LUT: max_abs_err {worst:.3e} "
                f"(tol {TOL[dname]})")

    # The int8 arena (bf16 scale rows) read by the kernel itself: bit for bit
    # the kernel on the arena dequantized first, at the main path's arenas.
    for S, lens, Hkv, extra in cases[:3]:
        k8, v8 = (torch.randint(-127, 128, (4, Hkv, S, 64), generator=gen, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = ((torch.rand((4, Hkv, S), generator=gen, device=dev) * 0.05 + 1e-3)
                  .bfloat16() for _ in range(2))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        q32 = randn(4, 16, 64)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            q = q32.to(dtype)
            k, v = attn.dequantize_arena(q, k8, v8, ks, vs)
            for lut in (False, True):
                kw = dict(exp_table=bank.exp if lut else None)
                got = attn.decode_attention(q, k8, v8, lengths, ks, vs, **kw)
                want = attn.decode_attention(q, k, v, lengths, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"decode_attention int8 arena S={S} lut={lut} "
                                         f"{dname}: {int((got != want).sum())} elements "
                                         "differ from the kernel on the dequantized arena")
                plain = attn.decode_attention_online_plain if lut else attn.decode_attention_plain
                record("decode_attention", f"decode_attention int8 arena S={S} lut={lut} "
                       f"{dname}", got, plain(q, k8, v8, lengths, ks, vs, **kw), TOL[dname])
        log(f"  decode_attention int8 arena {S} (bf16 scale rows), lengths {lens}, f32 and "
            f"bf16, exact/LUT: bit-exact to the kernel on the dequantized arena, within TOL "
            f"of the plain version")

    # Planted keys over wide arenas (runs over clusters of 8 blocks; qwen2-1.5B's
    # 131072 keys walked in windows), g 6, D 128, bf16: a dropped or mis-merged
    # run or window misses by O(1).
    for B, S, lens in ((4, 4100, [1, 257, 3000, 4100]), (1, 131072, [131072])):
        q = randn(B, 12, 128).bfloat16()
        k32, v32 = randn(B, 2, S, 128), randn(B, 2, S, 128)
        for b, n in enumerate(lens):
            for h in range(12):
                qh = q[b, h].float()
                u = torch.rand(6, generator=gen, device=dev)
                pos = ((torch.arange(6, device=dev) + 0.1 + 0.8 * u) / 6 * n).long()
                c = (18.0 + 3 * torch.rand(6, generator=gen, device=dev) - 1.5) * 128 ** 0.5
                k32[b, h // 6, pos.clamp(max=n - 1)] = (c / (qh @ qh))[:, None] * qh
                v32[b, h // 6, pos.clamp(max=n - 1)] = 4 * randn(6, 128)
        k, v = k32.bfloat16(), v32.bfloat16()
        del k32, v32
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        cs, win = paged_attention.arena_plan(B, 2, S, 6, 128, 256)
        worst = 0.0
        for lut in (False, True):
            kw = dict(exp_table=bank.exp if lut else None)
            got = attn.decode_attention(q, k, v, lengths, **kw)
            torch.cuda.synchronize()
            plain = attn.decode_attention_online_plain if lut else attn.decode_attention_plain
            want = plain(q, k, v, lengths, **kw)
            if float(want.float().abs().amax()) <= 0.5:
                raise AssertionError(f"decode_attention S={S}: the planted keys did not "
                                     "dominate")
            worst = max(worst, record("decode_attention", f"decode_attention planted S={S} "
                                      f"lut={lut}", got, want, TOL["bfloat16"]))
        log(f"  decode_attention 12 heads / 2 kv heads, D=128, arena {S}, lengths {lens}, "
            f"planted keys (cluster {cs}, windows of {win} blocks), exact vs plain and LUT vs "
            f"the online walk: max_abs_err {worst:.3e} (tol {TOL['bfloat16']})")
        del k, v

    # The RoPE models' heads over a 4800-position arena, bf16 and int8 (bf16
    # scale rows), planted keys, past gemma2's and danube's 4096-token window.
    for model, g, D, mopts in MODEL_HEADS:
        lens = [4700, 1500, 1]
        q, k32, v32, tables, lengths = wide_decode_case(torch, gen, 3, 2 * g, 2, D, 300, lens,
                                                        hot=8)
        ka, va = (paged_attention.gather_paged_kv(t, tables) for t in (k32, v32))
        del k32, v32
        (k8, ks), (v8, vs) = (quantize.quantize_vec(t, torch.bfloat16) for t in (ka, va))
        arenas = {"bf16": (ka.bfloat16(), va.bfloat16(), None, None),
                  "int8": (k8, v8, ks, vs)}
        del ka, va
        worst = 0.0
        for name, (k, v, ksc, vsc) in arenas.items():
            for opts in (dict(mopts), dict(mopts, exp_table=bank.exp)):
                got = attn.decode_attention(q, k, v, lengths, ksc, vsc, **opts)
                torch.cuda.synchronize()
                lut = "exp_table" in opts
                plain = attn.decode_attention_online_plain if lut else attn.decode_attention_plain
                want = plain(q, k, v, lengths, ksc, vsc, **opts)
                label = f"decode_attention {model} g={g} D={D} {name} arena lut={lut}"
                if float(want.float().abs().amax()) <= 0.5:
                    raise AssertionError(f"{label}: the planted keys did not dominate")
                worst = max(worst, record("decode_attention", label, got, want,
                                          TOL["bfloat16"]))
        cs, win = paged_attention.arena_plan(3, 2, 4800, g, D, 2 * D)
        log(f"  decode_attention at {model}'s heads (g {g}, D {D}, {mopts or 'no options'}), "
            f"2 kv heads, arena 4800, lengths {lens} (cluster {cs}, windows of {win} blocks), "
            f"bf16 and int8 arenas, planted keys, exact vs plain and LUT vs the online walk: "
            f"max_abs_err {worst:.3e} (tol {TOL['bfloat16']})")
        del q, arenas, k8, v8, ks, vs

    for S in (128, 960):
        x32 = randn(16, S, S, std=4.0)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            x = x32.to(dtype)
            worst = 0.0
            for kw in ({"causal": True}, {}):
                got = softmax_lut.softmax_lut(x, bank.exp, bank.recip, **kw)
                torch.cuda.synchronize()
                want = softmax_lut.softmax_lut_plain(x, bank.exp, bank.recip, **kw)
                worst = max(worst, record("softmax_lut", f"softmax_lut S={S} {kw} {dname}",
                                          got, want, TOL[dname]))
                if not torch.equal(softmax_lut.softmax_lut(x, bank.exp, bank.recip, **kw), got):
                    raise AssertionError(f"softmax_lut S={S} {kw} {dname}: two launches differ")
            log(f"  softmax_lut (16*{S}, {S}) causal and unmasked {dname}: max_abs_err "
                f"{worst:.3e} (tol {TOL[dname]}); two launches bit for bit")
        del x32

    for M in (4, 64):
        x32 = randn(M, 1024, std=3.0) + 0.5
        g32, b32 = randn(1024, std=0.2) + 1.0, randn(1024, std=0.2)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            x, g, b = x32.to(dtype), g32.to(dtype), b32.to(dtype)
            # the rows of a (M, 3, d) tensor at [:, -1], as the final norm reads them
            x3 = x.reshape(M, 1, 1024).expand(M, 3, 1024).contiguous()[:, -1]
            for rms in (False, True):
                for lut in (False, True):
                    kw = dict(eps=1e-5, rsqrt_table=bank.rsqrt if lut else None, rms=rms)
                    beta = None if rms else b
                    got = layernorm_lut.layernorm_lut(x, g, beta, **kw)
                    torch.cuda.synchronize()
                    want = layernorm_lut.layernorm_lut_plain(x, g, beta, wide_sums=True,
                                                             **kw)
                    label = f"layernorm_lut M={M} rms={rms} lut={lut} {dname}"
                    record("layernorm_lut", label, got, want, TOL[dname])
                    strided = layernorm_lut.layernorm_lut(x3, g, beta, **kw)
                    for name, t in (("", got), (" strided", strided)):
                        if not torch.equal(t, want):
                            raise AssertionError(f"{label}{name}: {int((t != want).sum())} "
                                                 "elements differ from the plain version")
            log(f"  layernorm_lut ({M}, 1024) LN/RMS x LUT/exact {dname}, contiguous and "
                "strided rows: bit-exact to the plain version")

    # Rows past 8 warps' registers, streamed through a block (nemotron-4-340B's
    # d 18432): bit for bit, in 16-byte pieces and, on rows of odd stride,
    # element by element.
    for d, dtype in ((16392, torch.bfloat16), (18432, torch.bfloat16), (8200, torch.float32)):
        dname = str(dtype).split(".")[1]
        M = 4
        if layernorm_lut.layernorm_plan(M, d, dtype.itemsize)[0] != 0:
            raise AssertionError(f"layernorm_lut ({M}, {d}) {dname} is not streamed")
        x = (randn(M, d, std=3.0) + 0.5).to(dtype)
        g, b = (randn(d, std=0.2) + 1.0).to(dtype), randn(d, std=0.2).to(dtype)
        xo = torch.cat([x, x[:, :1]], dim=1)[:, :d]          # stride d + 1
        for rms in (False, True):
            for lut in (False, True):
                for plus_one in ((False, True) if rms else (False,)):
                    kw = dict(eps=1e-5, rsqrt_table=bank.rsqrt if lut else None, rms=rms,
                              plus_one=plus_one)
                    beta = None if rms else b
                    got = layernorm_lut.layernorm_lut(x, g, beta, **kw)
                    odd = layernorm_lut.layernorm_lut(xo, g, beta, **kw)
                    torch.cuda.synchronize()
                    want = layernorm_lut.layernorm_lut_plain(x, g, beta, wide_sums=True, **kw)
                    label = f"layernorm_lut ({M}, {d}) rms={rms} lut={lut} {dname}"
                    record("layernorm_lut", label, got, want, TOL[dname])
                    for name, t in (("", got), (" odd stride", odd)):
                        if not torch.equal(t, want):
                            raise AssertionError(f"{label}{name}: {int((t != want).sum())} "
                                                 "elements differ from the plain version")
        log(f"  layernorm_lut ({M}, {d}) {dname}, streamed (a block a row), LN/RMS/RMS+1 x "
            "LUT/exact, contiguous and odd-stride rows: bit-exact to the plain version")

    for M in (4, 64):
        x32 = randn(M, 4096, std=3.0)
        for dtype in (torch.float32, torch.bfloat16):
            for name in ("gelu", "exp", "tanh"):
                x = x32.to(dtype)
                got = lut_interp.lut_interp(x, getattr(bank, name))
                torch.cuda.synchronize()
                want = lut_interp.lut_interp_plain(x, getattr(bank, name))
                if not torch.equal(got, want):
                    raise AssertionError(f"lut_interp ({M}, 4096) {name} {dtype}: "
                                         f"{int((got != want).sum())} elements differ")
        log(f"  lut_interp ({M}, 4096) gelu/exp/tanh f32 and bf16: bit-exact to the plain "
            "version")
    log("  LUT mode, decode_attention's online block walk vs the dense LUT plain version "
        "(the TPU kernel's algebra, not a kernel error): max gap "
        + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    return errs


def plan_variants(torch, mod, planner, args, max_chunks, fn, n, label):
    """Time `fn` under every launch shape of a row kernel, `mod.<planner>`
    replaced for the while: each group of 1 to 8 warps a row with the fewest
    pieces a lane (at most `max_chunks`) that hold it, at each rows-a-block
    (a block holds at most 8 warps); the numbers behind `_build.row_plan`.
    A tree without the planner (the parent, in an A/B call) prints
    nothing."""
    orig = getattr(mod, planner, None)
    if orig is None:
        return
    n_rows, width, itemsize = args
    per = 16 // itemsize
    times = {}
    try:
        for warps in (1, 2, 4, 8):
            chunks = 1
            while chunks * 32 * warps * per < width:
                chunks *= 2
            for rows in (1, 2, 4, 8):
                if chunks <= max_chunks and warps * rows <= 8:
                    setattr(mod, planner, lambda *a, p=(chunks, warps, rows): p)
                    times[(chunks, warps, rows)] = time_graph(torch, fn, n)
    finally:
        setattr(mod, planner, orig)
    log(f"  {label}, launch shapes (chunks, warps a row, rows a block): "
        + ", ".join(f"{p} {t * 1e3:.2f} us" for p, t in times.items())
        + f"; planned {orig(*args)}")


def time_dense_kernels(torch, F, cfg, tlut, attn, softmax_lut, layernorm_lut, lut_interp,
                       seed):
    """The four kernels at the dense path's shapes in bf16 (scores in f32),
    one input set a layer, beside their plain versions, a PyTorch call and
    their bounds: decode attention at 4 slots x 128..160 keys of a 256
    arena (and x 960..1020 of a 1024 arena), the LUT softmax of a 128- and
    a 960-token prefill's causal scores, the LayerNorm of a decode step's
    (4, 1024) rows, the paged chunk's 64 and generate()'s prefill's 512,
    the LUT GELU of a (4, 4096) w_up output; the two row kernels also under
    each launch shape their planner could have picked."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    bank = tlut.LutBank.create(64)
    L, H, D = cfg.n_layers, cfg.n_heads, cfg.head_dim
    out = {}

    def randn(*shape, std=1.0, dtype=cfg.cdtype):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    q = randn(4, H, D)
    for S, lens in ((256, [128, 137, 151, 160]), (1024, [960, 981, 1003, 1020])):
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        arenas = [(randn(4, H, S, D), randn(4, H, S, D)) for _ in range(L)]
        key_ok = torch.arange(S, device=dev)[None, :] < lengths[:, None].long()

        def sdpa(i):
            return F.scaled_dot_product_attention(q[:, :, None], *arenas[i],
                                                  attn_mask=key_ok[:, None, None])[:, :, 0]

        compare(torch, f"sdpa dense-arena yardstick S={S}", sdpa(0),
                attn.decode_attention_plain(q, *arenas[0], lengths), TOL["bfloat16"])
        ms = time_graph(torch, lambda i: attn.decode_attention(q, *arenas[i], lengths), L)
        plain = time_graph(torch, lambda i: attn.decode_attention_plain(
            q, *arenas[i], lengths), L)
        lib = time_graph(torch, sdpa, L)
        keys = sum(lens) * H
        bnd, by = bound_ms(2 * keys * D * 2 + 2 * (2 * 4 * H * D) + 4 * 4, 4 * keys * D,
                           "bfloat16")
        # The int8 arena (bf16 scale rows): the kernel reading it, and the
        # eager dequantization then the kernel, as before.
        int8 = [tuple(torch.randint(-127, 128, (4, H, S, D), generator=gen, device=dev,
                                    dtype=torch.int8) for _ in range(2))
                + tuple((torch.rand((4, H, S), generator=gen, device=dev) * 0.05).bfloat16()
                        for _ in range(2)) for _ in range(L)]
        ms8 = time_graph(torch, lambda i: attn.decode_attention(
            q, *int8[i][:2], lengths, *int8[i][2:]), L)
        deq8 = time_graph(torch, lambda i: attn.decode_attention(
            q, *attn.dequantize_arena(q, *int8[i]), lengths), L)
        bnd8, _ = bound_ms(2 * keys * (D + 2) + 2 * (2 * 4 * H * D) + 4 * 4, 4 * keys * D,
                           "bfloat16")
        log(f"  decode_attention int8 arena {S} [lengths {lens}]: {ms8 * 1e3:.2f} us reading "
            f"it, {deq8 * 1e3:.2f} us dequantized first (eager), bound {bnd8 * 1e3:.2f} us")
        del int8
        row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
                   shape=f"B=4 H=16 D=64 arena {S}, lengths {lens}, bf16 (int8 arena "
                   f"{ms8 * 1e3:.2f} us, dequantized first {deq8 * 1e3:.2f} us)")
        if S == 256:
            out["decode_attention"] = row
        else:
            out["decode_attention"]["shape"] += (
                f"; arena 1024, lengths {lens}: {ms * 1e3:.2f} us, plain {plain * 1e3:.2f} "
                f"us, SDPA {lib * 1e3:.2f} us, bound {bnd * 1e3:.2f} us")
        log(f"  decode_attention [arena {S}, lengths {lens}]: {ms * 1e3:.2f} us, plain "
            f"{plain * 1e3:.2f} us, SDPA with a length mask {lib * 1e3:.2f} us, bound "
            f"{bnd * 1e3:.2f} us ({by})")

    # The LUT softmax of a 128- and a 960-token prefill's causal scores (one
    # launch a layer in LUT mode; attn_chunk is 1024), beside torch.softmax.
    for S in (128, 960):
        scores = [randn(1, H, 1, S, S, std=4.0, dtype=torch.float32) for _ in range(L)]

        def run(i):
            return softmax_lut.softmax_lut(scores[i], bank.exp, bank.recip, causal=True)

        ms = time_graph(torch, run, L)
        plain = time_graph(torch, lambda i: softmax_lut.softmax_lut_plain(
            scores[i], bank.exp, bank.recip, causal=True), L)
        lib = time_graph(torch, lambda i: torch.softmax(scores[i], dim=-1), L)
        # A copy of the scores: the time of one plain pass over them.
        copies = [torch.empty_like(t) for t in scores]
        copy = time_graph(torch, lambda i: copies[i].copy_(scores[i]), L)
        del copies
        # The causal row q reads its q + 1 valid keys and writes all S entries.
        valid = H * S * (S + 1) // 2
        bnd, by = bound_ms(4 * valid + 4 * H * S * S, 5 * valid, "float32")
        shape = (f"({H}*{S}, {S}) f32 scores of a {S}-token prefill, causal; library: "
                 "torch.softmax, unmasked")
        if S == 128:
            out["softmax_lut"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                                      bound_by=by, shape=shape)
        else:
            out["softmax_lut"]["shape"] += (
                f"; ({H}*{S}, {S}): {ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us, "
                f"torch.softmax {lib * 1e3:.2f} us, bound {bnd * 1e3:.2f} us")
        log(f"  softmax_lut [{shape}]: {ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us, "
            f"library {lib * 1e3:.2f} us, bound {bnd * 1e3:.2f} us ({by}); a copy_ of the "
            f"scores {copy * 1e3:.2f} us")
        plan_variants(torch, softmax_lut, "softmax_plan", (H * S, S, 4), 8, run, L,
                      f"softmax_lut ({H}*{S}, {S}) f32 causal")
        del scores

    # The norm at a decode step's 4 rows, the paged chunk's 64 and
    # generate()'s 512-token prefill (4 prompts of 128), beside F.layer_norm.
    d = cfg.d_model
    g, b = randn(d, std=0.2) + 1.0, randn(d, std=0.2)
    n = 2 * L + 1
    for M in (4, 64, 512):
        rows = [randn(M, d) for _ in range(n)]

        def run(i):
            return layernorm_lut.layernorm_lut(rows[i], g, b, rsqrt_table=bank.rsqrt)

        ms = time_graph(torch, run, n)
        exact = time_graph(torch, lambda i: layernorm_lut.layernorm_lut(rows[i], g, b), n)
        plain = time_graph(torch, lambda i: layernorm_lut.layernorm_lut_plain(
            rows[i], g, b, rsqrt_table=bank.rsqrt, wide_sums=True), n)
        lib = time_graph(torch, lambda i: F.layer_norm(rows[i], (d,), g, b, 1e-5), n)
        bnd, by = bound_ms(2 * (2 * M * d + 2 * d), 8 * M * d, "float32")
        shape = (f"({M}, {d}) bf16, LUT rsqrt (exact rsqrt {exact * 1e3:.2f} us); library: "
                 "F.layer_norm")
        if M == 4:
            out["layernorm_lut"] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                                        bound_by=by, shape=shape)
        else:
            out["layernorm_lut"]["shape"] += (
                f"; ({M}, {d}): {ms * 1e3:.2f} us (exact {exact * 1e3:.2f} us), plain "
                f"{plain * 1e3:.2f} us, F.layer_norm {lib * 1e3:.2f} us, bound "
                f"{bnd * 1e3:.2f} us")
        log(f"  layernorm_lut [{shape}]: {ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us, "
            f"library {lib * 1e3:.2f} us, bound {bnd * 1e3:.2f} us ({by})")
        plan_variants(torch, layernorm_lut, "layernorm_plan", (M, d, 2), 8, run, n,
                      f"layernorm_lut ({M}, {d}) bf16 LUT")
        del rows

    # The streamed norm at nemotron-4-340B's width: a decode step's 4 rows of
    # 18432 in bf16, LayerNorm, a block a row.
    d, M = 18432, 4
    g, b = (randn(d, std=0.2) + 1.0).bfloat16(), randn(d, std=0.2).bfloat16()
    rows = [randn(M, d).bfloat16() for _ in range(n)]
    ms = time_graph(torch, lambda i: layernorm_lut.layernorm_lut(rows[i], g, b,
                                                                 rsqrt_table=bank.rsqrt), n)
    exact = time_graph(torch, lambda i: layernorm_lut.layernorm_lut(rows[i], g, b), n)
    plain = time_graph(torch, lambda i: layernorm_lut.layernorm_lut_plain(
        rows[i], g, b, rsqrt_table=bank.rsqrt, wide_sums=True), n)
    lib = time_graph(torch, lambda i: F.layer_norm(rows[i], (d,), g, b, 1e-5), n)
    bnd, by = bound_ms(2 * (2 * M * d + 2 * d), 8 * M * d, "float32")
    out["layernorm_lut"]["shape"] += (
        f"; ({M}, {d}) bf16 streamed (a block a row): {ms * 1e3:.2f} us (exact "
        f"{exact * 1e3:.2f} us), plain {plain * 1e3:.2f} us, F.layer_norm {lib * 1e3:.2f} us, "
        f"bound {bnd * 1e3:.2f} us")
    log(f"  layernorm_lut [({M}, {d}) bf16 streamed, LUT rsqrt (exact rsqrt "
        f"{exact * 1e3:.2f} us)]: {ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us, library "
        f"(F.layer_norm) {lib * 1e3:.2f} us, bound {bnd * 1e3:.2f} us ({by})")
    del rows

    acts = [randn(4, cfg.d_ff, std=3.0) for _ in range(L)]
    ms = time_graph(torch, lambda i: lut_interp.lut_interp(acts[i], bank.gelu), L)
    plain = time_graph(torch, lambda i: lut_interp.lut_interp_plain(acts[i], bank.gelu), L)
    bnd, by = bound_ms(2 * 2 * 4 * cfg.d_ff, 2 * 4 * cfg.d_ff, "float32")
    # The launch floor: an empty kernel in the same CUDA-graph harness.
    floor = time_graph(torch, lambda i: lut_interp.empty_kernel(dev), L)
    log(f"  launch floor: an empty kernel replayed in the same CUDA graph takes "
        f"{floor * 1e3:.2f} us a launch; lut_interp on (4, {cfg.d_ff}) {ms * 1e3:.2f} us")
    out["lut_interp"] = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bnd,
                             bound_by=by, launch_floor_ms=floor,
                             shape=f"(4, {cfg.d_ff}) bf16, the LUT GELU that q3 ran after its "
                             f"int8 w_up before the GEMV's epilogue took it in; an empty kernel "
                             f"{floor * 1e3:.2f} us; library: none")
    for name, r in out.items():
        if name in ("softmax_lut", "layernorm_lut"):
            continue                                # printed above, at each width
        lib = "none" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f} us"
        log(f"  {name} [{r['shape']}]: {r['ms'] * 1e3:.2f} us, plain "
            f"{r['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")
    return out


def fixed_operands(torch, M, C, R, gen):
    """fixed16 GEMV operands on the card, made as
    tests/test_torch_kernels.py's `quant_gemv_inputs` makes them: x in Q.10
    and w in Q.12 with x row 0 at v = sqrt(5e8 / C), w rows 0 and 1 at +v
    and -v (saturating both ways after the shift) and w row 2 at 32767 (a
    sum with x row 0 past 2^31, which wraps)."""
    dev = torch.device("cuda")

    def q16(t):
        return torch.clamp(torch.round(t), -32768, 32767).to(torch.int16)

    xq = q16(torch.randn((M, C), generator=gen, device=dev) * 2 ** 10)
    wq = q16(torch.randn((R, C), generator=gen, device=dev) * C ** -0.5 * 2 ** 12)
    v = int((5e8 / C) ** 0.5)
    xq[0], wq[0], wq[1], wq[2] = v, v, -v, 32767
    return xq, wq


def check_quant_kernels(torch, quant, tlut, gemv_pim, seed):
    """The int8 and fixed16 GEMVs against their plain versions, bit for
    bit: fixed16 at M in {1, 4, 64} over the model's GEMV shapes; int8 over
    M {1, 4, 8, 9, 20, 64, 65, 512} x R {1000, 1024, 4096, 50257} x C {1024,
    4096, 1000}, with and without bias, on the s8 tensor cores (the
    wrapper's tc_launches must show it) and, at C = 1000, the __dp4a
    kernel; then quantize_int8_rows on f32 and bf16 rows, zero rows and .5
    ties among them; then `check_fixed_routes`."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    errs = {"gemv_pim_int8": 0.0, "gemv_pim_fixed": 0.0, "quantize_int8_rows": 0.0}

    def same(name, label, got, want):
        err = float((got.float() - want.float()).abs().max())
        errs[name] = max(errs[name], err)
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: {int((got != want).sum())} elements differ "
                                 f"from the plain version; max abs err {err:.3e}")

    for R, C in QUANT_SHAPES:
        for M in (1, 4, 64):
            xq, wq = fixed_operands(torch, M, C, R, gen)
            wraps = abs(float(xq[0].double() @ wq[2].double())) >= 2 ** 31
            for shift in (10, 12):
                got = gemv_pim.gemv_pim_fixed(xq, wq, shift=shift)
                torch.cuda.synchronize()
                want = gemv_pim.gemv_pim_fixed_plain(xq, wq, shift=shift)
                same("gemv_pim_fixed", f"gemv_pim_fixed M={M} C={C} R={R} shift={shift}",
                     got, want)
                if (int(want[0, 0]), int(want[0, 1])) != (32767, -32768) or not wraps:
                    raise AssertionError(f"gemv_pim_fixed M={M} C={C} R={R}: the "
                                         "saturating or wrapping rows did not")
    log("  gemv_pim_fixed M=1/4/64 over the model's shapes, shift 10/12, rows saturating to "
        "+-32767/-32768 and one wrapping past 2^31: bit-exact to the plain version")

    fn = gemv_pim.gemv_pim_int8
    for C in (1024, 4096, 1000):
        calls = tc = 0
        for R in (1000, 1024, 4096, 50257):
            w8 = torch.randint(-127, 128, (R, C), generator=gen, device=dev, dtype=torch.int8)
            w8[0] = -127
            ws = torch.rand(R, generator=gen, device=dev) * 0.01 + 1e-4
            b = torch.randn(R, generator=gen, device=dev)
            for M in (1, 4, 8, 9, 20, 64, 65, 512):
                x8 = torch.randint(-127, 128, (M, C), generator=gen, device=dev,
                                   dtype=torch.int8)
                xs = torch.rand(M, generator=gen, device=dev) * 0.05 + 1e-3
                for bias in (None, b):
                    before = fn.tc_launches
                    got = fn(x8, xs, w8, ws, bias)
                    torch.cuda.synchronize()
                    tc += fn.tc_launches - before
                    calls += 1
                    same("gemv_pim_int8", f"gemv_pim_int8 M={M} C={C} R={R} "
                         f"bias={bias is not None}", got,
                         gemv_pim.gemv_pim_int8_plain(x8, xs, w8, ws, bias))
            del w8
        want_tc = calls if C % 16 == 0 else 0
        if tc != want_tc:
            raise AssertionError(f"gemv_pim_int8 C={C}: {tc} of {calls} launches on the "
                                 f"tensor cores, expected {want_tc}")
        route = "the s8 tensor cores" if tc else "the CUDA cores (__dp4a: C % 16 != 0)"
        log(f"  gemv_pim_int8 grid C={C}: M 1..512 x R 1000..50257, with and without bias, "
            f"{calls} launches on {route} (the wrapper's count): bit-exact to the plain "
            "version")

    qfn = gemv_pim.quantize_int8_rows
    ties = torch.tensor([2.5, -2.5, 3.5, -0.5, 0.5, 126.5, 1.5, 127.0], device=dev)
    for dtype, compute in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                           (torch.bfloat16, torch.float32)):
        for rows, C in ((4, 1024), (4, 4096), (64, 4096), (512, 1024), (1024, 1024),
                        (4096, 1024), (1024, 4096), (50257, 1024), (3, 20000)):
            x = torch.randn((rows, C), generator=gen, device=dev)
            x = x * torch.tensor([1e-3, 0.5, 30.0], device=dev)[torch.arange(rows, device=dev) % 3,
                                                                None]
            x[1] = 0.0
            x[2] = ties.repeat(C // 8)
            x = x.to(dtype)
            for start in (0, 1):              # 1: x starts past a 16-byte boundary
                xs = x if start == 0 else torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(
                    rows, C)
                before = qfn.launches
                q, sc = qfn(xs, compute=compute)
                torch.cuda.synchronize()
                if qfn.launches != before + 1:
                    raise AssertionError("quantize_int8_rows: not one launch")
                wq, wsc = gemv_pim.quantize_int8_rows_plain(xs.to(compute))
                name = f"quantize_int8_rows {rows}x{C} {dtype} in {compute} start {start}"
                same("quantize_int8_rows", name + " payload", q, wq)
                same("quantize_int8_rows", name + " scale", sc, wsc)
                if q[2, :6].tolist() != [2, -2, 4, 0, 0, 126] or bool(q[1].any()):
                    raise AssertionError(f"{name}: the ties or the zero row")
        log(f"  quantize_int8_rows {str(dtype).split('.')[1]} rows in "
            f"{str(compute).split('.')[1]}: 4x1024 .. 50257x1024 and 3x20000 (streamed) "
            "rows, aligned and one element past a 16-byte boundary, a zero row and exact .5 "
            "ties: payload and scales bit-exact to the plain function, one launch a call")
    check_int8_linear(torch, gemv_pim, tlut, gen, same)
    check_fixed_routes(torch, quant, tlut, gemv_pim, gen, same)
    return errs


def check_int8_linear(torch, gemv_pim, tlut, gen, same):
    """The int8 linear layer (`gemv_pim_int8_linear`) bit for bit with x's
    quantize_int8_rows launch then `gemv_pim_int8`, and with its plain
    version, over GPT-2's and qwen2-1.5B's shapes at M 1, 4, 8, 20, 64 (one
    launch, x quantized in the load path, on the s8 tensor cores, where
    `gemv_int8_linear_plan` tiles it: past 4 pieces of x a thread, as
    qwen2's w_down at decode, the rest loaded as they are quantized) and
    65, 512 (the two launches), in q1's form (bf16 x quantized in f32, f32
    weight scales, bf16 bias) and q3's (bf16 x and weight scales, the bias, the
    LUT GELU)."""
    dev = torch.device("cuda")
    fn = gemv_pim.gemv_pim_int8_linear
    gelu = tlut.LutBank.create(64).gelu
    one = two = 0
    fused_at = set()
    for R, C in QUANT_SHAPES + MODEL_GEMV_SHAPES[:5]:     # GPT-2's, then qwen2-1.5B's
        w = (torch.randn((R, C), generator=gen, device=dev) * C ** -0.5).to(torch.bfloat16)
        b = (torch.randn(R, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        forms = {"q1": (torch.float32, *gemv_pim.quantize_int8_rows_plain(w.float()), None),
                 "q3": (torch.bfloat16, *gemv_pim.quantize_int8_rows_plain(w), gelu)}
        for M in (1, 4, 8, 20, 64, 65, 512):
            x = (torch.randn((M, C), generator=gen, device=dev) * 1.5).to(torch.bfloat16)
            for form, (compute, w8, ws, table) in forms.items():
                before = (fn.launches, fn.tc_launches, gemv_pim.gemv_pim_int8.launches)
                got = fn(x, w8, ws, b, compute=compute, act_table=table)
                torch.cuda.synchronize()
                d = (fn.launches - before[0], fn.tc_launches - before[1],
                     gemv_pim.gemv_pim_int8.launches - before[2])
                fused = gemv_pim.gemv_int8_linear_plan(M, C, R) is not None
                if fused:
                    fused_at.add(M)
                if d != ((1, 1, 0) if fused else (0, 0, 1)):
                    raise AssertionError(f"gemv_pim_int8_linear M={M} C={C} R={R}: launches "
                                         f"(linear, its tensor-core ones, gemv_pim_int8) {d}")
                one += d[0]
                two += d[2]
                label = f"gemv_pim_int8_linear {form} M={M} C={C} R={R}"
                x8, xs = gemv_pim.quantize_int8_rows(x, compute=compute)
                same("gemv_pim_int8", label, got, gemv_pim.gemv_pim_int8(
                    x8, xs, w8, ws, b, out_dtype=x.dtype, act_table=table))
                same("gemv_pim_int8", label + " (plain)", got, gemv_pim.gemv_pim_int8_linear_plain(
                    x, w8, ws, b, compute=compute, act_table=table))
        del w
    log(f"  gemv_pim_int8_linear over GPT-2's and qwen2-1.5B's shapes at M 1, 4, 8, 20, 64, 65, "
        f"512, q1's form "
        f"(x in f32, f32 scales) and q3's (bf16 scales, bias, LUT GELU): {one} launches with x "
        f"quantized in the load path (M {sorted(fused_at)}), {two} as quantize_int8_rows + "
        "gemv_pim_int8: bit-exact to the two launches and to the plain version")


def check_fixed_routes(torch, quant, tlut, gemv_pim, gen, same):
    """The redesigned fixed16 kernels and the int8 GEMV's epilogue, bit for
    bit with their plain versions (`same` records the error and raises):
    the int16 kernel (shift 12) and the fused fixed16 linear layer (bf16
    and f32 x and w quantized as they load; no bias, and a bias with the
    LUT GELU) at M in {1, 4, 8, 16, 64, 512} over the model's (R, C), on
    the 8-bit tensor cores, and at C = 1000 and with a misaligned x on the
    CUDA cores (each wrapper's tc_launches must show the route); x and w
    planted so that sums saturate both ways and wrap past +-2^31; two
    launches bit for bit; then the int8 GEMV with q3's epilogue (scales and
    bias in x's dtype, out in x's dtype, the LUT GELU) on both routes."""
    dev = torch.device("cuda")
    gelu = tlut.LutBank.create(64).gelu
    fixed, fused = gemv_pim.gemv_pim_fixed, gemv_pim.gemv_pim_fixed_linear
    kw = dict(frac_x=10, frac_w=12)
    x_fmt, w_fmt = quant.QFormat(10), quant.QFormat(12)
    calls = tc = 0
    for R, C in QUANT_SHAPES + [(1024, 1000)]:
        b = torch.randn(R, generator=gen, device=dev) * 0.5
        for M in (1, 4, 8, 16, 64, 512):
            xq, wq = fixed_operands(torch, M, C, R, gen)
            xf, wf = xq.float() / 2 ** 10, wq.float() / 2 ** 12
            wf[2] = 8.0                     # Q.12 saturates it to 32767
            if M > 1:
                xf[-1] = 32.0               # Q.10's largest, against w row 3's smallest
            wf[3] = -8.0
            before = (fixed.tc_launches, fused.tc_launches)
            label = f"M={M} C={C} R={R}"
            want16 = gemv_pim.gemv_pim_fixed_plain(xq, wq, shift=12)
            same("gemv_pim_fixed", f"gemv_pim_fixed {label}", fixed(xq, wq, shift=12), want16)
            for dtype in (torch.bfloat16, torch.float32):
                x, w, bd = xf.to(dtype), wf.to(dtype), b.to(dtype)
                for bias, table in ((None, None), (bd, gelu)):
                    got = fused(x, w, bias, act_table=table, **kw)
                    torch.cuda.synchronize()
                    want = gemv_pim.gemv_pim_fixed_linear_plain(x, w, bias, act_table=table,
                                                                **kw)
                    same("gemv_pim_fixed", f"gemv_pim_fixed_linear {label} {dtype} "
                         f"bias+lut={bias is not None}", got, want)
                    calls += 1
                qs = x_fmt.quantize(x).double() @ w_fmt.quantize(w).double().t()
                sat = gemv_pim.gemv_pim_fixed_plain(x_fmt.quantize(x), w_fmt.quantize(w),
                                                    shift=12)
                if (float(qs[0, 2]) < 2 ** 31 or (int(sat[0, 0]), int(sat[0, 1])) !=
                        (32767, -32768) or (M > 1 and float(qs[-1, 3]) > -2 ** 31)):
                    raise AssertionError(f"gemv_pim_fixed_linear {label} {dtype}: the planted "
                                         "sums did not wrap or saturate")
            calls += 1
            tc += (fixed.tc_launches - before[0]) + (fused.tc_launches - before[1])
        want_tc = calls if C % 16 == 0 else 0
        if tc != want_tc:
            raise AssertionError(f"gemv_pim_fixed C={C}: {tc} of {calls} launches on the "
                                 f"tensor cores, expected {want_tc}")
        route = "the 8-bit tensor cores" if tc else "the CUDA cores (C % 16 != 0)"
        log(f"  gemv_pim_fixed grid C={C} R={R}: int16 (shift 12) and the fused fixed16 "
            f"linear layer (bf16 and f32, bias + LUT GELU or none) at M 1..512, {calls} "
            f"launches on {route}, sums planted to saturate both ways and to wrap past "
            "+-2^31: bit-exact to the plain versions")
        calls = tc = 0
    # A misaligned x (2 bytes past a 16-byte boundary) takes the CUDA cores;
    # two launches give the same bits.
    xq, wq = fixed_operands(torch, 4, 1024, 1024, gen)
    buf = torch.zeros(4 * 1024 + 8, dtype=torch.bfloat16, device=dev)
    x = buf[1:1 + 4 * 1024].view(4, 1024)
    x.copy_(xq.float() / 2 ** 10)
    w = (wq.float() / 2 ** 12).to(torch.bfloat16)
    before = fused.tc_launches
    same("gemv_pim_fixed", "gemv_pim_fixed_linear misaligned x", fused(x, w, **kw),
         gemv_pim.gemv_pim_fixed_linear_plain(x, w, **kw))
    if fused.tc_launches != before:
        raise AssertionError("gemv_pim_fixed_linear: a misaligned x went to the tensor cores")
    for M, C, R in ((4, 4096, 1024), (64, 1024, 4096), (512, 4096, 1024)):
        xq, wq = fixed_operands(torch, M, C, R, gen)
        x, w = (xq.float() / 2 ** 10).to(torch.bfloat16), (wq.float() / 2 ** 12).to(torch.bfloat16)
        for fn, args in ((fused, dict(act_table=gelu, **kw)), (fixed, dict(shift=12))):
            a = (x, w) if fn is fused else (xq, wq)
            if not torch.equal(fn(*a, **args), fn(*a, **args)):
                raise AssertionError(f"{fn.__name__} M={M} C={C} R={R}: two launches differ")
    log("  gemv_pim_fixed_linear on a misaligned x (CUDA cores) bit-exact; both fixed16 "
        "kernels give the same bits in two launches (M 4, 64, 512)")

    i8 = gemv_pim.gemv_pim_int8
    for C in (1024, 1000):
        for R in (1024, 50257):
            w8 = torch.randint(-127, 128, (R, C), generator=gen, device=dev, dtype=torch.int8)
            ws = torch.rand(R, generator=gen, device=dev) * 5e-4 + 5e-6
            b = torch.randn(R, generator=gen, device=dev)
            for M in (1, 4, 64):
                x8 = torch.randint(-127, 128, (M, C), generator=gen, device=dev,
                                   dtype=torch.int8)
                xs = torch.rand(M, generator=gen, device=dev) * 0.05 + 1e-3
                for dtype in (torch.bfloat16, torch.float32):
                    args = (x8, xs.to(dtype), w8, ws.to(dtype), b.to(dtype))
                    ekw = dict(out_dtype=dtype, act_table=gelu)
                    same("gemv_pim_int8", f"gemv_pim_int8 q3 epilogue M={M} C={C} R={R} "
                         f"{dtype}", i8(*args, **ekw), gemv_pim.gemv_pim_int8_plain(*args, **ekw))
            del w8
    log("  gemv_pim_int8 with q3's epilogue (scales and bias in x's dtype, out in x's dtype, "
        "the LUT GELU), bf16 and f32, M 1/4/64 x R 1024/50257 x C 1024 (tensor cores) and "
        "1000 (__dp4a): bit-exact to the plain version")


def check_prefill_grid(torch, tlut, quantize, paged_prefill, seed):
    """The paged prefill kernel (fp64 sums) with bf16 queries over a 64-page
    table (page 16, D 64): g in {1, 2} (16 query heads over 16 or 8 kv heads), chunks of
    Sq in {1, 17, 64} at starts {0, 15, 64, 896}, every pool format, exact
    and LUT, with and without window 300 and softcap 30: exact mode
    against the plain version, LUT mode against the page walk
    (`paged_prefill_attention_online_plain`), at TOL; the elements whose
    bits differ from the plain version's are counted."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    bank = tlut.LutBank.create(64)
    H, D, page, n_tbl = 16, 64, 16, 64
    P = 1 + n_tbl
    table = (torch.randperm(P - 1, generator=gen, device=dev) + 1)[None].to(torch.int32)
    fn = paged_prefill.paged_prefill_attention
    worst = {}
    calls = differ = elems = 0
    opts_list = [{}, {"exp_table": bank.exp}, {"window": 300, "softcap": 30.0},
                 {"exp_table": bank.exp, "window": 300, "softcap": 30.0}]
    for Hkv in (16, 8):
        k32 = torch.randn((P, Hkv, page, D), generator=gen, device=dev)
        v32 = torch.randn((P, Hkv, page, D), generator=gen, device=dev)
        for fmt in POOLS:
            k, v, ks, vs = make_pools(torch, quantize, k32, v32, fmt, torch.bfloat16)
            for Sq in (1, 17, 64):
                q = torch.randn((1, Sq, H, D), generator=gen, device=dev).bfloat16()
                for start in (0, 15, 64, 896):
                    st = torch.tensor([start], dtype=torch.int32, device=dev)
                    ln = st + Sq
                    for opts in opts_list:
                        before = fn.launches
                        got = fn(q, k, v, table, ln, st, ks, vs, **opts)
                        torch.cuda.synchronize()
                        calls += fn.launches - before
                        walk = "exp_table" in opts
                        plain = (paged_prefill.paged_prefill_attention_online_plain if walk
                                 else paged_prefill.paged_prefill_attention_plain)
                        want = plain(q, k, v, table, ln, st, ks, vs, **opts)
                        differ += int((got != want.to(got.dtype)).sum())
                        elems += got.numel()
                        e = compare(torch, f"paged prefill g={H // Hkv} {fmt} Sq={Sq} "
                                    f"start={start} {sorted(opts)}", got, want, TOL["bfloat16"])
                        key = "LUT vs the page walk" if walk else "exact vs plain"
                        worst[key] = max(worst.get(key, 0.0), e)
    if calls != 2 * len(POOLS) * 3 * 4 * len(opts_list):
        raise AssertionError(f"paged prefill grid: {calls} launches")
    log(f"  paged_prefill_attention grid: {calls} launches (the wrapper's count), {differ} of "
        f"{elems} elements off the plain version's bits, g 1 and 2, Sq 1/17/64 at starts 0/15/64/896, every pool format, "
        f"bf16, x window 300 + softcap 30: max_abs_err "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + f" (tol {TOL['bfloat16']})")
    worst["verify rows"] = check_prefill_verify_rows(torch, tlut, quantize, paged_prefill, gen)
    # The RoPE models' heads over a 300-page table (4800 keys): chunks at
    # the start, mid-prompt and past the 4096-token window, with queries of
    # std 4 so that a few keys dominate each row (scores of std ~4).
    for model, g, D, mopts in MODEL_HEADS:
        P = 1 + 300
        table = (torch.randperm(P - 1, generator=gen, device=dev) + 1)[None].to(torch.int32)
        k32 = torch.randn((P, 2, page, D), generator=gen, device=dev)
        v32 = torch.randn((P, 2, page, D), generator=gen, device=dev)
        m_worst, m_calls, m_differ = 0.0, 0, 0
        for fmt in POOLS:
            k, v, ks, vs = make_pools(torch, quantize, k32, v32, fmt, torch.bfloat16)
            for Sq, start in ((64, 0), (17, 15), (64, 4400)):
                q = (4 * torch.randn((1, Sq, 2 * g, D), generator=gen, device=dev)).bfloat16()
                st = torch.tensor([start], dtype=torch.int32, device=dev)
                ln = st + Sq
                for opts in (dict(mopts), dict(mopts, exp_table=bank.exp)):
                    before = fn.launches
                    got = fn(q, k, v, table, ln, st, ks, vs, **opts)
                    torch.cuda.synchronize()
                    m_calls += fn.launches - before
                    walk = "exp_table" in opts
                    plain = (paged_prefill.paged_prefill_attention_online_plain if walk
                             else paged_prefill.paged_prefill_attention_plain)
                    want = plain(q, k, v, table, ln, st, ks, vs, **opts)
                    m_differ += int((got != want.to(got.dtype)).sum())
                    m_worst = max(m_worst, compare(
                        torch, f"paged prefill {model} g={g} D={D} {fmt} Sq={Sq} "
                        f"start={start} {sorted(opts)}", got, want, TOL["bfloat16"]))
        if m_calls != len(POOLS) * 3 * 2:
            raise AssertionError(f"paged prefill at {model}'s heads: {m_calls} launches")
        log(f"  paged_prefill_attention at {model}'s heads (g {g}, D {D}, "
            f"{mopts or 'no options'}), Sq/start 64/0, 17/15, 64/4400 of a 4800-key table, "
            f"every pool format, bf16, exact (vs plain) and LUT (vs the page walk), "
            f"{m_calls} launches, {m_differ} elements off the plain version's bits: "
            f"max_abs_err {m_worst:.3e} (tol {TOL['bfloat16']})")
        worst[f"{model} heads"] = m_worst
        del k32, v32, k, v, ks, vs
    return max(worst.values())


def check_prefill_verify_rows(torch, tlut, quantize, paged_prefill, gen):
    """The prefill kernel as a speculative verify pass and a shared prompt's
    last chunk run it: B = 4 rows of Sq = 5 (k+1 tokens) at a different
    start a row, rows 0 and 1 mapping the same 4 physical pages (a shared
    prefix), row 3 parked (an all-trash table, start 0); and Sq = 1 at
    position 79 (the recomputed last token of a fully shared 80-token
    prompt) beside other rows. g 1 and 2, every pool format, exact and LUT,
    bf16: every element must equal the plain version's (the page walk's in
    LUT mode), bit for bit."""
    dev = torch.device("cuda")
    bank = tlut.LutBank.create(64)
    fn = paged_prefill.paged_prefill_attention
    H, D, page, n_tbl = 16, 64, 16, 64
    P = 1 + 4 * n_tbl
    worst, calls, elems = 0.0, 0, 0
    for Hkv in (16, 8):
        k32 = torch.randn((P, Hkv, page, D), generator=gen, device=dev)
        v32 = torch.randn((P, Hkv, page, D), generator=gen, device=dev)
        tables = (torch.randperm(P - 1, generator=gen, device=dev) + 1)[:4 * n_tbl]
        tables = tables.reshape(4, n_tbl).to(torch.int32)
        tables[1, :4] = tables[0, :4]
        tables[3] = 0
        for fmt in POOLS:
            k, v, ks, vs = make_pools(torch, quantize, k32, v32, fmt, torch.bfloat16)
            for Sq, starts in ((5, (37, 128, 611, 0)), (1, (79, 79, 300, 0))):
                q = torch.randn((4, Sq, H, D), generator=gen, device=dev).bfloat16()
                st = torch.tensor(starts, dtype=torch.int32, device=dev)
                ln = st + Sq
                for opts in ({}, {"exp_table": bank.exp}):
                    before = fn.launches
                    got = fn(q, k, v, tables, ln, st, ks, vs, **opts)
                    torch.cuda.synchronize()
                    calls += fn.launches - before
                    plain = (paged_prefill.paged_prefill_attention_online_plain if opts
                             else paged_prefill.paged_prefill_attention_plain)
                    want = plain(q, k, v, tables, ln, st, ks, vs, **opts).to(got.dtype)
                    label = (f"paged prefill verify rows g={H // Hkv} {fmt} Sq={Sq} "
                             f"starts={starts} {sorted(opts)}")
                    worst = max(worst, compare(torch, label, got, want, TOL["bfloat16"]))
                    if not torch.equal(got, want):
                        raise AssertionError(f"{label}: {int((got != want).sum())} elements "
                                             "off the plain version's bits")
                    elems += got.numel()
    if calls != 2 * len(POOLS) * 2 * 2:
        raise AssertionError(f"paged prefill verify rows: {calls} launches")
    log(f"  paged_prefill_attention as a verify pass: B 4 x Sq 5 at starts 37/128/611/0 and "
        f"Sq 1 at 79/79/300/0 (rows 0 and 1 on the same 4 physical pages, row 3 parked on "
        f"the trash page), g 1 and 2, every pool format, exact and LUT, bf16: {calls} "
        f"launches, 0 of {elems} elements off the plain version's bits, max_abs_err "
        f"{worst:.3e} (tol {TOL['bfloat16']})")
    return worst


def wide_decode_case(torch, gen, B, H, Hkv, D, n_pages, lengths, hot=8, target=18.0):
    """Pools of n_pages pages a sequence (page 16), randomly placed, f32.
    Each query row gets `hot` planted keys, one in each of `hot` equal
    stretches of its length, whose scores stand near `target` (k = c q;
    the rest score about N(0, 1)) with V rows of std 4: the output is then
    a mix of those few V rows, O(1), so a walk that drops or mis-merges a
    run or a window of pages misses by O(1), not by 1/sqrt(keys)."""
    dev = torch.device("cuda")
    P = 1 + B * n_pages
    tables = ((torch.randperm(P - 1, generator=gen, device=dev) + 1)
              .reshape(B, n_pages).to(torch.int32))
    k32 = torch.randn((P, Hkv, 16, D), generator=gen, device=dev)
    v32 = torch.randn((P, Hkv, 16, D), generator=gen, device=dev)
    q = torch.randn((B, H, D), generator=gen, device=dev).bfloat16()
    g = H // Hkv
    for b, n in enumerate(lengths):
        for h in range(H):
            qh = q[b, h].float()
            u = torch.rand(hot, generator=gen, device=dev)
            pos = ((torch.arange(hot, device=dev) + 0.1 + 0.8 * u) / hot * n).long()
            pos = pos.clamp(max=n - 1)
            c = (target + 3 * torch.rand(hot, generator=gen, device=dev) - 1.5) * D ** 0.5
            phys = tables[b, pos // 16].long()
            k32[phys, h // g, pos % 16] = (c / (qh @ qh))[:, None] * qh
            v32[phys, h // g, pos % 16] = 4 * torch.randn((hot, D), generator=gen, device=dev)
    return q, k32, v32, tables, torch.tensor(lengths, dtype=torch.int32, device=dev)


def check_wide_decode(torch, tlut, quantize, paged_attention, seed):
    """The single walk past one block's shared memory: qwen2-1.5B's widths
    (B=1, 12 query heads over 2 kv heads, D 128) at 131072 keys, walked in
    windows, on bf16, int8 and int4 pools; g 12 x D 192 (1 kv head) at
    1024 keys on every pool format; and the windowed walk forced at 384
    keys (windows of 1 and 3 pages over runs of 12, g x D of 512 and 128)
    on every pool format. Exact (vs plain) and LUT (vs the page walk),
    bf16, at TOL, on planted keys that keep every output O(1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 6)
    bank = tlut.LutBank.create(64)
    worst = 0.0

    def held(label, got, q, k, v, tables, lengths, ks, vs, opts):
        plain = (paged_attention.paged_attention_online_plain if opts
                 else paged_attention.paged_attention_plain)
        want = plain(q, k, v, tables, lengths, ks, vs, **opts)
        if float(want.float().abs().amax()) <= 0.5:
            raise AssertionError(f"{label}: the planted keys did not dominate")
        return compare(torch, label, got, want, TOL["bfloat16"])

    for (B, H, Hkv, D, n_pages, lens, fmts) in [
            (1, 12, 2, 128, 8192, [131072], ("fp", "int8/bf16", "int4/bf16")),
            (2, 12, 1, 192, 64, [1024, 517], tuple(POOLS))]:
        q, k32, v32, tables, lengths = wide_decode_case(torch, gen, B, H, Hkv, D, n_pages, lens)
        row_bytes = 2 * D
        cs, win = paged_attention.decode_plan(B, Hkv, n_pages, H // Hkv, D, 16, row_bytes)
        for fmt in fmts:
            k, v, ks, vs = make_pools(torch, quantize, k32, v32, fmt, torch.bfloat16)
            for opts in ({}, {"exp_table": bank.exp}):
                got = paged_attention.paged_attention(q, k, v, tables, lengths, ks, vs, **opts)
                torch.cuda.synchronize()
                e = held(f"wide decode {H}/{Hkv} heads D={D} {lens} {fmt} {sorted(opts)}",
                         got, q, k, v, tables, lengths, ks, vs, opts)
                worst = max(worst, e)
                log(f"  paged_attention {H} heads / {Hkv} kv heads, D={D}, lengths {lens}, "
                    f"{fmt} pools, {'LUT vs the page walk' if opts else 'exact vs plain'} "
                    f"(cluster {cs}, windows of {win} pages, runs of {-(-n_pages // cs)}): "
                    f"max_abs_err {e:.3e} (tol {TOL['bfloat16']})")
            del k, v, ks, vs
        del k32, v32
    for (H, Hkv, D) in ((8, 2, 128), (4, 2, 64)):
        q, k32, v32, tables, lengths = wide_decode_case(torch, gen, 3, H, Hkv, D, 24,
                                                        [384, 250, 97], hot=6)
        for fmt in POOLS:
            k, v, ks, vs = make_pools(torch, quantize, k32, v32, fmt, torch.bfloat16)
            code = paged_attention.pool_format("paged_attention", q, k, v, ks, vs)
            for win in (1, 3):
                for opts in ({}, {"exp_table": bank.exp}):
                    got = paged_attention.launch_decode(q, k, v, tables, lengths, ks, vs,
                                                        code, 2, win, **opts)
                    torch.cuda.synchronize()
                    e = held(f"windowed decode {H}/{Hkv} heads D={D} {fmt} windows of {win} "
                             f"{sorted(opts)}", got, q, k, v, tables, lengths, ks, vs, opts)
                    worst = max(worst, e)
        log(f"  paged_attention forced into windows of 1 and 3 pages (runs of 12, cluster 2), "
            f"{H} heads / {Hkv} kv heads, D={D} (g x D {H // Hkv * D}), lengths 384/250/97, "
            f"every pool format, exact vs plain and LUT vs the page walk: within "
            f"{TOL['bfloat16']}")
    return worst


def check_split_planted(torch, tlut, quantize, paged_attention, seed):
    """The KV split as a decode step routes it (`paged_attention(...,
    kv_splits=K)`: the split kernel, then merge_partials), on planted keys: the main
    path's shape (4 slots x 16 heads, D 64, a 64-page table, lengths 1, 333,
    960 and 1024) at K 4, 8 and 16 on every pool format, and qwen2-1.5B's
    widths (12 query heads over 2 kv heads, D 128, 131072 keys) at K 8 on
    bf16, int8 and int4 pools (clusters of 8 blocks a split); exact against
    the plain split, LUT against the online walk over K runs, bf16, at TOL.
    Returns the largest error."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 8)
    bank = tlut.LutBank.create(64)
    worst = 0.0
    for (B, H, Hkv, D, n_pages, lens, fmts, ks_) in [
            (4, 16, 16, 64, 64, [1, 333, 960, 1024], tuple(POOLS), (4, 8, 16)),
            (1, 12, 2, 128, 8192, [131072], ("fp", "int8/bf16", "int4/bf16"), (8,))]:
        q, k32, v32, tables, lengths = wide_decode_case(torch, gen, B, H, Hkv, D, n_pages, lens,
                                                        hot=6)
        for fmt in fmts:
            k, v, ks, vs = make_pools(torch, quantize, k32, v32, fmt, torch.bfloat16)
            for splits in ks_:
                for opts in ({}, {"exp_table": bank.exp}):
                    got = paged_attention.paged_attention(
                        q, k, v, tables, lengths, ks, vs, kv_splits=splits, **opts)
                    torch.cuda.synchronize()
                    if opts:
                        want = paged_attention.paged_attention_online_plain(
                            q, k, v, tables, lengths, ks, vs, splits=splits, **opts)
                    else:
                        want = paged_attention.paged_attention_split_plain(
                            q, k, v, tables, lengths, ks, vs, kv_splits=splits)
                    label = f"split K={splits} {H}/{Hkv} heads D={D} {lens} {fmt} {sorted(opts)}"
                    if float(want.float().abs().amax()) <= 0.5:
                        raise AssertionError(f"{label}: the planted keys did not dominate")
                    worst = max(worst, compare(torch, label, got, want, TOL["bfloat16"]))
            del k, v, ks, vs
        cs, win = paged_attention.split_plan(B, Hkv, ks_[0], n_pages, H // Hkv, D, 16, 2 * D)
        log(f"  paged_attention(kv_splits=K) (split + merge_partials) on planted keys, "
            f"{H} heads / {Hkv} kv heads, D={D}, lengths {lens}, "
            f"K={'/'.join(map(str, ks_))}, pools {'/'.join(fmts)}, exact vs plain and LUT "
            f"vs the online walk (K={ks_[0]}: "
            f"cluster {cs}, windows of {win} pages): max_abs_err {worst:.3e} "
            f"(tol {TOL['bfloat16']})")
        del k32, v32
    return worst


def time_quant_kernels(torch, quant, gemv_pim, params, qparams, cfg, seed):
    """The int8 and fixed16 GEMVs over the 145 calls of a decode step at 4
    slots and over `w_up` at M = 64, with the model's weights quantized
    (int8: `quantize_params_int8`; the int16 fixed16 kernel: Q.12), one
    set a layer (cold in L2 as in a decode step), beside their plain
    versions, their bounds and, for int8, `torch._int_mm`; the fixed16
    linear layer as `quant="fixed16"` runs it (bf16 weights and x in, the
    quantization in the kernel's load path), on the tensor cores and, at
    M = 4 and 8, on the CUDA-core route; then the device time of
    quantizing a step's weights on every call, as `quant="int8"` does (and
    as `quant="fixed16"` did before its kernel took the quantization in)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    bl, qb = params["blocks"], qparams["blocks"]
    w_fmt, x_fmt = quant.QFormat(12), quant.QFormat(10)

    def act(M, C):
        return (torch.randn((M, C), generator=gen, device=dev) * 0.5).to(cfg.cdtype)

    xs = {d: act(4, d), f: act(4, f)}            # decode-step inputs by width C
    x8 = {C: quant.quantize_int8_rows(x.float()) for C, x in xs.items()}
    x16 = {C: x_fmt.quantize(x) for C, x in xs.items()}
    layers = [("attn", "wq", "bq"), ("attn", "wk", "bk"), ("attn", "wv", "bv"),
              ("attn", "wo", None), ("ffn", "w_up", None), ("ffn", "w_down", None)]
    weights, int8_step, fixed_step, fused_step, linear_step = [], [], [], [], []
    for i in range(L):
        for grp, wname, bname in layers:
            w, qw = bl[grp][wname][i], qb[grp][wname]
            b = bl[grp][bname][i].float() if bname else None
            weights.append(w)
            int8_step.append((*x8[w.shape[1]], qw.w_i8[i], qw.scale[i], b))
            linear_step.append((xs[w.shape[1]], qw.w_i8[i], qw.scale[i],
                                bl[grp][bname][i] if bname else None))
            fixed_step.append((x16[w.shape[1]], w_fmt.quantize(w)))
            fused_step.append((xs[w.shape[1]], w, bl[grp][bname][i] if bname else None))
    weights.append(params["lm_head"])
    int8_step.append((*x8[d], qparams["lm_head"].w_i8, qparams["lm_head"].scale, None))
    linear_step.append((xs[d], qparams["lm_head"].w_i8, qparams["lm_head"].scale, None))
    fixed_step.append((x16[d], w_fmt.quantize(params["lm_head"])))
    fused_step.append((xs[d], params["lm_head"], None))
    n = len(int8_step)
    fkw = dict(frac_x=10, frac_w=12)

    def per_step(fn):
        return time_graph(torch, fn, n) * n

    i8_bytes = f16_bytes = ops = 0
    for (x, _, w8, _, b) in int8_step:
        M, C = x.shape
        R = w8.shape[0]
        i8_bytes += R * C + 4 * R + M * C + 4 * M + (4 * R if b is not None else 0) + 4 * M * R
        f16_bytes += 2 * (R * C + M * C + M * R) + (2 * R if b is not None else 0)
        ops += 2 * M * R * C
    out = {}
    ms = per_step(lambda i: gemv_pim.gemv_pim_int8(*int8_step[i]))
    plain = per_step(lambda i: gemv_pim.gemv_pim_int8_plain(*int8_step[i]))
    # Yardstick: torch._int_mm, the int32 product alone. It takes M > 16 and
    # widths that are multiples of 8, so x is padded to 32 rows and the LM
    # head to 50264 rows of zeros, both outside the timing.
    pad32 = {C: torch.nn.functional.pad(v[0], (0, 0, 0, 28)) for C, v in x8.items()}
    mm_w = [torch.nn.functional.pad(t[2], (0, 0, 0, -t[2].shape[0] % 8)) for t in int8_step]

    def mm(i):
        return torch._int_mm(pad32[int8_step[i][0].shape[1]], mm_w[i].t())

    if not torch.equal(mm(n - 1)[:4, :cfg.vocab],
                       quant.int32_matmul(int8_step[-1][0], int8_step[-1][2])):
        raise AssertionError("torch._int_mm yardstick: not the int32 product")
    # The row times the route the main path runs: q1's int8 linear layer,
    # bf16 x quantized in f32 in the kernel's load path, the bias in bf16,
    # out in bf16, one launch a linear; beside it the GEMV alone on x
    # quantized beforehand, and the two launches the route replaces.
    f32 = torch.float32
    route = per_step(lambda i: gemv_pim.gemv_pim_int8_linear(*linear_step[i], compute=f32))
    route_plain = per_step(lambda i: gemv_pim.gemv_pim_int8_linear_plain(*linear_step[i],
                                                                         compute=f32))

    def two_launches(i):
        x, w8, ws, b = linear_step[i]
        return gemv_pim.gemv_pim_int8(*gemv_pim.quantize_int8_rows(x, compute=f32), w8, ws, b,
                                      out_dtype=x.dtype)

    two = per_step(two_launches)
    lin_bytes = sum(w8.numel() + 4 * w8.shape[0] + 2 * x.numel()
                    + (2 * w8.shape[0] if b is not None else 0) + 2 * x.shape[0] * w8.shape[0]
                    for x, w8, _, b in linear_step)
    bnd, by = bound_ms(lin_bytes, ops, "int8")
    kb, kby = bound_ms(i8_bytes, ops, "int8")
    out["gemv_pim_int8"] = dict(
        ms=route, plain_ms=route_plain, library_ms=per_step(mm), bound_ms=bnd, bound_by=by,
        kernel_alone_ms=ms, two_launch_ms=two,
        shape=f"one decode step: {n} launches of the int8 linear layer (q1: bf16 x quantized "
        f"in f32 in the kernel's load path, bf16 bias and out), M=4; the GEMV alone on x "
        f"quantized beforehand {ms:.3f} ms (plain {plain:.3f} ms, bound {kb:.3f} ms); "
        f"quantize_int8_rows + gemv_pim_int8, the two launches the route replaces, "
        f"{two:.3f} ms; library: torch._int_mm, the int32 product alone, x padded to 32 rows")
    # The fixed16 row times the route the main path runs: the fused linear
    # layer on bf16 x and w (the same bytes as int16 ones), bias included.
    ms = per_step(lambda i: gemv_pim.gemv_pim_fixed_linear(*fused_step[i], **fkw))
    plain = per_step(lambda i: gemv_pim.gemv_pim_fixed_linear_plain(*fused_step[i], **fkw))
    k16 = per_step(lambda i: gemv_pim.gemv_pim_fixed(*fixed_step[i], shift=12))
    k16_plain = per_step(lambda i: gemv_pim.gemv_pim_fixed_plain(*fixed_step[i], shift=12))
    cuda_core = gemv_pim.GemvPlan("cuda_core")
    cc = {}
    for M in (4, 8):
        xm = {C: act(M, C) for C in xs}
        cc_step = [(xm[w.shape[1]], w, b) for _, w, b in fused_step]
        cc[M] = (per_step(lambda i: gemv_pim.gemv_pim_fixed_linear(*cc_step[i], **fkw)),
                 per_step(lambda i: gemv_pim.launch_fixed_linear(*cc_step[i], cuda_core,
                                                                 **fkw)))
    bnd, by = bound_ms(f16_bytes, ops, "int16")
    out["gemv_pim_fixed"] = dict(
        ms=ms, plain_ms=plain, library_ms=None, bound_ms=bnd, bound_by=by,
        shape=f"one decode step: {n} launches of the fixed16 linear layer, M=4, bf16 x and w "
        f"quantized in the kernel, bias; the int16 kernel on pre-quantized operands "
        f"{k16:.3f} ms (plain {k16_plain:.3f} ms); library: none, no PyTorch call does an "
        "int16 GEMM on CUDA")
    log("  gemv_pim_fixed_linear, a decode step's 145 calls, tensor cores against the "
        "CUDA-core route: " + ", ".join(f"M={M}: {a:.3f} against {b:.3f} ms"
                                         for M, (a, b) in cc.items()))
    log(f"  gemv_pim_int8_linear, a decode step's {n} calls (q1's form): {route:.3f} ms "
        f"against {two:.3f} ms for quantize_int8_rows + gemv_pim_int8 and "
        f"{out['gemv_pim_int8']['kernel_alone_ms']:.3f} ms for the GEMV alone on x quantized "
        f"beforehand; bound {out['gemv_pim_int8']['bound_ms']:.3f} ms")
    for name, r in out.items():
        if "shape" not in r:
            continue
        lib = "none" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f} us"
        log(f"  {name} [{r['shape']}]: {r['ms'] * 1e3:.2f} us, plain "
            f"{r['plain_ms'] * 1e3:.2f} us, library {lib}, bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']})")

    # w_up over a 64-token chunk, one weight set a layer.
    x64 = act(64, d)
    c8, c8s = quant.quantize_int8_rows(x64.float())
    c16 = x_fmt.quantize(x64)
    up8 = [(qb["ffn"]["w_up"].w_i8[i], qb["ffn"]["w_up"].scale[i]) for i in range(L)]
    up16 = [fixed_step[6 * i + 4][1] for i in range(L)]
    t8 = time_graph(torch, lambda i: gemv_pim.gemv_pim_int8(c8, c8s, *up8[i]), L)
    p8 = time_graph(torch, lambda i: gemv_pim.gemv_pim_int8_plain(c8, c8s, *up8[i]), L)
    l8 = time_graph(torch, lambda i: torch._int_mm(c8, up8[i][0].t()), L)
    b8, by8 = bound_ms(f * d + 4 * f + 64 * d + 4 * 64 + 4 * 64 * f, 2 * 64 * f * d, "int8")
    tf = time_graph(torch, lambda i: gemv_pim.gemv_pim_fixed(c16, up16[i], shift=12), L)
    pf = time_graph(torch, lambda i: gemv_pim.gemv_pim_fixed_plain(c16, up16[i], shift=12), L)
    ups = [bl["ffn"]["w_up"][i] for i in range(L)]
    tfl = time_graph(torch, lambda i: gemv_pim.gemv_pim_fixed_linear(x64, ups[i], **fkw), L)
    pfl = time_graph(torch, lambda i: gemv_pim.gemv_pim_fixed_linear_plain(x64, ups[i], **fkw),
                     L)
    bf, byf = bound_ms(2 * (f * d + 64 * d + 64 * f), 2 * 64 * f * d, "int16")
    log(f"  gemv_pim_int8 M=64 C={d} R={f} (w_up over a chunk): {t8 * 1e3:.2f} us, plain "
        f"{p8 * 1e3:.2f} us, torch._int_mm {l8 * 1e3:.2f} us, bound {b8 * 1e3:.2f} us ({by8})")
    log(f"  gemv_pim_fixed M=64 C={d} R={f} (w_up over a chunk): {tf * 1e3:.2f} us, plain "
        f"{pf * 1e3:.2f} us, bound {bf * 1e3:.2f} us ({byf}); the fixed16 linear layer on "
        f"bf16 x and w (the route): {tfl * 1e3:.2f} us, plain {pfl * 1e3:.2f} us")
    # w_up at a decode step's M=4.
    c4, c4s = x8[d]
    t4 = time_graph(torch, lambda i: gemv_pim.gemv_pim_int8(c4, c4s, *up8[i]), L)
    l4 = time_graph(torch, lambda i: torch._int_mm(pad32[d], up8[i][0].t()), L)
    b4, by4 = bound_ms(f * d + 4 * f + 4 * d + 4 * 4 + 4 * 4 * f, 2 * 4 * f * d, "int8")
    log(f"  gemv_pim_int8 M=4 C={d} R={f} (w_up in a decode step): {t4 * 1e3:.2f} us, "
        f"torch._int_mm (x padded to 32 rows) {l4 * 1e3:.2f} us, bound {b4 * 1e3:.2f} us ({by4})")
    out["gemv_pim_int8"]["shape"] += (f"; w_up at M=64: {t8 * 1e3:.2f} us (torch._int_mm "
                                      f"{l8 * 1e3:.2f}, bound {b8 * 1e3:.2f}); w_up at M=4: "
                                      f"{t4 * 1e3:.2f} us (torch._int_mm {l4 * 1e3:.2f}, bound "
                                      f"{b4 * 1e3:.2f})")
    out["gemv_pim_fixed"]["shape"] += (f"; w_up at M=64: the route {tfl * 1e3:.2f} us, the "
                                       f"int16 kernel {tf * 1e3:.2f} us, bound "
                                       f"{bf * 1e3:.2f} us")

    # The weight quantization that quant="int8" runs on every call, on the
    # quantize_int8_rows kernel (one launch a weight), beside its plain
    # version (~10 eager ops a weight); and the eager Q.12 quantization that
    # quant="fixed16" ran before its kernel took it in.
    qi8 = per_step(lambda i: gemv_pim.quantize_int8_rows(weights[i], static_input=True))
    qi8_plain = per_step(lambda i: quant.quantize_int8_rowwise(weights[i]))
    qf16 = per_step(lambda i: w_fmt.quantize(weights[i]))
    w_bytes = sum(w.numel() * 3 + 2 * w.shape[0] for w in weights)   # read bf16, write int8
    bq, byq = bound_ms(w_bytes, 0, "bfloat16")
    # x's quantization as a launch of its own, which the int8 linear layer
    # took into its load path at decode widths: (4, C) bf16 rows in f32.
    xb = [xs[w.shape[1]] for w in weights]
    qx = per_step(lambda i: gemv_pim.quantize_int8_rows(xb[i], compute=f32))
    qx_plain = per_step(lambda i: quant.quantize_int8_rows(xb[i].float()))
    variants = {}
    for R, C in sorted({tuple(w.shape) for w in weights}):   # one weight a layer a shape
        ws_ = [w for w in weights if tuple(w.shape) == (R, C)]
        variants[(R, C)] = (len(ws_), gemv_pim.quant_plan(R, C, 2), time_graph(
            torch, lambda i: gemv_pim.quantize_int8_rows(ws_[i], static_input=True), len(ws_)))
    log(f"  per-call weight quantization of a decode step's {n} bf16 weights on the "
        f"device: quantize_int8_rows kernel {qi8:.3f} ms (plain quantize_int8_rowwise "
        f"{qi8_plain:.3f} ms, bound {bq:.3f} ms by {byq}, {bq / qi8:.0%} of it); by shape "
        + ", ".join(f"{R}x{C} x{k} plan {pl}: {t * 1e3:.2f} us"
                    for (R, C), (k, pl, t) in variants.items())
        + f"; an eager Q.12 quantize (no longer on the fixed16 route) {qf16:.3f} ms; x's "
        f"quantization as its own launch before a step's {n} int8 GEMVs (taken into the "
        f"int8 linear layer at decode widths): kernel {qx:.3f} ms, plain {qx_plain:.3f} ms")
    out["quantize_int8_rows"] = dict(
        ms=qi8, plain_ms=qi8_plain, library_ms=None, bound_ms=bq, bound_by=byq,
        x_own_launch_ms=qx,
        shape=f"a decode step's {n} bf16 weights, one launch each (quant=\"int8\"); "
              f"x (4, C) bf16 in f32 of a step's {n} GEMVs as launches of their own: "
              f"{qx:.3f} ms, plain {qx_plain:.3f} ms; library: none")
    return out, {"int8": qi8, "int8_plain": qi8_plain, "fixed16": qf16}


# ---------------------------------------------------------------------------
# Phase 4: serving
# ---------------------------------------------------------------------------

def exact_activation(F, torch, act):
    """The exact activation `act` in plain PyTorch (Nonlinear's exact
    mode: the tanh GELU, SiLU, squared ReLU)."""
    return {"gelu": lambda t: F.gelu(t, approximate="tanh"), "silu": F.silu,
            "squared_relu": lambda t: torch.clamp(t, min=0.0) ** 2}[act]


def plain_linear(torch, F, sal, quant, qz, gemv_pim, lut_interp):
    """`SalPimEngine.linear` of `sal` through plain functions alone: the
    float GEMV's plain version, or `core.quant`'s `int8_linear` and
    `fixed_linear` (the twins of the JAX package's), which compute the
    quantized datapaths with the integer product in float64, followed by
    the activation's plain version (the LUT where the bank has a table for
    it, else the exact function)."""
    cfg, nl = sal.config, sal.nl

    def table(act):
        return getattr(nl.bank, act, None) if nl.mode == "lut" else None

    def activation(out, act):
        if table(act) is not None:
            return lut_interp.lut_interp_plain(out, table(act))
        return exact_activation(F, torch, act)(out)

    def lin(x, w, b=None, act=None):
        if isinstance(w, qz.QTensor):
            out = quant.int8_linear(x.float(), w.w_i8, w.scale,
                                    None if b is None else b.float()).to(x.dtype)
        elif cfg.quant == "int8":
            out = quant.int8_linear(x, *quant.quantize_int8_rowwise(w), b)
        elif cfg.quant == "fixed16":
            w_fmt, x_fmt = quant.QFormat(cfg.fixed_frac_w), quant.QFormat(cfg.fixed_frac_x)
            out = quant.fixed_linear(x, w_fmt.quantize(w), None, w_fmt=w_fmt, x_fmt=x_fmt,
                                     out_fmt=x_fmt)
            if b is not None:
                out = out + b.to(x.dtype)
        elif act is None:
            return gemv_pim.gemv_pim_plain(x, w, b)
        elif table(act) is not None:
            return gemv_pim.gemv_pim_plain(x, w, b, act_table=table(act))
        elif act == "gelu":
            return gemv_pim.gemv_pim_plain(x, w, b, act="gelu")
        else:
            out = gemv_pim.gemv_pim_plain(x, w, b)
        return activation(out, act) if act is not None else out
    return lin


def plain_prefill_logits(torch, F, params, cfg, sal, prompt, quant, qz, plain,
                         fmt="fp", online=True):
    """One-shot prefill of `prompt` through the plain versions only, on the
    linear datapath of `sal`: the reference for the engine's first logits.
    Any dense model of the port: learned positions or RoPE, LayerNorm or
    RMSNorm (1 + w with `rmsnorm_plus1`), GQA, the sliding window of each
    layer, softcaps, post-norms, a gated or plain MLP. Attention runs over
    a pool of format `fmt` (quantized per vector as the engine writes it)
    with the paged plain version or, in LUT mode with `online`, with the
    page walk the paged kernels compute
    (`paged_prefill_attention_online_plain`:
    its LUT algebra is not the dense LUT softmax's); with fmt="dense" it is
    the dense path's masked softmax attention (the LUT softmax's plain
    version in LUT mode)."""
    from repro_torch.models.rope import apply_rope, rope_cos_sin
    gemv_pim, paged_prefill, layernorm_lut, lut_interp, softmax_lut, walk = plain
    dev = params["embed"].device
    S, H, Hkv, D, page = len(prompt), cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 16
    g = H // Hkv
    scale = cfg.attn_scale if cfg.attn_scale is not None else D ** -0.5
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=dev)
    x = params["embed"][toks].to(cfg.cdtype)
    if cfg.embed_scale:
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=cfg.cdtype))
    if cfg.learned_pos_emb:
        x = x + params["pos_embed"][:S].to(cfg.cdtype)
        cos = sin = None
    else:
        cos, sin = rope_cos_sin(torch.arange(S, device=dev), D, cfg.rope_theta)
    n_pages = -(-S // page)
    table = torch.arange(1, n_pages + 1, dtype=torch.int32, device=dev)[None]
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    length = zero + S
    nl = sal.nl
    lut = nl.mode == "lut"
    lin = plain_linear(torch, F, sal, quant, qz, gemv_pim, lut_interp)
    bl = params["blocks"]

    def norm(x, p, i=None):
        g_, b_ = p["g"] if i is None else p["g"][i], p.get("b")
        if b_ is not None and i is not None:
            b_ = b_[i]
        return layernorm_lut.layernorm_lut_plain(
            x, g_, b_, eps=cfg.norm_eps, rsqrt_table=nl.bank.rsqrt if lut else None,
            rms=cfg.norm != "layernorm", plus_one=cfg.norm == "rmsnorm_plus1",
            wide_sums=True)

    def at(w, i):                                 # layer i of a stacked weight
        return qz.QTensor(w.w_i8[i], w.scale[i]) if isinstance(w, qz.QTensor) else w[i]

    def bias(a, name, i):
        return a[name][i] if name in a else None

    def softcap(t, cap):
        if lut:
            return cap * lut_interp.lut_interp_plain(t / cap, nl.bank.tanh)
        return cap * torch.tanh(t / cap)

    def pool(t):                                  # (S, Hkv, D) -> (1 + n, Hkv, page, D)
        p = torch.zeros((n_pages * page, Hkv, D), dtype=t.dtype, device=dev)
        p[:S] = t
        p = p.reshape(n_pages, page, Hkv, D).transpose(1, 2)
        return torch.cat([torch.zeros_like(p[:1]), p]).contiguous()

    def dense_attention(q, k, v, window):         # q (1, S, H, D), k/v (S, Hkv, D)
        qg = q.reshape(1, S, Hkv, g, D)
        sc = torch.einsum("bqhgd,khd->bhgqk", qg.float(), k.float()) * scale
        if cfg.attn_softcap is not None:
            sc = softcap(sc, cfg.attn_softcap)
        if lut:
            probs = softmax_lut.softmax_lut_plain(sc, nl.bank.exp, nl.bank.recip,
                                                  causal=True, window=window)
        else:
            mask = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
            if window is not None:
                mask = mask & torch.ones_like(mask).triu(1 - window)
            probs = torch.softmax(torch.where(mask, sc, -torch.inf), dim=-1)
        out = torch.einsum("bhgqk,khd->bqhgd", probs.to(v.dtype), v)
        return out.reshape(1, S, H, D)

    for i in range(cfg.n_layers):
        a, ffn = bl["attn"], bl["ffn"]
        window = cfg.window_for_layer(i)
        h = norm(x, bl["ln1"], i)
        q = lin(h, at(a["wq"], i), bias(a, "bq", i)).reshape(1, S, H, D)
        k = lin(h, at(a["wk"], i), bias(a, "bk", i)).reshape(S, Hkv, D)
        v = lin(h, at(a["wv"], i), bias(a, "bv", i)).reshape(S, Hkv, D)
        if cos is not None:
            q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if fmt == "dense":
            att = dense_attention(q, k, v, window)
        else:
            kp, vp, ks, vs = make_pools(torch, qz, pool(k), pool(v), fmt, cfg.cdtype)
            kw = dict(scale=scale, softcap=cfg.attn_softcap, window=window)
            if lut and online:
                att = walk(q, kp, vp, table, length, zero, ks, vs, exp_table=nl.bank.exp,
                           **kw).to(q.dtype)
            else:
                att = paged_prefill.paged_prefill_attention_plain(
                    q, kp, vp, table, length, zero, ks, vs,
                    exp_table=nl.bank.exp if lut else None, **kw)
        h = lin(att.reshape(S, H * D), at(a["wo"], i))
        if cfg.post_norms:
            h = norm(h, bl["post_ln1"], i)
        x = x + h
        h = norm(x, bl["ln2"], i)
        if cfg.gated_mlp:
            h = (lin(h, at(ffn["w_gate"], i), act=cfg.activation)
                 * lin(h, at(ffn["w_up"], i)))
        else:
            h = lin(h, at(ffn["w_up"], i), act=cfg.activation)
        h = lin(h, at(ffn["w_down"], i))
        if cfg.post_norms:
            h = norm(h, bl["post_ln2"], i)
        x = x + h
    x = norm(x[-1:], params["final_norm"])
    logits = lin(x, params["lm_head"])[0].float()
    if cfg.final_softcap is not None:
        logits = softcap(logits, cfg.final_softcap)
    return logits


class TcCounter:
    """A wrapper's `tc_launches` (its tensor-core kernel's launches) under
    the `launches` name of the other counters, so that the launch checks
    read the tensor-core kernels beside the wrappers."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self):
        return self.fn.tc_launches

    @launches.setter
    def launches(self, n):
        self.fn.tc_launches = n


TC = "gemv_pim_float.tc"
TC8 = "gemv_pim_int8.tc"
TC8L = "gemv_pim_int8_linear.tc"
TCF = "gemv_pim_fixed_linear.tc"


def param_count(tree) -> int:
    """Elements of every tensor in a nested dict of parameters."""
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    return tree.numel()


def step_counts(cfg) -> tuple[int, int]:
    """(linears, norms) of one decode step or prefill chunk: q, k, v, o
    and the MLP's two or three a layer plus the LM head; two norms a layer
    (four with post-norms) plus the final one."""
    L = cfg.n_layers
    return (6 + int(cfg.gated_mlp)) * L + 1, (2 + 2 * int(cfg.post_norms)) * L + 1


def serving_handles(torch):
    """The kernel wrappers by name (their launch counters; TC, TC8, TC8L and
    TCF count the tensor-core launches of the float and int8 GEMVs and of
    the int8 and fixed16 linear layers), the modules that `serve`
    takes and the plain versions that `plain_prefill_logits` takes."""
    from repro_torch.core import lut as tlut
    from repro_torch.core.salpim import SalPimConfig, SalPimEngine
    from repro_torch.distributed import collectives
    from repro_torch.kernels import decode_attention as attn
    from repro_torch.kernels import (gemv_pim, layernorm_lut, lut_interp, paged_attention,
                                     paged_prefill, softmax_lut)
    from repro_torch.models import api
    from repro_torch.serving.config import EngineConfig, GenConfig
    from repro_torch.serving.engine import ServingEngine
    kernels = {"gemv_pim_float": gemv_pim.gemv_pim_float,
               "paged_attention": paged_attention.paged_attention,
               "paged_prefill_attention": paged_prefill.paged_prefill_attention,
               "paged_attention_split": paged_attention.paged_attention_split,
               "merge_partials": paged_attention.merge_partials,
               "gemv_pim_int8": gemv_pim.gemv_pim_int8,
               "gemv_pim_int8_linear": gemv_pim.gemv_pim_int8_linear,
               "gemv_pim_fixed": gemv_pim.gemv_pim_fixed,
               "gemv_pim_fixed_linear": gemv_pim.gemv_pim_fixed_linear,
               "decode_attention": attn.decode_attention,
               "softmax_lut": softmax_lut.softmax_lut,
               "layernorm_lut": layernorm_lut.layernorm_lut,
               "lut_interp": lut_interp.lut_interp,
               "quantize_int8_rows": gemv_pim.quantize_int8_rows,
               TC: TcCounter(gemv_pim.gemv_pim_float),
               TC8: TcCounter(gemv_pim.gemv_pim_int8),
               TC8L: TcCounter(gemv_pim.gemv_pim_int8_linear),
               TCF: TcCounter(gemv_pim.gemv_pim_fixed_linear)}
    mods = (api, SalPimConfig, SalPimEngine, EngineConfig, GenConfig, ServingEngine,
            paged_attention, kernels)
    plain = (gemv_pim, paged_prefill, layernorm_lut, lut_interp, softmax_lut,
             paged_prefill.paged_prefill_attention_online_plain)
    return kernels, mods, plain


class WrongDrafter:
    """A drafter whose every proposal is rejected (vocab - 1, never the
    argmax of these runs): every speculative round rewinds its tail."""

    def __init__(self, vocab):
        import numpy
        self.np, self.vocab = numpy, vocab

    def propose(self, slot, context, k):
        return self.np.full((k,), -1, self.np.int64) % self.vocab

    def release(self, slot):
        pass


class DonorWatch:
    """The donor-pages gate of a sharing drain: at every COW fork the page
    copy must leave the donor page as it was and the fork equal to it, and
    a page a sharer borrowed must read, after every chunk and step, what
    it held when the sharer's first chunk ran (payload and scale rows)."""

    def __init__(self, torch, eng, kvcache):
        self.torch, self.eng, self.kvcache = torch, eng, kvcache
        self.snaps, self.forks = {}, 0
        self.sec = 0.0             # host time of its own work inside the chunks
        self.copy_page, self.tick = kvcache.copy_page, eng._prefill_tick
        kvcache.copy_page = self.spy_copy
        eng._prefill_tick = self.spy_tick

    def pools(self):
        c = self.eng.cache
        return [t for t in (c.k_pages, c.v_pages, c.k_scale, c.v_scale) if t is not None]

    def spy_copy(self, cache, src, dst):
        before = [t[:, src].clone() for t in self.pools()]
        out = self.copy_page(cache, src, dst)
        for t, b in zip(self.pools(), before):
            if not (self.torch.equal(t[:, src], b) and self.torch.equal(t[:, dst], b)):
                raise AssertionError(f"COW fork {src} -> {dst}: the pages differ")
        self.forks += 1
        return out

    def spy_tick(self):
        t0 = time.perf_counter()
        eng = self.eng
        cand = [(r.uid, i) for i, r in enumerate(eng.active) if r is not None and r.prefilling]
        if cand:
            req = eng.active[min(cand)[1]]
            ps = eng.allocator.page_size
            if req.prefill_cursor == min(req.shared_prompt_tokens, len(req.prompt) - 1):
                for p in eng.allocator.pages_of(req.uid)[:req.shared_prompt_tokens // ps]:
                    self.snaps.setdefault(p, [t[:, p].clone() for t in self.pools()])
        t1 = time.perf_counter()
        self.tick()
        t2 = time.perf_counter()
        self.check()
        self.sec += (t1 - t0) + (time.perf_counter() - t2)

    def check(self):
        for p, saved in list(self.snaps.items()):
            if self.eng.allocator.refcount(p) == 0:
                del self.snaps[p]            # freed: its bits may be reused
                continue
            for t, b in zip(self.pools(), saved):
                if not self.torch.equal(t[:, p], b):
                    raise AssertionError(f"shared page {p} changed under its sharers")

    def close(self):
        self.kvcache.copy_page = self.copy_page


def serve(torch, mods, params, cfg, prompts, new_tokens, card, *, label,
          mode="exact", max_len=256, fmt="fp", kv_splits=None, quant="none",
          gemv="gemv_pim_float", sharing=False, spec=None, drafter=None, gaps=None):
    """Drain `prompts` through ServingEngine (4 slots, page 16, 64-token
    chunks) on SAL-PIM datapath `quant`, checking every step's launches of
    every kernel: every linear one launch of the GEMV kernel `gemv` on the
    tensor cores (on the int8 datapaths the int8 linear layer, x quantized
    in its load path: no quantize_int8_rows launch for x, one for the
    weight with quant="int8"), every chunk's and verify pass's attention one
    prefill kernel launch a layer, no lut_interp (a LUT activation rides
    every GEMV's epilogue; a LUT-mode final softcap is one lut_interp a
    step and a chunk, the LUT tanh of the logits).

    With `sharing` (prefix sharing) a `DonorWatch` holds the donor pages
    bit for bit at every COW fork and chunk. With `spec` (a SpecConfig;
    `drafter` replaces its drafter) every round is one verify pass over 4
    slots x (k+1) tokens and no decode step: the pass's launches are a
    chunk's, and a draft model's are counted apart, each of its dense
    prefills and decode steps as phase 7's. `gaps`, a dict, collects the
    top-2 logit gap behind each greedy token (uid -> list)."""
    (api, SalPimConfig, SalPimEngine, EngineConfig, GenConfig, ServingEngine,
     paged_attention, kernels) = mods
    from repro_torch.serving import kvcache
    kv, sd = POOLS[fmt]
    n_lin, n_norm = step_counts(cfg)
    softcap_lut = mode == "lut" and cfg.final_softcap is not None
    sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode, quant=quant))
    eng = ServingEngine(params, cfg, sal, EngineConfig(
        slots=4, max_len=max_len, paged=True, page_size=16, prefill_chunk_tokens=64,
        prefix_sharing=sharing, speculative=spec, kv_cache_dtype=kv, kv_scale_dtype=sd,
        kv_splits=kv_splits, gen=GenConfig(stop_on_eos=False)), device="cuda")
    if drafter is not None:
        eng.drafter = drafter
    split = paged_attention.effective_kv_splits(kv_splits, eng.max_pages, 16) is not None
    first: dict[int, object] = {}
    tick = eng._prefill_tick

    def record_gaps():
        rows = [(i, r) for i, r in enumerate(eng.active)
                if r is not None and not r.prefilling and r.uid in first]
        if gaps is None or not rows:
            return
        top2 = torch.topk(eng.last_logits[[i for i, _ in rows]], 2).values.float().cpu()
        for (_, r), (a, b) in zip(rows, top2.tolist()):
            seen = gaps.setdefault(r.uid, [])
            if len(seen) == len(r.generated):
                seen.append(a - b)

    def tick_and_capture():          # record each request's first logits
        tick()
        for i, r in enumerate(eng.active):
            if r is not None and not r.prefilling and r.uid not in first:
                first[r.uid] = eng.last_logits[i].clone()
        record_gaps()

    eng._prefill_tick = tick_and_capture
    watch = DonorWatch(torch, eng, kvcache) if sharing else None
    # A draft model's launches (and its dense prefills and decode steps,
    # through the model API it shares with nothing else in a spec drain)
    # are counted apart from the target's.
    draft = collections.Counter()
    dense_calls = collections.Counter()
    api_fns = (api.prefill, api.decode_step, api.verify_tokens)
    verify_shapes = set()
    reach = [0, 0]                 # verify positions' end, the table's columns
    if spec is not None:
        propose = eng.drafter.propose

        def counted_propose(slot, context, k):
            before = {n: kk.launches for n, kk in kernels.items()}
            out = propose(slot, context, k)
            for n, kk in kernels.items():
                draft[n] += kk.launches - before[n]
            return out

        def counting(kind, fn):
            def call(*a, **kw):
                dense_calls[kind] += 1
                return fn(*a, **kw)
            return call

        def verify(p, toks, tables, start, *a, **kw):
            verify_shapes.add(tuple(toks.shape))
            reach[0] = max(reach[0], int(start.max()) + toks.shape[1])
            reach[1] = tables.shape[1]
            return api_fns[2](p, toks, tables, start, *a, **kw)

        eng.drafter.propose = counted_propose
        api.prefill, api.decode_step = counting("prefill", api_fns[0]), counting(
            "decode", api_fns[1])
        api.verify_tokens = verify
    try:
        uids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = 0
        while True:
            before = {n: k.launches for n, k in kernels.items()}
            n_dec, n_chunk, n_ver = eng.decode_steps, eng.prefill_chunks, eng.verify_passes
            draft.clear()
            dense_calls.clear()
            n = eng.step()
            steps += 1
            if watch is not None:
                watch.check()
            record_gaps()
            d = {n_: k.launches - before[n_] - draft[n_] for n_, k in kernels.items()}
            dec, chunk = eng.decode_steps - n_dec, eng.prefill_chunks - n_chunk
            ver = eng.verify_passes - n_ver
            L = cfg.n_layers
            passes = dec + chunk + ver
            lin = n_lin * passes
            expect = {name: 0 for name in kernels}
            expect.update({gemv: lin,
                           TC: lin if gemv == "gemv_pim_float" else 0,
                           TC8L: lin if gemv == "gemv_pim_int8_linear" else 0,
                           TCF: lin if gemv == "gemv_pim_fixed_linear" else 0,
                           "quantize_int8_rows": lin if quant == "int8" else 0,
                           "layernorm_lut": n_norm * passes,
                           "lut_interp": passes if softcap_lut else 0,
                           "paged_attention": 0 if split else L * dec,
                           "paged_prefill_attention": L * (chunk + ver),
                           "paged_attention_split": L * dec if split else 0,
                           "merge_partials": L * dec if split else 0})
            if gemv == "gemv_pim_int8_linear":
                # A linear is one launch, x quantized in its load path, where
                # gemv_int8_linear_plan tiles it (every linear of a decode step),
                # else quantize_int8_rows then gemv_pim_int8 (a chunk's wider x;
                # never its LM head, which takes the last token alone).
                two = d["gemv_pim_int8"]
                if two > (n_lin - 1) * chunk:
                    raise AssertionError(f"serve[{label}] step {steps}: {two} int8 linears "
                                         f"took two launches; a decode step takes none")
                expect.update({gemv: lin - two, TC8L: lin - two, "gemv_pim_int8": two,
                               TC8: two,
                               "quantize_int8_rows": (lin if quant == "int8" else 0) + two})
            if d != expect:
                raise AssertionError(f"serve[{label}] step {steps}: launches {d}, expected "
                                     f"{expect} (decode {dec}, chunk {chunk}, verify {ver})")
            want_draft = dense_expect(kernels, L, dense_calls["decode"], dense_calls["prefill"],
                                      mode == "lut")
            if {n_: draft[n_] for n_ in kernels} != want_draft:
                raise AssertionError(f"serve[{label}] step {steps}: draft launches "
                                     f"{dict(draft)}, expected {want_draft} ({dict(dense_calls)} "
                                     "dense calls)")
            if n == 0 and not eng.queue and all(r is None for r in eng.active):
                break
            if steps > 4000:
                raise AssertionError(f"serve[{label}]: engine did not drain")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        api.prefill, api.decode_step, api.verify_tokens = api_fns
        if watch is not None:
            watch.close()
    done = {r.uid: r for r in eng.finished}
    st = eng.stats()
    a = eng.allocator
    log(f"  serve[{label}]: {fmt} pools ({a.num_pages} pages), {mode}, "
        f"quant={quant}, kv_splits={kv_splits}, sharing={sharing}: finished "
        f"{len(done)}/{len(uids)}, {a.used_pages} pages in use after the drain "
        f"({a.reserved_pages} reserved, {a.pinned_pages} pinned), peak {st['peak_pages']}, "
        f"{st['decode_steps']} decode steps, {st['prefill_chunks']} chunks, "
        f"{st['tokens']} tokens in {wall:.3f} s = {st['tokens'] / wall:.1f} tok/s ({card})")
    if len(done) != len(uids) or any(len(done[u].generated) != new_tokens for u in uids):
        raise AssertionError(f"serve[{label}]: not every request finished")
    if (a.used_pages, a.reserved_pages, a.pinned_pages) != (0, 0, 0):
        raise AssertionError(f"serve[{label}]: {a.used_pages} pages still in use, "
                             f"{a.reserved_pages} reserved, {a.pinned_pages} pinned")
    if len(first) != len(uids):
        raise AssertionError(f"serve[{label}]: first logits of {len(first)} requests")
    L = cfg.n_layers
    attn = (f"{L} paged_attention_split + {L} merge_partials" if split
            else f"{L} paged_attention")
    tc = " (all on the tensor cores)"
    wq = f", {n_lin} quantize_int8_rows (the weights)" if quant == "int8" else ""
    if gemv == "gemv_pim_int8_linear":
        dec_lin = f"{n_lin} {gemv}{tc} (x quantized in the load path){wq}"
        chunk_lin = (f"{n_lin} int8 linears{wq}, each one {gemv} or, where no token tile "
                     "holds the chunk's x, quantize_int8_rows + gemv_pim_int8 (all on the "
                     "tensor cores)")
    else:
        dec_lin = chunk_lin = f"{n_lin} {gemv}{tc}"
    interp = ("1 lut_interp (the final softcap's LUT tanh)" if softcap_lut
              else "no lut_interp")
    if spec is None:
        log(f"  serve[{label}] launches per decode step: {dec_lin}, {attn}, "
            f"{n_norm} layernorm_lut; per prefill chunk: {chunk_lin}, "
            f"{L} paged_prefill_attention, {n_norm} "
            f"layernorm_lut; {interp}, no other kernel (checked every step)")
    else:
        log(f"  serve[{label}] launches per verify pass ({st['verify_passes']} passes over "
            f"(slots, k+1) = {sorted(verify_shapes)}, M = 20 at every linear): {chunk_lin}, "
            f"{L} paged_prefill_attention, {n_norm} layernorm_lut, no paged_attention; the "
            f"same per prefill chunk; no decode step; the draft model's launches those of "
            f"its dense prefills and decode steps (checked every step)")
        if verify_shapes - {(4, spec.k + 1)}:
            raise AssertionError(f"serve[{label}]: verify passes over {verify_shapes}")
        log(f"  serve[{label}] verify positions end at {reach[0]} (max_len {max_len}); the "
            f"verify pass's table {reach[1]} columns against the cache's {eng.max_pages}")
    eng.verify_reach = reach[0]
    eng.cow_forks = watch.forks if watch is not None else 0
    eng.watch_sec = watch.sec if watch is not None else 0.0
    if watch is not None and st["prefill_tokens_saved"]:
        log(f"  serve[{label}] prefix sharing: {st['prefill_tokens_saved']} prompt tokens "
            f"not prefilled, {watch.forks} COW forks, donor pages bit for bit at every fork "
            f"and after every chunk and step")
    return eng, done, first, wall


def first_logit_gaps(torch, F, params, cfg, sal, prompts, done, first, fmt, quant, qz,
                     plain):
    """max |diff| / max |logit| of each request's first logits against a
    plain one-shot prefill (the plain page walk for a LUT-mode paged drain),
    the greedy first tokens the two agree on, and, for a LUT-mode paged
    drain, the same measure against the dense LUT softmax (else None)."""
    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    walked = sal.nl.mode == "lut" and fmt != "dense"
    worst, agree, dense_gap = 0.0, 0, 0.0
    for u, p in zip(sorted(done), prompts):
        want = plain_prefill_logits(torch, F, params, cfg, sal, p, quant, qz, plain, fmt)
        got = first[u]
        worst = max(worst, rel(got, want))
        agree += int(int(torch.argmax(want)) == done[u].generated[0])
        if walked:
            dense_gap = max(dense_gap, rel(got, plain_prefill_logits(
                torch, F, params, cfg, sal, p, quant, qz, plain, fmt, online=False)))
    return worst, agree, dense_gap if walked else None


def check_first_logits(torch, F, params, cfg, sal, prompts, done, first, label, fmt,
                       quant, qz, plain):
    """Each request's first logits within FIRST_LOGITS_LIMIT of a plain
    one-shot prefill; a LUT-mode paged drain is held to the plain page walk,
    and within DENSE_LUT_GAP_LIMIT of the dense LUT softmax."""
    worst, agree, dense_gap = first_logit_gaps(torch, F, params, cfg, sal, prompts, done,
                                               first, fmt, quant, qz, plain)
    log(f"  serve[{label}] greedy first-token agreement with the plain path: "
        f"{agree}/{len(prompts)}")
    extra = ("" if dense_gap is None else
             f"; against the dense LUT softmax instead of the page walk {dense_gap:.3e} "
             f"(limit {DENSE_LUT_GAP_LIMIT:.0e})")
    log(f"  serve[{label}] first logits vs plain one-shot prefill ({fmt}), "
        f"quant={sal.config.quant}: "
        f"max |diff| / max |logit| = {worst:.3e} (limit {FIRST_LOGITS_LIMIT:.0e}){extra}")
    if worst > FIRST_LOGITS_LIMIT:
        raise AssertionError(f"serve[{label}]: first logits differ by {worst:.3e}")
    if dense_gap is not None and dense_gap > DENSE_LUT_GAP_LIMIT:
        raise AssertionError(f"serve[{label}]: first logits differ from the dense LUT "
                             f"softmax's by {dense_gap:.3e}")


def time_long_decode(torch, api, params, cfg, sal, fmt, label, card):
    """ms per decode step at 4 slots x 960..1020 context, max_len 1024, on a
    pool of format `fmt` with random contents (the step's time does not
    depend on them): host clock around eager steps, and the device alone,
    the same step replayed as a CUDA graph."""
    dev = params["embed"].device
    B, page, max_pages = 4, 16, 64
    kv, sd = POOLS[fmt]
    cache = api.init_paged_cache(cfg, B, 1 + B * max_pages, page, max_pages,
                                 kv_dtype=kv, kv_scale_dtype=sd, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    for t in (cache.k_pages, cache.v_pages):
        if cache.quantized:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device=dev,
                                  dtype=torch.int8))
        else:
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    if cache.quantized:
        for t in (cache.k_scale, cache.v_scale):
            t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.05)
    cache.block_tables.copy_(torch.arange(1, 1 + B * max_pages, dtype=torch.int32,
                                          device=dev).reshape(B, max_pages))
    cache.lengths.copy_(torch.tensor([960, 981, 1003, 1020], dtype=torch.int32))
    tok = torch.full((B,), 5, dtype=torch.int32, device=dev)
    step_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.decode_step(params, tok, cache, cfg, sal)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    host = statistics.median(step_ms[2:])
    device = time_graph(torch, lambda i: api.decode_step(params, tok, cache, cfg, sal), 1)
    log(f"  long-context decode step [{label}] ({card}): {host:.2f} ms eager on the host "
        f"clock, {device:.2f} ms on the device (host share {1 - device / host:.0%}), "
        f"4 slots x 960..1020 context")
    return host, device


def eager_ops(torch, fn):
    """The PyTorch operations that `fn()` dispatches, counted by name."""
    from torch.utils._python_dispatch import TorchDispatchMode
    counts = collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts[str(func)] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return counts


def check_quant_step_ops(torch, api, params, qparams, cfg, SalPimConfig, SalPimEngine):
    """The PyTorch operations of a prefill chunk and a decode step on each
    quantized datapath against the fp path's on the same pools and
    nonlinearities: q2 (fixed16) adds exactly one GELU a layer (exact
    mode's tanh GELU, fused into the float GEMV, runs after a quantized
    one); q1 (int8 weights, int8 pools) adds the same GELUs and the unbind
    of each stacked QTensor's scales, and no cast (`aten._to_copy`) or other
    op around its GEMVs; q3 (quant="int8", LUT) adds only the two outputs
    that each weight's quantize_int8_rows launch allocates. Each linear is
    its one GEMV launch, x quantized in the kernel."""
    dev = params["embed"].device
    B, page, max_pages, L = 4, 16, 16, cfg.n_layers
    lin = 6 * L + 1
    tables = torch.arange(1, 1 + B * max_pages, dtype=torch.int32,
                          device=dev).reshape(B, max_pages)
    toks = torch.full((1, 64), 5, dtype=torch.int64, device=dev)
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    tok = torch.full((B,), 5, dtype=torch.int32, device=dev)

    def ops(p, kv="model", sd="float32", **knobs):
        sal = SalPimEngine.create(SalPimConfig(**knobs))
        cache = api.init_paged_cache(cfg, B, 1 + B * max_pages, page, max_pages,
                                     kv_dtype=kv, kv_scale_dtype=sd, device=dev)
        chunk = eager_ops(torch, lambda: api.prefill_chunk(
            p, toks, tables[:1], start, cache.k_pages, cache.v_pages, cfg, sal,
            cache.k_scale, cache.v_scale))
        cache.lengths[:] = 64
        cache.block_tables.copy_(tables)
        step = eager_ops(torch, lambda: api.decode_step(p, tok, cache, cfg, sal))
        return {"prefill chunk": chunk, "decode step": step}

    gelu, unbind, empty = "aten.gelu.default", "aten.unbind.int", "aten.empty.memory_format"
    # (label, its ops, the fp path's ops, the extra ops it may have in a
    # chunk and in a decode step, what to say); None: any count. A chunk's
    # x, too wide for the int8 linear layer's load path, is quantized by a
    # quantize_int8_rows launch of its own, which allocates two outputs.
    cases = [("q2", ops(params, quant="fixed16"), ops(params), {gelu: L}, {gelu: L},
              "the exact GELU after w_up: no quantize, dequantize, cast or bias op around "
              "the fixed16 GEMV"),
             ("q1", ops(qparams, "int8"), ops(params, "int8"),
              {gelu: L, unbind: None, empty: None}, {gelu: L, unbind: None},
              "the exact GELU after w_up, the QTensor scales' unbind and, in a chunk, x's "
              "quantize_int8_rows outputs: no cast, quantize or bias op around the int8 GEMV"),
             ("q3", ops(params, quant="int8", nonlinear_mode="lut"),
              ops(params, nonlinear_mode="lut"), {empty: None}, {empty: 2 * lin},
              "the int8 payload and scale of each weight's quantize_int8_rows launch (and, "
              "in a chunk, x's): no cast or bias op around the int8 GEMV")]
    torch.cuda.synchronize()
    for label, got, fp, chunk_extra, step_extra, what in cases:
        for part, extra in (("prefill chunk", chunk_extra), ("decode step", step_extra)):
            more, missing = dict(got[part] - fp[part]), dict(fp[part] - got[part])
            bad = {k: n for k, n in more.items()
                   if k not in extra or extra[k] not in (None, n)}
            if bad or missing or any(n and k not in more for k, n in extra.items()):
                raise AssertionError(f"{label} {part}: PyTorch operations beyond the fp "
                                     f"path's {more} (allowed {extra}), missing {missing}")
            log(f"  {label} {part}: {sum(got[part].values())} PyTorch operations dispatched, "
                f"the fp path's {sum(fp[part].values())} + {more}: {what}")


def time_model(torch, api, params, cfg, sal, prompts, card, label=None, fmt="fp"):
    """ms per prefill chunk and per decode step through the model API: on
    the host clock with a device synchronise around each eager call (4
    slots, 128-token prompts), and on the device alone, the same call
    replayed as a CUDA graph. Their gap is the host's share of the step."""
    dev = params["embed"].device
    B, page, max_pages, S = 4, 16, 16, 128
    kv, sd = POOLS[fmt]
    cache = api.init_paged_cache(cfg, B, 1 + B * max_pages, page, max_pages,
                                 kv_dtype=kv, kv_scale_dtype=sd, device=dev)
    scales = (cache.k_scale, cache.v_scale)
    tables = torch.arange(1, 1 + B * max_pages, dtype=torch.int32,
                          device=dev).reshape(B, max_pages)
    chunk_ms = []
    for b in range(B):
        toks = torch.as_tensor(prompts[b][:S], dtype=torch.int64, device=dev)
        if len(toks) < S:
            toks = torch.cat([toks, toks.new_full((S - len(toks),), 2)])
        for a in range(0, S, 64):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.prefill_chunk(params, toks[None, a:a + 64], tables[b:b + 1],
                              torch.tensor([a], dtype=torch.int32, device=dev),
                              cache.k_pages, cache.v_pages, cfg, sal, *scales)
            torch.cuda.synchronize()
            chunk_ms.append(1e3 * (time.perf_counter() - t0))
    cache.lengths[:] = S
    cache.block_tables.copy_(tables)
    tok = torch.full((B,), 5, dtype=torch.int32, device=dev)
    step_ms = []
    for _ in range(32):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = api.decode_step(params, tok, cache, cfg, sal)
        tok = torch.argmax(logits, -1).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    chunk = statistics.median(chunk_ms[1:])
    dec = statistics.median(step_ms[2:])
    dev_dec = time_graph(torch, lambda i: api.decode_step(params, tok, cache, cfg, sal), 1)
    a = torch.tensor([64], dtype=torch.int32, device=dev)
    dev_chunk = time_graph(torch, lambda i: api.prefill_chunk(
        params, toks[None, 64:128], tables[B - 1:], a, cache.k_pages, cache.v_pages,
        cfg, sal, *scales), 1)
    log(f"  model timing [{label or sal.nl.mode}] ({card}): prefill {chunk:.2f} ms per 64-token "
        f"chunk (device {dev_chunk:.2f} ms), decode {dec:.2f} ms per step at 4 slots x "
        f"128..160 context (device {dev_dec:.2f} ms, host share "
        f"{1 - dev_dec / dec:.0%}) = {4e3 / dec:.1f} tok/s")
    return dict(chunk=chunk, dec=dec, dev_chunk=dev_chunk, dev_dec=dev_dec)


# ---------------------------------------------------------------------------
# Phase 11: prefix sharing and speculative decoding
# ---------------------------------------------------------------------------

VERIFY_K = 4


def check_verify(torch, api, params, cfg, sal, fmt, label, card, prompts, timed=False):
    """From one resident state (4 slots, 128-token prompts, page 16): five
    greedy decode steps, and one verify pass over the same 5 tokens on a
    copy of the pools. The verify logits at each position must be within
    FIRST_LOGITS_LIMIT of the decode logits there (max |diff| / max
    |logit|). With `timed`, a verify pass (4 slots x 5 tokens) and a decode
    step on the host clock (eager, synchronised) and on the device (a CUDA
    graph's replay)."""
    dev = params["embed"].device
    B, page, max_pages, S = 4, 16, 16, 128
    kv, sd = POOLS[fmt]
    cache = api.init_paged_cache(cfg, B, 1 + B * max_pages, page, max_pages,
                                 kv_dtype=kv, kv_scale_dtype=sd, device=dev)
    tables = torch.arange(1, 1 + B * max_pages, dtype=torch.int32,
                          device=dev).reshape(B, max_pages)
    scales = (cache.k_scale, cache.v_scale)
    logits = []
    for b in range(B):
        toks = torch.as_tensor(prompts[b][:S], dtype=torch.int64, device=dev)
        if len(toks) < S:
            toks = torch.cat([toks, toks.new_full((S - len(toks),), 2)])
        logits.append(api.prefill_chunk(params, toks[None], tables[b:b + 1],
                                        torch.zeros(1, dtype=torch.int32, device=dev),
                                        cache.k_pages, cache.v_pages, cfg, sal, *scales)[0][0])
    cache.lengths[:] = S
    cache.block_tables.copy_(tables)
    pools = [t.clone() if t is not None else None
             for t in (cache.k_pages, cache.v_pages, cache.k_scale, cache.v_scale)]
    la = torch.stack(logits).float()
    toks, seq = [], []
    c = cache
    for _ in range(VERIFY_K + 1):
        t = torch.argmax(la, -1).to(torch.int32)
        toks.append(t)
        la, c = api.decode_step(params, t, c, cfg, sal)
        la = la.float()
        seq.append(la)
    vt = torch.stack(toks, 1)
    start = torch.full((B,), S, dtype=torch.int32, device=dev)
    vlog = api.verify_tokens(params, vt, tables, start, pools[0], pools[1], cfg, sal,
                             pools[2], pools[3])[0].float()
    gaps = [float((vlog[:, j] - seq[j]).abs().max() / seq[j].abs().max())
            for j in range(VERIFY_K + 1)]
    agree = sum(int(torch.equal(vlog[:, j].argmax(-1), seq[j].argmax(-1)))
                for j in range(VERIFY_K + 1))
    log(f"  verify vs decode [{label}] ({fmt}, {sal.nl.mode}): 4 slots x {VERIFY_K + 1} "
        f"positions from 128 resident tokens, max |diff| / max |logit| by position "
        + ", ".join(f"{g:.3e}" for g in gaps)
        + f" (limit {FIRST_LOGITS_LIMIT:.0e}); argmax equal at {agree}/{VERIFY_K + 1} positions "
        "for all 4 slots")
    if max(gaps) > FIRST_LOGITS_LIMIT:
        raise AssertionError(f"verify vs decode [{label}]: {max(gaps):.3e}")
    if not timed:
        return None

    def host_ms(fn):
        ms = []
        for _ in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(ms[2:])

    def verify():
        api.verify_tokens(params, vt, tables, start, pools[0], pools[1], cfg, sal, pools[2],
                          pools[3])

    def decode():
        api.decode_step(params, toks[0], cache, cfg, sal)

    out = {"verify_host": host_ms(verify), "decode_host": host_ms(decode),
           "verify_dev": time_graph(torch, lambda i: verify(), 1),
           "decode_dev": time_graph(torch, lambda i: decode(), 1)}
    log(f"  verify pass vs decode step [{label}] ({card}): verify of 4 slots x "
        f"{VERIFY_K + 1} tokens {out['verify_dev']:.3f} ms on the device, "
        f"{out['verify_host']:.2f} ms eager on the host clock; decode step of 4 slots "
        f"{out['decode_dev']:.3f} ms on the device, {out['decode_host']:.2f} ms on the host "
        f"clock; device ratio {out['verify_dev'] / out['decode_dev']:.2f} for "
        f"{VERIFY_K + 1}x the tokens")
    return out


def verify_gap_sources(torch, params, seed):
    """Reported, not gated: where a verify pass's bf16 logits can part from
    a decode step's. The float GEMV's first 4 rows at M 20 against the same
    rows at M 4 (GPT-2's LM head and a w_up), and the prefill walk at Sq 1
    against the decode walk at the same position (4 slots, 133 keys, 16
    heads of 64, fp pool): the elements whose bits differ, of all."""
    from repro_torch.kernels import gemv_pim, paged_attention, paged_prefill
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    out = []
    for name, w in (("LM head", params["lm_head"]),
                    ("w_up", params["blocks"]["ffn"]["w_up"][0])):
        x = torch.randn((20, w.shape[1]), generator=gen, device=dev).to(w.dtype)
        a = gemv_pim.gemv_pim_float(x, w)[:4]
        b = gemv_pim.gemv_pim_float(x[:4].contiguous(), w)
        out.append(f"gemv_pim_float {name} ({w.shape[0]} x {w.shape[1]}) M 20 vs M 4: "
                   f"{int((a != b).sum())} of {a.numel()}")
    B, H, D, page, n = 4, 16, 64, 16, 9
    k = torch.randn((1 + B * n, H, page, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((1 + B * n, H, page, D), generator=gen, device=dev).bfloat16()
    tables = torch.arange(1, 1 + B * n, dtype=torch.int32, device=dev).reshape(B, n)
    q = torch.randn((B, H, D), generator=gen, device=dev).bfloat16()
    length = torch.full((B,), 133, dtype=torch.int32, device=dev)
    dec = paged_attention.paged_attention(q, k, v, tables, length)
    pre = paged_prefill.paged_prefill_attention(q[:, None].contiguous(), k, v, tables, length,
                                                length - 1)[:, 0]
    out.append(f"paged_prefill_attention Sq 1 vs paged_attention at key 133: "
               f"{int((dec != pre).sum())} of {dec.numel()}")
    log("  where verify and decode part, elements off each other's bits (reported, not a "
        "gate): " + "; ".join(out))


def token_share(a, b, n_tokens, gaps=None):
    """(tokens equal between drains a and b by uid, first divergent
    position per request, b's top-2 logit gap there (None where equal))."""
    same = sum(x == y for u in a for x, y in zip(a[u].generated, b[u].generated))
    first, gap = [], []
    for u in sorted(a):
        k = next((i for i, (x, y) in enumerate(zip(a[u].generated, b[u].generated))
                  if x != y), None)
        first.append(n_tokens if k is None else k)
        gap.append(None if k is None or gaps is None else round(gaps[u][k], 4))
    return same, first, gap


def share_spec_phase(torch, F, np, mods, plain, counted, quant, quantize, params, cfg,
                     prompts, qw, qcfg, q_prompts, new_tokens, card, rng):
    """Phase 11: GPT-2 medium's sharing drains (fp and int8/bf16 pools with
    sharing, fp without) and speculative drains on phase 4's requests (spec
    off, ngram k=4 on fp and int8/bf16 pools, self-draft, all-rejecting),
    qwen2-1.5B's ngram drain, each request's first logits, the token shares
    between them, then verify against decode on copies of the pools.
    Returns the drains' launch counts and the verify/decode timings."""
    api, SalPimConfig, SalPimEngine = mods[0], mods[1], mods[2]
    from repro_torch.serving.speculative import SpecConfig
    # Sharing: four prompts on one 64-token (4-page) prefix with tails of 16,
    # 32, 48 and 24 tokens, the first (80 tokens) followed by two exact
    # repeats (fully covered: the last token recomputed through a COW fork),
    # then two unrelated prompts.
    prefix = rng.randint(2, cfg.vocab, size=64)
    fam = [np.concatenate([prefix, rng.randint(2, cfg.vocab, size=n)]) for n in (16, 32, 48, 24)]
    share_prompts = ([fam[0], fam[0].copy(), fam[0].copy()] + fam[1:]
                     + [rng.randint(2, cfg.vocab, size=int(n)) for n in rng.randint(32, 129, 2)])
    # Two requests that fill max_len 256 (prompt + max_new - 1): a repeated
    # motif the ngram drafter matches, and a random prompt.
    full_prompts = [np.resize(rng.randint(2, cfg.vocab, size=9), 257 - new_tokens),
                    rng.randint(2, cfg.vocab, size=257 - new_tokens)]
    ngram = SpecConfig(mode="ngram", k=VERIFY_K)
    share_drains = [("s1 fp sharing", dict(sharing=True)),
                    ("s2 int8/bf16 sharing", dict(sharing=True, fmt="int8/bf16")),
                    ("s3 fp no sharing", dict()),
                    ("s4 int8/bf16 no sharing", dict(fmt="int8/bf16"))]
    spec_drains = [("p0 fp spec off", dict(sharing=True)),
                   ("p5 int8/bf16 spec off", dict(sharing=True, fmt="int8/bf16")),
                   ("p1 fp ngram k=4", dict(sharing=True, spec=ngram)),
                   ("p2 int8/bf16 ngram k=4", dict(sharing=True, spec=ngram, fmt="int8/bf16")),
                   ("p3 fp self-draft k=4", dict(sharing=True, spec=SpecConfig(
                       mode="draft-model", k=VERIFY_K, draft_cfg=cfg, draft_params=params))),
                   ("p4 fp all-rejecting k=4", dict(sharing=True, spec=ngram,
                                                    drafter=WrongDrafter(cfg.vocab)))]
    ss_gaps = {label: {} for label in ("s3 fp no sharing", "s4 int8/bf16 no sharing",
                                       "p0 fp spec off", "p5 int8/bf16 spec off")}

    def drive_share_spec():
        out = {}
        for label, kw in share_drains:
            out[label] = serve(torch, mods, params, cfg, share_prompts, new_tokens, card,
                               label=label, gaps=ss_gaps.get(label), **kw)
        for label, kw in spec_drains:
            out[label] = serve(torch, mods, params, cfg, prompts, new_tokens, card,
                               label=label, gaps=ss_gaps.get(label), **kw)
        out["f1 fp ngram k=4 to max_len"] = serve(
            torch, mods, params, cfg, full_prompts, new_tokens, card,
            label="f1 fp ngram k=4 to max_len", sharing=True, spec=ngram)
        out["qwen2 ngram k=4"] = serve(torch, mods, qw, qcfg, q_prompts, new_tokens, card,
                                       label="qwen2 ngram k=4", sharing=True, spec=ngram)
        return out

    ss_runs, counts_ss = counted("share/spec", drive_share_spec, [
        "gemv_pim_float", TC, "paged_attention", "paged_prefill_attention",
        "decode_attention", "layernorm_lut"])
    exact = SalPimEngine.create(SalPimConfig())
    for label, kw in share_drains + spec_drains + [("f1 fp ngram k=4 to max_len", {}),
                                                   ("qwen2 ngram k=4", {})]:
        eng, done, first, _ = ss_runs[label]
        w, c, ps = ((qw, qcfg, q_prompts) if label.startswith("qwen2") else
                    (params, cfg, {"s": share_prompts, "f": full_prompts}.get(
                        label[0], prompts)))
        check_first_logits(torch, F, w, c, exact, ps, done, first, label, kw.get("fmt", "fp"),
                           quant, quantize, plain)
        st = eng.stats()
        log(f"  serve[{label}] stats ({card}): sec_per_token {st['sec_per_token']:.5f}, "
            f"prefill_tokens {st['prefill_tokens']}, prefill_tokens_saved "
            f"{st['prefill_tokens_saved']}, {st['prefill_chunks']} chunks in "
            f"{st['chunk_prefill_sec']:.3f} s, decode {st['decode_steps']} steps in "
            f"{st['decode_sec']:.3f} s; proposed {st['proposed']}, accepted {st['accepted']}, "
            f"acceptance_rate {st['acceptance_rate']:.4f}, verify_passes "
            f"{st['verify_passes']}, spec_rounds {st['spec_rounds']}, verify_per_token "
            f"{st['verify_per_token']:.4f}, tokens_per_pass {st['tokens_per_pass']:.4f}, "
            f"draft_sec {st['draft_sec']:.3f}, verify_sec {st['verify_sec']:.3f} "
            f"({1e3 * st['verify_sec'] / max(st['verify_passes'], 1):.2f} ms a pass)")
        if label.startswith("f") and eng.verify_reach <= eng.max_len:
            raise AssertionError(f"serve[{label}]: no verify pass padded past max_len")
        if kw.get("sharing") and label.startswith("s") and (
                st["prefill_tokens_saved"] == 0 or not eng.cow_forks):
            raise AssertionError(f"serve[{label}]: no prompt token shared or no page forked")
    # Reported, not gated: on the card the draft model's dense decode and
    # the verify pass's prefill walk and M = 20 GEMVs are different kernels,
    # so self-draft's acceptance may miss 1.0 where two logits nearly tie.
    st3 = ss_runs["p3 fp self-draft k=4"][0].stats()
    st4 = ss_runs["p4 fp all-rejecting k=4"][0].stats()
    log(f"  self-draft acceptance_rate {st3['acceptance_rate']:.4f} (1.0 on the CPU, where "
        f"both sides run the plain versions); all-rejecting drafter: {st4['accepted']} of "
        f"{st4['proposed']} drafts accepted, {st4['spec_rounds']} rounds rewound")
    for a, b in [("s1 fp sharing", "s3 fp no sharing"),
                 ("s2 int8/bf16 sharing", "s4 int8/bf16 no sharing"),
                 ("p1 fp ngram k=4", "p0 fp spec off"),
                 ("p2 int8/bf16 ngram k=4", "p5 int8/bf16 spec off"),
                 ("p3 fp self-draft k=4", "p0 fp spec off"),
                 ("p4 fp all-rejecting k=4", "p0 fp spec off")]:
        same, first_div, gap = token_share(ss_runs[a][1], ss_runs[b][1], new_tokens, ss_gaps[b])
        n = len(ss_runs[a][1]) * new_tokens
        log(f"  serve[{a}] shares {same}/{n} greedy tokens with serve[{b}]; first divergent "
            f"position per request {first_div} ({new_tokens}: none), {b}'s top-2 logit gap "
            f"there {gap} (reported, not a gate)")
    for on, off in (("s1 fp sharing", "s3 fp no sharing"),
                    ("s2 int8/bf16 sharing", "s4 int8/bf16 no sharing")):
        e1, e3 = ss_runs[on][0], ss_runs[off][0]
        s1, s3 = e1.stats(), e3.stats()
        c1 = s1["chunk_prefill_sec"] - e1.watch_sec
        log(f"  prefix sharing [{on}] ({card}): {s1['prefill_tokens_saved']} of "
            f"{s3['prefill_tokens']} prompt tokens not prefilled, {s1['prefill_chunks']} "
            f"chunks against {s3['prefill_chunks']}, chunk time on the host clock {c1:.3f} s "
            f"(the donor gate's own {e1.watch_sec:.3f} s taken out) against "
            f"{s3['chunk_prefill_sec']:.3f} s: saved {s3['chunk_prefill_sec'] - c1:.3f} s; "
            f"peak pages {s1['peak_pages']} against {s3['peak_pages']}")
    del ss_runs
    verify_ms = {}
    for fmt in ("fp", "int8/bf16"):
        for mode in ("exact", "lut"):
            label = f"gpt2 {fmt} {mode}"
            out = check_verify(torch, api, params, cfg,
                               SalPimEngine.create(SalPimConfig(nonlinear_mode=mode)), fmt,
                               label, card, prompts, timed=(fmt, mode) == ("fp", "exact"))
            if out is not None:
                verify_ms["gpt2"] = out
    verify_ms["qwen2"] = check_verify(torch, api, qw, qcfg, exact, "fp", "qwen2 fp exact", card,
                                      q_prompts, timed=True)
    verify_gap_sources(torch, params, int(rng.randint(1 << 30)))
    return counts_ss, verify_ms


# ---------------------------------------------------------------------------
# Phase 7: the dense cache
# ---------------------------------------------------------------------------

def dense_expect(kernels, L, dec, prefills, lut):
    """Launches of `dec` dense decode steps and `prefills` whole-prompt
    prefills: 6 linears a layer plus the LM head, 2 norms a layer plus the
    final one, one attention a layer (decode_attention; the LUT softmax
    in a LUT-mode prefill), nothing else; every GEMV on the tensor cores."""
    expect = {name: 0 for name in kernels}
    expect.update({"gemv_pim_float": (6 * L + 1) * (dec + prefills),
                   TC: (6 * L + 1) * (dec + prefills),
                   "layernorm_lut": (2 * L + 1) * (dec + prefills),
                   "decode_attention": L * dec,
                   "softmax_lut": L * prefills if lut else 0})
    return expect


def drive_generate(torch, generate, GenConfig, kernels, params, cfg, sal, prompts,
                   new_tokens):
    """`generate()` over a (B, S) batch, its launches checked in total:
    one prefill and new_tokens decode steps."""
    toks = torch.as_tensor(prompts, device="cuda")
    before = {n: k.launches for n, k in kernels.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, st = generate(params, toks, cfg, sal,
                       GenConfig(max_new_tokens=new_tokens, stop_on_eos=False), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = {n: k.launches - before[n] for n, k in kernels.items()}
    mode = sal.nl.mode
    expect = dense_expect(kernels, cfg.n_layers, new_tokens, 1, mode == "lut")
    if d != expect:
        raise AssertionError(f"generate[{mode}]: launches {d}, expected {expect}")
    if tuple(out.shape) != (len(prompts), new_tokens) or not bool(
            ((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"generate[{mode}]: tokens {tuple(out.shape)} out of range")
    log(f"  generate[{mode}]: {tuple(toks.shape)} prompts, {new_tokens} new tokens, "
        f"{st['tokens']} tokens; prefill {st['prefill_sec'] * 1e3:.1f} ms, decode "
        f"{st['decode_sec'] * 1e3:.1f} ms = {st['sec_per_token'] * 1e3:.2f} ms per token a "
        f"sequence; {wall:.3f} s in all; launches as expected ({d['gemv_pim_float']} GEMV "
        f"({d[TC]} on the tensor cores), "
        f"{d['decode_attention']} decode_attention, {d['layernorm_lut']} layernorm_lut, "
        f"{d['softmax_lut']} softmax_lut, no paged kernel)")
    return out


def serve_dense(torch, mods, params, cfg, prompts, new_tokens, card, *, label,
                mode="exact", max_len=256):
    """Drain `prompts` through ServingEngine(paged=False) (4 slots; the
    arena is int8 when cfg.kv_dtype says so), checking every step's
    launches: per decode step 145 GEMV, 24 decode_attention, 49
    layernorm_lut; per admission 145 GEMV, 49 layernorm_lut and, in LUT
    mode, 24 softmax_lut; no paged kernel."""
    (api, SalPimConfig, SalPimEngine, EngineConfig, GenConfig, ServingEngine,
     paged_attention, kernels) = mods
    sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode))
    eng = ServingEngine(params, cfg, sal, EngineConfig(
        slots=4, max_len=max_len, gen=GenConfig(stop_on_eos=False)), device="cuda")
    first: dict[int, object] = {}
    place = eng._place_dense

    def place_and_capture(slot, req):          # record each request's first logits
        place(slot, req)
        first[req.uid] = eng.last_logits[slot].clone()

    eng._place_dense = place_and_capture
    uids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 0
    while True:
        before = {n: k.launches for n, k in kernels.items()}
        n_dec, n_adm = eng.decode_steps, len(first)
        n = eng.step()
        steps += 1
        d = {n_: k.launches - before[n_] for n_, k in kernels.items()}
        dec, adm = eng.decode_steps - n_dec, len(first) - n_adm
        expect = dense_expect(kernels, cfg.n_layers, dec, adm, mode == "lut")
        if d != expect:
            raise AssertionError(f"serve[{label}] step {steps}: launches {d}, expected "
                                 f"{expect} (decode {dec}, admissions {adm})")
        if n == 0 and not eng.queue and all(r is None for r in eng.active):
            break
        if steps > 4000:
            raise AssertionError(f"serve[{label}]: engine did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = {r.uid: r for r in eng.finished}
    st = eng.stats()
    c = eng.cache
    arena = sum(t.numel() * t.element_size() for t in (c.k, c.v, c.k_scale, c.v_scale)
                if t is not None)
    parked = c.lengths.tolist()
    log(f"  serve[{label}]: dense {'int8' if c.quantized else 'fp'} arena "
        f"({arena / 2 ** 20:.1f} MiB, {max_len} positions x 4 slots), {mode}: finished "
        f"{len(done)}/{len(uids)}, slot lengths after the drain {parked}, "
        f"{st['decode_steps']} decode steps, {st['tokens']} tokens in {wall:.3f} s = "
        f"{st['tokens'] / wall:.1f} tok/s ({card})")
    if len(done) != len(uids) or any(len(done[u].generated) != new_tokens for u in uids):
        raise AssertionError(f"serve[{label}]: not every request finished")
    if parked != [0] * 4 or len(first) != len(uids):
        raise AssertionError(f"serve[{label}]: slots not parked ({parked}) or first logits "
                             f"of {len(first)} requests")
    L = cfg.n_layers
    sm = f", {L} softmax_lut" if mode == "lut" else ""
    log(f"  serve[{label}] launches per decode step: {6 * L + 1} gemv_pim_float (all on "
        f"the tensor cores), {L} decode_attention, {2 * L + 1} layernorm_lut; per admission "
        f"prefill: {6 * L + 1} gemv_pim_float (tensor cores), {2 * L + 1} layernorm_lut{sm}; "
        "no paged kernel (checked every step)")
    return eng, done, first, wall


def time_dense_decode(torch, api, params, cfg, sal, max_len, lens, label, card):
    """ms per dense decode step at 4 slots with the given lengths, on an
    arena of random contents (the step's time does not depend on them):
    host clock around eager steps, and the device alone, the step replayed
    as a CUDA graph; for the int8 arena also the device time of the JAX
    package's eager whole-arena dequantization, which the kernel's own
    int8 read replaces, for comparison."""
    dev = params["embed"].device
    cache = api.init_cache(cfg, 4, max_len, device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    for t in (cache.k, cache.v):
        if cache.quantized:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen, device=dev,
                                  dtype=torch.int8))
        else:
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    if cache.quantized:
        for t in (cache.k_scale, cache.v_scale):
            t.copy_(torch.rand(t.shape, generator=gen, device=dev) * 0.05)
    cache.lengths.copy_(torch.tensor(lens, dtype=torch.int32))
    tok = torch.full((4,), 5, dtype=torch.int32, device=dev)
    step_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.decode_step(params, tok, cache, cfg, sal)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    host = statistics.median(step_ms[2:])
    device = time_graph(torch, lambda i: api.decode_step(params, tok, cache, cfg, sal), 1)
    arena = sum(t.numel() * t.element_size() for t in (cache.k, cache.v, cache.k_scale,
                                                        cache.v_scale) if t is not None)
    deq = 0.0
    if cache.quantized:
        def dequant(i):
            for x, s in ((cache.k[i], cache.k_scale[i]), (cache.v[i], cache.v_scale[i])):
                x.to(cfg.cdtype) * s[..., None].to(cfg.cdtype)
        deq = time_graph(torch, dequant, cfg.n_layers) * cfg.n_layers
    extra = (f"; the eager whole-arena dequantization, which the kernel's int8 read "
             f"replaces, takes {deq:.2f} ms" if deq else "")
    log(f"  dense decode step [{label}] ({card}): {host:.2f} ms eager on the host clock, "
        f"{device:.2f} ms on the device{extra} (host share {1 - device / host:.0%}), 4 "
        f"slots x {lens} context, arena {max_len} positions ({arena / 2 ** 20:.1f} MiB)")
    return dict(host=host, device=device, dequant=deq, arena=arena)


# ---------------------------------------------------------------------------

def time_dense_admission(torch, api, params, cfg, sal, S, max_len, label, card):
    """Device ms of one dense admission's prefill (ServingEngine(paged=False)
    admits a batch of 1, the whole prompt: 145 GEMV, 49 layernorm_lut and,
    in LUT mode, 24 softmax_lut), an S-token prompt replayed as a CUDA
    graph."""
    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(11)
    toks = torch.randint(2, cfg.vocab, (1, S), generator=gen, device=dev)
    device = time_graph(torch, lambda i: api.prefill(params, {"tokens": toks}, cfg, sal,
                                                     max_len=max_len), 1)
    log(f"  dense admission [{label}] ({card}): a {S}-token prompt, arena {max_len}: "
        f"{device:.3f} ms on the device")
    return device


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import gpt2_medium
    from repro_torch.core import lut as tlut
    from repro_torch.core import quant
    from repro_torch.core.salpim import SalPimConfig, SalPimEngine
    from repro_torch.distributed import collectives
    from repro_torch.kernels import _build, gemv_pim, layernorm_lut, lut_interp
    from repro_torch.kernels import decode_attention as attn
    from repro_torch.kernels import paged_attention, paged_prefill, softmax_lut
    from repro_torch.models import api
    from repro_torch.serving import quantize
    from repro_torch.serving.config import GenConfig
    from repro_torch.serving.engine import generate

    t_start = time.perf_counter()
    log("== 1. card")
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)}, power limit {card_line.split(',')[-1].strip()}"
    log(f"  {card_line}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("== 2. build (nvcc, sm_90a)")
    t0 = time.perf_counter()
    reports = _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
        report = reports.get(name, "")
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", report)]
        spills = [int(s) + int(l) for s, l in
                  re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)]
        if regs:
            log(f"  {name}: {len(regs)} kernels, at most {max(regs)} registers a thread; "
                f"{sum(s > 0 for s in spills)} spill, at most {max(spills, default=0)} "
                "bytes of spill stores + loads")
    log(f"  built {sorted(reports)} in {time.perf_counter() - t0:.1f} s "
        f"(already built: {sorted(set(_build.SOURCES) - set(reports))})")

    log("== 3. kernels against their plain versions")
    errs = check_kernels(torch, tlut, quantize, collectives, gemv_pim, paged_attention,
                         paged_prefill, args.seed)
    errs["gemv_pim_float"] = max(errs["gemv_pim_float"],
                                 check_gemv_grid(torch, tlut, gemv_pim, args.seed))
    errs["paged_attention"] = max(errs["paged_attention"],
                                  check_decode_grid(torch, tlut, quantize, paged_attention,
                                                    args.seed))
    errs["paged_prefill_attention"] = max(errs["paged_prefill_attention"], check_prefill_grid(
        torch, tlut, quantize, paged_prefill, args.seed))
    errs["paged_attention"] = max(errs["paged_attention"],
                                  check_wide_decode(torch, tlut, quantize, paged_attention,
                                                    args.seed))
    errs["paged_attention_split"] = max(errs["paged_attention_split"], check_split_planted(
        torch, tlut, quantize, paged_attention, args.seed))
    errs.update(check_quant_kernels(torch, quant, tlut, gemv_pim, args.seed))
    errs.update(check_dense_kernels(torch, tlut, quantize, attn, paged_attention, softmax_lut,
                                    layernorm_lut, lut_interp, args.seed))
    cfg = gpt2_medium.config()
    params = api.init_params(cfg, seed=args.seed, device="cuda")
    qparams = quantize.quantize_params_int8(params)
    times = time_kernels(torch, F, params, cfg, gemv_pim, paged_attention,
                         paged_prefill, args.seed)
    times.update(time_long_kernels(torch, F, cfg, quantize, collectives, paged_attention,
                                   args.seed))
    quant_times, wquant_ms = time_quant_kernels(torch, quant, gemv_pim, params, qparams,
                                                cfg, args.seed)
    times.update(quant_times)
    times.update(time_dense_kernels(torch, F, cfg, tlut, attn, softmax_lut, layernorm_lut,
                                    lut_interp, args.seed))
    model_times = time_model_kernels(torch, F, gemv_pim, paged_attention, paged_prefill,
                                     args.seed)

    kernels, mods, plain = serving_handles(torch)

    def counted(path: str, drive, path_kernels):
        """Launch counts of one main path: every count set to 0 just before
        it is driven and read just after; each of its kernels must have
        run."""
        for k in kernels.values():
            k.launches = 0
        result = drive()
        counts = {name: k.launches for name, k in kernels.items()}
        log(f"  launches over the {path} drains: {counts}")
        missing = [n for n in path_kernels if counts[n] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the {path} path: {missing}")
        return result, counts

    log("== 4. serve GPT-2 medium (full width, random weights)")
    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(2, cfg.vocab, size=int(n)) for n in rng.randint(32, 129, size=8)]
    new_tokens = 32
    runs, counts_256 = counted("max_len 256", lambda: {
        mode: serve(torch, mods, params, cfg, prompts, new_tokens, card, label=mode,
                    mode=mode) for mode in ("exact", "lut")},
        ["gemv_pim_float", TC, "paged_attention", "paged_prefill_attention",
         "layernorm_lut"])
    for mode, (eng, done, first, _) in runs.items():
        sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode))
        check_first_logits(torch, F, params, cfg, sal, prompts, done, first, mode, "fp",
                           quant, quantize, plain)
    model_ms = {mode: time_model(torch, api, params, cfg,
                                 SalPimEngine.create(SalPimConfig(nonlinear_mode=mode)),
                                 prompts, card) for mode in ("exact", "lut")}

    log("== 5. long context: max_len 1024, 4 requests of 896..960 prompt tokens")
    long_prompts = [rng.randint(2, cfg.vocab, size=int(n)) for n in rng.randint(896, 961, size=4)]
    drains = [("1 fp exact", dict(fmt="fp")),
              ("2 fp exact K=4", dict(fmt="fp", kv_splits=4)),
              ("3 int8/bf16 exact K=4", dict(fmt="int8/bf16", kv_splits=4)),
              ("4 int4/bf16 lut K=4", dict(fmt="int4/bf16", kv_splits=4, mode="lut"))]
    long_runs, counts_1024 = counted("max_len 1024", lambda: {
        label: serve(torch, mods, params, cfg, long_prompts, new_tokens, card, label=label,
                     max_len=1024, **kw) for label, kw in drains},
        ["gemv_pim_float", TC, "paged_attention", "paged_prefill_attention",
         "paged_attention_split", "merge_partials", "layernorm_lut"])
    (_, d1, _, _), (_, d2, _, _) = long_runs[drains[0][0]], long_runs[drains[1][0]]
    same = sum(a == b for u in d1 for a, b in zip(d1[u].generated, d2[u].generated))
    prefix = [next((i for i, (a, b) in enumerate(zip(d1[u].generated, d2[u].generated))
                    if a != b), new_tokens) for u in sorted(d1)]
    log(f"  drain 2 (kv_splits=4) shares {same}/{len(long_prompts) * new_tokens} greedy "
        f"tokens with drain 1 (one walk); common prefix per request {prefix}")
    step_ms = {}
    for label, kw in drains:
        eng, done, first, _ = long_runs[label]
        mode = kw.get("mode", "exact")
        sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode,
                                               kv_splits=kw.get("kv_splits")))
        check_first_logits(torch, F, params, cfg, sal, long_prompts, done, first, label,
                           kw["fmt"], quant, quantize, plain)
        step_ms[label] = time_long_decode(torch, api, params, cfg, sal, kw["fmt"], label, card)

    log("== 6. quantized linear datapaths: max_len 256, phase 4's 8 requests")
    # (label, weights, SalPimConfig knobs, pool format, the GEMV kernel that
    # carries every linear)
    qdrains = [("q1 int8 weights, int8 pools", qparams, dict(), "int8/f32",
                "gemv_pim_int8_linear"),
               ("q2 fixed16", params, dict(quant="fixed16"), "fp", "gemv_pim_fixed_linear"),
               ("q3 int8 per call, lut", params, dict(quant="int8", mode="lut"), "fp",
                "gemv_pim_int8_linear")]
    qruns, counts_q = counted("quantized max_len 256", lambda: {
        label: serve(torch, mods, p, cfg, prompts, new_tokens, card, label=label, fmt=fmt,
                     gemv=gemv, **kw) for label, p, kw, fmt, gemv in qdrains},
        ["gemv_pim_int8_linear", TC8L, "gemv_pim_int8", TC8, "quantize_int8_rows",
         "gemv_pim_fixed_linear", TCF,
         "paged_attention", "paged_prefill_attention", "layernorm_lut"])
    check_quant_step_ops(torch, api, params, qparams, cfg, SalPimConfig, SalPimEngine)
    _, exact_done, _, _ = runs["exact"]
    for label, p, kw, fmt, _ in qdrains:
        _, done, first, _ = qruns[label]
        sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=kw.get("mode", "exact"),
                                               quant=kw.get("quant", "none")))
        check_first_logits(torch, F, p, cfg, sal, prompts, done, first, label, fmt, quant,
                           quantize, plain)
        same = sum(a == b for u in done for a, b in zip(done[u].generated,
                                                        exact_done[u].generated))
        log(f"  serve[{label}] shares {same}/{len(prompts) * new_tokens} greedy tokens with "
            "phase 4's exact drain (fp weights and pools; reported, not a gate)")
        model_ms[label] = time_model(torch, api, p, cfg, sal, prompts, card, label, fmt)
    q1, q3 = model_ms[qdrains[0][0]], model_ms[qdrains[2][0]]
    log(f"  q3 quantizes every weight on every call: {wquant_ms['int8']:.3f} ms of device "
        f"time a decode step (the quantize_int8_rows kernel alone, phase 3; plain "
        f"{wquant_ms['int8_plain']:.3f} ms); its device decode step "
        f"{q3['dev_dec']:.2f} ms against q1's {q1['dev_dec']:.2f} ms with pre-quantized "
        f"weights (q1 also differs in its int8 pools and exact nonlinearities); q2's "
        f"device decode step {model_ms[qdrains[1][0]]['dev_dec']:.2f} ms quantizes in its "
        f"kernel (an eager Q.12 quantization of the weights took {wquant_ms['fixed16']:.3f} "
        "ms a step)")

    log("== 7. dense cache: generate() and ServingEngine(paged=False)")
    gen_prompts = np.stack([rng.randint(2, cfg.vocab, size=128) for _ in range(4)])
    cfg8 = dataclasses.replace(cfg, kv_dtype="int8")
    # (label, model config: fp or int8 arena, nonlinear mode, prompts, max_len,
    # the paged drain whose tokens it is set beside)
    dense_drains = [("d1 exact", cfg, "exact", prompts, 256, runs["exact"]),
                    ("d2 lut", cfg, "lut", prompts, 256, runs["lut"]),
                    ("d3 int8 arena", cfg8, "exact", prompts, 256, runs["exact"]),
                    ("d4 exact 1024", cfg, "exact", long_prompts, 1024,
                     long_runs[drains[0][0]])]

    def drive_dense():
        out = {}
        for mode in ("exact", "lut"):
            sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode))
            out[mode] = drive_generate(torch, generate, GenConfig, kernels, params, cfg, sal,
                                       gen_prompts, new_tokens)
        for label, c, mode, ps, ml, _ in dense_drains:
            out[label] = serve_dense(torch, mods, params, c, ps, new_tokens, card,
                                     label=label, mode=mode, max_len=ml)
        return out

    dense_runs, counts_dense = counted("dense", drive_dense, [
        "gemv_pim_float", TC, "decode_attention", "layernorm_lut", "softmax_lut"])
    gen_toks = torch.as_tensor(gen_prompts, device="cuda")
    for mode in ("exact", "lut"):
        sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode))
        logits, _ = api.prefill(params, {"tokens": gen_toks}, cfg, sal, max_len=129)
        worst, agree = 0.0, 0
        for b in range(len(gen_prompts)):
            want = plain_prefill_logits(torch, F, params, cfg, sal, gen_prompts[b], quant,
                                        quantize, plain, "dense")
            worst = max(worst, float((logits[b].float() - want).abs().max()
                                     / want.abs().max()))
            agree += int(int(torch.argmax(want)) == int(dense_runs[mode][b, 0]))
        log(f"  generate[{mode}] first logits vs plain one-shot prefill (dense): max |diff| "
            f"/ max |logit| = {worst:.3e} (limit {FIRST_LOGITS_LIMIT:.0e}); first-token "
            f"agreement "
            f"{agree}/{len(gen_prompts)}")
        if worst > FIRST_LOGITS_LIMIT:
            raise AssertionError(f"generate[{mode}]: first logits differ by {worst:.3e}")
    dense_ms = {}
    for label, c, mode, ps, ml, paged_run in dense_drains:
        _, done, first, _ = dense_runs[label]
        sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode))
        check_first_logits(torch, F, params, c, sal, ps, done, first, label, "dense", quant,
                           quantize, plain)
        paged_done = paged_run[1]
        same = sum(a == b for u in done for a, b in zip(done[u].generated,
                                                        paged_done[u].generated))
        log(f"  serve[{label}] shares {same}/{len(ps) * new_tokens} greedy tokens with the "
            f"paged {mode} drain on the same requests (reported, not a gate)")
        lens = [128, 137, 151, 160] if ml == 256 else [960, 981, 1003, 1020]
        dense_ms[label] = time_dense_decode(torch, api, params, c, sal, ml, lens, label, card)
    admission_ms = {mode: time_dense_admission(
        torch, api, params, cfg, SalPimEngine.create(SalPimConfig(nonlinear_mode=mode)), 128,
        256, mode, card) for mode in ("exact", "lut")}

    log("== 8. qwen2-1.5B at full width (28 layers, d 1536, 12/2 heads, head_dim 128, "
        "d_ff 8960, vocab 151936, bf16, random weights)")
    from repro_torch.configs import get_config
    qcfg = get_config("qwen2_1_5b")
    qw = api.init_params(qcfg, seed=args.seed, device="cuda")
    qw_q1 = quantize.quantize_params_int8(qw)
    n_params = param_count(qw)
    log(f"  {n_params / 1e9:.2f} B parameters, {2 * n_params / 2 ** 30:.1f} GiB in bf16")
    q_prompts = [rng.randint(2, qcfg.vocab, size=int(n)) for n in rng.randint(32, 129, size=8)]
    # (label, weights, serve's options)
    q_drains = [("qwen2 exact", qw, dict()), ("qwen2 lut", qw, dict(mode="lut")),
                ("qwen2 exact K=4 max_len 1024", qw, dict(max_len=1024, kv_splits=4)),
                ("qwen2 q1 int8 weights, int8 pools", qw_q1,
                 dict(fmt="int8/f32", gemv="gemv_pim_int8_linear"))]
    q_runs, counts_qwen = counted("qwen2-1.5b", lambda: {
        label: serve(torch, mods, p, qcfg, q_prompts, new_tokens, card, label=label, **kw)
        for label, p, kw in q_drains},
        ["gemv_pim_float", TC, "paged_attention", "paged_prefill_attention",
         "paged_attention_split", "merge_partials", "gemv_pim_int8_linear", TC8L,
         "gemv_pim_int8", TC8, "quantize_int8_rows", "layernorm_lut"])
    for label, p, kw in q_drains:
        _, done, first, _ = q_runs[label]
        sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=kw.get("mode", "exact")))
        check_first_logits(torch, F, p, qcfg, sal, q_prompts, done, first, label,
                           kw.get("fmt", "fp"), quant, quantize, plain)
    qwen_ms = {mode: time_model(torch, api, qw, qcfg,
                                SalPimEngine.create(SalPimConfig(nonlinear_mode=mode)),
                                q_prompts, card, label=f"qwen2 {mode}")
               for mode in ("exact", "lut")}
    del qw, qw_q1, q_runs

    log("== 9. gemma2-2B and h2o-danube3-4B at full width, 2 layers")
    # Three prompts of 32..128 tokens and one of 4200, past the 4096-token
    # sliding window of danube's every layer and gemma2's local ones.
    gd_prompts = [rng.randint(2, 32000, size=int(n)) for n in rng.randint(32, 129, size=3)]
    gd_prompts.append(rng.randint(2, 32000, size=4200))
    gd_runs = {}

    def drive_gd():
        out = {}
        for name in ("gemma2_2b", "h2o_danube3_4b"):
            full = get_config(name)
            mcfg = dataclasses.replace(full, n_layers=2)
            log(f"  {full.name}: the published widths (d {full.d_model}, {full.n_heads}/"
                f"{full.n_kv_heads} heads, head_dim {full.head_dim}, d_ff {full.d_ff}, vocab "
                f"{full.vocab}), depth cut from {full.n_layers} to {mcfg.n_layers} layers; "
                f"random weights; prompts of {[len(p) for p in gd_prompts]} tokens")
            w = api.init_params(mcfg, seed=args.seed, device="cuda")
            for mode in ("exact", "lut"):
                label = f"{name} {mode}"
                out[label] = (mcfg, w, mode, serve(torch, mods, w, mcfg, gd_prompts, new_tokens,
                                                   card, label=label, mode=mode, max_len=4352))
        return out

    gd_runs, counts_gd = counted("gemma2-2b / h2o-danube3-4b", drive_gd, [
        "gemv_pim_float", TC, "paged_attention", "paged_prefill_attention", "layernorm_lut",
        "lut_interp"])
    for label, (mcfg, w, mode, (_, done, first, _)) in gd_runs.items():
        sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode))
        check_first_logits(torch, F, w, mcfg, sal, gd_prompts, done, first, label, "fp",
                           quant, quantize, plain)
    del gd_runs
    torch.cuda.empty_cache()

    log("== 10. nemotron-4-340B at full width, 1 layer")
    full = get_config("nemotron_4_340b")
    ncfg = dataclasses.replace(full, n_layers=1)
    nw = api.init_params(ncfg, seed=args.seed, device="cuda")
    n_params = param_count(nw)
    n_prompts = [rng.randint(2, ncfg.vocab, size=int(n)) for n in (40, 97)]
    plan = layernorm_lut.layernorm_plan(4, ncfg.d_model, 2)
    log(f"  {full.name}: the published widths (d {full.d_model}, {full.n_heads}/"
        f"{full.n_kv_heads} heads, head_dim {full.head_dim}, d_ff {full.d_ff} squared ReLU, "
        f"vocab {full.vocab}), depth cut from {full.n_layers} to 1 layer: "
        f"{n_params / 1e9:.2f} B parameters, {2 * n_params / 2 ** 30:.1f} GiB in bf16; "
        f"the norm's plan at (4, {ncfg.d_model}) bf16 {plan} (chunks 0: streamed)")
    if plan[0] != 0:
        raise AssertionError("nemotron's norms are not on the streamed path")
    n_runs, counts_nem = counted("nemotron-4-340b", lambda: serve(
        torch, mods, nw, ncfg, n_prompts, new_tokens, card, label="nemotron exact"),
        ["gemv_pim_float", TC, "paged_attention", "paged_prefill_attention", "layernorm_lut"])
    _, done, first, _ = n_runs
    check_first_logits(torch, F, nw, ncfg, SalPimEngine.create(SalPimConfig()), n_prompts,
                       done, first, "nemotron exact", "fp", quant, quantize, plain)
    del nw, n_runs
    torch.cuda.empty_cache()

    log("== 11. share/spec: prefix sharing and speculative decoding (GPT-2 medium, "
        "qwen2-1.5B)")
    qw = api.init_params(qcfg, seed=args.seed, device="cuda")
    counts_ss, verify_ms = share_spec_phase(
        torch, F, np, mods, plain, counted, quant, quantize, params, cfg, prompts, qw, qcfg,
        q_prompts, new_tokens, card, rng)
    del qw
    torch.cuda.empty_cache()

    log("== 12. result")
    all_counts = [("max_len 256", counts_256), ("max_len 1024", counts_1024),
                  ("quantized max_len 256", counts_q), ("dense", counts_dense),
                  ("qwen2-1.5b", counts_qwen), ("gemma2-2b / h2o-danube3-4b", counts_gd),
                  ("nemotron-4-340b", counts_nem), ("share/spec", counts_ss)]
    rows = []
    for name in SOURCE:
        t = times[name]
        src, replaces = SOURCE[name]
        # The fixed16 and int8 kernels run through two entries each: the
        # GEMV on quantized operands and, on the main path, the linear
        # layer that quantizes x (and, for fixed16, w) in its load path.
        entries = [name] + {"gemv_pim_fixed": ["gemv_pim_fixed_linear"],
                            "gemv_pim_int8": ["gemv_pim_int8_linear"]}.get(name, [])
        by_path = {path: sum(c[e] for e in entries) for path, c in all_counts}
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
               "launches": sum(by_path.values()), "launches_by_path": by_path}
        if name in NOT_TPU_KERNELS:
            row["tpu_kernel"] = False
        tc_keys = {"gemv_pim_float": [TC], "gemv_pim_int8": [TC8, TC8L],
                   "gemv_pim_fixed": [TCF]}
        if name in tc_keys:
            row["tc_launches"] = sum(c[k] for _, c in all_counts for k in tc_keys[name])
        if name == "gemv_pim_float":
            row["chunk_145_launches"] = times["gemv_chunk"]
        if name == "paged_attention":
            row["wide_131072_keys"] = times["wide"]
        if name == "lut_interp":
            row["launch_floor_ms"] = t["launch_floor_ms"]
        if name == "gemv_pim_float":
            row["qwen2_decode_step"] = model_times["gemv_pim_float"]
        if name in ("paged_attention", "paged_prefill_attention"):
            form = "decode" if name == "paged_attention" else "prefill"
            row["model_heads"] = {m: model_times[f"{m} heads"][form]
                                  for m, _, _, _ in MODEL_HEADS}
        rows.append({**row,
                     "max_abs_err": errs[name],
                     "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                     "timed_at": t["shape"]})
    log(f"  long-context decode step, device ms: "
        + ", ".join(f"[{k}] {v[1]:.2f}" for k, v in step_ms.items()))
    log(f"  dense decode step, device ms: "
        + ", ".join(f"[{k}] {v['device']:.2f}" for k, v in dense_ms.items()))
    log(f"  dense 128-token admission, device ms: "
        + ", ".join(f"[{k}] {v:.3f}" for k, v in admission_ms.items()))
    log(f"  qwen2-1.5B decode step / 64-token chunk, device ms (host clock ms): "
        + ", ".join(f"[{k}] {v['dev_dec']:.2f} ({v['dec']:.2f}) / {v['dev_chunk']:.2f} "
                    f"({v['chunk']:.2f})" for k, v in qwen_ms.items()) + f" ({card})")
    log(f"  verify pass (4 slots x {VERIFY_K + 1}) / decode step (4 slots), device ms (host "
        f"clock ms): "
        + ", ".join(f"[{k}] {v['verify_dev']:.3f} ({v['verify_host']:.2f}) / "
                    f"{v['decode_dev']:.3f} ({v['decode_host']:.2f})"
                    for k, v in verify_ms.items()) + f" ({card})")
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
