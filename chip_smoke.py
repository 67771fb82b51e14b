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
 12. slo/swap — the SLO scheduler with preempt-and-swap on the paged
              engine, GPT-2 medium at full width (4 slots, page 16, 64-token
              chunks, max_len 256, prefix sharing): a request's 9 pages
              swapped out and back into 9 other pages in reverse order on
              fp, int8/f32 and int4/bf16 pools (0 bytes off, payload and
              scale rows; the next decode step's logits bit for bit those
              on an untouched copy; swap-out and swap-in on the host clock);
              `SloScheduler` drains of phase 4's 8 requests (priority 1, 64
              new tokens) and 4 urgent ones arriving at decode step 3
              (priority 0, 32 new tokens, two on one 64-token prefix) on 24
              pages, fp exact, int8/f32 LUT and int4/bf16 LUT: preemptions,
              swap-ins and mid-prefill aborts (one at the urgent arrival),
              every step's launches as phase 4's, first logits, and every
              greedy token equal to a calm FIFO drain of the same requests
              on the default pool; a pin drain (`pin_budget_pages=8`, two
              waves of 3 requests on one 64-token prefix: pages pinned
              between the waves, prompt tokens saved on the second); an
              `ngram` k=4 drain under the same pressure (token share with
              its calm FIFO drain reported); each drain's stats();
 13. telemetry — the observability layer and the roofline cost model on
              the paged and dense engines, GPT-2 medium at full width (4
              slots, page 16, 64-token chunks, max_len 256): phase 4's 8
              requests exact with telemetry off, on, and on with
              `annotate=True` under `torch.profiler` (CPU and CUDA
              activity); an `ngram` k=4 drain with sharing and phase 12's
              SLO drain on its 24 pages, each off and on under the
              profiler; a dense drain on under the profiler, held to phase
              7's d1. Gates: greedy tokens and first logits bit for bit off
              and on, every step's launches equal off and on (and as phase
              4 expects them), the disabled registry empty after its drain,
              each on drain's Chrome trace balanced and its snapshot's
              counters equal to stats(), `h100` detected, decode
              memory-bound in `stats()["roofline"]`, one profiler scope a
              step and a model call, each holding at least its call's
              counted kernels; reported: each drain's roofline (modeled
              bytes and FLOPs, achieved GB/s on the host clock), one decode
              step's traced breakdown (device us under each scope against
              its host us), host ms a step and a token off and on; then
              `python -m repro_torch.launch.serve --full --requests 8
              --slots 4` must finish its 8 requests;
 14. moe    — the MoE family on the paged engine and the dense arena:
              olmoe-1B-7B at full width, 8 of its 16 layers (64 experts top-8,
              expert d_ff 1024, cap factor 1.25; bf16 random weights) serves
              the first 6 of phase 4's requests (MODEL_PHASE_REQUESTS; 4
              slots, two requests in a reused slot, page 16, 64-token chunks,
              max_len 256) exact, LUT, with `quantize_params_int8` weights on
              int8/bf16 pools (q1), on the dense arena and with `ngram` k=4
              and sharing; phi-3.5-MoE at its published widths (16 experts
              top-2, expert d_ff 6400, LayerNorm), 2 layers, exact and LUT.
              Launches checked every step: a decode step's linears a
              `gemv_pim_float` each, the f32 routers (one a layer) on the
              CUDA cores and the rest on the tensor cores, in LUT mode the
              experts' SiLU one lut_interp a layer. Each drain runs again
              under `plain_ops` (no kernel launched), its prompts routed to
              the kernel drain's top-k experts (`RoutingRecorder`), and its
              first logits are held to the kernel drain's within
              FIRST_LOGITS_LIMIT: which tokens an expert drops depends on
              every token of a call, and random-weight routing is chaotic
              (one near-tie flip moves a token enough to flip more), so a
              one-shot prefill (another grouping), a free-running plain
              drain and a verify pass against decode steps are reported,
              not gated; the top-k sets the plain path's own weights would
              have chosen otherwise are counted. Then olmoe's decode step
              and chunk on the host clock and the device beside the bound of
              streaming every weight, and lut_interp and the f32 routers at
              the MoE shapes;
 15. ssm/hybrid — the SSM and hybrid families on the dense cache (the
              reference serves them on nothing else): mamba2-370m (d
              1024, state 128; 24 of its 48 Mamba2 layers) and
              zamba2-1.2B (d 2048, state 64, one shared attention + GeGLU
              block before each segment of 6; 19 of its 38 layers) at full
              width, depths cut (CUT_LAYERS), bf16 random weights,
              each serving the first 6 of phase 4's requests
              (MODEL_PHASE_REQUESTS; two in a reused slot) through
              ServingEngine(paged=False) (4 slots, max_len 256) exact and
              LUT, mamba2 also with `quantize_params_int8` weights (q1),
              and `generate()` on 4 prompts of 128 tokens, exact. Gates:
              every request finishes and every slot parks at length 0;
              every step's launches (at full depth mamba2: 97 GEMVs, all
              on the tensor cores, and 97 layernorm_lut a decode step, in
              LUT mode 144 lut_interp, no attention kernel; zamba2: 126
              GEMVs, 91 norms, 7 decode_attention, in LUT mode 114
              lut_interp and 7 softmax_lut an admission; q1: 97 one-launch
              int8 linears a step; at the cut depths fewer, as
              `dense_expect` counts them); within FIRST_LOGITS_LIMIT, every stage of each
              prompt's prefill (a Mamba2 layer, a shared-block
              application, the head) through the kernels against the
              plain versions on the same input, each request's first
              logits and its logits after its first decode step against
              a batch of one through the kernels (the engine's state
              handoff), and q1's first logits against a one-shot plain
              prefill; the model's state handoff in f32 within
              F32_HANDOFF_LIMIT. At this depth one bf16 step of the
              embeddings moves the plain path's own first logits past
              FIRST_LOGITS_LIMIT, so the bf16 one-shot comparisons with
              the plain path and across the prefill/decode boundary are
              reported beside that measure. Reported too: each model's
              decode step and
              128-token admission on the host clock and on the device
              beside the step's bound and the eager PyTorch operations a
              step, each drain's roofline, and `python -m
              repro_torch.launch.serve --arch mamba2-370m --full
              --requests 8 --slots 4`, which must finish. Phase 3 holds
              and times the kernels at these models' shapes
              (`time_ssm_kernels`);
 16. encdec — whisper-large-v3 at its published widths and depth (32
              encoder + 32 decoder layers, d 1280, 20 heads x 64, d_ff
              5120, vocab 51866, enc_seq 1500; bf16 random weights, 1.64 B
              parameters) through generate(extra_inputs={"frames": ...}),
              its one entry point (ServingEngine refuses the family, as the
              reference cannot serve it there): frames (4, 1500, 1280) from
              the seed, 4 prompts of 32..128 tokens, 32 new ones, exact,
              LUT and q1. Gates: every call's launches (a decode step 257
              GEMVs, 64 decode_attention over the self and the 1500-key
              cross arenas, 97 norms; an admission 513 GEMVs, 162 norms, 96
              softmax_lut in LUT mode; q1 on the int8 routes), the cross
              arenas bit for bit the admission's after the last step;
              within FIRST_LOGITS_LIMIT each stage of the admission and of
              the first decode step through the kernels against the plain
              versions on the same input, each sequence's first and
              first-decode logits against a batch of one, and q1's first
              logits against a one-shot plain prefill (the others'
              reported). Reported: the decode step and the admission on
              the host clock and the device beside their bounds, and the
              eager operations a step. Phase 3 holds and times the kernels
              at its shapes (`time_encdec_kernels`: the GEMV and q1's int8
              linear at M 6000, decode_attention over the cross and self
              arenas, softmax_lut on 120000 rows of 1500 keys, layernorm_lut
              at (6000, 1280) with beta);
 17. vlm    — qwen2-vl-2B's text path (qwen2's widths and 28 layers, M-RoPE
              sections (16, 24, 24)): phase 4's 8 requests through the
              paged engine, exact, with phase 4's checks, and generate() on
              4 prompts of 128 tokens; first logits against a one-shot
              plain prefill; its decode step and chunk timed;
 18. train  — GPT-2 medium at full width and depth (bf16, remat "block")
              on batches of 8 x 1024 tokens: the three backward kernels
              (lut_interp_backward bit for bit on (8192, 4096) bf16,
              layernorm_lut_backward on (8192, 1024) bf16 exact and LUT,
              softmax_lut_backward on (8*16*1024, 1024) f32 causal) against
              their plain twins and timed; one step's loss and gradients,
              exact and LUT, through the kernels against the plain path;
              `run_training` in LUT mode, 4 AdamW steps, and a resume from
              its step-2 checkpoint against the straight run;
 19. mesh   — tensor-parallel paged serving (`EngineConfig(mesh=...)`):
              `paged_attention` at a rank's shapes (half the heads; GPT-2's
              single walk at 128..160 keys and split at 960..1024, qwen2's
              g 6 x 128 at one kv head) planned on the model's kv heads, bit
              for bit the one-device call's heads, and on the rank's own
              (reported), timed in CUDA graphs; then 2 ranks spawned on the
              one card (one process each, gloo, `launch/mesh.World`), each
              running on a ("model",) mesh: GPT-2 medium at full width and
              depth on phase 4's requests exact, LUT and on int8/bf16 pools,
              on phase 5's at max_len 1024 with kv_splits=4 and phase 12's
              SLO drain u1, qwen2-1.5B exact on phase 8's, and olmoe-1B-7B
              with `moe_impl="shardmap"` (4 requests, 16 new tokens) — every
              step's launches checked on every rank (a rank launches the
              one-device counts on its 8 of 16 heads). Gates: the ranks in
              lockstep (tokens, first and first-decode logits bit for bit,
              counters); each GPT-2 and qwen2 drain token for token the
              one-device drain, its first and first-decode logits bit for
              bit and its counters (preemptions, swap-ins, ...) equal, a
              rank's pools half the one-device bytes; olmoe's first logits
              within FIRST_LOGITS_LIMIT of a one-device drain (the psum adds
              in another order; token share reported). Reported: a rank's
              decode step on the host clock and the host time of its
              gather_heads calls;
 20. mesh train: GPT-2 medium whole (bf16, remat, 8 x 1024 tokens) on a
     (2, 2) ("data", "model") world of 4 ranks of the one card (gloo),
     parameters and moments cut by param_pspecs(fsdp=True): one exact and
     one LUT AdamW step each within MESH_TRAIN_GAP of the one-device step
     on the same weights and batch (loss and global grad norm), every
     rank's launches equal to the one-device step's at every step, each
     rank's parameter and moment bytes its spec's slices; run_training
     LUT, 3 steps saving at step 2, resumed from it bit for bit on every
     rank, its step-3 checkpoint restored here on one device bit for bit
     the gathered shards; compressed_psum (bit for bit its numpy algebra),
     merge_partial_softmax and pipeline_forward on CUDA tensors; then
     qwen2-1.5B whole on (1, 2), one exact step. Reported: a rank's step
     on the host clock, its collectives' share (synchronised, by kind),
     each rank's peak memory beside the one-device step's;
 21. mesh dense (run by phase 19's ranks, reported here): the dense decode
     on a mesh, api.decode_step(..., mesh=) on a rank's shard of a dense
     cache (shard_cache). GPT-2 medium whole, phase 4's 8 requests
     prefilled densely at max_len 256, 32 greedy steps on a (1, 2)
     ("data", "model") mesh (the KV heads on "model"): tokens and every
     rank's cache slices bit for bit the one-device dense decode's;
     h2o-danube3-4B at its published widths, 2 layers, B 1, a 4600-token
     prompt past its window, max_len 8192, 32 steps on (2, 1) fed the
     one-device greedy tokens: the sequence on ("data", "model"), each
     rank's decode_attention_partials merged by merge_partial_softmax,
     each step's logits within MESH_DENSE_GAP of one device's, layer 0's
     cache slices bit for bit, layer 1's within bf16's tolerance; the
     path's launches (every count set to 0 before the mesh decodes, the
     one-device references run first). Reported: the tokens shared, a
     rank's step on the host clock;
 22. the kernels line, a JSON object with each kernel's error, times,
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
the float and int8 GEMVs and the int8 linear layer at M = 20. It holds
decode_attention_partials to its plain version at phase 21's rank shapes
(every slice at its key offset, exact and LUT, the window on and off) and
a whole-arena slice, normalised, bit for bit to decode_attention, and
times it on danube's 4096-key slice beside SDPA on the slice's keys.

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
import bisect
import collections
import contextlib
import dataclasses
import gc
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
_T0 = time.perf_counter()
# The requests a drain of phases 14-15 serves: the first 6 of phase 4's 8,
# so that two of them enter a slot another request used (the dense state's
# reset and the pages' recycling on reuse, each request's first logits
# gated) while the script with phase 20 keeps inside its time limit.
MODEL_PHASE_REQUESTS = 6
# Depths cut to keep the whole script inside its time limit (full width
# kept): olmoe-1B-7B in phases 14 and 19 (of 16 layers), mamba2-370m and
# zamba2-1.2B in phase 15 (of 48 and 38).
CUT_LAYERS = {"olmoe_1b_7b": 8, "mamba2_370m": 24, "zamba2_1_2b": 19}


def cut_config(get_config, name: str):
    """The model's published config, its depth cut to CUT_LAYERS[name]."""
    return dataclasses.replace(get_config(name), n_layers=CUT_LAYERS[name])
# CUDA cores f32; int8 dense tensor cores. An int16 product is four 8-bit
# ones (hi.hi, hi.lo, lo.hi, lo.lo byte planes), which the fixed16 kernel
# runs on the int8 tensor cores: a quarter of their rate. The bf16 peak and
# the memory rate are the roofline cost model's `h100` spec (bound_ms).
PEAK_FLOPS = {"float32": 67e12, "int8": 1979e12, "int16": 1979e12 / 4}
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
    # The same walk over one rank's slice of a sequence-sharded arena,
    # leaving the partials the mesh decode merges across the ranks.
    "decode_attention_partials": ("src/repro_torch/kernels/csrc/decode_attention.cu",
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
    # Not TPU kernels: the gradients the JAX package takes by XLA's autodiff
    # of its LUT functions (apply_table, Nonlinear.layernorm, softmax).
    "lut_interp_backward": ("src/repro_torch/kernels/csrc/backward.cu",
                            "src/repro/core/lut.py:121"),
    "layernorm_lut_backward": ("src/repro_torch/kernels/csrc/backward.cu",
                               "src/repro/core/nonlinear.py:110"),
    "softmax_lut_backward": ("src/repro_torch/kernels/csrc/backward.cu",
                             "src/repro/core/nonlinear.py:98"),
}
NOT_TPU_KERNELS = {"quantize_int8_rows", "lut_interp_backward", "layernorm_lut_backward",
                   "softmax_lut_backward"}
# The model's GEMV shapes (R, C): q/k/v/o projections, w_up, w_down, LM head.
QUANT_SHAPES = [(1024, 1024), (4096, 1024), (1024, 4096), (50257, 1024)]
# The RoPE models' attention shapes: (model, g = query heads a kv head,
# head_dim, the options their layers pass: gemma2-2B's softcap and
# 4096-token window, h2o-danube3-4B's window).
MODEL_HEADS = [("qwen2-1.5b", 6, 128, {}),
               ("gemma2-2b", 2, 256, {"softcap": 50.0, "window": 4096}),
               ("h2o-danube3-4b", 4, 120, {"window": 4096}),
               ("nemotron-4-340b", 12, 192, {}),
               ("olmoe-1b-7b", 1, 128, {}), ("phi-3.5-moe", 4, 128, {})]
# Their linears (R, C): q, k/v, o, w_gate/w_up, w_down, LM head.
MODEL_GEMV_SHAPES = [
    (1536, 1536), (256, 1536), (8960, 1536), (1536, 8960), (151936, 1536),      # qwen2
    (2048, 2304), (1024, 2304), (2304, 2048), (9216, 2304), (2304, 9216),       # gemma2
    (256000, 2304),
    (3840, 3840), (960, 3840), (10240, 3840), (3840, 10240), (32000, 3840),     # danube
    (18432, 18432), (1536, 18432), (73728, 18432), (18432, 73728),              # nemotron
    (256000, 18432)]
# The MoE models' linears in bf16 (R, C): olmoe-1B-7B's q/k/v/o and LM head,
# phi-3.5-MoE's q/o, k/v and LM head; their f32 routers (E, d) on the CUDA
# cores. The experts are batched products (torch.bmm), not GEMVs.
MOE_GEMV_SHAPES = [(2048, 2048), (50304, 2048), (4096, 4096), (1024, 4096), (32064, 4096)]
ROUTER_SHAPES = [(64, 2048), (16, 4096)]
# Pool formats: (kv_cache_dtype, kv_scale_dtype); fp pools hold q's dtype.
POOLS = {"fp": ("model", "float32"), "int8/f32": ("int8", "float32"),
         "int8/bf16": ("int8", "bfloat16"), "int4/bf16": ("int4", "bfloat16")}


def log(msg: str) -> None:
    """Print a line; a phase's header ("== ...") with the seconds since start."""
    if msg.startswith("== "):
        msg = f"{msg} [at {time.perf_counter() - _T0:.1f} s]"
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
    from repro_torch.serving.costmodel import HARDWARE_SPECS
    h100 = HARDWARE_SPECS["h100"]
    t_bytes = nbytes / h100.peak_bytes_per_sec
    t_ops = flops / (h100.peak_flops if dtype == "bfloat16" else PEAK_FLOPS[dtype])
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
    # The MoE models: their bf16 linears at the paths' widths (M 4 decode,
    # 20 verify, 64 chunk, up to 128 a dense admission) on the tensor
    # cores, and their f32 routers on the CUDA cores, no epilogue.
    moe_worst = {"bfloat16": 0.0, "float32": 0.0}
    moe_calls = 0
    for shapes, dtype in ((MOE_GEMV_SHAPES, torch.bfloat16), (ROUTER_SHAPES, torch.float32)):
        dname = str(dtype).split(".")[1]
        for R, C in shapes:
            w = (torch.randn((R, C), generator=gen, device=dev) * C ** -0.5).to(dtype)
            for M in (1, 4, 20, 64, 65, 128, 256):
                x = (torch.randn((M, C), generator=gen, device=dev) * 0.5).to(dtype)
                tc = fn.tc_launches
                got = fn(x, w)
                torch.cuda.synchronize()
                if (fn.tc_launches > tc) != (dtype == torch.bfloat16):
                    raise AssertionError(f"gemv {M}x{C}x{R} {dname} took the wrong route")
                moe_worst[dname] = max(moe_worst[dname], compare(
                    torch, f"gemv {M}x{C}x{R} {dname}", got, gemv_pim.gemv_pim_plain(x, w),
                    TOL[dname]))
                moe_calls += 1
            del w
    log(f"  gemv_pim_float over the MoE models' linears ({len(MOE_GEMV_SHAPES)} bf16 shapes "
        f"on the tensor cores, max_abs_err {moe_worst['bfloat16']:.3e}) and routers "
        f"({ROUTER_SHAPES} f32 on the CUDA cores, max_abs_err {moe_worst['float32']:.3e}) "
        f"at M 1/4/20/64/65/128/256: {moe_calls} launches (tol {TOL})")
    return max(max(worst.values()), model_worst, *moe_worst.values())


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


# Phase 21's rank shapes: h2o-danube3-4B at B 1 on 2 ranks, each holding
# 4096 of an 8192-position arena (8 kv heads x g 4 x head_dim 120), a
# 4600-token prompt past its 4096-token window; GPT-2 medium's 4 slots x 16
# heads x 64 over two 128-key slices of a 256 arena.
PARTIALS_CASES = [("h2o-danube3-4b", 1, 32, 8, 120, 8192, 2, [4633], {"window": 4096}),
                  ("h2o-danube3-4b", 1, 32, 8, 120, 8192, 2, [4633], {}),
                  ("gpt2-medium", 4, 16, 16, 64, 256, 2, [128, 137, 151, 160], {})]


def check_partials_kernel(torch, F, tlut, attn, seed):
    """`decode_attention_partials` against its plain version at phase 21's
    rank shapes (every slice of the arena at its key offset, exact and LUT,
    the window on and off; -inf where a slice holds no valid key), and a
    whole-arena slice normalised bit for bit `decode_attention` (one walk,
    two epilogues). Then its time on danube's first slice (the window's
    3559 valid keys of its 4096), beside the plain version, SDPA on the
    slice's valid keys (the yardstick) and the bound. Returns (max abs err,
    the kernels row's times)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    bank = tlut.LutBank.create(64)
    worst = 0.0
    for model, B, H, Hkv, D, S, n, lens, opts in PARTIALS_CASES:
        q = torch.randn((B, H, D), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((B, Hkv, S, D), generator=gen, device=dev).bfloat16()
                for _ in range(2))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        w = S // n
        err = 0.0
        for lut in (False, True):
            kw = dict(opts, exp_table=bank.exp if lut else None)
            for r in range(n):
                kk, vv = (t[:, :, r * w:(r + 1) * w].contiguous() for t in (k, v))
                got = attn.decode_attention_partials(q, kk, vv, lengths, key_offset=r * w, **kw)
                torch.cuda.synchronize()
                want = attn.decode_attention_partials_plain(q, kk, vv, lengths,
                                                            key_offset=r * w, **kw)
                for name, g, x in zip("mla", got, want):
                    if not torch.equal(torch.isneginf(g), torch.isneginf(x)):
                        raise AssertionError(f"decode_attention_partials {model} slice {r} "
                                             f"{name}: -inf where the plain version has none")
                    g, x = (torch.where(torch.isneginf(t), 0.0, t) for t in (g, x))
                    err = max(err, compare(torch, f"decode_attention_partials {model} slice {r} "
                                           f"{name} lut={lut}", g, x, TOL["float32"]))
            m, l, acc = attn.decode_attention_partials(q, k, v, lengths, key_offset=0, **kw)
            whole = attn.decode_attention(q, k, v, lengths, **kw)
            torch.cuda.synchronize()
            if not torch.equal((acc / torch.clamp(l, min=1e-9)).to(q.dtype), whole):
                raise AssertionError(f"decode_attention_partials {model} lut={lut}: the "
                                     "whole-arena slice, normalised, is not decode_attention's "
                                     "bits")
        worst = max(worst, err)
        log(f"  decode_attention_partials {model} B={B} H={H} Hkv={Hkv} D={D}, {n} slices "
            f"of {w} of a {S} arena, lengths {lens} {opts or ''}, bf16, exact/LUT: f32 "
            f"partials max_abs_err {err:.3e} (tol {TOL['float32']}) against the plain "
            "version; a whole-arena slice normalised: bit for bit decode_attention")

    # Time danube's first slice (window on) over one input set a layer.
    _, B, H, Hkv, D, S, n, lens, opts = PARTIALS_CASES[0]
    w, L = S // n, 8
    q = torch.randn((B, H, D), generator=gen, device=dev).bfloat16()
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    slices = [tuple(torch.randn((B, Hkv, w, D), generator=gen, device=dev).bfloat16()
                    for _ in range(2)) for _ in range(L)]
    lo, hi = lens[0] - opts["window"], min(lens[0], w)
    valid = [tuple(t[:, :, lo:hi].repeat_interleave(H // Hkv, dim=1).contiguous() for t in kv)
             for kv in slices]
    ms = time_graph(torch, lambda i: attn.decode_attention_partials(
        q, *slices[i], lengths, key_offset=0, **opts), L)
    plain = time_graph(torch, lambda i: attn.decode_attention_partials_plain(
        q, *slices[i], lengths, key_offset=0, **opts), L)
    lib = time_graph(torch, lambda i: F.scaled_dot_product_attention(
        q[:, :, None], *valid[i])[:, :, 0], L)
    keys = (hi - lo) * Hkv
    bnd, by = bound_ms(2 * keys * D * 2 + 2 * B * H * D + 4 * B * H * (D + 2) + 4 * B,
                       4 * (hi - lo) * H * D, "bfloat16")
    log(f"  decode_attention_partials [danube's rank 0 slice: 1 x 32 heads x 4096 keys, "
        f"{hi - lo} in the window]: {ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us, SDPA on "
        f"the slice's valid keys {lib * 1e3:.2f} us, bound {bnd * 1e3:.2f} us ({by})")
    row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
               shape=f"B=1 H=32 Hkv=8 D=120, a 4096-key slice of an 8192 arena at key "
               f"offset 0, length {lens[0]}, window 4096 ({hi - lo} valid keys), bf16; "
               "library: SDPA on the valid keys (normalised, not partials)")
    return worst, row


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
    Any dense model of the port: learned positions, RoPE or M-RoPE, LayerNorm or
    RMSNorm (1 + w with `rmsnorm_plus1`), GQA, the sliding window of each
    layer, softcaps, post-norms, a gated or plain MLP. Attention runs over
    a pool of format `fmt` (quantized per vector as the engine writes it)
    with the paged plain version or, in LUT mode with `online`, with the
    page walk the paged kernels compute
    (`paged_prefill_attention_online_plain`:
    its LUT algebra is not the dense LUT softmax's); with fmt="dense" it is
    the dense path's masked softmax attention (the LUT softmax's plain
    version in LUT mode)."""
    from repro_torch.models.rope import apply_rope, mrope_cos_sin, rope_cos_sin
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
    elif cfg.mrope_sections is not None:          # the text path: three equal streams
        cos, sin = mrope_cos_sin(torch.arange(S, device=dev)[None].expand(3, S), D,
                                 cfg.rope_theta, cfg.mrope_sections)
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


# Parameters the analytic count (ModelConfig.param_count, the JAX package's
# formula, which prices the roofline's weight stream) leaves out: learned
# positions (the decoder's, in whisper), LayerNorm shifts, gemma2's
# post-norms, a Mamba2 layer's conv bias and dt bias, and whisper's
# encoder's final norm.
UNCOUNTED = re.compile(r"^pos_embed$|/b$|^blocks/post_ln\d/|/conv_b$|/dt_bias$|^enc_norm/g$")


def check_param_count(tree, cfg, label: str) -> int:
    """The tensors' count against cfg.param_count(): equal once the
    UNCOUNTED tensors are set aside. Returns the tensors' count."""
    def leaves(t, path=""):
        for k, v in t.items():
            name = f"{path}/{k}" if path else k
            if isinstance(v, dict):
                yield from leaves(v, name)
            else:
                yield name, v.numel()

    n = param_count(tree)
    left_out = sum(c for name, c in leaves(tree) if UNCOUNTED.search(name))
    log(f"  {label}: {n} parameters in its tensors = the analytic count "
        f"{cfg.param_count()} + {left_out} it leaves out (positions, LayerNorm shifts, "
        "post-norms, conv and dt biases, an encoder's final norm)")
    if n != cfg.param_count() + left_out:
        raise AssertionError(f"{label}: {n} parameters, analytic {cfg.param_count()} + "
                             f"{left_out}")
    return n


def attention_layers(cfg) -> int:
    """Attention calls a pass: one a layer; none in the SSM family; one an
    application of the hybrid's shared block."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return -(-cfg.n_layers // cfg.hybrid_attn_every)
    return cfg.n_layers


def step_counts(cfg) -> tuple[int, int]:
    """(linears, norms) of one decode step or prefill chunk: q, k, v, o
    and the MLP's two or three a layer (an MoE layer's router: its experts
    are batched products, no GEMV) plus the LM head; two norms a layer
    (four with post-norms) plus the final one. A Mamba2 layer: in_proj and
    out_proj, the block norm and the gated norm; the hybrid's shared block
    counts at each application."""
    L, A = cfg.n_layers, attention_layers(cfg)
    mlp = 1 if cfg.family == "moe" else 2 + int(cfg.gated_mlp)
    norms = 2 + 2 * int(cfg.post_norms)
    if cfg.family in ("ssm", "hybrid"):
        return 2 * L + (4 + mlp) * A + 1, 2 * L + norms * A + 1
    return (4 + mlp) * L + 1, norms * L + 1


def router_act_counts(cfg, mode) -> tuple[int, int]:
    """(f32 router GEMVs, lut_interp launches) of one pass: an MoE model's
    router a layer, on the CUDA cores, and in LUT mode its experts' SiLU a
    layer (no GEMV epilogue carries it); in LUT mode a Mamba2 layer's conv
    SiLU, dt softplus and gate SiLU. (0, 0) for a dense model."""
    lut = mode == "lut"
    if cfg.family in ("ssm", "hybrid"):
        return 0, 3 * cfg.n_layers if lut else 0
    if cfg.family != "moe":
        return 0, 0
    return cfg.n_layers, cfg.n_layers if lut else 0


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
               "decode_attention_partials": attn.decode_attention_partials,
               "softmax_lut": softmax_lut.softmax_lut,
               "layernorm_lut": layernorm_lut.layernorm_lut,
               "lut_interp": lut_interp.lut_interp,
               "quantize_int8_rows": gemv_pim.quantize_int8_rows,
               "lut_interp_backward": lut_interp.lut_interp_backward,
               "layernorm_lut_backward": layernorm_lut.layernorm_lut_backward,
               "softmax_lut_backward": softmax_lut.softmax_lut_backward,
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
        # A page whose refcount reaches 0 (freed, or pinned) loses its
        # snapshot at once: preemption may free it and swap another
        # request's KV into it within one step.
        decref = eng.allocator._decref

        def spy_decref(page):
            decref(page)
            if eng.allocator.refcount(page) == 0:
                self.snaps.pop(page, None)
        eng.allocator._decref = spy_decref

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
            req = eng.active[eng.scheduler.select_prefill_slot(eng, cand)]
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
          gemv="gemv_pim_float", sharing=False, spec=None, drafter=None, gaps=None,
          scheduler=None, num_pages=None, priority=0, late=(), telemetry=None,
          on_step=None, plain=False, mesh=None):
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
    top-2 logit gap behind each greedy token (uid -> list).

    `scheduler` (an SloScheduler; None: FIFO) and `num_pages` (None: the fp
    byte budget) set the pool's policy and size; `prompts` are submitted at
    `priority`, and each entry (at, prompts, new tokens, priority) of `late`
    once `at` decode steps or verify passes have run (at None: once the
    engine has drained, `eng.between` then holding its stats() there).
    Every request must finish, every page, reservation and swap blob come
    back (pages the scheduler's pin budget keeps excepted);
    `eng.preempt_log` lists each preemption as (decode steps and verify
    passes run, uid, mid-prefill). `telemetry` (a Telemetry) goes to the
    engine; `on_step(launches, calls)` is called after each step with its
    launches and its decode steps, chunks and verify passes.

    An MoE model's routers are f32 GEMVs on the CUDA cores, one a layer
    (`gemv_pim_float` on every datapath but quant="int8"), and in LUT mode
    its experts' SiLU one lut_interp a layer. With `plain` (the drain run
    under `plain_ops`) no kernel may launch at all.

    `mesh` (phase 19: a rank of a tensor-parallel mesh) goes to the engine;
    a rank launches the one-device counts, on its slice of the heads.
    `eng.first_decode` holds each request's logits after its first decode
    step (its first generated token fed back)."""
    (api, SalPimConfig, SalPimEngine, EngineConfig, GenConfig, ServingEngine,
     paged_attention, kernels) = mods
    from repro_torch.serving import kvcache
    kv, sd = POOLS[fmt]
    n_lin, n_norm = step_counts(cfg)
    n_route, n_act = router_act_counts(cfg, mode)
    if quant != "none":
        n_route = 0                # quant="int8"/"fixed16" carry the routers too
    n_gemv = n_lin - n_route
    softcap_lut = mode == "lut" and cfg.final_softcap is not None
    sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode, quant=quant))
    eng = ServingEngine(params, cfg, sal, EngineConfig(
        slots=4, max_len=max_len, paged=True, page_size=16, prefill_chunk_tokens=64,
        prefix_sharing=sharing, speculative=spec, kv_cache_dtype=kv, kv_scale_dtype=sd,
        kv_splits=kv_splits, scheduler=scheduler, num_pages=num_pages,
        telemetry=telemetry, gen=GenConfig(stop_on_eos=False), mesh=mesh), device="cuda")
    if drafter is not None:
        eng.drafter = drafter
    eng.preempt_log, eng.between = [], None
    preempt = eng._preempt

    def logged_preempt(slot):
        r = eng.active[slot]
        eng.preempt_log.append((eng.decode_steps + eng.verify_passes, r.uid, r.prefilling))
        preempt(slot)
    eng._preempt = logged_preempt
    split = paged_attention.effective_kv_splits(kv_splits, eng.max_pages, 16) is not None
    first: dict[int, object] = {}
    first_decode: dict[int, object] = {}
    placed: list[int] = []                     # the slot of each request's first logits
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
                placed.append(i)
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
    pending = list(late)

    def arrive(drained):
        while pending and (drained if pending[0][0] is None
                           else eng.decode_steps + eng.verify_passes >= pending[0][0]):
            _, ps, nt, pr = pending.pop(0)
            uids.extend(eng.submit(p, max_new_tokens=nt, priority=pr) for p in ps)

    try:
        uids = [eng.submit(p, max_new_tokens=new_tokens, priority=priority) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = 0
        while True:
            arrive(False)
            before = {n: k.launches for n, k in kernels.items()}
            n_dec, n_chunk, n_ver = eng.decode_steps, eng.prefill_chunks, eng.verify_passes
            draft.clear()
            dense_calls.clear()
            n = eng.step()
            steps += 1
            if watch is not None:
                watch.check()
            record_gaps()
            for i, r in enumerate(eng.active):
                if r is not None and len(r.generated) == 1 and r.uid not in first_decode:
                    first_decode[r.uid] = eng.last_logits[i].clone()
            d = {n_: k.launches - before[n_] - draft[n_] for n_, k in kernels.items()}
            dec, chunk = eng.decode_steps - n_dec, eng.prefill_chunks - n_chunk
            ver = eng.verify_passes - n_ver
            L = cfg.n_layers
            passes = dec + chunk + ver
            lin = n_gemv * passes
            expect = {name: 0 for name in kernels}
            expect.update({gemv: lin,
                           TC: lin if gemv == "gemv_pim_float" else 0,
                           TC8L: lin if gemv == "gemv_pim_int8_linear" else 0,
                           TCF: lin if gemv == "gemv_pim_fixed_linear" else 0,
                           "quantize_int8_rows": lin if quant == "int8" else 0,
                           "layernorm_lut": n_norm * passes,
                           "lut_interp": passes * (int(softcap_lut) + n_act),
                           "paged_attention": 0 if split else L * dec,
                           "paged_prefill_attention": L * (chunk + ver),
                           "paged_attention_split": L * dec if split else 0,
                           "merge_partials": L * dec if split else 0})
            expect["gemv_pim_float"] += n_route * passes
            if gemv == "gemv_pim_int8_linear":
                # A linear is one launch, x quantized in its load path, where
                # gemv_int8_linear_plan tiles it (every linear of a decode step),
                # else quantize_int8_rows then gemv_pim_int8 (a chunk's wider x;
                # never its LM head, which takes the last token alone).
                two = d["gemv_pim_int8"]
                if two > (n_gemv - 1) * chunk:
                    raise AssertionError(f"serve[{label}] step {steps}: {two} int8 linears "
                                         f"took two launches; a decode step takes none")
                expect.update({gemv: lin - two, TC8L: lin - two, "gemv_pim_int8": two,
                               TC8: two,
                               "quantize_int8_rows": (lin if quant == "int8" else 0) + two})
            if plain:
                expect = {name: 0 for name in kernels}
            if d != expect:
                raise AssertionError(f"serve[{label}] step {steps}: launches {d}, expected "
                                     f"{expect} (decode {dec}, chunk {chunk}, verify {ver})")
            if on_step is not None:
                on_step(d, {"decode": dec, "chunk": chunk, "verify": ver})
            want_draft = dense_expect(kernels, cfg, dense_calls["decode"],
                                      dense_calls["prefill"], mode == "lut")
            if {n_: draft[n_] for n_ in kernels} != want_draft:
                raise AssertionError(f"serve[{label}] step {steps}: draft launches "
                                     f"{dict(draft)}, expected {want_draft} ({dict(dense_calls)} "
                                     "dense calls)")
            if (n == 0 and not eng.queue and not eng.swapped
                    and all(r is None for r in eng.active)):
                if not pending:
                    break
                if pending[0][0] is None:
                    eng.between = eng.stats()
                arrive(True)
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
    sched = ("" if scheduler is None else
             f", scheduler {st['scheduler']}: {st['preemptions']} preemptions "
             f"({sum(m for _, _, m in eng.preempt_log)} mid-prefill aborts), "
             f"{st['swap_outs']} swap-outs, {st['swap_ins']} swap-ins, swap tier peak "
             f"{st['swap_bytes_peak']} bytes")
    log(f"  serve[{label}]: {fmt} pools ({a.num_pages} pages), {mode}, "
        f"quant={quant}, kv_splits={kv_splits}, sharing={sharing}: finished "
        f"{len(done)}/{len(uids)} ({len(placed) - len(set(placed))} in a reused slot), "
        f"{a.used_pages} pages in use after the drain "
        f"({a.reserved_pages} reserved, {a.pinned_pages} pinned), peak {st['peak_pages']}, "
        f"{st['decode_steps']} decode steps, {st['prefill_chunks']} chunks, "
        f"{st['tokens']} tokens in {wall:.3f} s = {st['tokens'] / wall:.1f} tok/s{sched} "
        f"({card})")
    if len(done) != len(uids) or any(len(done[u].generated) != done[u].max_new_tokens
                                     for u in uids):
        raise AssertionError(f"serve[{label}]: not every request finished")
    pins = a.pinned_pages if eng.scheduler.pin_budget_pages else 0
    if (a.used_pages, a.reserved_pages, a.pinned_pages) != (pins, 0, pins):
        raise AssertionError(f"serve[{label}]: {a.used_pages} pages still in use, "
                             f"{a.reserved_pages} reserved, {a.pinned_pages} pinned")
    if eng.swapped or len(eng.swap_tier) or st["swapped"]:
        raise AssertionError(f"serve[{label}]: {len(eng.swapped)} requests still swapped "
                             f"out, {len(eng.swap_tier)} blobs in the swap tier")
    if len(first) != len(uids):
        raise AssertionError(f"serve[{label}]: first logits of {len(first)} requests")
    eng.verify_reach = reach[0]
    eng.first_decode = first_decode
    eng.cow_forks = watch.forks if watch is not None else 0
    eng.watch_sec = watch.sec if watch is not None else 0.0
    if plain:
        log(f"  serve[{label}] under plain_ops: no kernel launched (checked every step)")
        return eng, done, first, wall
    L = cfg.n_layers
    attn = (f"{L} paged_attention_split + {L} merge_partials" if split
            else f"{L} paged_attention")
    tc = " (all on the tensor cores)"
    wq = f", {n_lin} quantize_int8_rows (the weights)" if quant == "int8" else ""
    if gemv == "gemv_pim_int8_linear":
        dec_lin = f"{n_gemv} {gemv}{tc} (x quantized in the load path){wq}"
        chunk_lin = (f"{n_gemv} int8 linears{wq}, each one {gemv} or, where no token tile "
                     "holds the chunk's x, quantize_int8_rows + gemv_pim_int8 (all on the "
                     "tensor cores)")
    else:
        dec_lin = chunk_lin = f"{n_gemv} {gemv}{tc}"
    if n_route:
        routers = f" + {n_route} f32 routers (gemv_pim_float on the CUDA cores)"
        dec_lin, chunk_lin = dec_lin + routers, chunk_lin + routers
    interp = ("1 lut_interp (the final softcap's LUT tanh)" if softcap_lut
              else f"{n_act} lut_interp (the experts' LUT SiLU)" if n_act
              else "no lut_interp")
    if spec is None:
        log(f"  serve[{label}] launches per decode step: {dec_lin}, {attn}, "
            f"{n_norm} layernorm_lut; per prefill chunk: {chunk_lin}, "
            f"{L} paged_prefill_attention, {n_norm} "
            f"layernorm_lut; {interp}, no other kernel (checked every step)")
    else:
        log(f"  serve[{label}] launches per verify pass ({st['verify_passes']} passes over "
            f"(slots, k+1) = {sorted(verify_shapes)}, M = 20 at every linear): {chunk_lin}, "
            f"{L} paged_prefill_attention, {n_norm} layernorm_lut, {interp}, no "
            f"paged_attention; the same per prefill chunk; no decode step; the draft model's "
            f"launches those of its dense prefills and decode steps (checked every step)")
        if verify_shapes - {(4, spec.k + 1)}:
            raise AssertionError(f"serve[{label}]: verify passes over {verify_shapes}")
        log(f"  serve[{label}] verify positions end at {reach[0]} (max_len {max_len}); the "
            f"verify pass's table {reach[1]} columns against the cache's {eng.max_pages}")
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


def check_verify(torch, api, params, cfg, sal, fmt, label, card, prompts, timed=False,
                 gate=True):
    """From one resident state (4 slots, 128-token prompts, page 16): five
    greedy decode steps, and one verify pass over the same 5 tokens on a
    copy of the pools. The verify logits at each position must be within
    FIRST_LOGITS_LIMIT of the decode logits there (max |diff| / max
    |logit|). With `timed`, a verify pass (4 slots x 5 tokens) and a decode
    step on the host clock (eager, synchronised) and on the device (a CUDA
    graph's replay). With `gate` False (an MoE model: a verify pass routes
    its 20 tokens at another capacity than a decode step its 4, so the two
    are different functions) the gap is reported only."""
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
        + (f" (limit {FIRST_LOGITS_LIMIT:.0e})" if gate else " (reported, not a gate)")
        + f"; argmax equal at {agree}/{VERIFY_K + 1} positions for all 4 slots")
    if gate and max(gaps) > FIRST_LOGITS_LIMIT:
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
# Phase 12: the SLO scheduler with preempt-and-swap
# ---------------------------------------------------------------------------

SLO_PAGES = 1 + 24       # the pressure drains' pool: the trash page and 24
# Decode step at which phase 12's urgent requests arrive. On phase 4's
# requests (seed 0) and 24 pages, every slot decodes by decode step 4, so
# at step 12 every victim would be swapped; at step 3 the two youngest
# background requests are still waiting for their first chunk, and the
# urgent arrival aborts them (and swaps the other two out).
SLO_ARRIVAL_STEP = 3


def swap_roundtrip(torch, api, kvcache, params, cfg, sal, fmt, card, prompt):
    """One request (a 128-token prompt, then 8 decode steps) in slot 1 of a
    4-slot pool: `swap_out_slot`, then `swap_in_slot` into 9 other pages in
    reverse order. Gates: the blob and the restored pages hold the swapped
    pages' bytes exactly (payload and scale rows), and the next decode
    step's logits of the slot equal, bit for bit, those of the same step on
    an untouched copy of the pool. Then 10 round trips on the host clock;
    returns (blob bytes, median swap-out ms, median swap-in ms)."""
    dev = params["embed"].device
    B, page, max_pages, n_pages = 4, 16, 16, 9
    kv, sd = POOLS[fmt]
    cache = api.init_paged_cache(cfg, B, 1 + 2 * max_pages, page, max_pages, kv_dtype=kv,
                                 kv_scale_dtype=sd, device=dev)
    pages = list(range(1, 1 + n_pages))
    fresh = list(range(2 * max_pages, 2 * max_pages - n_pages, -1))
    row = torch.zeros((1, max_pages), dtype=torch.int32, device=dev)
    row[0, :n_pages] = torch.as_tensor(pages, dtype=torch.int32)
    toks = torch.as_tensor(prompt[:128], dtype=torch.int64, device=dev)[None]
    first = api.prefill_chunk(params, toks, row, torch.zeros(1, dtype=torch.int32, device=dev),
                              cache.k_pages, cache.v_pages, cfg, sal, cache.k_scale,
                              cache.v_scale)[0][0]
    cache.lengths[1] = 128
    cache.block_tables[1] = row[0]
    la = torch.zeros((B, cfg.vocab), dtype=torch.float32, device=dev)
    la[1] = first.float()
    for _ in range(8):               # slots 0, 2, 3 parked: length 0, trash rows
        la, cache = api.decode_step(params, torch.argmax(la, -1).to(torch.int32), cache, cfg,
                                    sal)
        la = la.float()
    tok = torch.argmax(la, -1).to(torch.int32)
    names = ("k_pages", "v_pages", "k_scale", "v_scale")
    copy = kvcache.PagedCache(*(None if getattr(cache, n) is None else getattr(cache, n).clone()
                                for n in ("lengths", "block_tables") + names))
    n_tok = 128 + 8
    cache, blob = kvcache.swap_out_slot(cache, 1, pages, n_tok)
    if int(cache.lengths[1]) != 0 or bool((cache.block_tables[1] != 0).any()):
        raise AssertionError(f"swap[{fmt}]: the slot was not cleared")
    kvcache.swap_in_slot(cache, 1, fresh, blob)

    def raw(t):
        return t.contiguous().view(torch.uint8)

    off, total = 0, 0
    for n, held in zip(names, (blob.k, blob.v, blob.k_scale, blob.v_scale)):
        if held is None:
            continue
        want = raw(getattr(copy, n)[:, pages])
        off += int((raw(held.to(dev)) != want).sum()) + int(
            (raw(getattr(cache, n)[:, fresh]) != want).sum())
        total += 2 * want.numel()
    if int(cache.lengths[1]) != n_tok or cache.block_tables[1, :n_pages].tolist() != fresh:
        raise AssertionError(f"swap[{fmt}]: the slot's length or table row was not restored")
    got, _ = api.decode_step(params, tok, cache, cfg, sal)
    want, _ = api.decode_step(params, tok, copy, cfg, sal)
    same = torch.equal(got[1], want[1])
    out_ms, in_ms = [], []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, blob = kvcache.swap_out_slot(cache, 1, fresh, n_tok)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        kvcache.swap_in_slot(cache, 1, fresh, blob)
        torch.cuda.synchronize()
        out_ms.append(1e3 * (t1 - t0))
        in_ms.append(1e3 * (time.perf_counter() - t1))
    o, i = statistics.median(out_ms), statistics.median(in_ms)
    log(f"  swap[{fmt}]: {n_pages} pages of {n_tok} tokens, blob {blob.nbytes} bytes "
        f"({blob.nbytes / n_pages / 2 ** 20:.4f} MiB a page), {off} of {total} bytes off "
        f"(blob and restored pages against the swapped ones); next decode step's logits of "
        f"the slot {'bit for bit' if same else 'NOT bit for bit'} those on an untouched copy; "
        f"swap-out {o:.3f} ms ({blob.nbytes / o / 1e6:.2f} GB/s), swap-in {i:.3f} ms "
        f"({blob.nbytes / i / 1e6:.2f} GB/s) on the host clock, medians of 10 ({card})")
    if off or not same:
        raise AssertionError(f"swap[{fmt}]: {off} bytes off, logits equal: {same}")
    return blob.nbytes, o, i


def slo_arrivals(np, cfg, seed):
    """Phase 12's urgent requests (two on one 64-token prefix, two of
    48..96 tokens) and the generator that drew them."""
    rng = np.random.RandomState(seed + 12)
    prefix = rng.randint(2, cfg.vocab, size=64)
    urgent = [np.concatenate([prefix, rng.randint(2, cfg.vocab, size=int(n))])
              for n in rng.randint(16, 33, size=2)]
    urgent += [rng.randint(2, cfg.vocab, size=int(n)) for n in rng.randint(48, 97, size=2)]
    return rng, urgent


def slo_phase(torch, F, np, mods, plain, counted, quant, quantize, params, cfg, prompts,
              card, seed):
    """Phase 12: swap round trips on fp, int8/f32 and int4/bf16 pools, then
    SloScheduler drains under pressure (phase 4's 8 requests at priority 1
    with 64 new tokens; 4 urgent ones at priority 0 with 32 new tokens
    arriving at decode step SLO_ARRIVAL_STEP, two on one 64-token prefix;
    SLO_PAGES pages) on fp exact, int8/f32 LUT and int4/bf16 LUT pools, each
    held token for token to a calm FIFO drain of the same requests on the
    default pool; a pin drain (two waves of 3 requests on one 64-token
    prefix, the second after the first has drained); an ngram k=4 drain
    under the same pressure. Returns the path's launch counts and the swap
    timings."""
    api, SalPimConfig, SalPimEngine = mods[0], mods[1], mods[2]
    from repro_torch.serving import kvcache
    from repro_torch.serving.scheduler import SloScheduler
    from repro_torch.serving.speculative import SpecConfig
    exact = SalPimEngine.create(SalPimConfig())
    swap_ms = {fmt: swap_roundtrip(torch, api, kvcache, params, cfg, exact, fmt, card,
                                   prompts[int(np.argmax([len(p) for p in prompts]))])
               for fmt in ("fp", "int8/f32", "int4/bf16")}
    rng, urgent = slo_arrivals(np, cfg, seed)
    late = [(SLO_ARRIVAL_STEP, urgent, 32, 0)]
    everyone = list(prompts) + urgent
    pin_prefix = rng.randint(2, cfg.vocab, size=64)
    waves = [[np.concatenate([pin_prefix, rng.randint(2, cfg.vocab, size=int(n))])
              for n in rng.randint(1, 16, size=3)] for _ in range(2)]
    ngram = SpecConfig(mode="ngram", k=VERIFY_K)
    pressure = dict(scheduler=SloScheduler(), num_pages=SLO_PAGES, priority=1, late=late,
                    sharing=True)
    calm = dict(priority=1, late=late, sharing=True)
    # (SLO drain, its calm FIFO drain, serve's options for both)
    pairs = [("u1 fp exact slo", "c1 fp exact calm fifo", dict(fmt="fp")),
             ("u2 int8/f32 lut slo", "c2 int8/f32 lut calm fifo", dict(fmt="int8/f32",
                                                                       mode="lut")),
             ("u3 int4/bf16 lut slo", "c3 int4/bf16 lut calm fifo", dict(fmt="int4/bf16",
                                                                         mode="lut")),
             ("n1 fp ngram k=4 slo", "n0 fp ngram k=4 calm fifo", dict(spec=ngram))]

    def drive():
        out = {}
        for slo, fifo, kw in pairs:
            out[slo] = serve(torch, mods, params, cfg, prompts, 64, card, label=slo,
                             **pressure, **kw)
            out[fifo] = serve(torch, mods, params, cfg, prompts, 64, card, label=fifo,
                              **calm, **kw)
        out["pin fp slo"] = serve(
            torch, mods, params, cfg, waves[0], 32, card, label="pin fp slo", sharing=True,
            scheduler=SloScheduler(pin_budget_pages=8), late=[(None, waves[1], 32, 0)])
        return out

    runs, counts = counted("slo/swap", drive, [
        "gemv_pim_float", TC, "paged_attention", "paged_prefill_attention", "layernorm_lut"])
    for slo, fifo, kw in pairs:
        eng, done, first, _ = runs[slo]
        sal = (exact if kw.get("mode") is None
               else SalPimEngine.create(SalPimConfig(nonlinear_mode=kw["mode"])))
        fmt = kw.get("fmt", "fp")
        if fmt == "int4/bf16":
            # Reported, not gated: on int4 pools at these 32..128-token
            # prompts one bf16 rounding anywhere moves GPT-2's first logits
            # by up to ~1e-1 of the largest (the plain path against itself,
            # scripts/logit_drift.py --pools int4/bf16), so a first-logit
            # gate of 3e-2 holds only for a GEMV bit for bit its plain
            # version. Phase 5 gates int4 pools at 896..960 tokens; here the
            # first logits are held bit for bit to the calm drain's below.
            worst, agree, dense_gap = first_logit_gaps(torch, F, params, cfg, sal, everyone,
                                                       done, first, fmt, quant, quantize,
                                                       plain)
            log(f"  serve[{slo}] first logits vs plain one-shot prefill ({fmt}): max |diff| / "
                f"max |logit| = {worst:.3e}, against the dense LUT softmax {dense_gap:.3e}; "
                f"greedy first-token agreement {agree}/{len(everyone)} (reported, not a gate: "
                f"int4 pools at short prompts, see ROADMAP.md queue 3)")
        else:
            check_first_logits(torch, F, params, cfg, sal, everyone, done, first, slo, fmt,
                               quant, quantize, plain)
        ceng, cdone, cfirst, _ = runs[fifo]
        first_same = sum(torch.equal(first[u], cfirst[u]) for u in first)
        st, cst = eng.stats(), ceng.stats()
        at_arrival = [(uid, mid) for ds, uid, mid in eng.preempt_log if ds == SLO_ARRIVAL_STEP]
        aborts = sum(mid for _, _, mid in eng.preempt_log)
        same, first_div, _ = token_share(done, cdone, 64)
        n = sum(len(r.generated) for r in done.values())
        log(f"  serve[{slo}]: preempted at the urgent arrival (uid, mid-prefill) "
            f"{at_arrival}; {aborts} mid-prefill aborts in all; shares {same}/{n} greedy "
            f"tokens with serve[{fifo}], first divergent position per request {first_div}; "
            f"first logits bit for bit the calm drain's for {first_same}/{len(first)} requests")
        log(f"  serve[{slo}] stats ({card}): sec_per_token {st['sec_per_token']:.5f} against "
            f"the calm drain's {cst['sec_per_token']:.5f}, model_sec_per_token "
            f"{st['model_sec_per_token']:.5f} against {cst['model_sec_per_token']:.5f}, "
            f"{st['decode_steps']} decode steps against {cst['decode_steps']}, admit_sec "
            f"{st['admit_sec']:.3f} against {cst['admit_sec']:.3f}, prefill_tokens "
            f"{st['prefill_tokens']} against {cst['prefill_tokens']}, prefill_tokens_saved "
            f"{st['prefill_tokens_saved']} against {cst['prefill_tokens_saved']}, peak_pages "
            f"{st['peak_pages']} of {SLO_PAGES - 1} against {cst['peak_pages']}, "
            f"preemptions {st['preemptions']}, swap_outs {st['swap_outs']}, swap_ins "
            f"{st['swap_ins']}, swap_bytes_peak {st['swap_bytes_peak']}, verify_passes "
            f"{st['verify_passes']}, acceptance_rate {st['acceptance_rate']:.4f} against "
            f"{cst['acceptance_rate']:.4f}")
        if kw.get("spec") is not None:
            # Reported, not gated: the verify pass and the decode step part
            # where bf16 logits tie (ROADMAP.md, queue 3).
            if not st["preemptions"] or eng.verify_reach > eng.max_len:
                raise AssertionError(f"serve[{slo}]: {st['preemptions']} preemptions, "
                                     f"verify positions end at {eng.verify_reach}")
        else:
            if not (st["preemptions"] and st["swap_ins"] and aborts):
                raise AssertionError(f"serve[{slo}]: {st['preemptions']} preemptions, "
                                     f"{st['swap_ins']} swap-ins, {aborts} aborts")
            if not any(mid for _, mid in at_arrival):
                raise AssertionError(f"serve[{slo}]: no mid-prefill victim at the urgent "
                                     "arrival")
            if same != n or first_same != len(first):
                raise AssertionError(f"serve[{slo}]: {same}/{n} tokens and {first_same}/"
                                     f"{len(first)} first logits equal to {fifo}'s")
    eng, done, first, _ = runs["pin fp slo"]
    check_first_logits(torch, F, params, cfg, exact, waves[0] + waves[1], done, first,
                       "pin fp slo", "fp", quant, quantize, plain)
    between, st = eng.between, eng.stats()
    saved = st["prefill_tokens_saved"] - between["prefill_tokens_saved"]
    log(f"  serve[pin fp slo] ({card}): {between['pinned_pages']} pages pinned between the "
        f"waves (budget 8), {between['prefill_tokens_saved']} prompt tokens not prefilled in "
        f"the first wave, {saved} in the second (3 x 64 when its first request revives the "
        f"pinned prefix), {st['pinned_pages']} pinned after it; sec_per_token "
        f"{st['sec_per_token']:.5f}")
    if not (between["pinned_pages"] > 0 and saved > 0):
        raise AssertionError(f"serve[pin fp slo]: {between['pinned_pages']} pinned, "
                             f"{saved} tokens saved on the second wave")
    return counts, swap_ms, runs["u1 fp exact slo"]


# ---------------------------------------------------------------------------
# Phase 13: telemetry and the roofline
# ---------------------------------------------------------------------------

def trace_balanced(events) -> bool:
    """Every B of a Chrome trace closed by an E on its tid, well nested."""
    stacks = {}
    for e in events:
        if e["ph"] == "B":
            stacks.setdefault(e["tid"], []).append(e["name"])
        elif e["ph"] == "E":
            if not stacks.get(e["tid"]):
                return False
            stacks[e["tid"]].pop()
    return not any(stacks.values())


TEL_SCOPES = ("serve_step", "prefill_chunk", "decode_step", "verify_tokens",
              "dense_admit_prefill")
CALL_SCOPES = TEL_SCOPES[1:]
# The engine steps torch.profiler records in an annotated drain, from the
# first: a whole drain's trace takes minutes to read.
TRACE_STEPS = 20
# The port's CUDA kernels, by the names of their __global__ functions.
OUR_KERNELS = re.compile(r"gemv|decode_walk|paged_prefill|layernorm_|softmax_rows|"
                         r"softmax_stream|lut_interp|merge_kernel|quantize_rows")


@dataclasses.dataclass
class Scope:
    """One engine scope of a trace: its host interval (ns) and the CUDA
    kernels launched inside it, (name, device us)."""
    name: str
    start: int
    end: int
    kernels: list

    @property
    def host_us(self) -> float:
        return (self.end - self.start) / 1e3

    @property
    def device_us(self) -> float:
        return sum(d for _, d in self.kernels)

    def ours(self) -> list:
        return [k for k in self.kernels if OUR_KERNELS.search(k[0])]

    def holds(self, other) -> bool:
        return self.start <= other.start and other.end <= self.end


def traced_scopes(torch, prof) -> dict:
    """The engine's scopes in a torch.profiler trace by name, each with the
    CUDA kernels launched inside it. torch.profiler attaches a kernel to
    the PyTorch operation that launched it, and the port's kernels,
    launched through ctypes, to none (they are traced, unattributed): so a
    kernel is matched here to its launch call by CUPTI correlation id, and
    the call to the scope around it by time."""
    from torch.autograd import DeviceType
    kernels, launches = {}, []
    scopes = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        name, t0 = e.name(), e.start_ns()
        if e.device_type() == DeviceType.CUDA:
            # Not a scope's or a profiler step's device span: such a span
            # carries the correlation id of a kernel it covers, and would
            # take that kernel's place here.
            if not (name in TEL_SCOPES or name.startswith("ProfilerStep#")
                    or e.is_user_annotation()):
                kernels[e.correlation_id()] = (name, e.duration_ns() / 1e3)
        elif name in TEL_SCOPES:
            scopes[name].append(Scope(name, t0, t0 + e.duration_ns(), []))
        elif "aunch" in name:     # cudaLaunchKernel(ExC), cuLaunchKernel(Ex)
            launches.append((t0, e.correlation_id()))
    launches.sort()
    starts = [t for t, _ in launches]
    for rows in scopes.values():
        for sc in rows:
            lo = bisect.bisect_left(starts, sc.start)
            hi = bisect.bisect_right(starts, sc.end)
            sc.kernels = [kernels[c] for _, c in launches[lo:hi] if c in kernels]
    return scopes


def check_scopes(torch, prof, window, label, ours_per_call, card):
    """The annotated drain's trace over the steps the profiler recorded
    (`window`: each one's model calls): one serve_step scope a step, one
    scope a model call inside it, and under every call's scope exactly its
    counted launches of the port's kernels (`ours_per_call`). Prints one
    decode step's traced breakdown and the medians over the window."""
    t0 = time.perf_counter()
    scopes = traced_scopes(torch, prof)
    n = {k: len(v) for k, v in scopes.items()}
    want = {"serve_step": len(window)}
    for scope, key in zip(CALL_SCOPES, ("chunk", "decode", "verify", "admit")):
        want[scope] = sum(c.get(key, 0) for c in window)
    want = {k: v for k, v in want.items() if v}
    steps = scopes["serve_step"]
    calls = [c for name in CALL_SCOPES for c in scopes.get(name, [])]
    inside = sum(1 for c in calls if any(st.holds(c) for st in steps))
    if n != want or inside != len(calls):
        raise AssertionError(f"trace[{label}]: scopes {n} ({inside} of {len(calls)} calls "
                             f"inside a serve_step), expected {want}")
    for c in calls:
        ours = c.ours()
        if len(ours) != ours_per_call[c.name]:
            names = collections.Counter(re.split(r"[<(]", k.removeprefix("void "), maxsplit=1)[0]
                                        for k, _ in c.kernels)
            raise AssertionError(
                f"trace[{label}]: a {c.name} scope holds {len(ours)} of the port's kernels "
                f"({len(c.kernels)} kernels in all: {dict(names)}); its call launches "
                f"{ours_per_call[c.name]}")
    decode_only = []
    for st in steps:
        held = [c for c in calls if st.holds(c)]
        if [c.name for c in held] == ["decode_step"]:
            decode_only.append((st, held[0]))
    if decode_only:
        st, dec = decode_only[len(decode_only) // 2]
        ours_us = sum(d for _, d in dec.ours())
        by_name = collections.Counter()
        for k, d in dec.kernels:
            k = k.replace("(anonymous namespace)::", "").removeprefix("void ")
            by_name[re.split(r"[<(]", k, maxsplit=1)[0]] += d
        top = "; ".join(f"{k} {v:.1f}" for k, v in by_name.most_common(5))
        log(f"  trace[{label}] one decode step (the middle one of {len(decode_only)} "
            f"decode-only steps traced): serve_step {st.host_us:.1f} us on the host, "
            f"{st.device_us:.1f} us of device time under it ({len(st.kernels)} kernels); "
            f"decode_step {dec.host_us:.1f} us on the host, {dec.device_us:.1f} us of device "
            f"time ({len(dec.kernels)} kernels: the port's {len(dec.ours())}, "
            f"{ours_us:.1f} us; PyTorch's {len(dec.kernels) - len(dec.ours())}, "
            f"{dec.device_us - ours_us:.1f} us); the host outside decode_step "
            f"{st.host_us - dec.host_us:.1f} us; device busy "
            f"{100 * st.device_us / st.host_us:.1f}% of the step; by device us: {top} "
            f"({card})")
        med = {"host": statistics.median(s.host_us for s, _ in decode_only),
               "dev": statistics.median(s.device_us for s, _ in decode_only),
               "dec_host": statistics.median(d.host_us for _, d in decode_only),
               "dec_dev": statistics.median(d.device_us for _, d in decode_only),
               "dec_ours": statistics.median(sum(x for _, x in d.ours())
                                             for _, d in decode_only)}
        log(f"  trace[{label}] medians over {len(decode_only)} decode-only steps: serve_step "
            f"{med['host']:.1f} us host / {med['dev']:.1f} us device; decode_step "
            f"{med['dec_host']:.1f} us host / {med['dec_dev']:.1f} us device, "
            f"{med['dec_ours']:.1f} us of it the port's kernels ({card})")
    for name in ("prefill_chunk", "verify_tokens", "dense_admit_prefill"):
        rows = scopes.get(name)
        if rows:
            log(f"  trace[{label}] {len(rows)} {name} scopes: median "
                f"{statistics.median(r.host_us for r in rows):.1f} us host / "
                f"{statistics.median(r.device_us for r in rows):.1f} us device, "
                f"{ours_per_call[name]} of the port's kernels each ({card})")
    log(f"  trace[{label}]: steps 1..{len(window)} traced, {sum(n.values())} scopes, "
        f"{sum(len(st.kernels) for st in steps)} kernels under the serve_step scopes; read "
        f"in {time.perf_counter() - t0:.1f} s")


def roofline_report(eng, label, card, hardware) -> None:
    """stats()["roofline"] of a drain, a line a phase; each drain's decode
    must be memory-bound on the card's roofline."""
    roof = eng.stats()["roofline"]
    for phase, r in roof.items():
        log(f"  roofline[{label}] {phase}: modeled {r['modeled_bytes'] / 1e9:.3f} GB and "
            f"{r['modeled_flops'] / 1e9:.1f} GFLOP over {r['sec'] * 1e3:.1f} ms of host "
            f"clock = {r['achieved_gbps']:.2f} GB/s, {r['arithmetic_intensity']:.2f} "
            f"FLOP/byte: {r['bound']}-bound on {eng.cost_model.hardware.name} ({card})")
    if roof.get("decode", {}).get("bound") not in (None, "memory"):
        raise AssertionError(f"roofline[{label}]: decode {roof['decode']['bound']}-bound")
    if hardware["name"] != "h100":
        raise AssertionError(f"roofline[{label}]: hardware {hardware}")


def telemetry_phase(torch, np, mods, counted, params, cfg, prompts, card, seed, dense_ref):
    """Phase 13: GPT-2 medium drains with telemetry off and on. Paged
    (max_len 256, page 16, 64-token chunks): phase 4's 8 requests exact
    (off; on; on with annotate=True under torch.profiler), an ngram k=4
    drain with sharing and phase 12's SLO drain on SLO_PAGES pages (each
    off, then on and annotated under the profiler); one dense drain on
    (annotated, under the profiler), held to phase 7's d1 drain. Gates:
    tokens and first logits bit for bit off and on, per-step launches
    equal, the disabled registry empty, the Chrome trace balanced, `h100`
    detected, decode memory-bound, the scopes holding their kernels.
    Then `python -m repro_torch.launch.serve --full --requests 8 --slots
    4` as a user runs it. Returns the path's launch counts."""
    from repro_torch.serving.scheduler import SloScheduler
    from repro_torch.serving.speculative import SpecConfig
    from repro_torch.serving.telemetry import NULL_TELEMETRY, Telemetry
    from torch.profiler import ProfilerActivity, profile, schedule
    n_lin, n_norm = step_counts(cfg)
    L = cfg.n_layers
    # The port's launches a model call: the GEMVs, the norms and one
    # attention a layer (an exact dense admission's is PyTorch's SDPA).
    ours_per_call = {"decode_step": n_lin + n_norm + L, "prefill_chunk": n_lin + n_norm + L,
                     "verify_tokens": n_lin + n_norm + L, "dense_admit_prefill": n_lin + n_norm}
    _, urgent = slo_arrivals(np, cfg, seed)
    ngram = SpecConfig(mode="ngram", k=VERIFY_K)
    # (label, serve's options, new tokens, telemetry settings); a drain under
    # SloScheduler gets a fresh one each run
    slo = dict(num_pages=SLO_PAGES, priority=1, late=[(SLO_ARRIVAL_STEP, urgent, 32, 0)],
               sharing=True)
    drains = [("t1 fp exact", dict(), 32, ("off", "on", "on+profiler")),
              ("t2 fp ngram k=4 sharing", dict(spec=ngram, sharing=True), 32,
               ("off", "on+profiler")),
              ("t3 fp exact slo", slo, 64, ("off", "on+profiler"))]
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def traced(drain, ps, new, **kw):
        """`drain` under torch.profiler (CPU and CUDA activity), its first
        TRACE_STEPS steps recorded."""
        log_ = []
        with profile(activities=activities, schedule=schedule(
                wait=0, warmup=0, active=TRACE_STEPS, repeat=1)) as prof:
            def on_step(d, c):
                log_.append((d, c))
                if len(log_) == TRACE_STEPS:
                    # The recording ends at this step: its last kernels may
                    # still run, and CUPTI records only what completed.
                    torch.cuda.synchronize()
                prof.step()
            run = drain(torch, mods, params, cfg, ps, new, card, on_step=on_step, **kw)
        return run, log_, prof

    def drive():
        out = {}
        for label, kw, new, modes in drains:
            runs = {}
            for tel_mode in modes:
                opts = dict(kw, scheduler=SloScheduler() if kw is slo else None)
                tel = (None if tel_mode == "off" else
                       Telemetry(enabled=True, annotate=tel_mode == "on+profiler"))
                tag = f"{label} telemetry {tel_mode}"
                if tel_mode == "on+profiler":
                    runs[tel_mode] = traced(serve, prompts, new, label=tag, telemetry=tel,
                                            **opts)
                else:
                    log_ = []
                    run = serve(torch, mods, params, cfg, prompts, new, card, label=tag,
                                telemetry=tel, on_step=lambda d, c: log_.append((d, c)),
                                **opts)
                    runs[tel_mode] = (run, log_, None)
            out[label] = runs
        out["t4 dense exact"] = {"on+profiler": traced(
            serve_dense, prompts, 32, label="t4 dense exact telemetry on+profiler",
            telemetry=Telemetry(enabled=True, annotate=True))}
        return out

    runs, counts = counted("telemetry", drive, [
        "gemv_pim_float", TC, "paged_attention", "paged_prefill_attention", "layernorm_lut",
        "decode_attention"])
    for label, by_mode in runs.items():
        ref_mode = "off" if "off" in by_mode else None
        if ref_mode is None:                       # the dense drain: phase 7's d1
            _, ref_done, ref_first, _ = dense_ref
            ref_log = None
        else:
            (ref_eng, ref_done, ref_first, _), ref_log, _ = by_mode["off"]
            if ref_eng.telemetry is not NULL_TELEMETRY or not ref_eng.telemetry.registry.empty \
                    or ref_eng.telemetry.requests or ref_eng.telemetry.steps:
                raise AssertionError(f"{label}: the disabled telemetry recorded something")
            log(f"  serve[{label} telemetry off]: the disabled registry is empty after the "
                "drain")
        for mode, ((eng, done, first, wall), step_log, prof) in by_mode.items():
            if mode == ref_mode:
                continue
            same = all(done[u].generated == ref_done[u].generated for u in ref_done)
            same_first = sum(torch.equal(first[u], ref_first[u]) for u in ref_first)
            if not same or same_first != len(ref_first) or set(done) != set(ref_done):
                raise AssertionError(f"{label} telemetry {mode}: tokens equal {same}, first "
                                     f"logits bit for bit {same_first}/{len(ref_first)}")
            if ref_log is not None and step_log != ref_log:
                raise AssertionError(f"{label} telemetry {mode}: per-step launches differ "
                                     f"from telemetry off ({len(step_log)} against "
                                     f"{len(ref_log)} steps)")
            tel = eng.telemetry
            snap = tel.snapshot()
            events = tel.chrome_trace_events()
            if not trace_balanced(events):
                raise AssertionError(f"{label} telemetry {mode}: the Chrome trace does not "
                                     "balance")
            st = eng.stats()
            c = snap["counters"]
            sched = snap["scheduler"]
            if (c.get("tokens.generated") != st["tokens"]
                    or c.get("requests.finished") != len(done)
                    or snap["steps"]["count"] != len(step_log)
                    or sched.get("preempt", 0) != st["preemptions"]
                    or sched.get("swap_out", 0) != st["swap_outs"]
                    or sched.get("swap_in", 0) != st["swap_ins"]):
                raise AssertionError(f"{label} telemetry {mode}: snapshot {c}, {sched} "
                                     f"against stats {st}")
            hw = snap["roofline"]["hardware"]
            log(f"  serve[{label} telemetry {mode}]: tokens and first logits bit for bit "
                f"{'phase 7 d1' if ref_log is None else 'telemetry off'}'s"
                f"{'' if ref_log is None else ', launches equal at each of ' + str(len(step_log)) + ' steps'}; "
                f"Chrome trace of {len(events)} events balanced; {snap['steps']['count']} "
                f"steps, counters {json.dumps(c, sort_keys=True)}; scheduler {sched}; "
                f"prefix cache {snap['prefix_cache']}; admission {snap['admission']}; "
                f"hardware {hw}")
            roofline_report(eng, f"{label} telemetry {mode}", card, hw)
            if prof is not None:
                check_scopes(torch, prof, [c for _, c in step_log[:TRACE_STEPS]], label,
                             ours_per_call, card)
        if "on" in by_mode:
            (eng_on, _, _, _), _, _ = by_mode["on"]
            (eng_p, _, _, _), _, _ = by_mode["on+profiler"]
            (eng_off, _, _, _), _, _ = by_mode["off"]
            rows = []
            for mode, e in (("off", eng_off), ("on", eng_on), ("on+profiler", eng_p)):
                st = e.stats()
                steps = e.telemetry.snapshot()["steps"]["count"] if mode != "off" else \
                    len(by_mode["off"][1])
                rows.append(f"{mode} {1e3 * st['step_sec'] / steps:.2f} ms a step, "
                            f"{1e3 * st['sec_per_token']:.3f} ms a token")
            log(f"  serve[{label}] host clock, telemetry " + "; ".join(rows) +
                f" (reported, not a gate; {card})")
    log("  launch: python -m repro_torch.launch.serve --full --requests 8 --slots 4")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--full", "--requests", "8",
         "--slots", "4"], capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT)
    for line in (res.stdout + res.stderr).strip().splitlines()[-6:]:
        log(f"    {line}")
    if res.returncode != 0 or "8 requests through 4 slots" not in res.stdout:
        raise AssertionError(f"launch/serve.py exited {res.returncode}")
    log(f"  launch/serve.py finished its 8 requests in {time.perf_counter() - t0:.1f} s "
        "(process start included)")
    return counts


# ---------------------------------------------------------------------------
# Phase 7: the dense cache
# ---------------------------------------------------------------------------

def dense_expect(kernels, cfg, dec, prefills, lut, gemv="gemv_pim_float", two=0):
    """Launches of `dec` dense decode steps and `prefills` whole-prompt
    prefills: `step_counts`' linears and norms, `attention_layers`'
    attention (decode_attention; the LUT softmax in a LUT-mode prefill),
    `router_act_counts`' LUT activations in LUT mode, nothing else; every
    bf16 GEMV on the tensor cores (an MoE model's f32 routers on the CUDA
    cores). With gemv "gemv_pim_int8_linear" (int8 weights) each linear is
    one int8 linear layer launch, but for the `two` that took
    quantize_int8_rows + gemv_pim_int8 (a prefill's wider x)."""
    A, passes = attention_layers(cfg), dec + prefills
    n_lin, n_norm = step_counts(cfg)
    n_route, n_act = router_act_counts(cfg, "lut" if lut else "exact")
    lin = (n_lin - n_route) * passes
    expect = {name: 0 for name in kernels}
    expect.update({"gemv_pim_float": n_route * passes,
                   "layernorm_lut": n_norm * passes,
                   "lut_interp": n_act * passes,
                   "decode_attention": A * dec,
                   "softmax_lut": A * prefills if lut else 0})
    if gemv == "gemv_pim_float":
        expect.update({"gemv_pim_float": n_lin * passes, TC: lin})
    else:
        expect.update({gemv: lin - two, TC8L: lin - two, "gemv_pim_int8": two, TC8: two,
                       "quantize_int8_rows": two})
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
    expect = dense_expect(kernels, cfg, new_tokens, 1, mode == "lut")
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
                mode="exact", max_len=256, telemetry=None, on_step=None, plain=False,
                gemv="gemv_pim_float", handoff=None):
    """Drain `prompts` through ServingEngine(paged=False) (4 slots; the
    arena is int8 when cfg.kv_dtype says so), checking every step's
    launches: per decode step 145 GEMV, 24 decode_attention, 49
    layernorm_lut; per admission 145 GEMV, 49 layernorm_lut and, in LUT
    mode, 24 softmax_lut; no paged kernel (`dense_expect` for other
    models; `gemv` the kernel that carries the linears: the int8 linear
    layer for int8 weights, where a decode step takes no two-launch
    linear). `telemetry` goes to the engine; `on_step(launches, calls)` is
    called after each step with its launches and its decode steps and
    admissions. With `plain` (under `plain_ops`) no kernel may launch.
    `handoff`, a dict, collects each request's logits after its first
    decode step (uid -> logits)."""
    (api, SalPimConfig, SalPimEngine, EngineConfig, GenConfig, ServingEngine,
     paged_attention, kernels) = mods
    sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode))
    eng = ServingEngine(params, cfg, sal, EngineConfig(
        slots=4, max_len=max_len, gen=GenConfig(stop_on_eos=False), telemetry=telemetry),
        device="cuda")
    first: dict[int, object] = {}
    placed: list[int] = []                     # the slot of each admission
    place = eng._place_dense

    def place_and_capture(slot, req):          # record each request's first logits
        place(slot, req)
        first[req.uid] = eng.last_logits[slot].clone()
        placed.append(slot)

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
        two = d["gemv_pim_int8"]
        if two > (step_counts(cfg)[0] - 1) * adm:
            raise AssertionError(f"serve[{label}] step {steps}: {two} int8 linears took two "
                                 f"launches; a decode step takes none")
        expect = dense_expect(kernels, cfg, dec, adm, mode == "lut", gemv, two)
        if handoff is not None:
            for i, r in enumerate(eng.active):
                if r is not None and len(r.generated) == 1 and r.uid not in handoff:
                    handoff[r.uid] = eng.last_logits[i].clone()
        if plain:
            expect = {name: 0 for name in kernels}
        if d != expect:
            raise AssertionError(f"serve[{label}] step {steps}: launches {d}, expected "
                                 f"{expect} (decode {dec}, admissions {adm})")
        if on_step is not None:
            on_step(d, {"decode": dec, "admit": adm})
        if n == 0 and not eng.queue and all(r is None for r in eng.active):
            break
        if steps > 4000:
            raise AssertionError(f"serve[{label}]: engine did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = {r.uid: r for r in eng.finished}
    st = eng.stats()
    c = eng.cache
    arena = sum(t.numel() * t.element_size() for f in dataclasses.fields(c)
                if f.name != "lengths" and (t := getattr(c, f.name)) is not None)
    parked = c.lengths.tolist()
    log(f"  serve[{label}]: dense {'int8' if c.quantized else 'fp'} cache "
        f"({arena / 2 ** 20:.1f} MiB, {max_len} positions x 4 slots), {mode}: finished "
        f"{len(done)}/{len(uids)} ({len(placed) - len(set(placed))} in a reused slot), slot "
        f"lengths after the drain {parked}, "
        f"{st['decode_steps']} decode steps, {st['tokens']} tokens in {wall:.3f} s = "
        f"{st['tokens'] / wall:.1f} tok/s ({card})")
    if len(done) != len(uids) or any(len(done[u].generated) != new_tokens for u in uids):
        raise AssertionError(f"serve[{label}]: not every request finished")
    if parked != [0] * 4 or len(first) != len(uids):
        raise AssertionError(f"serve[{label}]: slots not parked ({parked}) or first logits "
                             f"of {len(first)} requests")
    A = attention_layers(cfg)
    want = dense_expect(kernels, cfg, 1, 0, mode == "lut", gemv)
    sm = f", {A} softmax_lut" if mode == "lut" and A else ""
    act = f", {want['lut_interp']} lut_interp" if want["lut_interp"] else ""
    tc = TC if gemv == "gemv_pim_float" else TC8L
    if not plain:
        log(f"  serve[{label}] launches per decode step: {want[gemv]} {gemv} ({want[tc]} on "
            f"the tensor cores), {want['decode_attention']} decode_attention, "
            f"{want['layernorm_lut']} layernorm_lut{act}; per admission prefill: the same "
            f"linears and norms{sm}{act}; no paged kernel (checked every step)")
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


# ---------------------------------------------------------------------------
# Phase 14: the MoE family
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_ops(mode):
    """Every `kernels.ops` entry of the serving paths held to its plain
    PyTorch version, as `scripts/logit_drift.py --plain` holds them: in LUT
    mode the decode, prefill and arena walks' plain page walks (the LUT
    algebra the kernels compute). A drain run inside launches no kernel."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import gemv_pim as gk
    from repro_torch.kernels import layernorm_lut as ln
    from repro_torch.kernels import lut_interp as li
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_prefill as pf
    from repro_torch.kernels import softmax_lut as sm
    lut = mode == "lut"
    walk = pa.paged_attention_online_plain if lut else pa.paged_attention_plain
    table = {
        "lut_apply": li.lut_interp_plain,
        "pim_linear": gk.gemv_pim_plain,
        "pim_int8_linear": gk.gemv_pim_int8_linear_plain,
        "pim_quantize_int8_rows": lambda x, static_input=False: gk.quantize_int8_rows_plain(x),
        "pim_fixed_linear": gk.gemv_pim_fixed_linear_plain,
        "pim_paged_prefill_attention": (
            (lambda q, *a, **k: pf.paged_prefill_attention_online_plain(q, *a, **k).to(
                q.dtype)) if lut else pf.paged_prefill_attention_plain),
        "pim_paged_attention": lambda q, *a, kv_splits=None, plan_kv_heads=None, **k: walk(
            q, *a, **k).to(q.dtype),
        "pim_layernorm": lambda *a, **k: ln.layernorm_lut_plain(*a, wide_sums=True, **k),
        "pim_softmax": sm.softmax_lut_plain,
        "pim_decode_attention": lambda *a, plan_kv_heads=None, **k: (
            da.decode_attention_online_plain if lut else da.decode_attention_plain)(*a, **k),
    }
    saved = {name: getattr(ops, name) for name in table}
    for name, fn in table.items():
        setattr(ops, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


class RoutingRecorder:
    """Each MoE layer call's router weights (T, E) and keep mask (G, kTg),
    kept on the card, tagged "prompt" inside a prefill chunk or a dense
    admission (whose inputs are the request's own prompt, whatever the
    other requests generate) and "step" elsewhere.

    With `replay` (another drain's calls) each prompt call takes the top-k
    experts that drain chose at the same call, in its order, weighted by
    this drain's own router weights, renormalised: the same dispatch and
    capacity drops, so that the two drains' prompts differ only where
    their kernels do. Which tokens an expert keeps is a discontinuous
    function of every token's routing, and random-weight routing is
    chaotic: a near-tie flip in one layer moves that token's later layers
    far enough to flip more (a free-running plain drain of olmoe parts
    from the kernels' in a quarter of its top-8 sets). `self.own` counts
    the prompt calls' top-k sets this drain's weights would have chosen
    otherwise, and the largest top-k / top-(k+1) gap of its own weights at
    one: how near a tie each such flip was."""

    def __init__(self, moe_lib, api):
        self.moe, self.api, self.calls, self.kind = moe_lib, api, [], "step"
        self.own = (0, 0, 0.0)

    @contextlib.contextmanager
    def recording(self, replay=None):
        import torch
        self.calls, self.own = [], (0, 0, 0.0)
        m, api = self.moe, self.api
        rw, disp, route = m.router_weights, m.dispatch, m.route
        chunk, prefill = api.prefill_chunk, api.prefill
        forced = iter([c[1] for c in replay if c[0] == "prompt"] if replay else [])

        def weights(*a, **k):
            w = rw(*a, **k)
            self.calls.append([self.kind, w.detach().clone(), None])
            return w

        def dispatch(*a, **k):
            plan = disp(*a, **k)
            self.calls[-1][2] = plan.keep.clone()
            return plan

        def replayed(router, xt, cfg, engine):
            if replay is None or self.kind != "prompt":
                return route(router, xt, cfg, engine)
            w, other = m.router_weights(router, xt, engine), next(forced)
            if other.shape != w.shape:
                raise AssertionError(f"replayed routing: shape {tuple(other.shape)} "
                                     f"against {tuple(w.shape)}")
            k = cfg.top_k
            ti = torch.sort(other, dim=-1, descending=True, stable=True).indices[:, :k]
            mine = torch.sort(w, dim=-1, descending=True, stable=True)
            differ = (mine.indices[:, :k].sort(-1).values != ti.sort(-1).values).any(-1)
            n, total, gap = self.own
            if bool(differ.any()):
                gap = max(gap, float((mine.values[:, k - 1] - mine.values[:, k])[differ].max()))
            self.own = (n + int(differ.sum()), total + differ.numel(), gap)
            tw = w.gather(-1, ti)
            return tw / tw.sum(-1, keepdim=True).clamp_min(1e-9), ti

        def prompt(fn):
            def call(*a, **k):
                self.kind = "prompt"
                try:
                    return fn(*a, **k)
                finally:
                    self.kind = "step"
            return call

        m.router_weights, m.dispatch, m.route = weights, dispatch, replayed
        api.prefill_chunk, api.prefill = prompt(chunk), prompt(prefill)
        try:
            yield self
        finally:
            m.router_weights, m.dispatch, m.route = rw, disp, route
            api.prefill_chunk, api.prefill = chunk, prefill
        if replay is not None and next(forced, None) is not None:
            raise AssertionError("replayed routing: the drain made fewer prompt calls")


def routing_diff(torch, got, want, k):
    """The prompt calls of two drains' records, in order: (token-layer
    top-k sets that differ, of all; keep entries that differ, of all; the
    largest top-k / top-(k+1) weight gap, in `got`, at a differing set)."""
    a = [c for c in got if c[0] == "prompt"]
    b = [c for c in want if c[0] == "prompt"]
    if [tuple(c[1].shape) for c in a] != [tuple(c[1].shape) for c in b]:
        raise AssertionError("the two drains' prompt calls differ in shape")
    sets = n_sets = keeps = n_keep = 0
    gap = 0.0
    for (_, wa, ka), (_, wb, kb) in zip(a, b):
        sa = torch.sort(wa, dim=-1, descending=True, stable=True)
        ia = sa.indices[:, :k].sort(-1).values
        ib = torch.sort(wb, dim=-1, descending=True, stable=True).indices[:, :k].sort(-1).values
        differ = (ia != ib).any(-1)
        sets += int(differ.sum())
        n_sets += differ.numel()
        keeps += int((ka != kb).sum())
        n_keep += ka.numel()
        if bool(differ.any()):
            g = (sa.values[:, k - 1] - sa.values[:, k])[differ]
            gap = max(gap, float(g.max()))
    return sets, n_sets, keeps, n_keep, gap


def one_shot_plain_logits(torch, api, params, cfg, sal, prompt, fmt):
    """First logits of `prompt` prefilled as one chunk through the plain
    versions (fmt "dense": the dense prefill): the MoE layers group and
    cap its tokens all together, not chunk by chunk as the engine does."""
    dev = params["embed"].device
    toks = torch.as_tensor(prompt, dtype=torch.int64, device=dev)[None]
    with plain_ops(sal.nl.mode):
        if fmt == "dense":
            return api.prefill(params, {"tokens": toks}, cfg, sal,
                               max_len=toks.shape[1])[0][0].float()
        kv, sd = POOLS[fmt]
        n = -(-toks.shape[1] // 16)
        cache = api.init_paged_cache(cfg, 1, 1 + n, 16, n, kv_dtype=kv, kv_scale_dtype=sd,
                                     device=dev)
        table = torch.arange(1, n + 1, dtype=torch.int32, device=dev)[None]
        return api.prefill_chunk(params, toks, table, torch.zeros(1, dtype=torch.int32,
                                                                  device=dev),
                                 cache.k_pages, cache.v_pages, cfg, sal, cache.k_scale,
                                 cache.v_scale)[0][0].float()


def moe_drains(torch, mods, rec, cfg, drains, prompts, new_tokens, card, plain=False,
               replay=None):
    """Run each (label, params, options) drain of an MoE model: through the
    kernels, or with `plain` under `plain_ops` (no kernel may launch) and,
    given `replay` (the kernel drains' results), each prompt call on the
    kernel drain's top-k experts (`RoutingRecorder`); the routing of each
    recorded. Returns {label: (serve's result, calls, own choices)}."""
    out = {}
    for label, p, kw in drains:
        kw = dict(kw)
        dense, mode = kw.pop("dense", False), kw.get("mode", "exact")
        tag = (f"{label}, plain" + (", replayed routing" if replay else "")) if plain else label
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(plain_ops(mode))
            stack.enter_context(rec.recording(replay[label][1] if replay else None))
            if dense:
                run = serve_dense(torch, mods, p, cfg, prompts, new_tokens, card, label=tag,
                                  mode=mode, plain=plain)
            else:
                run = serve(torch, mods, p, cfg, prompts, new_tokens, card, label=tag,
                            plain=plain, **kw)
        out[label] = (run, rec.calls, rec.own)
    return out


def logits_gap(torch, done, first, other):
    """max over requests of max |diff| / max |logit| of two drains' first
    logits, and the requests whose greedy first tokens agree."""
    worst = max(float((first[u].float() - other[u].float()).abs().max()
                      / other[u].float().abs().max()) for u in done)
    return worst, sum(int(first[u].argmax()) == int(other[u].argmax()) for u in done)


def check_moe_drains(torch, api, SalPimConfig, SalPimEngine, cfg, drains, runs, plains,
                     prompts, new_tokens):
    """Each drain's first logits against the same drain on the plain
    versions, its prompts routed as the kernel drain routed them (gated at
    FIRST_LOGITS_LIMIT), and against a one-shot plain prefill (reported:
    another grouping of the tokens); the top-k sets the plain drain would
    have chosen otherwise, and the token share (reported)."""
    for label, p, kw in drains:
        (eng, done, first, _), _, _ = runs[label]
        (_, pdone, pfirst, _), _, (own, n_own, gap) = plains[label]
        mode = kw.get("mode", "exact")
        sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode))
        fmt = "dense" if kw.get("dense") else kw.get("fmt", "fp")
        worst, agree = logits_gap(torch, done, first, pfirst)
        shot = max(logits_gap(torch, [u], first, {u: one_shot_plain_logits(
            torch, api, p, cfg, sal, prompts[i], fmt)})[0] for i, u in enumerate(sorted(done)))
        same, firsts, _ = token_share(done, pdone, new_tokens)
        log(f"  serve[{label}] first logits vs the same drain on the plain versions (its "
            f"prompts on the kernel drain's routing): max |diff| / max |logit| = {worst:.3e} "
            f"(limit {FIRST_LOGITS_LIMIT:.0e}); first tokens equal {agree}/{len(done)}; vs a "
            f"one-shot plain prefill of each prompt {shot:.3e} (reported: the engine's chunks "
            f"group and cap the tokens otherwise)")
        near = (f"; the largest top-{cfg.top_k}/top-{cfg.top_k + 1} gap of its own router "
                f"weights at one {gap:.3e} (a near-tie, not a kernel fault)" if own else "")
        log(f"  serve[{label}] routing: on the same decisions so far, the plain path's own "
            f"weights choose another top-{cfg.top_k} set at {own} of {n_own} token-layers of "
            f"the prompts{near}; greedy tokens shared {same}/{len(done) * new_tokens}, first "
            f"divergent position per request {firsts} (reported)")
        if worst > FIRST_LOGITS_LIMIT:
            raise AssertionError(f"serve[{label}]: first logits differ from the plain drain's "
                                 f"by {worst:.3e}")


def free_running_plain(torch, mods, rec, cfg, label, params, prompts, new_tokens, card, run):
    """Reported, not a gate: the drain on the plain versions with its own
    routing, against the kernel drain `run`: first logits, routing of the
    prompts' chunks, greedy tokens."""
    (_, done, first, _), calls, _ = run
    free = moe_drains(torch, mods, rec, cfg, [(label, params, {})], prompts, new_tokens, card,
                      plain=True)
    (_, fdone, ffirst, _), fcalls, _ = free[label]
    worst, agree = logits_gap(torch, done, first, ffirst)
    sets, n_sets, keeps, n_keep, gap = routing_diff(torch, calls, fcalls, cfg.top_k)
    same, _, _ = token_share(done, fdone, new_tokens)
    log(f"  serve[{label}] against the plain drain with its own routing (reported, not a "
        f"gate): first logits {worst:.3e}, first tokens equal {agree}/{len(done)}; in the "
        f"prompts {sets} of {n_sets} top-{cfg.top_k} sets and {keeps} of {n_keep} keep "
        f"entries differ (the largest top-{cfg.top_k}/top-{cfg.top_k + 1} gap at one "
        f"{gap:.3e}); greedy tokens shared {same}/{len(done) * new_tokens}")


def time_moe_kernels(torch, F, tlut, gemv_pim, lut_interp, seed):
    """The kernels at the MoE path's own shapes, bf16 lut_interp bit for bit
    and timed at an olmoe decode step's expert SiLU (1, 64, 4, 1024), a
    64-token chunk's (2, 64, 8, 1024) and a 4 x 64 batch's (8, 64, 8, 1024)
    ((G, E, C, f); the products' (E, G*C, f) outputs), beside F.silu (the
    exact function, no LUT) and the bound; the f32 router GEMVs (64, 2048)
    and (16, 4096) at M 4 and 256 against F.linear and the bound."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    bank = tlut.LutBank.create(64)
    out = {"lut_interp": {}, "router": {}}
    for shape in ((1, 64, 4, 1024), (2, 64, 8, 1024), (8, 64, 8, 1024)):
        G, E, C, f = shape
        xs = [(3 * torch.randn((E, G * C, f), generator=gen, device=dev)).bfloat16()
              for _ in range(16)]
        got = lut_interp.lut_interp(xs[0], bank.silu)
        if not torch.equal(got, lut_interp.lut_interp_plain(xs[0], bank.silu)):
            raise AssertionError(f"lut_interp {shape}: not bit for bit its plain version")
        ms = time_graph(torch, lambda i: lut_interp.lut_interp(xs[i], bank.silu), 16)
        plain = time_graph(torch, lambda i: lut_interp.lut_interp_plain(xs[i], bank.silu), 16)
        silu = time_graph(torch, lambda i: F.silu(xs[i]), 16)
        n = xs[0].numel()
        bnd, by = bound_ms(2 * 2 * n, 2 * n, "float32")
        log(f"  lut_interp at the MoE experts' SiLU {shape} bf16: bit for bit its plain "
            f"version; {ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us, F.silu (exact) "
            f"{silu * 1e3:.2f} us, bound {bnd * 1e3:.2f} us ({by})")
        out["lut_interp"][str(shape)] = dict(ms=ms, plain_ms=plain, silu_ms=silu, bound_ms=bnd,
                                             bound_by=by)
    for R, C in ROUTER_SHAPES:
        ws = [torch.randn((R, C), generator=gen, device=dev) * C ** -0.5 for _ in range(16)]
        for M in (4, 256):
            x = torch.randn((M, C), generator=gen, device=dev)
            ms = time_graph(torch, lambda i: gemv_pim.gemv_pim_float(x, ws[i]), 16)
            plain = time_graph(torch, lambda i: gemv_pim.gemv_pim_plain(x, ws[i]), 16)
            lib = time_graph(torch, lambda i: F.linear(x, ws[i]), 16)
            bnd, by = bound_ms(4 * (M * C + R * C + M * R), 2 * M * R * C, "float32")
            log(f"  gemv_pim_float router ({R}, {C}) f32 at M {M} (CUDA cores): "
                f"{ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us, F.linear {lib * 1e3:.2f} us, "
                f"bound {bnd * 1e3:.2f} us ({by})")
            out["router"][f"({R}, {C}) M {M}"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                                      bound_ms=bnd, bound_by=by)
    return out


def moe_phase(torch, F, np, mods, counted, quantize, prompts, new_tokens, card, seed):
    """Phase 14: olmoe-1B-7B at full width, 8 of its 16 layers (exact, LUT, q1, the
    dense arena, ngram k=4 with sharing) and phi-3.5-MoE at its published
    widths, 2 layers (exact, LUT), each drain run again under `plain_ops`
    and held to it; the launches of each path counted apart. Returns
    ({path: counts}, times)."""
    from repro_torch.configs import get_config
    from repro_torch.core import lut as tlut
    from repro_torch.kernels import gemv_pim, lut_interp
    from repro_torch.models import moe as moe_lib
    from repro_torch.serving.speculative import SpecConfig
    api, SalPimConfig, SalPimEngine = mods[0], mods[1], mods[2]
    rec = RoutingRecorder(moe_lib, api)
    counts, times = {}, {}
    path_kernels = ["gemv_pim_float", TC, "paged_attention", "paged_prefill_attention",
                    "layernorm_lut", "lut_interp"]

    cfg = cut_config(get_config, "olmoe_1b_7b")
    params = api.init_params(cfg, seed=seed, device="cuda")
    n_params = check_param_count(params, cfg, "olmoe-1b-7b")
    t0 = time.perf_counter()
    q1 = quantize.quantize_params_int8(params)
    torch.cuda.synchronize()
    log(f"  olmoe-1B-7B at full width, depth cut from 16 to {cfg.n_layers} layers (d "
        f"{cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.n_experts} experts top-{cfg.top_k}, "
        f"expert d_ff {cfg.moe_ff}, cap factor {cfg.router_cap_factor}, vocab {cfg.vocab}): "
        f"{n_params / 1e9:.2f} B parameters, {2 * n_params / 1e9:.1f} GB in bf16, "
        f"{cfg.active_param_count() / 1e9:.2f} B active a token; random weights; "
        f"quantize_params_int8 (a layer at a time) {time.perf_counter() - t0:.1f} s")
    drains = [("olmoe exact", params, dict()),
              ("olmoe lut", params, dict(mode="lut")),
              ("olmoe q1 int8 weights, int8/bf16 pools", q1,
               dict(fmt="int8/bf16", gemv="gemv_pim_int8_linear")),
              ("olmoe dense exact", params, dict(dense=True)),
              ("olmoe ngram k=4 sharing", params,
               dict(sharing=True, spec=SpecConfig(mode="ngram", k=VERIFY_K)))]
    runs, counts["olmoe-1b-7b"] = counted("olmoe-1b-7b", lambda: moe_drains(
        torch, mods, rec, cfg, drains, prompts, new_tokens, card),
        path_kernels + ["gemv_pim_int8_linear", TC8L, "decode_attention"])
    plains = moe_drains(torch, mods, rec, cfg, drains, prompts, new_tokens, card, plain=True,
                        replay=runs)
    check_moe_drains(torch, api, SalPimConfig, SalPimEngine, cfg, drains, runs, plains,
                     prompts, new_tokens)
    free_running_plain(torch, mods, rec, cfg, "olmoe exact", params, prompts, new_tokens,
                       card, runs["olmoe exact"])
    st = runs["olmoe ngram k=4 sharing"][0][0].stats()
    log(f"  serve[olmoe ngram k=4 sharing] stats: acceptance {st['acceptance_rate']:.3f}, "
        f"{st['verify_passes']} verify passes for {st['tokens']} tokens")
    sal = {m: SalPimEngine.create(SalPimConfig(nonlinear_mode=m)) for m in ("exact", "lut")}
    for mode in ("exact", "lut"):
        times[f"olmoe {mode}"] = time_model(torch, api, params, cfg, sal[mode], prompts, card,
                                            label=f"olmoe {mode}")
    times["olmoe verify"] = check_verify(torch, api, params, cfg, sal["exact"], "fp",
                                         "olmoe exact", card, prompts, timed=True, gate=False)
    expert_bytes = 2 * cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.moe_ff
    stream = 2 * (n_params - cfg.vocab * cfg.d_model)     # every weight but the embedding
    bnd, _ = bound_ms(stream, 0, "bfloat16")
    active, _ = bound_ms(2 * (cfg.active_param_count() - cfg.vocab * cfg.d_model), 0,
                         "bfloat16")
    times["olmoe bound"] = dict(stream=stream, experts=expert_bytes, bound_ms=bnd,
                                active_bound_ms=active)
    d = times["olmoe exact"]
    log(f"  olmoe decode step (4 slots): device {d['dev_dec']:.2f} ms, host clock "
        f"{d['dec']:.2f} ms; bound {bnd:.2f} ms streaming every weight once "
        f"({stream / 1e9:.2f} GB, {expert_bytes / 1e9:.2f} GB of it the 64 experts a layer that "
        f"the reference's batched products read), {active:.2f} ms at the active experts alone "
        f"(the cost model's price) ({card})")
    del params, q1, runs, plains
    rec.calls = []
    torch.cuda.empty_cache()

    full = get_config("phi35_moe_42b")
    pcfg = dataclasses.replace(full, n_layers=2)
    pw = api.init_params(pcfg, seed=seed, device="cuda")
    n_params = check_param_count(pw, pcfg, "phi-3.5-MoE, 2 layers")
    log(f"  {full.name}: the published widths (d {full.d_model}, {full.n_heads}/"
        f"{full.n_kv_heads} heads, head_dim {full.head_dim}, {full.n_experts} experts "
        f"top-{full.top_k}, expert d_ff {full.moe_ff}, LayerNorm, vocab {full.vocab}), depth "
        f"cut from {full.n_layers} to {pcfg.n_layers} layers: {n_params / 1e9:.2f} B "
        f"parameters, {2 * n_params / 1e9:.1f} GB in bf16; random weights")
    rng = np.random.RandomState(seed + 14)
    p_prompts = [rng.randint(2, pcfg.vocab, size=len(p)) for p in prompts]
    p_drains = [("phi exact", pw, dict()), ("phi lut", pw, dict(mode="lut"))]
    p_runs, counts["phi-3.5-moe"] = counted("phi-3.5-moe", lambda: moe_drains(
        torch, mods, rec, pcfg, p_drains, p_prompts, new_tokens, card), path_kernels)
    p_plains = moe_drains(torch, mods, rec, pcfg, p_drains, p_prompts, new_tokens, card,
                          plain=True, replay=p_runs)
    check_moe_drains(torch, api, SalPimConfig, SalPimEngine, pcfg, p_drains, p_runs,
                     p_plains, p_prompts, new_tokens)
    times["phi exact"] = time_model(torch, api, pw, pcfg, sal["exact"], p_prompts, card,
                                    label="phi exact (2 layers)")
    del pw, p_runs, p_plains
    rec.calls = []
    torch.cuda.empty_cache()
    times["kernels"] = time_moe_kernels(torch, F, tlut, gemv_pim, lut_interp, seed)
    return counts, times


# ---------------------------------------------------------------------------
# Phase 15: the SSM and hybrid families
# ---------------------------------------------------------------------------

# The SSM and hybrid models' linears in bf16 (R, C): mamba2-370m's in_proj,
# out_proj and LM head; zamba2-1.2B's in_proj, out_proj, LM head, and its
# shared block's q/k/v/o, GeGLU w_gate/w_up and w_down.
SSM_GEMV_SHAPES = [(4384, 1024), (1024, 2048), (50280, 1024),
                   (8384, 2048), (2048, 4096), (32000, 2048),
                   (2048, 2048), (8192, 2048), (2048, 8192)]


def time_ssm_kernels(torch, F, tlut, gemv_pim, layernorm_lut, lut_interp, attn, softmax_lut,
                     seed):
    """The kernels at the SSM and hybrid paths' shapes, each held to its
    plain version and timed beside it, a PyTorch call and its bound: the
    float GEMV at every linear of the two models at a decode step's M 4
    (within the bf16 tolerance, on the tensor cores); q1's int8 linear
    layer at mamba2's in_proj, out_proj and LM head (bit for bit, one
    launch); layernorm_lut's RMSNorm at (4, 1024), (4, 2048) and the gated
    norm at (4, 2048), (4, 4096) bf16 (bit for bit); lut_interp's SiLU at
    the conv's (4, 2304) and (4, 4224) bf16 and softplus at dt's (4, 32)
    and (4, 64) f32 (bit for bit); decode_attention over one application
    of zamba2's shared arena (4 slots x 32 heads x 64, 256 positions) and
    softmax_lut at its 128-token admission's causal scores. Returns
    ({kernel: max abs error}, {kernel: [timing rows]})."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 15)
    bank = tlut.LutBank.create(64)
    errs, rows = collections.defaultdict(float), collections.defaultdict(list)
    f32, n = torch.float32, 8

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def record(name, shape, ms, plain, lib, lib_name, bnd, by):
        rows[name].append(dict(shape=shape, ms=ms, plain_ms=plain, library_ms=lib,
                               bound_ms=bnd, bound_by=by))
        lib_s = "none" if lib is None else f"{lib * 1e3:.2f} us"
        log(f"  {name} at {shape}: {ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us, "
            f"{lib_name} {lib_s}, bound {bnd * 1e3:.2f} us ({by})")

    for R, C in SSM_GEMV_SHAPES:
        x = randn(4, C)
        ws = [randn(R, C, std=C ** -0.5) for _ in range(n)]
        before = gemv_pim.gemv_pim_float.tc_launches
        got = gemv_pim.gemv_pim_float(x, ws[0])
        if gemv_pim.gemv_pim_float.tc_launches != before + 1:
            raise AssertionError(f"gemv_pim_float ({R}, {C}) M 4: not on the tensor cores")
        errs["gemv_pim_float"] = max(errs["gemv_pim_float"], compare(
            torch, f"gemv_pim_float ({R}, {C}) M 4", got, gemv_pim.gemv_pim_plain(x, ws[0]),
            TOL["bfloat16"]))
        ms = time_graph(torch, lambda i: gemv_pim.gemv_pim_float(x, ws[i]), n)
        plain = time_graph(torch, lambda i: gemv_pim.gemv_pim_plain(x, ws[i]), n)
        lib = time_graph(torch, lambda i: F.linear(x, ws[i]), n)
        bnd, by = bound_ms(2 * (4 * C + R * C + 4 * R), 2 * 4 * R * C, "bfloat16")
        record("gemv_pim_float", f"({R}, {C}) bf16 M 4", ms, plain, lib, "F.linear", bnd, by)
        if (R, C) in SSM_GEMV_SHAPES[:3]:                           # mamba2's q1 linears
            qs = [gemv_pim.quantize_int8_rows_plain(w.float()) for w in ws]
            if gemv_pim.gemv_int8_linear_plan(4, C, R) is None:
                raise AssertionError(f"q1 ({R}, {C}): not one launch at M 4")
            got = gemv_pim.gemv_pim_int8_linear(x, *qs[0], compute=f32)
            if not torch.equal(got, gemv_pim.gemv_pim_int8_linear_plain(x, *qs[0],
                                                                        compute=f32)):
                raise AssertionError(f"gemv_pim_int8_linear ({R}, {C}): not bit for bit")
            ms = time_graph(torch, lambda i: gemv_pim.gemv_pim_int8_linear(x, *qs[i],
                                                                           compute=f32), n)
            plain = time_graph(torch, lambda i: gemv_pim.gemv_pim_int8_linear_plain(
                x, *qs[i], compute=f32), n)
            bnd, by = bound_ms(2 * 4 * C + R * C + 4 * R + 2 * 4 * R, 2 * 4 * R * C, "int8")
            record("gemv_pim_int8", f"q1 ({R}, {C}) int8, f32 scales, x bf16 M 4, one "
                   f"launch (bit for bit)", ms, plain, lib, "F.linear (bf16 weight)", bnd, by)
        del ws

    for M, d, what in ((4, 1024, "mamba2's block norm"), (4, 2048, "zamba2's block norm, "
                       "mamba2's gated norm"), (4, 4096, "zamba2's gated norm")):
        xs = [randn(M, d) for _ in range(n)]
        g = randn(d, std=0.2) + 1.0
        got = layernorm_lut.layernorm_lut(xs[0], g, None, rsqrt_table=bank.rsqrt, rms=True)
        if not torch.equal(got, layernorm_lut.layernorm_lut_plain(
                xs[0], g, None, rsqrt_table=bank.rsqrt, rms=True, wide_sums=True)):
            raise AssertionError(f"layernorm_lut ({M}, {d}): not bit for bit")
        ms = time_graph(torch, lambda i: layernorm_lut.layernorm_lut(
            xs[i], g, None, rsqrt_table=bank.rsqrt, rms=True), n)
        plain = time_graph(torch, lambda i: layernorm_lut.layernorm_lut_plain(
            xs[i], g, None, rsqrt_table=bank.rsqrt, rms=True, wide_sums=True), n)
        lib = time_graph(torch, lambda i: F.layer_norm(xs[i], (d,), g, None, 1e-6), n)
        bnd, by = bound_ms(2 * (2 * M * d + d), 6 * M * d, "float32")
        record("layernorm_lut", f"({M}, {d}) bf16 RMSNorm, LUT rsqrt ({what}; bit for bit)",
               ms, plain, lib, "F.layer_norm", bnd, by)

    for shape, dtype, name, lib_fn in (((4, 2304), torch.bfloat16, "silu", F.silu),
                                       ((4, 4224), torch.bfloat16, "silu", F.silu),
                                       ((4, 32), f32, "softplus", F.softplus),
                                       ((4, 64), f32, "softplus", F.softplus)):
        table = getattr(bank, name)
        xs = [randn(*shape, std=3.0, dtype=dtype) for _ in range(n)]
        if not torch.equal(lut_interp.lut_interp(xs[0], table),
                           lut_interp.lut_interp_plain(xs[0], table)):
            raise AssertionError(f"lut_interp {name} {shape}: not bit for bit")
        ms = time_graph(torch, lambda i: lut_interp.lut_interp(xs[i], table), n)
        plain = time_graph(torch, lambda i: lut_interp.lut_interp_plain(xs[i], table), n)
        lib = time_graph(torch, lambda i: lib_fn(xs[i]), n)
        size = xs[0].numel() * xs[0].element_size()
        bnd, by = bound_ms(2 * size, 2 * xs[0].numel(), "float32")
        record("lut_interp", f"{shape} {str(dtype)[6:]} LUT {name} (bit for bit)", ms, plain,
               lib, f"F.{name} (exact)", bnd, by)

    H, D, S, lens = 32, 64, 256, [128, 137, 151, 160]
    q = randn(4, H, D)
    arenas = [(randn(4, H, S, D), randn(4, H, S, D)) for _ in range(7)]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    key_ok = torch.arange(S, device=dev)[None, :] < lengths[:, None].long()
    errs["decode_attention"] = compare(
        torch, "decode_attention at zamba2's heads", attn.decode_attention(q, *arenas[0], lengths),
        attn.decode_attention_plain(q, *arenas[0], lengths), TOL["bfloat16"])
    ms = time_graph(torch, lambda i: attn.decode_attention(q, *arenas[i], lengths), 7)
    plain = time_graph(torch, lambda i: attn.decode_attention_plain(q, *arenas[i], lengths), 7)
    lib = time_graph(torch, lambda i: F.scaled_dot_product_attention(
        q[:, :, None], *arenas[i], attn_mask=key_ok[:, None, None])[:, :, 0], 7)
    keys = sum(lens) * H
    bnd, by = bound_ms(2 * keys * D * 2 + 2 * (2 * 4 * H * D) + 4 * 4, 4 * keys * D, "bfloat16")
    record("decode_attention", f"zamba2's shared arena: B 4 x H {H} x D {D}, arena {S}, "
           f"lengths {lens}, bf16", ms, plain, lib, "SDPA with a length mask", bnd, by)
    del arenas

    scores = [randn(1, H, 1, 128, 128, std=4.0, dtype=f32) for _ in range(7)]
    got = softmax_lut.softmax_lut(scores[0], bank.exp, bank.recip, causal=True)
    errs["softmax_lut"] = compare(torch, "softmax_lut at zamba2's admission", got,
                                  softmax_lut.softmax_lut_plain(scores[0], bank.exp,
                                                                bank.recip, causal=True),
                                  TOL["float32"])
    ms = time_graph(torch, lambda i: softmax_lut.softmax_lut(scores[i], bank.exp, bank.recip,
                                                             causal=True), 7)
    plain = time_graph(torch, lambda i: softmax_lut.softmax_lut_plain(
        scores[i], bank.exp, bank.recip, causal=True), 7)
    lib = time_graph(torch, lambda i: torch.softmax(scores[i], dim=-1), 7)
    valid = H * 128 * 129 // 2
    bnd, by = bound_ms(4 * valid + 4 * H * 128 * 128, 5 * valid, "float32")
    record("softmax_lut", f"({H}*128, 128) f32 causal scores of zamba2's 128-token admission",
           ms, plain, lib, "torch.softmax (unmasked)", bnd, by)
    return dict(errs), dict(rows)


def time_ssm_model(torch, api, params, cfg, sal, label, card, n_params):
    """The decode step at 4 slots (lengths 128..160, random state and
    arenas) and a 128-token admission (a batch of 1, max_len 256): on the
    host clock around eager calls with a synchronise, and on the device
    alone, each replayed as a CUDA graph; beside the step's bound, the
    weights streamed once (every one but the embedding, whose 4 rows are
    gathered) plus the SSM state and conv window read and written and the
    shared arenas' keys read, and the eager PyTorch operations a step."""
    dev = params["embed"].device
    gen = torch.Generator(device=dev).manual_seed(15)
    cache = api.init_cache(cfg, 4, 256, device=dev)
    cache.ssm.copy_(torch.randn(cache.ssm.shape, generator=gen, device=dev) * 0.1)
    cache.conv.copy_(torch.randn(cache.conv.shape, generator=gen, device=dev))
    for t in (cache.shared_k, cache.shared_v):
        if t is not None:
            t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    lens = [128, 137, 151, 160]
    cache.lengths.copy_(torch.tensor(lens, dtype=torch.int32))
    tok = torch.full((4,), 5, dtype=torch.int32, device=dev)
    step_ms = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.decode_step(params, tok, cache, cfg, sal)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    host = statistics.median(step_ms[2:])
    device = time_graph(torch, lambda i: api.decode_step(params, tok, cache, cfg, sal), 1)
    ops = eager_ops(torch, lambda: api.decode_step(params, tok, cache, cfg, sal))
    toks = torch.randint(2, cfg.vocab, (1, 128), generator=gen, device=dev)
    adm_ms = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.prefill(params, {"tokens": toks}, cfg, sal, max_len=256)
        torch.cuda.synchronize()
        adm_ms.append(1e3 * (time.perf_counter() - t0))
    adm_host = statistics.median(adm_ms[1:])
    adm_dev = time_graph(torch, lambda i: api.prefill(params, {"tokens": toks}, cfg, sal,
                                                      max_len=256), 1)
    weights = 2 * (n_params - cfg.vocab * cfg.d_model)
    state = cache.ssm.numel() * 4 + cache.conv.numel() * 2
    kv = (2 * 2 * cfg.n_kv_heads * cfg.head_dim * sum(l + 1 for l in lens)
          * attention_layers(cfg) if cfg.family == "hybrid" else 0)
    bnd, by = bound_ms(weights + 2 * state + kv, 2 * 4 * n_params, "bfloat16")
    top = ", ".join(f"{k.replace('aten.', '').replace('.default', '')} {v}"
                    for k, v in ops.most_common(8))
    log(f"  decode step [{label}] ({card}): {host:.2f} ms eager on the host clock, "
        f"{device:.3f} ms on the device (host share {1 - device / host:.0%}), 4 slots x "
        f"{lens} context; bound {bnd:.3f} ms ({by}: {weights / 1e9:.3f} GB of weights once, "
        f"{2 * state / 1e9:.3f} GB of SSM state and conv window read and written, "
        f"{kv / 1e9:.3f} GB of shared keys and values read); {sum(ops.values())} eager "
        f"PyTorch operations a step ({top}, ...)")
    log(f"  128-token admission [{label}] ({card}): {adm_host:.2f} ms eager on the host clock, "
        f"{adm_dev:.3f} ms on the device")
    return dict(host=host, device=device, bound_ms=bnd, bound_by=by, weights=weights,
                state=2 * state, kv=kv, ops=sum(ops.values()), admit_host=adm_host,
                admit_device=adm_dev)


def rel_gap(got, want) -> float:
    """max |got - want| / max |want|."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def ssm_stage_gaps(torch, params, cfg, sal, toks):
    """Each stage of an SSM or hybrid model's prefill of `toks` (B, S) (a
    Mamba2 layer with its norm and residual, an application of the
    hybrid's shared block, the final norm and LM head at the last
    position) run through the kernels and through the plain versions
    (`plain_ops`) on the same input, the kernels' output feeding the next
    stage: each stage's gap is its own kernels' rounding, not the depth's
    amplification of the roundings before it. Returns the largest max
    |diff| / max |out| and its stage."""
    from repro_torch.models import blocks as blk
    from repro_torch.models import mamba2 as m2
    from repro_torch.models import transformer as tf
    pos = torch.arange(toks.shape[1], device=toks.device)
    x = tf._embed(params, toks, cfg, pos[None])
    cos, sin = tf._rope(cfg, pos)
    layers = tf._layers(params["blocks"], cfg.n_layers)
    stages = []
    for a, (s, e) in enumerate(tf._hybrid_segments(cfg)):
        if cfg.family == "hybrid":
            stages.append((f"shared block {a}", lambda h: blk.apply_decoder_block_prefill(
                params["shared_attn"], h, cfg, sal, cos=cos, sin=sin, window=None)[0]))
        for i in range(s, e):
            stages.append((f"layer {i}", lambda h, bp=layers[i]: h + m2.apply_mamba2(
                bp["mamba"], blk.apply_norm(bp["norm"], h, cfg, sal), cfg, sal)))
    stages.append(("the final norm and LM head", lambda h: tf._logits(params, h[:, -1], cfg,
                                                                         sal)))
    worst, where = 0.0, None
    for label, fn in stages:
        out = fn(x)
        with plain_ops(sal.nl.mode):
            gap = rel_gap(out, fn(x))
        if gap >= worst:
            worst, where = gap, label
        x = out
    return worst, where


def plain_one_step_gap(torch, api, params, cfg, sal, prompt) -> float:
    """How far the plain path's first logits move when every token
    embedding element moves by one bf16 step (its bit pattern +- 1, the
    sign from a seed): the model's own amplification of one rounding, no
    kernel involved (as `scripts/logit_drift.py` measures it)."""
    from repro_torch.models import transformer as tf
    embed = tf._embed
    gen = torch.Generator(device="cuda").manual_seed(len(prompt))
    sign = (torch.randint(0, 2, (len(prompt), cfg.d_model), generator=gen, device="cuda")
            * 2 - 1).to(torch.int16)

    def perturbed(*a, **k):
        x = embed(*a, **k)
        return (x.view(torch.int16) + sign * (x[0] != 0)).view(x.dtype)

    toks = torch.as_tensor(prompt, dtype=torch.int64, device="cuda")[None]
    with plain_ops(sal.nl.mode):
        base = api.prefill(params, {"tokens": toks}, cfg, sal, max_len=len(prompt))[0][0]
        tf._embed = perturbed
        try:
            moved = api.prefill(params, {"tokens": toks}, cfg, sal, max_len=len(prompt))[0][0]
        finally:
            tf._embed = embed
    return rel_gap(moved, base)


def check_ssm_drain(torch, api, params, cfg, sal, label, prompts, done, first, handoff, *,
                    plain_gate):
    """The gates of an SSM or hybrid drain, each request at a time, within
    FIRST_LOGITS_LIMIT: its first logits against a one-shot kernel prefill
    of its prompt (the admission's own computation); every stage of that
    prefill through the kernels against the plain versions on the same
    input (`ssm_stage_gaps`); its logits after its first decode step
    against a one-shot kernel prefill of the prompt and one kernel decode
    step of that token, a batch of one (the engine's state handoff into
    and out of its slot). With `plain_gate` (a bit-exact datapath) its first
    logits against a one-shot prefill on the plain versions too. Reported
    beside them: the first logits against the plain one-shot prefill, the
    handoff against a one-shot kernel prefill of the prompt and the token,
    and the plain path's own move under one bf16 step of its embeddings
    (two requests) - bf16 roundings amplified by the depth."""
    adm = stage = hand = shot = model_hand = 0.0
    where, agree = None, 0
    for u, prompt in zip(sorted(done), prompts):
        toks = torch.as_tensor(prompt, dtype=torch.int64, device="cuda")[None]
        logits, cache = api.prefill(params, {"tokens": toks}, cfg, sal, max_len=256)
        adm = max(adm, rel_gap(first[u], logits[0]))
        gap, at = ssm_stage_gaps(torch, params, cfg, sal, toks)
        if gap >= stage:
            stage, where = gap, at
        g0 = done[u].generated[0]
        step, _ = api.decode_step(params, torch.tensor([g0], dtype=torch.int32, device="cuda"),
                                  cache, cfg, sal)
        hand = max(hand, rel_gap(handoff[u], step[0]))
        want = one_shot_plain_logits(torch, api, params, cfg, sal, prompt, "dense")
        shot = max(shot, rel_gap(first[u], want))
        agree += int(int(want.argmax()) == g0)
        ext = torch.cat([toks, torch.tensor([[g0]], device="cuda")], dim=1)
        model_hand = max(model_hand, rel_gap(handoff[u], api.prefill(
            params, {"tokens": ext}, cfg, sal, max_len=256)[0][0]))
    noise = max(plain_one_step_gap(torch, api, params, cfg, sal, p) for p in prompts[:2])
    log(f"  serve[{label}] first logits vs a one-shot kernel prefill {adm:.3e}; each stage "
        f"of the prefill through the kernels vs the plain versions on the same input at most "
        f"{stage:.3e} ({where}); the logits after the first decode step vs a one-shot kernel "
        f"prefill and decode step, a batch of one, {hand:.3e} (limit {FIRST_LOGITS_LIMIT:.0e} "
        f"each)")
    log(f"  serve[{label}] reported: first logits vs a one-shot plain prefill {shot:.3e}"
        f"{f' (limit {FIRST_LOGITS_LIMIT:.0e})' if plain_gate else ''}, first tokens equal "
        f"{agree}/{len(done)}; after the first decode step vs a one-shot kernel prefill of "
        f"the prompt and that token {model_hand:.3e}; the plain path's own move under one "
        f"bf16 step of its embeddings {noise:.3e}")
    if max(adm, stage, hand) > FIRST_LOGITS_LIMIT or (plain_gate and shot > FIRST_LOGITS_LIMIT):
        raise AssertionError(f"serve[{label}]: admission {adm:.3e}, stage {stage:.3e} "
                             f"({where}), handoff {hand:.3e}, one-shot plain {shot:.3e}")


# The state handoff in f32 (weights and compute), where depth does not
# amplify roundings past this: a wrong conv window or state moves the
# logits by O(1).
F32_HANDOFF_LIMIT = 1e-3


def check_f32_handoff(torch, api, params, cfg, sal, label, prompts):
    """The model's state handoff with f32 weights and compute through the
    kernels (the float GEMV on the CUDA cores): a prefill of each prompt
    and one decode step of a token against a one-shot prefill of the
    prompt and the token, within F32_HANDOFF_LIMIT."""
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")

    def f32(tree):
        return {k: f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}

    p32 = f32(params)
    worst = 0.0
    for prompt in prompts:
        toks = torch.as_tensor(prompt, dtype=torch.int64, device="cuda")[None]
        _, cache = api.prefill(p32, {"tokens": toks}, cfg32, sal, max_len=256)
        tok = torch.tensor([7], dtype=torch.int32, device="cuda")
        step, _ = api.decode_step(p32, tok, cache, cfg32, sal)
        ext = torch.cat([toks, tok[None].long()], dim=1)
        worst = max(worst, rel_gap(step[0], api.prefill(
            p32, {"tokens": ext}, cfg32, sal, max_len=256)[0][0]))
    log(f"  state handoff [{label}] in f32 (weights and compute): a prefill and one decode "
        f"step vs a one-shot prefill of the prompt and the token, {len(prompts)} prompts: "
        f"{worst:.3e} (limit {F32_HANDOFF_LIMIT:.0e})")
    if worst > F32_HANDOFF_LIMIT:
        raise AssertionError(f"state handoff [{label}] in f32: {worst:.3e}")
    del p32
    torch.cuda.empty_cache()


def ssm_phase(torch, np, mods, counted, quantize, prompts, new_tokens, card, seed):
    """Phase 15: mamba2-370m and zamba2-1.2B at full width, 24 of 48 and 19 of
    38 layers (CUT_LAYERS), bf16
    random weights, on the dense cache (the reference serves them on
    nothing else): the first MODEL_PHASE_REQUESTS (6) of phase 4's requests
    through ServingEngine(paged=False) (4 slots, so two requests enter a
    slot another used; max_len 256) exact and LUT for both and with
    quantize_params_int8 weights (q1) for mamba2, and generate() on 4
    prompts of 128 tokens, exact, for both. Gates: every request finishes,
    every slot parks at 0, every step's launches (`dense_expect`), and
    `check_ssm_drain`'s within FIRST_LOGITS_LIMIT (each stage of a prompt's
    prefill, kernels against the plain versions on the same input; the
    engine's first logits and its logits after the first decode step
    against a batch of one; q1, bit for bit on the plain path, against a
    one-shot plain prefill), generate()'s batch stage by stage, and the
    state handoff in f32 (`check_f32_handoff`). At full depth bf16
    roundings amplified by 38-48 layers move the first logits by more than
    FIRST_LOGITS_LIMIT on the plain path alone (one bf16 step of the
    embeddings), so the one-shot comparisons against the plain path and
    across the prefill/decode boundary are reported beside that measure.
    Reported: each model's decode step and 128-token admission
    (`time_ssm_model`), each drain's roofline, and launch/serve.py serving
    mamba2-370m at full width. Returns ({path:
    counts}, {label: times})."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import generate
    api, SalPimConfig, SalPimEngine, _, GenConfig = mods[:5]
    kernels = mods[-1]
    counts, times = {}, {}
    path_kernels = ["gemv_pim_float", TC, "layernorm_lut", "lut_interp"]
    gen_prompts = np.random.RandomState(seed + 15).randint(2, 32000, size=(4, 128))
    for name in ("mamba2_370m", "zamba2_1_2b"):
        cfg = cut_config(get_config, name)
        t0 = time.perf_counter()
        params = api.init_params(cfg, seed=seed, device="cuda")
        n_params = check_param_count(params, cfg, cfg.name)
        segs = f", shared attention + GeGLU before each of {attention_layers(cfg)} segments" \
            if cfg.family == "hybrid" else ""
        log(f"  {cfg.name} at full width, depth cut from {get_config(name).n_layers} to "
            f"{cfg.n_layers} ({cfg.n_layers} Mamba2 layers, d "
            f"{cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_heads} SSM heads x "
            f"{cfg.ssm_headdim}, state {cfg.ssm_state}, vocab {cfg.vocab}{segs}): "
            f"{n_params / 1e9:.3f} B parameters, {2 * n_params / 1e9:.2f} GB in bf16; random "
            f"weights ({time.perf_counter() - t0:.1f} s)")
        rng = np.random.RandomState(seed + 15)
        ps = prompts if cfg.vocab >= 50257 else [rng.randint(2, cfg.vocab, size=len(p))
                                                 for p in prompts]
        drains = [("exact", params, dict()), ("lut", params, dict(mode="lut"))]
        if cfg.family == "ssm":
            drains.append(("q1 int8 weights", quantize.quantize_params_int8(params),
                           dict(gemv="gemv_pim_int8_linear")))
        handoffs = {label: {} for label, _, _ in drains}
        short = cfg.name.split("-")[0]

        def drive():
            out = {}
            sal = SalPimEngine.create(SalPimConfig())
            out["generate"] = drive_generate(torch, generate, GenConfig, kernels, params, cfg,
                                             sal, gen_prompts, new_tokens)
            for label, p, kw in drains:
                out[label] = serve_dense(torch, mods, p, cfg, ps, new_tokens, card,
                                         label=f"{short} {label}", handoff=handoffs[label],
                                         **kw)
            return out

        extra = ["decode_attention", "softmax_lut"] if cfg.family == "hybrid" else \
            ["gemv_pim_int8_linear", TC8L]
        runs, counts[cfg.name] = counted(cfg.name, drive, path_kernels + extra)
        for label, p, kw in drains:
            eng, done, first, _ = runs[label]
            mode = kw.get("mode", "exact")
            sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode))
            check_ssm_drain(torch, api, p, cfg, sal, f"{short} {label}", ps, done, first,
                            handoffs[label], plain_gate=label.startswith("q1"))
            roofline_report(eng, f"{short} {label}", card,
                            eng.cost_model.describe()["hardware"])
            dec = eng.stats()["roofline"]["decode"]
            log(f"  roofline[{short} {label}] modeled decode bytes a step: "
                f"{dec['modeled_bytes'] / eng.decode_steps / 1e9:.3f} GB (the weight stream; "
                f"the cost model prices no SSM state)")
        sal = SalPimEngine.create(SalPimConfig())
        gen_toks = torch.as_tensor(gen_prompts, device="cuda")
        worst, where = ssm_stage_gaps(torch, params, cfg, sal, gen_toks)
        logits = api.prefill(params, {"tokens": gen_toks}, cfg, sal, max_len=129)[0]
        shot = max(rel_gap(logits[b], one_shot_plain_logits(torch, api, params, cfg, sal,
                                                            gen_prompts[b], "dense"))
                   for b in range(len(gen_prompts)))
        log(f"  generate[{short}] prefill of the batch of 4, each stage through the kernels "
            f"vs the plain versions on the same input: at most {worst:.3e} ({where}; limit "
            f"{FIRST_LOGITS_LIMIT:.0e}); first logits vs one-shot plain prefills {shot:.3e} "
            f"(reported)")
        if worst > FIRST_LOGITS_LIMIT:
            raise AssertionError(f"generate[{short}]: {where} differs by {worst:.3e}")
        check_f32_handoff(torch, api, params, cfg, SalPimEngine.create(SalPimConfig()), short,
                          ps[:2])
        for mode in ("exact", "lut"):
            times[f"{short} {mode}"] = time_ssm_model(
                torch, api, params, cfg, SalPimEngine.create(SalPimConfig(nonlinear_mode=mode)),
                f"{short} {mode}", card, n_params)
        del params, drains, runs
        torch.cuda.empty_cache()
    log("  launch: python -m repro_torch.launch.serve --arch mamba2-370m --full --requests 8 "
        "--slots 4")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "mamba2-370m", "--full",
         "--requests", "8", "--slots", "4"], capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT)
    for line in (res.stdout + res.stderr).strip().splitlines()[-6:]:
        log(f"    {line}")
    if res.returncode != 0 or "8 requests through 4 slots" not in res.stdout:
        raise AssertionError(f"launch/serve.py --arch mamba2-370m exited {res.returncode}")
    log(f"  launch/serve.py served mamba2-370m's 8 requests in {time.perf_counter() - t0:.1f} "
        "s (process start included)")
    return counts, times


# ---------------------------------------------------------------------------
# Phase 3 at the encoder-decoder's shapes; phases 16-17
# ---------------------------------------------------------------------------

# whisper-large-v3's admission at 4 slots: 4 x 1500 frames through the
# encoder (M 6000 at every encoder linear and the decoder's cross K/V).
WHISPER_M = 4 * 1500


def time_encdec_kernels(torch, F, tlut, gemv_pim, layernorm_lut, attn, softmax_lut, seed):
    """The kernels at whisper-large-v3's shapes, each held to its plain
    version and timed beside it, a PyTorch call and its bound: the float
    GEMV at the encoder's M 6000 (d x d with the QKV bias, w_up with the
    tanh GELU, w_down; within the bf16 tolerance, on the tensor cores, its
    `gemv_plan` printed) and q1's int8 linear there (quantize_int8_rows +
    gemv_pim_int8, bit for bit); decode_attention over the 1500-key cross
    arena (4 slots x 20 kv heads, g 1, D 64, every key valid) and the
    161-position self arena (128..160 keys), exact and LUT (LUT held to the
    online walk), `arena_plan` printed; softmax_lut on the encoder's
    120000 unmasked f32 rows of 1500 keys (its plan printed); layernorm_lut
    at (6000, 1280) bf16 with beta, exact and LUT rsqrt, bit for bit.
    Returns ({kernel: max abs error}, {kernel: [timing rows]})."""
    from repro_torch.kernels.paged_attention import arena_plan
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 16)
    bank = tlut.LutBank.create(64)
    errs, rows = collections.defaultdict(float), collections.defaultdict(list)
    f32, bf16, M, d = torch.float32, torch.bfloat16, WHISPER_M, 1280

    def randn(*shape, std=1.0, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    def record(name, shape, ms, plain, lib, lib_name, bnd, by):
        rows[name].append(dict(shape=shape, ms=ms, plain_ms=plain, library_ms=lib,
                               bound_ms=bnd, bound_by=by))
        log(f"  {name} at {shape}: {ms * 1e3:.2f} us, plain {plain * 1e3:.2f} us, "
            f"{lib_name} {lib * 1e3:.2f} us, bound {bnd * 1e3:.2f} us ({by})")

    x = randn(M, d)
    for R, C, what, act, bias in ((d, d, "d x d + QKV bias (q, k, v, o; cross K/V)", None,
                                   True),
                                  (4 * d, d, "w_up + tanh GELU", "gelu", False),
                                  (d, 4 * d, "w_down", None, False)):
        n = 3
        xin = x if C == d else randn(M, C)
        ws = [randn(R, C, std=C ** -0.5) for _ in range(n)]
        b = randn(R, std=0.1) if bias else None
        plan = gemv_pim.gemv_plan(M, C, R, bf16)
        before = gemv_pim.gemv_pim_float.tc_launches
        got = gemv_pim.gemv_pim_float(xin, ws[0], b, act=act)
        if gemv_pim.gemv_pim_float.tc_launches != before + 1:
            raise AssertionError(f"gemv_pim_float ({R}, {C}) M {M}: not on the tensor cores")
        errs["gemv_pim_float"] = max(errs["gemv_pim_float"], compare(
            torch, f"gemv_pim_float ({R}, {C}) M {M}", got,
            gemv_pim.gemv_pim_plain(xin, ws[0], b, act=act), TOL["bfloat16"]))
        ms = time_graph(torch, lambda i: gemv_pim.gemv_pim_float(xin, ws[i], b, act=act), n)
        plain = time_graph(torch, lambda i: gemv_pim.gemv_pim_plain(xin, ws[i], b, act=act), n)
        gelu = (lambda t: F.gelu(t, approximate="tanh")) if act else (lambda t: t)
        lib = time_graph(torch, lambda i: gelu(F.linear(xin, ws[i], b)), n)
        bnd, by = bound_ms(2 * (M * C + R * C + M * R), 2 * M * R * C, "bfloat16")
        record("gemv_pim_float", f"({R}, {C}) bf16 M {M}, {what}; plan {plan}", ms, plain, lib,
               "F.linear" + (" + F.gelu" if act else ""), bnd, by)
        qs = [gemv_pim.quantize_int8_rows_plain(w.float()) for w in ws]
        qb = b.float() if b is not None else None
        got = gemv_pim.gemv_pim_int8_linear(xin, *qs[0], qb, compute=f32)
        if not torch.equal(got, gemv_pim.gemv_pim_int8_linear_plain(xin, *qs[0], qb,
                                                                    compute=f32)):
            raise AssertionError(f"q1 int8 linear ({R}, {C}) M {M}: not bit for bit")
        ms = time_graph(torch, lambda i: gemv_pim.gemv_pim_int8_linear(xin, *qs[i], qb,
                                                                       compute=f32), n)
        plain = time_graph(torch, lambda i: gemv_pim.gemv_pim_int8_linear_plain(
            xin, *qs[i], qb, compute=f32), n)
        lib = time_graph(torch, lambda i: F.linear(xin, ws[i], b), n)
        bnd, by = bound_ms(2 * M * C + R * C + 4 * R + 2 * M * R, 2 * M * R * C, "int8")
        record("gemv_pim_int8", f"q1 ({R}, {C}) int8, f32 scales, x bf16 M {M} "
               f"(quantize_int8_rows + gemv_pim_int8, bit for bit)", ms, plain, lib,
               "F.linear (bf16 weight)", bnd, by)
        del ws, qs

    H, D = 20, 64
    q = randn(4, H, D)
    for S, lens, what in ((1500, [1500] * 4, "cross arena"),
                          (161, [128, 137, 151, 160], "self arena")):
        n = 4
        arenas = [(randn(4, H, S, D), randn(4, H, S, D)) for _ in range(n)]
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        plan = arena_plan(4, H, S, 1, D, 2 * D)
        for mode, table, want_fn in (("exact", None, attn.decode_attention_plain),
                                     ("lut", bank.exp, attn.decode_attention_online_plain)):
            got = attn.decode_attention(q, *arenas[0], lengths, exp_table=table)
            errs["decode_attention"] = max(errs["decode_attention"], compare(
                torch, f"decode_attention {what} {mode}", got,
                want_fn(q, *arenas[0], lengths, exp_table=table), TOL["bfloat16"]))
        ms = time_graph(torch, lambda i: attn.decode_attention(q, *arenas[i], lengths), n)
        plain = time_graph(torch, lambda i: attn.decode_attention_plain(q, *arenas[i],
                                                                        lengths), n)
        key_ok = torch.arange(S, device=dev)[None, :] < lengths[:, None].long()
        lib = time_graph(torch, lambda i: F.scaled_dot_product_attention(
            q[:, :, None], *arenas[i], attn_mask=key_ok[:, None, None])[:, :, 0], n)
        keys = sum(lens) * H
        bnd, by = bound_ms(2 * keys * D * 2 + 2 * (2 * 4 * H * D) + 4 * 4, 4 * keys * D,
                           "bfloat16")
        record("decode_attention", f"whisper's {what}: B 4 x H {H} (g 1) x D {D}, arena {S}, "
               f"lengths {lens}, bf16, arena_plan {plan} (exact and LUT checked)", ms, plain,
               lib, "SDPA with a length mask", bnd, by)
        del arenas

    n = 3
    scores = [randn(4, H, 1, 1500, 1500, std=4.0, dtype=f32) for _ in range(n)]
    plan = softmax_lut.softmax_plan(4 * H * 1500, 1500, 4)
    got = softmax_lut.softmax_lut(scores[0], bank.exp, bank.recip)
    errs["softmax_lut"] = max(errs["softmax_lut"], compare(
        torch, "softmax_lut at whisper's encoder", got,
        softmax_lut.softmax_lut_plain(scores[0], bank.exp, bank.recip), TOL["float32"]))
    del got
    ms = time_graph(torch, lambda i: softmax_lut.softmax_lut(scores[i], bank.exp, bank.recip),
                    n, reps=10)
    plain = time_graph(torch, lambda i: softmax_lut.softmax_lut_plain(scores[i], bank.exp,
                                                                      bank.recip), n, reps=5)
    lib = time_graph(torch, lambda i: torch.softmax(scores[i], dim=-1), n, reps=10)
    elems = 4 * H * 1500 * 1500
    bnd, by = bound_ms(2 * 4 * elems, 5 * elems, "float32")
    record("softmax_lut", f"({4 * H}*1500, 1500) f32 unmasked scores of whisper's encoder "
           f"(4 x 1500 frames); plan (chunks, warps a row, rows a block) {plan}", ms, plain,
           lib, "torch.softmax", bnd, by)
    del scores
    torch.cuda.empty_cache()

    xs = [randn(M, d) for _ in range(6)]
    g, beta = randn(d, std=0.2) + 1.0, randn(d, std=0.2)
    plan = layernorm_lut.layernorm_plan(M, d, 2)
    for table in (None, bank.rsqrt):
        got = layernorm_lut.layernorm_lut(xs[0], g, beta, rsqrt_table=table)
        if not torch.equal(got, layernorm_lut.layernorm_lut_plain(xs[0], g, beta,
                                                                  rsqrt_table=table,
                                                                  wide_sums=True)):
            raise AssertionError(f"layernorm_lut ({M}, {d}) rsqrt_table={table is not None}: "
                                 "not bit for bit")
    ms = time_graph(torch, lambda i: layernorm_lut.layernorm_lut(xs[i], g, beta,
                                                                 rsqrt_table=bank.rsqrt), 6)
    plain = time_graph(torch, lambda i: layernorm_lut.layernorm_lut_plain(
        xs[i], g, beta, rsqrt_table=bank.rsqrt, wide_sums=True), 6)
    lib = time_graph(torch, lambda i: F.layer_norm(xs[i], (d,), g, beta, 1e-5), 6)
    bnd, by = bound_ms(2 * (2 * M * d + 2 * d), 8 * M * d, "float32")
    record("layernorm_lut", f"({M}, {d}) bf16 LayerNorm with beta, LUT rsqrt (whisper's "
           f"encoder; exact and LUT bit for bit); plan {plan}", ms, plain, lib,
           "F.layer_norm", bnd, by)
    return dict(errs), dict(rows)


def encdec_linear_shapes(cfg, B, S):
    """(M, C, R) of every linear an admission of B prompts of S tokens runs,
    in order: each encoder layer's q, k, v, o, w_up, w_down over B x enc_seq
    frames; each decoder layer's self q, k, v, o and cross q over the
    prompt, cross K/V over the frames, cross o, w_up, w_down; the LM head
    at the last positions."""
    d, f, Me, Md = cfg.d_model, cfg.d_ff, B * cfg.enc_seq, B * S
    enc = [(Me, d, d)] * 4 + [(Me, d, f), (Me, f, d)]
    dec = [(Md, d, d)] * 5 + [(Me, d, d)] * 2 + [(Md, d, d), (Md, d, f), (Md, f, d)]
    return enc * cfg.n_enc_layers + dec * cfg.n_layers + [(B, d, cfg.vocab)]


def encdec_expect(kernels, cfg, dec, prefills, lut, gemv="gemv_pim_float", two=0):
    """Launches of `dec` encoder-decoder decode steps and `prefills`
    admissions: a decode step 8 linears a decoder layer (self q, k, v, o;
    cross q, o; w_up; w_down: the cross K/V of the new token are not
    projected) + the LM head, 3 norms a layer + the final one, 2
    decode_attention a layer (self, cross); an admission 6 linears an
    encoder layer and 10 a decoder layer + the LM head, 2 norms an encoder
    layer + its final one and 3 a decoder layer + the final one, in LUT
    mode one softmax_lut an encoder layer and 2 a decoder layer. With int8
    weights (gemv "gemv_pim_int8_linear") `two` linears take
    quantize_int8_rows + gemv_pim_int8."""
    Le, L = cfg.n_enc_layers, cfg.n_layers
    n_lin = (8 * L + 1) * dec + (6 * Le + 10 * L + 1) * prefills
    expect = {name: 0 for name in kernels}
    expect.update({"layernorm_lut": (3 * L + 1) * dec + (2 * Le + 3 * L + 2) * prefills,
                   "decode_attention": 2 * L * dec,
                   "softmax_lut": (Le + 2 * L) * prefills if lut else 0})
    if gemv == "gemv_pim_float":
        expect.update({"gemv_pim_float": n_lin, TC: n_lin})
    else:
        expect.update({gemv: n_lin - two, TC8L: n_lin - two, "gemv_pim_int8": two, TC8: two,
                       "quantize_int8_rows": two})
    return expect


class EncdecWatch:
    """Wraps `api.prefill` and `api.decode_step` (which `generate()` calls)
    while open: checks each call's launches against `encdec_expect`, and
    keeps the admission's logits, the first decode step's, a copy of the
    cross arenas the admission wrote and the last cache."""

    def __init__(self, torch, api, kernels, cfg, lut, gemv, two):
        self.torch, self.api, self.kernels, self.cfg = torch, api, kernels, cfg
        self.lut, self.gemv, self.two = lut, gemv, two
        self.first = self.first_decode = self.cross = self.cache = None
        self.steps = 0

    def _counted(self, fn, dec, prefills, two):
        def call(*a, **k):
            before = {n: c.launches for n, c in self.kernels.items()}
            out = fn(*a, **k)
            d = {n: c.launches - before[n] for n, c in self.kernels.items()}
            want = encdec_expect(self.kernels, self.cfg, dec, prefills, self.lut, self.gemv,
                                 two)
            if d != want:
                raise AssertionError(f"{fn.__name__}: launches {d}, expected {want}")
            return out
        return call

    def __enter__(self):
        self.saved = self.api.prefill, self.api.decode_step
        prefill = self._counted(self.api.prefill, 0, 1, self.two)
        decode = self._counted(self.api.decode_step, 1, 0, 0)

        def watched_prefill(*a, **k):
            logits, cache = prefill(*a, **k)
            self.first = logits.clone()
            self.cross = (cache.cross_k.clone(), cache.cross_v.clone())
            self.cache = cache
            return logits, cache

        def watched_decode(*a, **k):
            logits, cache = decode(*a, **k)
            if self.steps == 0:
                self.first_decode = logits.clone()
            self.steps += 1
            self.cache = cache
            return logits, cache

        self.api.prefill, self.api.decode_step = watched_prefill, watched_decode
        return self

    def __exit__(self, *exc):
        self.api.prefill, self.api.decode_step = self.saved
        return False

    def cross_static(self) -> bool:
        return (self.torch.equal(self.cache.cross_k, self.cross[0])
                and self.torch.equal(self.cache.cross_v, self.cross[1]))


def encdec_stage_gaps(torch, params, cfg, sal, toks, frames, first_tokens):
    """Each stage of an admission and of the first decode step through the
    kernels against the plain versions (`plain_ops`) on the same input, the
    kernels' output feeding the next stage: each encoder layer and its
    final norm, each decoder layer over the prompt (cross-attending the
    kernels' encoder output) and the head; then each decoder layer of the
    decode step on a copy of the admission's cache, and the head. Returns
    the largest max |diff| / max |out| and its stage."""
    from repro_torch.models import blocks as blk
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tf
    enc_layers = tf._layers(params["enc_blocks"], cfg.n_enc_layers)
    dec_layers = tf._layers(params["dec_blocks"], cfg.n_layers)
    B, S = toks.shape
    worst, where = 0.0, None

    def stage(label, fn, x):
        nonlocal worst, where
        out = fn(x)
        with plain_ops(sal.nl.mode):
            gap = rel_gap(out, fn(x))
        if gap >= worst:
            worst, where = gap, label
        return out

    x = frames.to(cfg.cdtype) + params["enc_pos"][None].to(cfg.cdtype)
    for i, bp in enumerate(enc_layers):
        x = stage(f"encoder layer {i}", lambda h, bp=bp: encdec.encode_layer(bp, h, cfg, sal), x)
    enc = stage("the encoder's final norm", lambda h: blk.apply_norm(
        params["enc_norm"], h, cfg, sal), x)
    pos = torch.arange(S, device=toks.device)
    x = encdec._dec_embed(params, toks, pos[None].expand(B, S), cfg)
    for i, bp in enumerate(dec_layers):
        x = stage(f"decoder layer {i} (prefill)", lambda h, bp=bp: encdec.decode_layer_prefill(
            bp, h, enc, cfg, sal)[0], x)
    stage("the final norm and LM head (prefill)", lambda h: encdec._logits(params, h[:, -1],
                                                                          cfg, sal), x)
    _, cache = encdec.prefill(params, frames, toks, cfg, sal, max_len=S + 1)
    x = encdec._dec_embed(params, first_tokens[:, None], cache.lengths[:, None], cfg)[:, 0]
    enc_len = torch.full((B,), cfg.enc_seq, dtype=torch.int32, device=toks.device)
    for i, bp in enumerate(dec_layers):
        x = stage(f"decoder layer {i} (decode step)", lambda h, bp=bp, i=i: (
            encdec.decode_layer_step(bp, h, cache, i, enc_len, cfg, sal)), x)
    stage("the final norm and LM head (decode step)", lambda h: encdec._logits(
        params, h, cfg, sal), x)
    del cache
    return worst, where


def whisper_generate(torch, mods, params, cfg, sal, toks, frames, new_tokens, label, *,
                     gemv="gemv_pim_float"):
    """generate(extra_inputs={"frames": ...}) of the batch `toks` (B, S),
    each call's launches checked (`EncdecWatch`: every decode step and the
    admission); the cross arenas after the last decode step must be the
    admission's bit for bit. Returns (tokens, the watch, seconds)."""
    from repro_torch.kernels import gemv_pim
    from repro_torch.serving.engine import generate
    api, GenConfig, kernels = mods[0], mods[4], mods[-1]
    B, S = toks.shape
    two = 0
    if gemv != "gemv_pim_float":
        two = sum(gemv_pim.gemv_int8_linear_plan(*shape) is None
                  for shape in encdec_linear_shapes(cfg, B, S))
    lut = sal.nl.mode == "lut"
    with EncdecWatch(torch, api, kernels, cfg, lut, gemv, two) as watch:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, st = generate(params, toks, cfg, sal,
                           GenConfig(max_new_tokens=new_tokens, stop_on_eos=False),
                           extra_inputs={"frames": frames}, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if watch.steps != new_tokens or watch.first is None:
        raise AssertionError(f"generate[{label}]: {watch.steps} decode steps")
    if tuple(out.shape) != (B, new_tokens) or not bool(((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"generate[{label}]: tokens {tuple(out.shape)} out of range")
    if not watch.cross_static():
        raise AssertionError(f"generate[{label}]: the cross arenas changed after the admission")
    dec = encdec_expect(kernels, cfg, 1, 0, lut, gemv)
    adm = encdec_expect(kernels, cfg, 0, 1, lut, gemv, two)
    tc = TC if gemv == "gemv_pim_float" else TC8L
    two_s = (f" ({two} of them quantize_int8_rows + gemv_pim_int8)" if two else "")
    log(f"  generate[{label}]: {B} x {S} prompt tokens over {B} x {cfg.enc_seq} frames, "
        f"{new_tokens} new tokens, {st['tokens']} tokens; prefill {st['prefill_sec'] * 1e3:.1f} "
        f"ms, decode {st['decode_sec'] * 1e3:.1f} ms = {st['sec_per_token'] * 1e3:.2f} ms per "
        f"token a sequence; {wall:.3f} s in all")
    log(f"  generate[{label}] launches checked at every call: a decode step {dec[gemv]} {gemv} "
        f"({dec[tc]} on the tensor cores), {dec['decode_attention']} decode_attention, "
        f"{dec['layernorm_lut']} layernorm_lut; the admission {adm[gemv] + adm['gemv_pim_int8']} "
        f"linears{two_s}, {adm['layernorm_lut']} layernorm_lut, {adm['softmax_lut']} "
        f"softmax_lut; no paged kernel; the cross arenas ({2 * watch.cross[0].numel() * 2 / 1e9:.3f} "
        f"GB) after the last decode step bit for bit the admission's")
    return out, watch, wall


def check_whisper_drain(torch, api, params, cfg, sal, label, toks, frames, out, watch, *,
                        plain_gate):
    """The gates of a whisper generate() drain, within FIRST_LOGITS_LIMIT:
    every stage of the admission and of the first decode step through the
    kernels against the plain versions on the same input
    (`encdec_stage_gaps`); each sequence's first logits and first-decode
    logits against a batch of one through the kernels (its prompt and its
    frames alone: another M at every linear and another B at the
    attention); with `plain_gate` (q1, bit for bit on the plain path) the
    first logits against a one-shot prefill on the plain versions.
    Reported: that one-shot comparison, and whether the batch-of-one
    comparisons are bit for bit."""
    B, S = toks.shape
    stage, where = encdec_stage_gaps(torch, params, cfg, sal, toks, frames, out[:, 0])
    first = dec = 0.0
    exact = 0
    for b in range(B):
        logits, cache = api.prefill(params, {"tokens": toks[b:b + 1], "frames": frames[b:b + 1]},
                                    cfg, sal, max_len=S + 2)
        step, _ = api.decode_step(params, out[b:b + 1, 0].to(torch.int32), cache, cfg, sal)
        first = max(first, rel_gap(watch.first[b], logits[0]))
        dec = max(dec, rel_gap(watch.first_decode[b], step[0]))
        exact += int(torch.equal(watch.first[b], logits[0])) + int(
            torch.equal(watch.first_decode[b], step[0]))
    with plain_ops(sal.nl.mode):
        want = api.prefill(params, {"tokens": toks, "frames": frames}, cfg, sal,
                           max_len=S)[0].float()
    shot = max(rel_gap(watch.first[b], want[b]) for b in range(B))
    agree = sum(int(int(want[b].argmax()) == int(out[b, 0])) for b in range(B))
    log(f"  generate[{label}] each stage of the admission and the first decode step through "
        f"the kernels vs the plain versions on the same input at most {stage:.3e} ({where}); "
        f"first logits vs a batch of one through the kernels {first:.3e}, first-decode logits "
        f"{dec:.3e} ({exact}/{2 * B} bit for bit) (limit {FIRST_LOGITS_LIMIT:.0e} each)")
    log(f"  generate[{label}] first logits vs a one-shot plain prefill {shot:.3e}"
        f"{f' (limit {FIRST_LOGITS_LIMIT:.0e})' if plain_gate else ' (reported)'}, first "
        f"tokens equal {agree}/{B}")
    if max(stage, first, dec) > FIRST_LOGITS_LIMIT or (plain_gate and shot > FIRST_LOGITS_LIMIT):
        raise AssertionError(f"generate[{label}]: stage {stage:.3e} ({where}), batch of one "
                             f"{first:.3e} / {dec:.3e}, one-shot plain {shot:.3e}")
    return dict(stage=stage, first=first, first_decode=dec, exact=exact, shot=shot)


def time_whisper(torch, api, params, cfg, sal, toks, frames, label, card, n_params):
    """whisper's decode step at 4 slots on an admission's cache (128..
    tokens of context, the 1500-key cross arenas) and the admission itself
    (4 x 1500 frames and the prompts, max_len S + 33): on the host clock
    around eager calls with a synchronise, and on the device alone, each
    replayed as a CUDA graph; beside their bounds (the step: the decoder's
    weights it reads, the LM head, the cross arenas and the self keys and
    values once; the admission: the larger of its linears' bf16 operations
    and the f32 Q.K^T products over their peaks, plus the S.V products),
    and the eager PyTorch operations of a step."""
    B, S = toks.shape
    max_len = S + 33
    _, cache = api.prefill(params, {"tokens": toks, "frames": frames}, cfg, sal, max_len=max_len)
    tok = torch.full((B,), 5, dtype=torch.int32, device="cuda")
    step_ms = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.decode_step(params, tok, cache, cfg, sal)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    host = statistics.median(step_ms[2:])
    device = time_graph(torch, lambda i: api.decode_step(params, tok, cache, cfg, sal), 1)
    ops = eager_ops(torch, lambda: api.decode_step(params, tok, cache, cfg, sal))
    del cache
    adm_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.prefill(params, {"tokens": toks, "frames": frames}, cfg, sal, max_len=max_len)
        torch.cuda.synchronize()
        adm_ms.append(1e3 * (time.perf_counter() - t0))
    adm_host = statistics.median(adm_ms[1:])
    adm_dev = time_graph(torch, lambda i: api.prefill(params, {"tokens": toks, "frames": frames},
                                                      cfg, sal, max_len=max_len), 1, reps=5)
    d, L, Le, V = cfg.d_model, cfg.n_layers, cfg.n_enc_layers, cfg.vocab
    H, Dh, Senc = cfg.n_heads, cfg.head_dim, cfg.enc_seq
    weights = 2 * (L * (6 * d * d + 2 * d * cfg.d_ff) + V * d)
    cross = 2 * 2 * L * B * H * Senc * Dh
    self_kv = 2 * 2 * L * H * Dh * (B * S + B)
    bnd, by = bound_ms(weights + cross + self_kv, 2 * B * (n_params - V * d), "bfloat16")
    lin_flops = 2 * sum(m * c * r for m, c, r in encdec_linear_shapes(cfg, B, S))
    qk = 2 * B * H * Dh * (Le * Senc * Senc + L * (S * S + S * Senc))
    adm_bnd = 1e3 * (lin_flops / 989e12 + qk / PEAK_FLOPS["float32"] + qk / 989e12)
    top = ", ".join(f"{k.replace('aten.', '').replace('.default', '')} {v}"
                    for k, v in ops.most_common(8))
    log(f"  decode step [{label}] ({card}): {host:.2f} ms eager on the host clock, "
        f"{device:.3f} ms on the device (host share {1 - device / host:.0%}), {B} slots x {S} "
        f"context + the {Senc}-key cross arenas; bound {bnd:.3f} ms ({by}: {weights / 1e9:.3f} "
        f"GB of decoder weights and LM head, {cross / 1e9:.3f} GB of cross K/V, "
        f"{self_kv / 1e9:.4f} GB of self K/V); {sum(ops.values())} eager PyTorch operations a "
        f"step ({top}, ...)")
    log(f"  admission [{label}] ({card}): {B} x {Senc} frames + {B} x {S} tokens, "
        f"{adm_host:.2f} ms eager on the host clock, {adm_dev:.3f} ms on the device; bound "
        f"{adm_bnd:.2f} ms ({lin_flops / 1e12:.2f} TFLOP of bf16 linears at 989 TFLOP/s, "
        f"{qk / 1e12:.3f} TFLOP of f32 Q.K^T at {PEAK_FLOPS['float32'] / 1e12:.0f} TFLOP/s "
        f"and as much S.V in bf16)")
    return dict(host=host, device=device, bound_ms=bnd, bound_by=by, ops=sum(ops.values()),
                admit_host=adm_host, admit_device=adm_dev, admit_bound_ms=adm_bnd)


def whisper_phase(torch, np, mods, counted, quantize, card, seed, new_tokens):
    """Phase 16: whisper-large-v3 at its published widths and depth (32
    encoder + 32 decoder layers, d 1280, 20 heads x 64, d_ff 5120, vocab
    51866, enc_seq 1500; bf16 random weights from `seed`), served through
    generate(extra_inputs={"frames": ...}), its one entry point (the
    reference's ServingEngine cannot serve it): frames (4, 1500, 1280)
    from `seed`, 4 prompts of 32..128 tokens (one length a drain, which
    generate() needs), new_tokens new ones; drains exact, LUT and q1
    (`quantize_params_int8` weights). Gates: each call's launches
    (`EncdecWatch`), the cross arenas static, and `check_whisper_drain`'s.
    Reported: the decode step and the admission on the host clock and the
    device (`time_whisper`), exact and LUT; `ServingEngine` refusing the
    family. Returns ({path: counts}, times)."""
    from repro_torch.configs import get_config
    api, SalPimConfig, SalPimEngine, EngineConfig, _, ServingEngine = mods[:6]
    cfg = get_config("whisper_large_v3")
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=seed, device="cuda")
    n_params = check_param_count(params, cfg, cfg.name)
    log(f"  {cfg.name} at full width and depth ({cfg.n_enc_layers} encoder + {cfg.n_layers} "
        f"decoder layers, d {cfg.d_model}, {cfg.n_heads} heads x {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, enc_seq {cfg.enc_seq}): {n_params / 1e9:.3f} B "
        f"parameters, {2 * n_params / 1e9:.2f} GB in bf16; random weights "
        f"({time.perf_counter() - t0:.1f} s)")
    try:
        ServingEngine(params, cfg, SalPimEngine.create(), EngineConfig(slots=4, max_len=256),
                      device="cuda")
        raise AssertionError("ServingEngine served the encoder-decoder family")
    except ValueError as e:
        log(f"  ServingEngine refuses it: {e}")
    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    frames = torch.randn((4, cfg.enc_seq, cfg.d_model), generator=gen, device="cuda").to(
        cfg.cdtype)
    rng = np.random.RandomState(seed + 16)
    lens = [int(n) for n in rng.randint(32, 129, size=3)]
    qparams = quantize.quantize_params_int8(params)
    drains = [("whisper exact", params, "exact", "gemv_pim_float"),
              ("whisper lut", params, "lut", "gemv_pim_float"),
              ("whisper q1 int8 weights", qparams, "exact", "gemv_pim_int8_linear")]
    toks = {label: torch.as_tensor(rng.randint(2, cfg.vocab, size=(4, n)), device="cuda")
            for (label, *_), n in zip(drains, lens)}

    def drive():
        return {label: whisper_generate(torch, mods, p, cfg,
                                        SalPimEngine.create(SalPimConfig(nonlinear_mode=mode)),
                                        toks[label], frames, new_tokens, label, gemv=gemv)
                for label, p, mode, gemv in drains}

    runs, counts = counted(cfg.name, drive, ["gemv_pim_float", TC, "decode_attention",
                                             "layernorm_lut", "softmax_lut",
                                             "gemv_pim_int8_linear", TC8L, "gemv_pim_int8", TC8,
                                             "quantize_int8_rows"])
    gates = {}
    for label, p, mode, gemv in drains:
        out, watch, _ = runs[label]
        sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode))
        gates[label] = check_whisper_drain(torch, api, p, cfg, sal, label, toks[label], frames,
                                           out, watch, plain_gate=gemv != "gemv_pim_float")
    del runs, qparams
    torch.cuda.empty_cache()
    times = {}
    t_toks = torch.as_tensor(rng.randint(2, cfg.vocab, size=(4, 128)), device="cuda")
    for mode in ("exact", "lut"):
        times[f"whisper {mode}"] = time_whisper(
            torch, api, params, cfg, SalPimEngine.create(SalPimConfig(nonlinear_mode=mode)),
            t_toks, frames, f"whisper {mode}", card, n_params)
    del params
    torch.cuda.empty_cache()
    return {cfg.name: counts}, dict(times=times, gates=gates)


def vlm_phase(torch, F, np, mods, counted, plain, quant, quantize, prompts, new_tokens, card,
              seed):
    """Phase 17: qwen2-vl-2B's text path at full width and depth (28
    layers; qwen2's widths with M-RoPE sections (16, 24, 24); bf16 random
    weights from `seed`): phase 4's 8 requests through the paged engine,
    exact (phase 4's checks at every step), and generate() on 4 prompts of
    128 tokens, exact; first logits of both against a one-shot plain
    prefill within FIRST_LOGITS_LIMIT; then its decode step and chunk
    (`time_model`). Returns ({path: counts}, times)."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import generate
    api, SalPimConfig, SalPimEngine, _, GenConfig = mods[:5]
    kernels = mods[-1]
    cfg = get_config("qwen2_vl_2b")
    params = api.init_params(cfg, seed=seed, device="cuda")
    n_params = check_param_count(params, cfg, cfg.name)
    log(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads x {cfg.head_dim}, M-RoPE sections {cfg.mrope_sections}, vocab {cfg.vocab}: "
        f"{n_params / 1e9:.3f} B parameters; the text path (M-RoPE's three streams each "
        f"token's position)")
    gen_prompts = np.random.RandomState(seed + 17).randint(2, cfg.vocab, size=(4, 128))
    sal = SalPimEngine.create(SalPimConfig())

    def drive():
        return {"paged": serve(torch, mods, params, cfg, prompts, new_tokens, card,
                               label="qwen2-vl exact"),
                "generate": drive_generate(torch, generate, GenConfig, kernels, params, cfg,
                                           sal, gen_prompts, new_tokens)}

    runs, counts = counted(cfg.name, drive, ["gemv_pim_float", TC, "paged_attention",
                                             "paged_prefill_attention", "decode_attention",
                                             "layernorm_lut"])
    _, done, first, _ = runs["paged"]
    check_first_logits(torch, F, params, cfg, sal, prompts, done, first, "qwen2-vl exact", "fp",
                       quant, quantize, plain)
    logits, _ = api.prefill(params, {"tokens": torch.as_tensor(gen_prompts, device="cuda")},
                            cfg, sal, max_len=129)
    worst, agree = 0.0, 0
    for b in range(len(gen_prompts)):
        want = plain_prefill_logits(torch, F, params, cfg, sal, gen_prompts[b], quant, quantize,
                                    plain, "dense")
        worst = max(worst, rel_gap(logits[b], want))
        agree += int(int(torch.argmax(want)) == int(runs["generate"][b, 0]))
    log(f"  generate[qwen2-vl exact] first logits vs a plain one-shot prefill (dense): "
        f"{worst:.3e} (limit {FIRST_LOGITS_LIMIT:.0e}); first tokens equal {agree}/"
        f"{len(gen_prompts)}")
    if worst > FIRST_LOGITS_LIMIT:
        raise AssertionError(f"generate[qwen2-vl exact]: first logits differ by {worst:.3e}")
    times = time_model(torch, api, params, cfg, sal, prompts, card, label="qwen2-vl exact")
    del params, runs
    torch.cuda.empty_cache()
    return {cfg.name: counts}, times


# ---------------------------------------------------------------------------
# Phase 18: training on one card
# ---------------------------------------------------------------------------

def time_events(torch, fn, reps: int = 5) -> float:
    """Median ms of `fn()` between two CUDA events, after one warm-up call
    (for calls that run autograd, which a CUDA graph does not capture)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def autograd_of(torch, f, inputs, dy):
    """The gradients of f(*inputs) against dy by autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        return torch.autograd.grad(f(*leaves), leaves, dy)


def check_backward_kernels(torch, F, tlut, layernorm_lut, lut_interp, softmax_lut, card, seed):
    """Phase 18 (a): the three backward kernels against their plain twins
    at the training path's shapes (GPT-2 medium, batch 8 x seq 1024):
    `lut_interp_backward` on w_up's (8192, 4096) bf16 LUT GELU, bit for
    bit; `layernorm_lut_backward` on (8192, 1024) bf16 LayerNorm rows with
    beta, exact and LUT rsqrt (3e-2); `softmax_lut_backward` on the
    (8*16*1024, 1024) f32 causal LUT softmax of one layer (1e-5). Each is
    timed beside its plain twin (autograd of the plain version), the
    library's counterpart (autograd of F.gelu, F.layer_norm,
    torch.softmax) and its bound. Returns (errs, times)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 18)
    bank = tlut.LutBank.create(64)
    errs, times = {}, {}

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    # The LUT GELU's slope kernel.
    x, dy = randn(8192, 4096, std=3.0), randn(8192, 4096)
    got = lut_interp.lut_interp_backward(x, dy, bank.gelu)
    torch.cuda.synchronize()
    want = lut_interp.lut_interp_backward_plain(x, dy, bank.gelu)
    off = int((got != want).sum())
    log(f"  lut_interp_backward (8192, 4096) bf16 GELU: {off} of {got.numel()} elements off "
        "the plain twin's bits")
    if off:
        raise AssertionError("lut_interp_backward is not bit for bit its plain twin")
    errs["lut_interp_backward"] = 0.0
    ms = time_graph(torch, lambda i: lut_interp.lut_interp_backward(x, dy, bank.gelu), 4)
    plain = time_events(torch, lambda: lut_interp.lut_interp_backward_plain(x, dy, bank.gelu))
    lib = time_events(torch, lambda: autograd_of(
        torch, lambda t: F.gelu(t, approximate="tanh"), [x], dy))
    bnd, by = bound_ms(3 * x.numel() * 2, 2 * x.numel(), "bfloat16")
    times["lut_interp_backward"] = dict(
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
        shape="(8192, 4096) bf16, w_up's LUT GELU at batch 8 x seq 1024; library: autograd "
              "of F.gelu(tanh)")
    log(f"  lut_interp_backward [(8192, 4096) bf16]: {ms:.4f} ms, plain {plain:.4f} ms, "
        f"autograd of F.gelu {lib:.4f} ms, bound {bnd:.4f} ms ({by}) ({card})")

    # The LayerNorm's backward, exact and LUT rsqrt.
    n, d = 8192, 1024
    x, dy = randn(n, d, std=2.0), randn(n, d)
    g, b = randn(d, std=0.2) + 1.0, randn(d, std=0.2)
    worst, row = 0.0, None
    for mode, table in (("exact", None), ("lut", bank.rsqrt)):
        kw = dict(eps=1e-5, rsqrt_table=table)
        got = layernorm_lut.layernorm_lut_backward(x, g, b, dy, **kw)
        torch.cuda.synchronize()
        want = layernorm_lut.layernorm_lut_backward_plain(x, g, b, dy, **kw)
        for name, a, w in zip(("dx", "dgamma", "dbeta"), got, want):
            worst = max(worst, compare(torch, f"layernorm_lut_backward {mode} {name}", a, w,
                                       TOL["bfloat16"]))
        again = layernorm_lut.layernorm_lut_backward(x, g, b, dy, **kw)
        if not (torch.equal(again[1], got[1]) and torch.equal(again[2], got[2])):
            raise AssertionError("layernorm_lut_backward: dgamma/dbeta differ between runs")
        ms = time_graph(torch, lambda i: layernorm_lut.layernorm_lut_backward(x, g, b, dy, **kw),
                        4)
        plain = time_events(torch, lambda: layernorm_lut.layernorm_lut_backward_plain(
            x, g, b, dy, **kw))
        log(f"  layernorm_lut_backward [({n}, {d}) bf16, beta, {mode}]: within "
            f"{TOL['bfloat16']:.0e} of the plain twin, dgamma/dbeta the same bits twice; "
            f"{ms:.4f} ms, plain {plain:.4f} ms ({card})")
        if mode == "lut":
            lib = time_events(torch, lambda: autograd_of(
                torch, lambda t, gg, bb: F.layer_norm(t, (d,), gg, bb, 1e-5), [x, g, b], dy))
            bnd, by = bound_ms(3 * n * d * 2 + 4 * d * 2, 10 * n * d, "bfloat16")
            row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
                       shape=f"({n}, {d}) bf16 LayerNorm with beta, LUT rsqrt (dx, dgamma, "
                             "dbeta); library: autograd of F.layer_norm")
            log(f"  layernorm_lut_backward: autograd of F.layer_norm {lib:.4f} ms, bound "
                f"{bnd:.4f} ms ({by}) ({card})")
    errs["layernorm_lut_backward"] = worst
    times["layernorm_lut_backward"] = row

    # The causal LUT softmax of one layer's scores (f32).
    B, H, S = 8, 16, 1024
    x = randn(B, H, S, S, std=2.0, dtype=torch.float32)
    dy = randn(B, H, S, S, dtype=torch.float32)
    kw = dict(q_offset=0, causal=True, window=None)
    got = softmax_lut.softmax_lut_backward(x, dy, bank.exp, bank.recip, **kw)
    torch.cuda.synchronize()
    want = softmax_lut.softmax_lut_backward_plain(x, dy, bank.exp, bank.recip, **kw)
    errs["softmax_lut_backward"] = compare(torch, "softmax_lut_backward", got, want, 1e-5)
    del got, want
    ms = time_graph(torch, lambda i: softmax_lut.softmax_lut_backward(
        x, dy, bank.exp, bank.recip, **kw), 2)
    plain = time_events(torch, lambda: softmax_lut.softmax_lut_backward_plain(
        x, dy, bank.exp, bank.recip, **kw), reps=3)
    mask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()

    def library():
        return autograd_of(torch, lambda t: torch.softmax(t.masked_fill(~mask, -torch.inf), -1),
                           [x], dy)
    lib = time_events(torch, library, reps=3)
    visible = B * H * S * (S + 1) // 2
    bnd, by = bound_ms(2 * visible * 4 + x.numel() * 4, 6 * visible, "float32")
    times["softmax_lut_backward"] = dict(
        ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd, bound_by=by,
        shape=f"({B}*{H}*{S}, {S}) f32 causal, one layer's scores at batch 8 x seq 1024; "
              "bound on the visible keys; library: autograd of a masked torch.softmax")
    log(f"  softmax_lut_backward [({B}*{H}*{S}, {S}) f32 causal]: within "
        f"1e-05 of the plain twin (max {errs['softmax_lut_backward']:.3e}); "
        f"{ms:.4f} ms, plain {plain:.4f} ms, autograd of torch.softmax {lib:.4f} ms, bound "
        f"{bnd:.4f} ms ({by}) ({card})")
    del x, dy
    torch.cuda.empty_cache()
    return errs, times


@contextlib.contextmanager
def plain_training(mode):
    """Every kernel of the training path held to its plain version: the
    `ops` entries plain (`plain_ops`) and no autograd Function, so that
    autograd differentiates the plain versions themselves."""
    from repro_torch.core import nonlinear
    route = nonlinear.autograd_route
    nonlinear.autograd_route = lambda *a: False
    try:
        with plain_ops(mode):
            yield
    finally:
        nonlinear.autograd_route = route


def train_phase(torch, np, mods, counted, card, seed, cfg=None, B=8, S=1024, device="cuda"):
    """Phase 18: training GPT-2 medium at full width and depth (24 layers,
    d 1024, vocab 50257; bf16, remat "block") on batches of 8 x 1024
    tokens from `data.tokens`. (b) one step's loss and gradients, exact
    and LUT, through the kernels against the plain path on the same
    parameters and batch (loss and global gradient norm within 3e-2;
    each leaf's largest gap reported); (c) `run_training` in LUT mode, 4
    AdamW steps (the losses finite; s/step, tokens/s, peak memory, each
    kernel's launches a step), saving at step 2; (d) a second
    `run_training` from that checkpoint runs steps 3-4, against the
    straight run (the embedding's backward adds with atomics on the card,
    so the gap is gated at 1e-3 and whether it is bit for bit is said).
    (`cfg`, `B`, `S` and `device` let the phase be rehearsed small on
    the CPU.) Returns ({path: counts}, summary)."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.data import tokens as data_lib
    from repro_torch.runtime import optimizer as opt
    from repro_torch.runtime.train_loop import (TrainConfig, batch_to_device, make_train_step,
                                                run_training)
    api, SalPimConfig, SalPimEngine = mods[:3]
    cfg = cfg or get_config("gpt2_medium")
    cuda = device == "cuda"
    dcfg = data_lib.data_config_for_model(cfg, S, B, seed=seed)
    log(f"  {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab}, "
        f"{cfg.param_dtype}, remat {cfg.remat!r}; batch {B} x {S} tokens")

    # (b) one step, kernels against the plain path; and the plain path
    # against itself with the embeddings moved one bf16 step, the size of
    # the gaps that bf16 rounding alone makes (a LUT's gradient is
    # piecewise constant, and a softmax row's max takes a share of the
    # row's gradient, so one rounding can move a section or a max).
    t_b = time.perf_counter()
    params = api.init_params(cfg, seed=seed, device=device)
    batch = batch_to_device(data_lib.batch_at(dcfg, 0), device)
    moved = dict(params, embed=(params["embed"].float() * (1 + 2 ** -8)).to(cfg.pdtype))
    summary = {}

    def by_leaf(ga, gb):
        gaps = {key: float((a.float() - w.float()).abs().max()
                           / w.float().abs().max().clamp_min(1e-30))
                for (key, a), w in zip(opt.named_leaves(ga), opt.tree_leaves(gb))}
        return sorted(gaps.items(), key=lambda kv: -kv[1])

    for mode in ("exact", "lut"):
        sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode))

        def loss_fn(p, b):
            return api.loss_fn(p, b, cfg, sal)

        (lk, _), gk = opt.value_and_grad(loss_fn, params, batch)
        nk = float(opt.global_norm(gk))
        with plain_training(mode):
            (lp, _), gp = opt.value_and_grad(loss_fn, params, batch)
            (_, _), gq = opt.value_and_grad(loss_fn, moved, batch)
        np_ = float(opt.global_norm(gp))
        top, own = by_leaf(gk, gp), by_leaf(gq, gp)
        del gk, gp, gq
        dl, dn = abs(float(lk) - float(lp)) / abs(float(lp)), abs(nk - np_) / np_
        log(f"  step[{mode}]: loss {float(lk):.6f} (plain {float(lp):.6f}, gap {dl:.3e}); global "
            f"grad norm {nk:.6f} (plain {np_:.6f}, gap {dn:.3e}); limit 3e-2 each")
        log(f"  step[{mode}] largest relative grad gap by leaf (max |kernel - plain| / max "
            f"|plain|; reported): " + ", ".join(f"{k} {v:.3e}" for k, v in top))
        log(f"  step[{mode}] the plain path against itself, embeddings one bf16 step apart "
            f"(reported): " + ", ".join(f"{k} {v:.3e}" for k, v in own)
            + " (bk's gradient is 0 in exact arithmetic: rounding noise on both sides)")
        summary[f"gap_{mode}"] = (dl, dn, top, own)
        if not (dl <= 3e-2 and dn <= 3e-2) or not np.isfinite(float(lk)):
            raise AssertionError(f"step[{mode}]: kernels part from the plain path")
    del params, moved, batch
    if cuda:
        torch.cuda.empty_cache()
    log(f"  (b) took {time.perf_counter() - t_b:.1f} s")

    # (c) + (d): run_training in LUT mode, a straight run and a resumed one.
    sal = SalPimEngine.create(SalPimConfig(nonlinear_mode="lut"))
    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    ocfg = opt.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=4)
    runs = {}

    def drive():
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            runs["base"] = torch.cuda.memory_allocated()
        tc = TrainConfig(steps=4, ckpt_dir=str(root / "straight"), ckpt_every=2, keep=2,
                         log_every=1, async_ckpt=False)
        runs["straight"] = run_training(cfg, tc, ocfg, dcfg, engine=sal, seed=seed,
                                        device=device)
        runs["peak"] = torch.cuda.max_memory_allocated() - runs["base"] if cuda else 0
        shutil.copytree(root / "straight" / "step_00000002", root / "resumed" / "step_00000002")
        tc = dataclasses.replace(tc, ckpt_dir=str(root / "resumed"), ckpt_every=100)
        runs["resumed"] = run_training(cfg, tc, ocfg, dcfg, engine=sal, seed=seed,
                                       device=device)
        return runs

    path_kernels = ["gemv_pim_float", TC, "layernorm_lut", "softmax_lut", "lut_interp",
                    "lut_interp_backward", "layernorm_lut_backward", "softmax_lut_backward"]
    _, counts = counted("train", drive, path_kernels)
    hist = runs["straight"]["history"]
    losses = [r["loss"] for r in hist]
    if len(losses) != 4 or not all(np.isfinite(losses)):
        raise AssertionError(f"train: losses {losses}")
    sec = statistics.median(r["sec_per_step"] for r in hist[1:])
    steps = 6
    per_step = {k: counts[k] / steps for k in path_kernels}
    log(f"  run_training[lut] 4 AdamW steps: losses {[round(v, 6) for v in losses]}; median "
        f"{sec:.4f} s/step over steps 2-4 ({B * S / sec:.0f} tokens/s), peak memory "
        f"{runs['peak'] / 2 ** 30:.2f} GiB (max_memory_allocated above the "
        f"{runs.get('base', 0) / 2 ** 30:.2f} GiB the earlier phases still hold) ({card})")
    log(f"  launches a step (6 steps: 4 straight, 2 resumed): "
        + ", ".join(f"{k} {v:g}" for k, v in per_step.items()))
    res = runs["resumed"]["history"]
    if [r["step"] for r in res] != [2, 3]:
        raise AssertionError(f"resumed run took steps {[r['step'] for r in res]}")
    gaps = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(res, hist[2:])]
    same = [a["loss"] == b["loss"] for a, b in zip(res, hist[2:])]
    pa, pb = runs["resumed"]["params"], runs["straight"]["params"]
    bits = all(torch.equal(a, b) for a, b in zip(opt.tree_leaves(pa), opt.tree_leaves(pb)))
    log(f"  resume from the step-2 checkpoint: steps 3-4 losses "
        f"{[round(r['loss'], 6) for r in res]} against the straight run's "
        f"{[round(r['loss'], 6) for r in hist[2:]]}: relative gaps "
        f"{', '.join(f'{g:.3e}' for g in gaps)} (limit 1e-3, for a backward that adds with "
        f"atomics), losses bit for bit {same}, parameters after step 4 bit for bit: {bits}")
    if max(gaps) > 1e-3:
        raise AssertionError("train: the resumed run parts from the straight one")
    del runs["resumed"], pa, pb

    # The plain path's own 4 steps from the same parameters and batches
    # (reported): where the losses go is the optimizer's doing, not the
    # kernels'.
    t_p = time.perf_counter()
    step_fn = make_train_step(cfg, sal, ocfg)
    p = api.init_params(cfg, seed=seed, device=device)
    st = opt.init_opt_state(p)
    plain_losses = []
    with plain_training("lut"):
        for i in range(4):
            p, st, m = step_fn(p, st, batch_to_device(data_lib.batch_at(dcfg, i), device))
            plain_losses.append(float(m["loss"]))
    del p, st
    log(f"  the plain path's 4 steps from the same start: losses "
        f"{[round(v, 6) for v in plain_losses]}; relative gaps to the kernels' "
        + ", ".join(f"{abs(a - b) / abs(b):.3e}" for a, b in zip(losses, plain_losses))
        + f" (reported; {time.perf_counter() - t_p:.1f} s)")
    summary.update(losses=losses, plain_losses=plain_losses, sec_per_step=sec,
                   tokens_per_s=B * S / sec, peak_gib=runs["peak"] / 2 ** 30, per_step=per_step)
    del runs
    shutil.rmtree(root, ignore_errors=True)
    if cuda:
        torch.cuda.empty_cache()
    return {"train": counts}, summary


# ---------------------------------------------------------------------------
# Phase 19: tensor-parallel paged serving on two ranks of the one card
# ---------------------------------------------------------------------------

MESH_RANKS = 2
# The stats() counts a rank's drain must share with the one-device drain.
MESH_COUNTERS = ("tokens", "decode_steps", "prefill_chunks", "prefill_tokens",
                 "prefill_tokens_saved", "peak_pages", "preemptions", "swap_outs", "swap_ins")
# The GPT-2 drains a rank runs (`mesh_rank` gives each its requests and
# serve()'s options), each held to its one-device drain.
MESH_GPT2 = ["m1 fp exact", "m2 fp lut", "m3 int8/bf16 exact", "m4 fp exact K=4 max_len 1024",
             "m5 fp exact slo"]


def bit_digest(torch, tree) -> int:
    """An exact checksum of a parameter tree's bits: each tensor's elements
    read as integers of their width and summed in int64 on the device."""
    if isinstance(tree, dict):
        return sum(bit_digest(torch, v) for v in tree.values())
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32}[tree.element_size()]
    return int(tree.contiguous().view(ints).sum(dtype=torch.int64))


def drain_summary(eng, done, first) -> dict:
    """What phase 19 compares of a drain, on the host: tokens, first and
    first-decode logits (f32), the MESH_COUNTERS, the pools' bytes and heads."""
    st, c = eng.stats(), eng.cache
    return {"tokens": {u: list(r.generated) for u, r in done.items()},
            "first": {u: t.float().cpu() for u, t in first.items()},
            "first_decode": {u: t.float().cpu() for u, t in eng.first_decode.items()},
            "counters": {k: st[k] for k in MESH_COUNTERS},
            "pool_bytes": sum(t.nbytes for t in (c.k_pages, c.v_pages, c.k_scale, c.v_scale)
                              if t is not None),
            "pool_heads": c.k_pages.shape[2]}


def time_mesh_step(torch, api, collectives, sal, params, cfg, prompts, mesh, card):
    """A rank's decode step through the model API on the host clock (4
    slots at 128..156 context, a device synchronise around each call, as
    `time_model` times phase 4's), then again with a synchronise around each
    `gather_heads` call, whose host time a step it returns beside."""
    dev = params["embed"].device
    B, page, max_pages, S = 4, 16, 16, 128
    cache = api.init_paged_cache(cfg, B, 1 + B * max_pages, page, max_pages, device=dev,
                                 mesh=mesh)
    tables = torch.arange(1, 1 + B * max_pages, dtype=torch.int32,
                          device=dev).reshape(B, max_pages)
    for b in range(B):
        toks = torch.as_tensor(prompts[b][:S], dtype=torch.int64, device=dev)
        toks = torch.cat([toks, toks.new_full((S - len(toks),), 2)]) if len(toks) < S else toks
        for a in range(0, S, 64):
            api.prefill_chunk(params, toks[None, a:a + 64], tables[b:b + 1],
                              torch.tensor([a], dtype=torch.int32, device=dev),
                              cache.k_pages, cache.v_pages, cfg, sal, mesh=mesh)
    cache.lengths[:] = S
    cache.block_tables.copy_(tables)
    tok = torch.full((B,), 5, dtype=torch.int32, device=dev)
    gather = [0.0, 0]
    plain_gather = collectives.gather_heads

    def timed_gather(x, group, axis):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = plain_gather(x, group, axis)
        torch.cuda.synchronize()
        gather[0] += time.perf_counter() - t0
        gather[1] += 1
        return y

    def step():
        nonlocal tok, cache
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = api.decode_step(params, tok, cache, cfg, sal, mesh=mesh)
        tok = torch.argmax(logits, -1).to(torch.int32)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    dec = statistics.median([step() for _ in range(20)][2:])
    collectives.gather_heads = timed_gather
    try:
        synced, gathered = [], []
        for _ in range(8):
            gather[:] = [0.0, 0]
            synced.append(step())
            gathered.append(1e3 * gather[0])
        n_gathers = gather[1]
    finally:
        collectives.gather_heads = plain_gather
    dec_synced, gathered = statistics.median(synced[2:]), statistics.median(gathered[2:])
    log(f"  mesh decode step on a rank (host clock, {card}): {dec:.2f} ms at 4 slots x "
        f"128..156 context; with a synchronise around each of its {n_gathers} gather_heads "
        f"{dec_synced:.2f} ms, of which gather_heads {gathered:.2f} ms")
    return dict(dec=dec, dec_synced=dec_synced, gather=gathered, gathers=n_gathers)


def mesh_rank(rank: int, job: dict) -> dict:
    """Phase 19 on one rank, a process of a gloo world of MESH_RANKS on the
    one card (`repro_torch.launch.mesh.World`): GPT-2 medium's drains
    (MESH_GPT2), its decode step timed, qwen2-1.5B exact, olmoe-1B-7B with
    the expert-parallel MoE, each through `serve` (every step's launches
    checked) on a ("model",) mesh of the world. olmoe also drains on one
    device (no mesh: the grouped dispatch), its prompts' routing recorded
    (`RoutingRecorder`), and again on the mesh with that routing replayed.
    Rank 0 logs; each rank returns its drains' `drain_summary`, the launch
    counts of its mesh drains and its parameters' `bit_digest`."""
    import torch
    if rank:
        sys.stdout = open(os.devnull, "w")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe as moe_lib
    from repro_torch.serving.scheduler import SloScheduler
    kernels, mods, _ = serving_handles(torch)
    api, SalPimConfig, SalPimEngine = mods[0], mods[1], mods[2]
    launches = collections.Counter()

    def on_mesh(label, p, model_cfg, ps, n, **kw):
        """A mesh drain through `serve`, its launches added to `launches`."""
        before = {name: k.launches for name, k in kernels.items()}
        eng, done, first, wall = serve(torch, mods, p, model_cfg, ps, n, card,
                                       label=f"mesh rank 0 {label}", mesh=mesh, **kw)
        launches.update({name: k.launches - before[name] for name, k in kernels.items()})
        return dict(drain_summary(eng, done, first), wall=wall)

    t_start = time.perf_counter()
    mesh = make_test_mesh((MESH_RANKS,), ("model",), device_type="cuda")
    card, seed, prompts = job["card"], job["seed"], job["prompts"]
    out = {"device": str(torch.device("cuda", torch.cuda.current_device())), "digest": {}}
    cfg = get_config("gpt2_medium")
    params = api.init_params(cfg, seed=seed, device="cuda")
    out["digest"]["gpt2"] = bit_digest(torch, params)
    slo = dict(scheduler=SloScheduler(), num_pages=SLO_PAGES, priority=1, sharing=True,
               late=[(SLO_ARRIVAL_STEP, job["urgent"], 32, 0)])
    options = dict(zip(MESH_GPT2, [(prompts, 32, dict()), (prompts, 32, dict(mode="lut")),
                                   (prompts, 32, dict(fmt="int8/bf16")),
                                   (job["long_prompts"], 32, dict(max_len=1024, kv_splits=4)),
                                   (prompts, 64, slo)]))
    for label, (ps, n, kw) in options.items():
        out[label] = on_mesh(label, params, cfg, ps, n, **kw)
    out["step"] = time_mesh_step(torch, api, collectives, SalPimEngine.create(SalPimConfig()),
                                 params, cfg, prompts, mesh, card)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    qcfg = get_config("qwen2_1_5b")
    qw = api.init_params(qcfg, seed=seed, device="cuda")
    out["digest"]["qwen2"] = bit_digest(torch, qw)
    out["qwen2 exact"] = on_mesh("qwen2 exact", qw, qcfg, job["q_prompts"], 32)
    del qw
    gc.collect()
    torch.cuda.empty_cache()

    ocfg = dataclasses.replace(cut_config(get_config, "olmoe_1b_7b"), moe_impl="shardmap")
    # One rank at a time: making the weights takes f32 temporaries beside them.
    for r in range(MESH_RANKS):
        if r == rank:
            ow = api.init_params(ocfg, seed=seed, device="cuda")
            torch.cuda.synchronize()
        torch.distributed.barrier()
    rec = RoutingRecorder(moe_lib, api)
    with rec.recording():
        eng, done, first, wall = serve(torch, mods, ow, ocfg, prompts[:4], 16, card,
                                       label="olmoe on one device (no mesh: the grouped "
                                       "dispatch)")
    out["olmoe one device"] = dict(drain_summary(eng, done, first), wall=wall)
    routing = rec.calls
    del eng
    out["olmoe shardmap"] = on_mesh("olmoe shardmap", ow, ocfg, prompts[:4], 16)
    with rec.recording(replay=routing):
        out["olmoe shardmap replayed"] = on_mesh(
            "olmoe shardmap, the one-device drain's prompt routing replayed", ow, ocfg,
            prompts[:4], 16)
    out["olmoe own"] = rec.own
    out["launches"] = {name: launches[name] for name in kernels}
    out["sec"] = time.perf_counter() - t_start
    del ow
    gc.collect()
    torch.cuda.empty_cache()
    t21 = time.perf_counter()
    out["dense"] = mesh_dense_rank(torch, mods, kernels, job)
    out["dense"]["sec"] = time.perf_counter() - t21
    return out


# ---------------------------------------------------------------------------
# Phase 21: the dense decode on a mesh, in phase 19's world of ranks
# ---------------------------------------------------------------------------

MESH_DENSE_STEPS = 32
MESH_DENSE_KERNELS = ["gemv_pim_float", TC, "decode_attention", "decode_attention_partials",
                      "layernorm_lut"]


def _dense_prefill(torch, api, params, cfg, sal, prompts, max_len):
    """A dense cache of len(prompts) rows, each prompt prefilled alone on one
    device (as the dense engine admits it), and the first greedy tokens."""
    dev = params["embed"].device
    cache = api.init_cache(cfg, len(prompts), max_len, device=dev)
    first = []
    for b, p in enumerate(prompts):
        toks = torch.as_tensor(p[None], dtype=torch.int64, device=dev)
        logits, one = api.prefill(params, {"tokens": toks}, cfg, sal, max_len=max_len)
        cache.k[:, b], cache.v[:, b] = one.k[:, 0], one.v[:, 0]
        cache.lengths[b] = len(p)
        first.append(int(torch.argmax(logits[0])))
    return cache, torch.tensor(first, dtype=torch.int32, device=dev)


def _clone_cache(torch, cache):
    return dataclasses.replace(cache, **{f.name: getattr(cache, f.name).clone()
                                         for f in dataclasses.fields(cache)
                                         if getattr(cache, f.name) is not None})


def _decode(torch, api, params, cfg, sal, cache, tok, steps, mesh=None, feed=None):
    """`steps` greedy decode steps (feed: the tokens to feed instead, one
    (B,) tensor a step); (tokens (B, steps), logits (steps, B, V) f32,
    cache, host ms a step)."""
    toks, logits, ms = [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cache = api.decode_step(params, tok, cache, cfg, sal, mesh=mesh)
        nxt = torch.argmax(out, -1).to(torch.int32)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        toks.append(nxt)
        logits.append(out.float())
        tok = nxt if feed is None else feed[i]
    return torch.stack(toks, 1), torch.stack(logits), cache, ms


def mesh_dense_rank(torch, mods, kernels, job) -> dict:
    """Phase 21 on one rank of phase 19's world: `api.decode_step(...,
    mesh=)` on the rank's shard of a dense cache (`shard_cache`).
    (a) GPT-2 medium whole, bf16, exact, phase 4's 8 requests prefilled
    densely at max_len 256, on a (1, 2) ("data", "model") mesh: the KV
    heads on "model" (8 of 16 a rank), MESH_DENSE_STEPS greedy steps.
    (b) h2o-danube3-4B at its published widths, 2 layers, B 1, a 4600-token
    prompt past its 4096 window, max_len 8192, on a (2, 1) mesh:
    `cache_pspecs(seq_shard=True)` puts the sequence on ("data", "model"),
    so each rank walks 4096 positions with `decode_attention_partials` and
    `merge_partial_softmax` merges them; the steps are fed the one-device
    greedy tokens so that each step's logits compare. Each first runs on
    one device (the references); then every launch count is set to 0, both
    mesh decodes run, and the counts are read."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.transformer import shard_cache
    api, SalPimConfig, SalPimEngine = mods[0], mods[1], mods[2]
    sal = SalPimEngine.create(SalPimConfig())
    seed, n = job["seed"], MESH_DENSE_STEPS
    m12 = make_test_mesh((1, MESH_RANKS), ("data", "model"), device_type="cuda")
    m21 = make_test_mesh((MESH_RANKS, 1), ("data", "model"), device_type="cuda")
    out = {}

    gcfg = get_config("gpt2_medium")
    gp = api.init_params(gcfg, seed=seed, device="cuda")
    gcache, gfirst = _dense_prefill(torch, api, gp, gcfg, sal, job["prompts"], 256)
    gshard = shard_cache(_clone_cache(torch, gcache), m12)
    g_toks, _, gcache, g_ms = _decode(torch, api, gp, gcfg, sal, gcache, gfirst, n)

    dcfg = dataclasses.replace(get_config("h2o_danube3_4b"), n_layers=2)
    dp = api.init_params(dcfg, seed=seed, device="cuda")
    prompt = np.random.RandomState(seed + 21).randint(2, dcfg.vocab, size=4600)
    dcache, dfirst = _dense_prefill(torch, api, dp, dcfg, sal, [prompt], 8192)
    dshard = shard_cache(_clone_cache(torch, dcache), m21, seq_shard=True)
    d_toks, d_logits, dcache, d_ms = _decode(torch, api, dp, dcfg, sal, dcache, dfirst, n)

    for k in kernels.values():
        k.launches = 0
    mg_toks, _, gshard, mg_ms = _decode(torch, api, gp, gcfg, sal, gshard, gfirst, n, mesh=m12)
    md_toks, md_logits, dshard, md_ms = _decode(torch, api, dp, dcfg, sal, dshard, dfirst, n,
                                                mesh=m21, feed=d_toks.t())
    out["launches"] = {name: k.launches for name, k in kernels.items()}

    def slices(shard, whole, mesh):
        """(every field's shard equal to its cut of the one-device cache,
        per layer: max |diff| / (1 + |one device's|) over k and v, the
        compare() measure)."""
        same, diffs = True, []
        for f in ("k", "v"):
            mine = getattr(shard, f)
            want = sh.shard_of(getattr(whole, f), getattr(shard.specs, f), mesh)
            same &= torch.equal(mine, want)
            diffs.append([float(((mine[i].float() - want[i].float()).abs()
                                 / (1 + want[i].float().abs())).max())
                          for i in range(mine.shape[0])])
        return same, [max(a, b) for a, b in zip(*diffs)]

    g_same, g_diffs = slices(gshard, gcache, m12)
    out["gpt2"] = dict(tokens_same=bool(torch.equal(mg_toks, g_toks)), cache_same=g_same,
                       layer_diffs=g_diffs, spec=gshard.specs.k, ms=mg_ms, one_ms=g_ms,
                       shard=tuple(gshard.k.shape), n=g_toks.numel())
    gaps = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(md_logits, d_logits)]
    d_same, d_diffs = slices(dshard, dcache, m21)
    out["danube"] = dict(gaps=gaps, shared=int((md_toks == d_toks).sum()), n=d_toks.numel(),
                         cache_same=d_same, layer_diffs=d_diffs, spec=dshard.specs.k, ms=md_ms,
                         one_ms=d_ms, shard=tuple(dshard.k.shape))
    return out


def check_mesh_plans(torch, paged_attention, card, seed):
    """The decode walk at a rank's shapes on 2 ranks (half the KV heads of
    each pool and of q): planned on the model's KV heads (what a rank of
    the mesh runs) it must equal the one-device call's heads bit for bit on
    both halves; planned on the rank's own heads (another cluster, another
    order of sums) its gap is reported. Times in CUDA graphs, one pool set
    a layer, beside the one-device call: GPT-2's single walk at 128..160
    keys (bf16, and f32, where a rounding of the regrouped sums survives
    the output's cast) and its split (K=4) at 960..1024, qwen2's g 6 x 128
    at one KV head."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    B, page = 4, 16
    short, long = [128, 137, 151, 160], [960, 981, 1003, 1024]
    cases = [("gpt2-medium, 128..160 keys", 24, 16, 16, 64, 16, short, None, torch.bfloat16),
             ("gpt2-medium, 128..160 keys, f32", 24, 16, 16, 64, 16, short, None,
              torch.float32),
             ("gpt2-medium, 960..1024 keys, kv_splits=4", 24, 16, 16, 64, 64, long, 4,
              torch.bfloat16),
             ("qwen2-1.5b, 128..160 keys", 28, 12, 2, 128, 16, short, None, torch.bfloat16)]
    out = {}
    for label, L, H, Hkv, D, n_tbl, lens, K, dtype in cases:
        P = 1 + B * n_tbl
        tables = ((torch.randperm(P - 1, generator=gen, device=dev) + 1)
                  .reshape(B, n_tbl).to(torch.int32).contiguous())
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((B, H, D), generator=gen, device=dev).to(dtype)
        pools = [tuple(torch.randn((P, Hkv, page, D), generator=gen, device=dev).to(dtype)
                       for _ in "kv") for _ in range(L)]
        h, hq, g = Hkv // MESH_RANKS, H // MESH_RANKS, H // Hkv
        halves = [(q[:, r * hq:(r + 1) * hq].contiguous(),
                   [tuple(t[:, r * h:(r + 1) * h].contiguous() for t in kv) for kv in pools])
                  for r in range(MESH_RANKS)]

        def call(qq, kv, plan=None):
            return paged_attention.paged_attention(qq, *kv, tables, lengths, kv_splits=K,
                                                   plan_kv_heads=plan)

        whole = call(q, pools[0])
        same, gap = True, 0.0
        for r, (qr, kvr) in enumerate(halves):
            want = whole[:, r * hq:(r + 1) * hq]
            same &= torch.equal(call(qr, kvr[0], Hkv), want)
            gap = max(gap, float((call(qr, kvr[0]).float() - want.float()).abs().max()))
        row_bytes = D * dtype.itemsize
        if K:
            plans = [paged_attention.split_plan(B, n, K, n_tbl, g, D, page, row_bytes)
                     for n in (Hkv, h)]
        else:
            plans = [paged_attention.decode_plan(B, n, n_tbl, g, D, page, row_bytes)
                     for n in (Hkv, h)]
        qr, kvr = halves[0]
        t_whole = time_graph(torch, lambda i: call(q, pools[i]), L)
        t_glob = time_graph(torch, lambda i: call(qr, kvr[i], Hkv), L)
        t_loc = time_graph(torch, lambda i: call(qr, kvr[i]), L)
        keys, size = sum(lens) * h, dtype.itemsize
        bnd, by = bound_ms(2 * keys * D * size + 2 * size * B * hq * D
                           + 4 * (tables.numel() + B), 4 * sum(lens) * hq * D,
                           str(dtype).split(".")[-1])
        log(f"  paged_attention at a rank's shapes, {label} (B {B}, {hq} of {H} heads, "
            f"{h} of {Hkv} kv heads, D {D}; {card}): planned on the model's {Hkv} kv heads "
            f"{plans[0]} {t_glob * 1e3:.2f} us, {'bit for bit' if same else 'NOT bit for bit'} "
            f"the one-device call's heads on both ranks; planned on the rank's {h} "
            f"{plans[1]} {t_loc * 1e3:.2f} us, max |diff| {gap:.3e} (reported); the "
            f"one-device call {t_whole * 1e3:.2f} us; the rank's bound {bnd * 1e3:.2f} us "
            f"by {by}")
        if not same:
            raise AssertionError(f"paged_attention at a rank's shapes ({label}): planned on "
                                 "the model's heads, not the one-device bits")
        out[label] = dict(ms=t_glob, local_plan_ms=t_loc, one_device_ms=t_whole, bound_ms=bnd,
                          bound_by=by, plan=list(plans[0]), local_plan=list(plans[1]),
                          local_plan_max_diff=gap)
    return out


def mesh_phase(torch, np, mods, card, seed, job, refs, one_rank_ms):
    """Phase 19: `check_mesh_plans`, then MESH_RANKS ranks spawned on the
    one card run `mesh_rank`. Every rank must return the same tokens, first
    and first-decode logits (bit for bit) and counters; each GPT-2 and qwen2
    drain must equal its one-device drain (`refs`, from phases 4, 5, 8 and
    12 and an int8/bf16 drain here) in tokens, first and first-decode
    logits bit for bit and counters, its pools holding half the one-device
    bytes; olmoe's first logits, its prompts routed as the one-device drain
    routed them, within FIRST_LOGITS_LIMIT of that drain's (free-running:
    reported). Returns ({"mesh": launches summed over the ranks},
    times)."""
    from repro_torch.launch.mesh import World
    from repro_torch.kernels import paged_attention
    times = {"plans": check_mesh_plans(torch, paged_attention, card, seed)}
    # The earlier phases' engines hold their weights in reference cycles (the
    # drains' patched methods close over their engines): collect them, so
    # that the ranks find the card's memory free.
    held = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  this process holds {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB of the card "
        f"({held / 2 ** 30:.2f} GiB before collecting the earlier phases' garbage)")
    workdir = ROOT / "build" / "mesh"
    workdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    ranks = World(mesh_rank, MESH_RANKS, (job,), workdir=workdir, backend="gloo",
                  timeout_s=900).join()
    log(f"  {MESH_RANKS} ranks (one process each, gloo, on {[r['device'] for r in ranks]}) "
        f"ran their drains in {[round(r['sec'], 1) for r in ranks]} s ({time.perf_counter() - t0:.1f} "
        "s with the spawn)")
    if any(r["digest"] != ranks[0]["digest"] for r in ranks) or \
            ranks[0]["digest"]["gpt2"] != refs["digest"]:
        raise AssertionError(f"mesh: parameter digests {[r['digest'] for r in ranks]}, the "
                             f"one-device GPT-2's {refs['digest']}")

    def same_drain(a, b, bits=True):
        return (a["tokens"] == b["tokens"] and a["counters"] == b["counters"]
                and (not bits or all(torch.equal(a[k][u], b[k][u]) for k in
                                     ("first", "first_decode") for u in b[k])))

    for label in MESH_GPT2 + ["qwen2 exact", "olmoe shardmap", "olmoe shardmap replayed"]:
        if not all(same_drain(r[label], ranks[0][label]) for r in ranks[1:]):
            raise AssertionError(f"mesh[{label}]: the ranks are not in lockstep")
    for label in MESH_GPT2 + ["qwen2 exact"]:
        mine, ref = ranks[0][label], refs[label]
        n = sum(len(t) for t in ref["tokens"].values())
        same_tokens = sum(a == b for u in ref["tokens"]
                          for a, b in zip(mine["tokens"].get(u, []), ref["tokens"][u]))
        first_bits = sum(torch.equal(mine["first"][u], ref["first"][u]) for u in ref["first"])
        dec_bits = sum(torch.equal(mine["first_decode"][u], ref["first_decode"][u])
                       for u in ref["first_decode"])
        log(f"  mesh[{label}] on {MESH_RANKS} ranks: {same_tokens}/{n} greedy tokens of the "
            f"one-device drain; first logits bit for bit for {first_bits}/{len(ref['first'])} "
            f"requests, first-decode logits for {dec_bits}/{len(ref['first_decode'])}; "
            f"counters {mine['counters']} (one device {ref['counters']}); a rank's pools "
            f"{mine['pool_bytes']} bytes over {mine['pool_heads']} kv heads against "
            f"{ref['pool_bytes']} over {ref['pool_heads']}; {mine['wall']:.2f} s on rank 0 "
            f"({card})")
        if not same_drain(mine, ref) or MESH_RANKS * mine["pool_bytes"] != ref["pool_bytes"]:
            raise AssertionError(f"mesh[{label}]: not the one-device drain")
    ref = ranks[0]["olmoe one device"]
    if any(not same_drain(r["olmoe one device"], ref) for r in ranks[1:]):
        raise AssertionError("mesh[olmoe]: the ranks' one-device drains differ")
    gaps = {}
    for label in ("olmoe shardmap", "olmoe shardmap replayed"):
        mine = ranks[0][label]
        gaps[label] = max(float((mine["first"][u] - ref["first"][u]).abs().max()
                                / ref["first"][u].abs().max()) for u in ref["first"])
        n = sum(len(t) for t in ref["tokens"].values())
        same_tokens = sum(a == b for u in ref["tokens"]
                          for a, b in zip(mine["tokens"][u], ref["tokens"][u]))
        log(f"  mesh[{label}] on {MESH_RANKS} ranks ({job['olmoe_experts']} experts a rank, "
            f"one psum a layer): first logits vs the one-device drain max |diff| / max "
            f"|logit| = {gaps[label]:.3e}; shares {same_tokens}/{n} greedy tokens with it; "
            f"{mine['wall']:.2f} s against {ref['wall']:.2f} s on one device ({card})")
    own, n_own, near = ranks[0]["olmoe own"]
    log(f"  mesh[olmoe]: gated, with the one-device drain's prompt routing replayed: "
        f"{gaps['olmoe shardmap replayed']:.3e} (limit {FIRST_LOGITS_LIMIT:.0e}); the "
        f"replayed drain's own weights would have chosen {own}/{n_own} prompt top-k sets "
        f"otherwise (largest top-k / top-(k+1) gap at one {near:.3e}); free-running "
        f"{gaps['olmoe shardmap']:.3e} and the token shares reported, not gated: the psum "
        f"adds in another order, and random-weight routing is chaotic (phase 14)")
    if gaps["olmoe shardmap replayed"] > FIRST_LOGITS_LIMIT:
        raise AssertionError(f"mesh[olmoe shardmap]: first logits differ by "
                             f"{gaps['olmoe shardmap replayed']:.3e} with the routing replayed")
    step = ranks[0]["step"]
    log(f"  mesh decode step (GPT-2 medium, 4 slots): {step['dec']:.2f} ms a rank on the host "
        f"clock against {one_rank_ms:.2f} ms on one device (phase 4), gather_heads "
        f"{step['gather']:.2f} ms of it over {step['gathers']} calls ({card})")
    counts = {name: sum(r["launches"][name] for r in ranks) for name in ranks[0]["launches"]}
    log(f"  launches over the mesh drains, summed over the ranks: {counts}")
    missing = [n for n in ("gemv_pim_float", TC, "paged_attention", "paged_prefill_attention",
                           "paged_attention_split", "merge_partials", "layernorm_lut")
               if counts[n] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the mesh path: {missing}")
    times["step"] = step
    times["dense"] = [r["dense"] for r in ranks]
    return {"mesh": counts}, times


MESH_DENSE_GAP = 3e-2      # danube's logits a step: max |diff| / max |logit| against one device


def mesh_dense_report(torch, dense: list, card: str) -> dict:
    """Phase 21's gates on the ranks' results (`mesh_dense_rank`): GPT-2's
    tokens and every rank's cache slices bit for bit one device's; danube's
    logits within MESH_DENSE_GAP of one device's at every step, its layer-0
    slices bit for bit (the new token's K/V from its embedding alone) and
    its layer-1 slices within bf16's tolerance (they take the merged layer
    0's output, which adds in another order: atol = rtol = 3e-2, compare()'s
    measure); the launches of the mesh path, summed over the ranks."""
    r0 = dense[0]
    g, d = r0["gpt2"], r0["danube"]
    g_toks = all(r["gpt2"]["tokens_same"] for r in dense)
    g_cache = all(r["gpt2"]["cache_same"] for r in dense)
    log(f"  mesh dense[gpt2-medium] on a (1, {MESH_RANKS}) mesh, k spec {g['spec']}, a rank's "
        f"k {g['shard']}: {MESH_DENSE_STEPS} greedy steps of 8 requests, tokens "
        f"{'bit for bit' if g_toks else 'NOT'} the one-device dense decode's, cache slices "
        f"{'bit for bit' if g_cache else 'NOT bit for bit'} on every rank; a step "
        f"{statistics.median(g['ms'][2:]):.2f} ms a rank on the host "
        f"clock against {statistics.median(g['one_ms'][2:]):.2f} ms on one device ({card})")
    worst = max(max(r["danube"]["gaps"]) for r in dense)
    l0 = all(r["danube"]["layer_diffs"][0] == 0.0 for r in dense)
    l1 = max(r["danube"]["layer_diffs"][1] for r in dense)
    log(f"  mesh dense[h2o-danube3-4b, 2 layers] on a ({MESH_RANKS}, 1) mesh, k spec "
        f"{d['spec']}, a rank's k {d['shard']} (the partials and the merge): "
        f"{MESH_DENSE_STEPS} steps fed the one-device greedy tokens, logits max |diff| / "
        f"max |logit| {worst:.3e} (limit {MESH_DENSE_GAP:.0e}; by step "
        f"{[float(f'{x:.2e}') for x in d['gaps'][:4]]} ...); {d['shared']}/{d['n']} greedy "
        f"tokens shared (reported); layer 0's cache slices "
        f"{'bit for bit' if l0 else 'NOT bit for bit'}, layer 1's max |diff| / (1 + |one "
        f"device's|) {l1:.3e} (limit {TOL['bfloat16']}); a step "
        f"{statistics.median(d['ms'][2:]):.2f} ms a rank on the host clock against "
        f"{statistics.median(d['one_ms'][2:]):.2f} ms on one device "
        f"({card})")
    counts = {name: sum(r["launches"][name] for r in dense) for name in r0["launches"]}
    log(f"  launches over the mesh dense decodes, summed over the ranks: {counts}")
    log(f"  phase 21 took {[round(r['sec'], 1) for r in dense]} s on the ranks")
    if not (g_toks and g_cache):
        raise AssertionError("mesh dense[gpt2]: not the one-device dense decode's bits")
    if worst > MESH_DENSE_GAP or not l0 or l1 > TOL["bfloat16"]:
        raise AssertionError(f"mesh dense[danube]: logits {worst:.3e}, layer 0 bit for bit "
                             f"{l0}, layer 1 {l1:.3e}")
    missing = [n for n in MESH_DENSE_KERNELS if counts[n] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the mesh dense path: {missing}")
    return {"mesh dense": counts}


# ---------------------------------------------------------------------------
# Phase 20: training under a mesh on ranks of the one card
# ---------------------------------------------------------------------------

# The kernels of the training path (phase 18's), checked at every step of a rank.
TRAIN_KERNELS = ["gemv_pim_float", TC, "layernorm_lut", "softmax_lut", "lut_interp",
                 "lut_interp_backward", "layernorm_lut_backward", "softmax_lut_backward"]
MESH_TRAIN_GAP = 3e-2      # loss and global grad norm against one device (phase 18's gate)


def _mesh_train_opt():
    from repro_torch.runtime import optimizer as opt
    return opt.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=4)


@contextlib.contextmanager
def deterministic_algorithms(torch):
    """PyTorch's deterministic algorithms, as phase 20's ranks run: the
    embedding's backward then sorts the token ids and sums each row's
    contributions in f32 instead of adding them with bf16 atomics."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def mu_gaps(torch, opt, mu, ref) -> list:
    """(path, max |mu - ref| / max |ref|) by leaf, the largest first."""
    gaps = {p: float((a - ref[p]).abs().max() / ref[p].abs().max().clamp_min(1e-30))
            for p, a in opt.named_leaves(mu)}
    return sorted(gaps.items(), key=lambda kv: -kv[1])


def train_refs(torch, np, mods, kernels, card, seed, cfg, B, S, modes, save_mu=None):
    """The one-device AdamW step of `cfg` (phase 20's optimizer) on the
    seeded parameters and the first batch of B x S tokens, under
    deterministic algorithms as the ranks run: per mode its loss, global
    gradient norm, the kernels' launches and the step's peak memory above
    what was held (the moments made in the step, as a rank's). With
    `save_mu` (a directory) each mode's first moment after the step,
    (1 - b1) times the clipped gradient, is saved there for the ranks, and
    the same step with PyTorch's default algorithms is held to it leaf by
    leaf (reported: how far the one-device step moves with the embedding
    backward's summation alone)."""
    from repro_torch.data import tokens as data_lib
    from repro_torch.runtime import optimizer as opt
    from repro_torch.runtime.train_loop import batch_to_device, make_train_step
    api, SalPimConfig, SalPimEngine = mods[:3]
    params = api.init_params(cfg, seed=seed, device="cuda")
    batch = batch_to_device(data_lib.batch_at(data_lib.data_config_for_model(cfg, S, B, seed=seed),
                                              0), "cuda")
    out = {}
    for mode in modes:
        sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode))
        step = make_train_step(cfg, sal, _mesh_train_opt())
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with deterministic_algorithms(torch):
            new, state, m = step(params, opt.init_opt_state(params), batch)
            loss, norm = float(m["loss"]), float(m["grad_norm"])
        sec = time.perf_counter() - t0
        out[mode] = dict(loss=loss, norm=norm, sec=sec,
                         launches={n: kernels[n].launches for n in TRAIN_KERNELS},
                         peak_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30)
        del new, m
        log(f"  one device, {cfg.name} {B} x {S} [{mode}]: loss {out[mode]['loss']:.6f}, "
            f"global grad norm {norm:.6f}; the AdamW step {sec:.3f} s on the host clock, "
            f"peak {out[mode]['peak_gib']:.2f} GiB above the "
            f"{base / 2 ** 30:.2f} GiB held; launches {out[mode]['launches']} ({card})")
        if save_mu is not None:
            out[mode]["mu"] = str(save_mu / f"mu_{mode}.pt")
            torch.save({p: x.cpu() for p, x in opt.named_leaves(state.mu)}, out[mode]["mu"])
            _, dstate, dm = step(params, opt.init_opt_state(params), batch)
            ref = dict(opt.named_leaves(state.mu))
            gaps = mu_gaps(torch, opt, dstate.mu, ref)
            out[mode]["default_mu_gaps"] = gaps
            log(f"  one device [{mode}] with PyTorch's default algorithms: loss "
                f"{float(dm['loss']):.6f}, global grad norm {float(dm['grad_norm']):.6f}; "
                f"first moment by leaf against the deterministic step's, max |diff| / max "
                f"|deterministic|: " + ", ".join(f"{p} {g:.3e}" for p, g in gaps[:6])
                + f" ({card})")
            del dstate, dm
            if mode == "exact":
                # The same step in f32 (weights, compute, gradients) from the
                # same weights: how far bf16 alone moves each leaf's moment.
                cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                            compute_dtype="float32")
                p32 = opt.tree_map(lambda x: x.float(), params)
                with deterministic_algorithms(torch):
                    _, s32, m32 = make_train_step(cfg32, sal, _mesh_train_opt())(
                        p32, opt.init_opt_state(p32), batch)
                out["exact f32"] = dict(mu=str(save_mu / "mu_exact_f32.pt"))
                torch.save({p: x.cpu() for p, x in opt.named_leaves(s32.mu)},
                           out["exact f32"]["mu"])
                ref32 = dict(opt.named_leaves(s32.mu))
                gaps = dict(mu_gaps(torch, opt, state.mu, ref32))
                log(f"  one device [exact] in f32: loss {float(m32['loss']):.6f}, global grad "
                    f"norm {float(m32['grad_norm']):.6f}; the bf16 step's first moment by "
                    f"leaf against it, max |diff| / max |f32|: " + ", ".join(
                        f"{p} {g:.3e}" for p, g in sorted(gaps.items(), key=lambda kv: -kv[1]))
                    + f" ({card})")
                del p32, s32, m32, ref32
            del ref
        del state
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_train_rank(rank: int, job: dict) -> dict:
    """Phase 20 on one rank of a gloo world of 4 on the one card: each case
    of job["cases"] on its ("data", "model") mesh (a mesh of fewer ranks
    than the world takes the first ones; the others sit the case out) by
    `mesh_train_case`. Returns {arch: the case's result, None where the
    rank sat out}. Rank 0 logs."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    if rank:
        sys.stdout = open(os.devnull, "w")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The embedding's backward adds with atomics unless deterministic
    # algorithms are asked for: the resumed run is then the straight one's bits.
    torch.use_deterministic_algorithms(True, warn_only=True)
    out = {}
    for case in job["cases"]:
        shape = tuple(case["shape"])
        n = shape[0] * shape[1]
        # Every rank builds the mesh (its groups are made by all of them).
        mesh = DeviceMesh("cuda", torch.arange(n).reshape(shape), mesh_dim_names=("data", "model"))
        out[case["arch"]] = mesh_train_case(torch, rank, dict(job, **case), mesh, rank < n)
    return out


def mesh_train_case(torch, rank: int, job: dict, mesh, member: bool):
    """One case of phase 20 on one rank: `job["arch"]` at full width and
    depth on `mesh`, its seeded parameters cut by `param_pspecs(...,
    fsdp=True)`. One sharded step per mode from those parameters (loss,
    global grad norm, launches, host clock; the last mode's with a
    synchronise around every collective: their share); with job["full"]
    also `run_training` in LUT mode for 3 steps saving at step 2 and a run
    resumed from that checkpoint (bit for bit, the launches checked at
    every step), and compressed_psum, merge_partial_softmax and
    pipeline_forward on CUDA tensors. A rank not in the mesh (`member`
    False) joins the world's barriers alone and returns None."""
    import shutil

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import tokens as data_lib
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.runtime import optimizer as opt
    from repro_torch.runtime.train_loop import (TrainConfig, batch_to_device, make_train_step,
                                                run_training, shard_train_step)
    kernels, mods, _ = serving_handles(torch)
    api, SalPimConfig, SalPimEngine = mods[:3]
    t_start = time.perf_counter()
    card, seed, B, S = job["card"], job["seed"], job["B"], job["S"]
    cfg = get_config(job["arch"])
    dcfg = data_lib.data_config_for_model(cfg, S, B, seed=seed)
    shapes = api.init_params(cfg, device="meta")
    specs = sh.param_pspecs(shapes, mesh, fsdp=True) if member else None
    # One rank at a time: the whole tree is made, then cut.
    for r in range(torch.distributed.get_world_size()):
        if r == rank and member:
            params = sh.shard_tree(api.init_params(cfg, seed=seed, device="cuda"), specs, mesh)
            gc.collect()
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    if not member:
        return None
    out = {"device": str(torch.device("cuda", torch.cuda.current_device())),
           "coords": {n: mesh.get_local_rank(n) for n in mesh.mesh_dim_names}}
    ocfg = _mesh_train_opt()
    batch_np = data_lib.batch_at(dcfg, 0)
    batch = batch_to_device(sh.shard_batch(batch_np, mesh), "cuda")

    def launches():
        return {n: kernels[n].launches for n in TRAIN_KERNELS}

    def check_step(label, counts, want):
        if counts != want:
            raise AssertionError(f"mesh train [{label}] rank {rank}: launches {counts}, one "
                                 f"device {want}")

    total = collections.Counter()
    out["steps"] = {}
    # The collectives' share: the last mode's step runs with a synchronise
    # around each collective, its time and bytes summed by kind.
    spent = collections.defaultdict(lambda: [0.0, 0, 0])
    plain = {n: getattr(collectives, n) for n in ("_all_reduce", "all_gather_dim")}

    def timed(name, fn):
        def call(x, *a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            y = fn(x, *a, **kw)
            torch.cuda.synchronize()
            rec = spent[f"{name} {str(x.dtype).split('.')[-1]}"]
            rec[0] += time.perf_counter() - t
            rec[1] += 1
            rec[2] += y.nbytes
            return y
        return call

    for mode in job["modes"]:
        sal = SalPimEngine.create(SalPimConfig(nonlinear_mode=mode))
        step = shard_train_step(make_train_step(cfg, sal, ocfg), mesh, cfg, shapes, batch_np,
                                fsdp=True)
        synced = job["full"] and mode == job["modes"][-1]
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        if synced:
            for n, fn in plain.items():
                setattr(collectives, n, timed(n, fn))
        try:
            t0 = time.perf_counter()
            new, state, m = step(params, opt.init_opt_state(params), batch)
            loss, norm = float(m["loss"]), float(m["grad_norm"])
            sec = time.perf_counter() - t0
        finally:
            for n, fn in plain.items():
                setattr(collectives, n, fn)
        if synced:
            out["collectives"] = dict(sec=sum(v[0] for v in spent.values()),
                                      calls=sum(v[1] for v in spent.values()), step_sec=sec,
                                      by_kind={k: tuple(v) for k, v in spent.items()})
        counts = launches()
        check_step(mode, counts, job["want_launches"][mode])
        total.update(counts)
        if mode == job["modes"][0]:
            out["bytes"] = {"params": sum(x.nbytes for x in opt.tree_leaves(params)),
                            "moments": 2 * sum(x.nbytes for x in opt.tree_leaves(state.mu)),
                            "spec_params": sh.spec_bytes(shapes, specs, mesh),
                            "spec_moments": 2 * sh.spec_bytes(
                                opt.tree_map(lambda p: p.float(), shapes), specs, mesh),
                            "whole_params": sum(x.nbytes for x in opt.tree_leaves(shapes))}
        out["steps"][mode] = dict(loss=loss, norm=norm, sec=sec, launches=counts,
                                  peak_gib=(torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                                  plan={p: step.plan.tensor_parallel(p) is not None
                                        for p in ("attn", "ffn", "experts", "head")})
        if job.get("ref_mu"):
            # Per leaf, the first moment (the clipped gradient times 1 - b1)
            # against each one-device step of this mode on this rank's slice:
            # the largest gap and the largest reference element; for the
            # embedding also the token (row) of the largest gap and how often
            # it occurs in the global batch.
            spec = dict(opt.named_leaves(specs))
            occurs = np.bincount(batch_np["tokens"].ravel(), minlength=cfg.vocab)
            out["steps"][mode]["mu_gaps"] = {}
            for label, path in job["ref_mu"].items():
                if label.split()[0] != mode:
                    continue
                ref = torch.load(path, mmap=True, weights_only=True)
                gaps = {}
                for leaf, mu in opt.named_leaves(state.mu):
                    want = sh.shard_of(ref[leaf], spec[leaf], mesh).to(mu.device)
                    diff = (mu - want.float()).abs()
                    gaps[leaf] = (float(diff.max()), float(want.abs().max()))
                    if leaf == "embed":
                        row = int(diff.amax(dim=1).argmax())
                        gaps["embed row"] = (row, int(occurs[row]), int(occurs.max()),
                                             float(diff[row].max()),
                                             float(want[row].abs().max()))
                out["steps"][mode]["mu_gaps"][label] = gaps
                del ref
        del new, state, m
        if rank == 0:
            log(f"  mesh rank 0 step[{mode}]: loss {loss:.6f}, global grad norm {norm:.6f}, "
                f"{sec:.3f} s on the host clock{' (collectives synchronised)' if synced else ''}"
                f"; launches {counts} (one device {job['want_launches'][mode]}: equal)")

    del params
    gc.collect()
    torch.cuda.empty_cache()

    if job["full"]:
        root = pathlib.Path(job["ckpt"])
        root.mkdir(parents=True, exist_ok=True)
        sal = SalPimEngine.create(SalPimConfig(nonlinear_mode="lut"))
        per_step = []
        prev = [launches()]

        def on_log(rec):
            now = launches()
            per_step.append({n: now[n] - prev[0][n] for n in now})
            prev[0] = now

        def train(sub, steps, ckpt_every):
            tc = TrainConfig(steps=steps, ckpt_dir=str(root / sub), ckpt_every=ckpt_every,
                             keep=2, log_every=1, async_ckpt=False,
                             metrics_path=str(root / "metrics.jsonl"))
            return run_training(cfg, tc, ocfg, dcfg, engine=sal, mesh=mesh, fsdp=True,
                                seed=seed, hooks={"on_log": on_log}, device="cuda")
        t0 = time.perf_counter()
        straight = train("straight", 3, 2)
        if rank == 0:
            shutil.copytree(root / "straight" / "step_00000002", root / "resumed" / "step_00000002")
        torch.distributed.barrier()
        resumed = train("resumed", 3, 100)
        out["loop_sec"] = time.perf_counter() - t0
        for i, c in enumerate(per_step):
            check_step(f"run_training step {i}", c, job["want_launches"]["lut"])
            total.update(c)
        pa = {"p": straight["params"], "o": straight["opt_state"]}
        pb = {"p": resumed["params"], "o": resumed["opt_state"]}
        same = [bool(torch.equal(a, b)) for (_, a), (_, b) in
                zip(opt.named_leaves(pa), opt.named_leaves(pb))]
        whole = sh.gather_tree(straight["params"], specs, mesh)
        out["loop"] = dict(losses=[r["loss"] for r in straight["history"]],
                           resumed=[(r["step"], r["loss"]) for r in resumed["history"]],
                           sec=[r["sec_per_step"] for r in straight["history"]],
                           same=same, digest={p: bit_digest(torch, x) for p, x in
                                              opt.named_leaves(whole)},
                           n_steps=len(per_step))
        del straight, resumed, pa, pb, whole
        gc.collect()
        torch.cuda.empty_cache()

        # The reductions of distributed/ on CUDA tensors, the CPU tests' shapes.
        flat = make_test_mesh((4,), ("data",), device_type="cuda")
        group = flat.get_group("data")
        dev = torch.device("cuda", torch.cuda.current_device())
        g1, g2 = (torch.from_numpy(a[rank]).to(dev) for a in job["grads"])
        mean1, ef1 = collectives.compressed_psum(g1, group)
        mean2, ef2 = collectives.compressed_psum(g2, group, ef1)
        scores, v = (torch.from_numpy(a).to(dev) for a in job["softmax"])
        n = scores.shape[0] // 4
        sc, vv = scores[rank * n:(rank + 1) * n], v[rank * n:(rank + 1) * n]
        mx = sc.max()[None, None]
        e = torch.exp(sc - mx[0])
        merged = collectives.merge_partial_softmax(mx, e.sum()[None, None], (e @ vv)[None],
                                                   group)
        from repro_torch.distributed.pipeline import make_pipelined_fn
        pod = make_test_mesh((4,), ("pod",), device_type="cuda")
        pipe = make_pipelined_fn(lambda w, x: torch.tanh(x @ w), pod, "pod", n_micro=4)(
            torch.from_numpy(job["stage_params"]).to(dev), torch.from_numpy(job["x"]).to(dev))
        out["reductions"] = dict(
            ef=[t.cpu().numpy() for t in (mean1, ef1, mean2, ef2)],
            merged=merged.cpu().numpy(), pipeline=pipe.cpu().numpy(),
            devices=[str(t.device) for t in (mean1, merged, pipe)])
    out["launches"] = dict(total)
    out["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["sec"] = time.perf_counter() - t_start
    return out


def emulate_compressed_psum(np, grads, efs):
    """The reference's compressed_psum algebra in numpy f32: (mean, the
    ranks' new feedback)."""
    g = [x.astype(np.float32) + (0 if e is None else e) for x, e in zip(grads, efs)]
    scale = max(np.float32(max(np.max(np.abs(x)), np.float32(1e-12))) / np.float32(127.0)
                for x in g)
    q = [np.clip(np.round(x / scale), -127, 127).astype(np.int8) for x in g]
    new_ef = [x - qq.astype(np.float32) * scale for x, qq in zip(g, q)]
    total = np.sum([qq.astype(np.int32) for qq in q], axis=0)
    return total.astype(np.float32) * scale / np.float32(len(g)), new_ef


def mesh_train_phase(torch, np, mods, card, seed):
    """Phase 20: GPT-2 medium whole (bf16, remat) on a (2, 2) ("data",
    "model") world of 4 ranks of the one card with fsdp, one exact and one
    LUT step held to the one-device step (loss and global grad norm within
    MESH_TRAIN_GAP), every rank's launches equal to one device's at every
    step, each rank's parameter and moment bytes its spec's, `run_training`
    resumed bit for bit and its checkpoint restored here on one device bit
    for bit the gathered shards, the reductions of distributed/ on CUDA
    tensors; then qwen2-1.5B whole on a (1, 2) world, one exact step.
    Returns ({"mesh train": launches summed over the ranks}, times)."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import World
    from repro_torch.runtime import checkpoint as ckpt_lib
    from repro_torch.runtime import optimizer as opt
    kernels = mods[7]
    api = mods[0]
    gc.collect()
    torch.cuda.empty_cache()
    cfg, qcfg = get_config("gpt2_medium"), get_config("qwen2_1_5b")
    root = ROOT / "build" / "mesh_train"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True, exist_ok=True)
    refs = train_refs(torch, np, mods, kernels, card, seed, cfg, 8, 1024, ("exact", "lut"),
                      save_mu=root)
    qrefs = train_refs(torch, np, mods, kernels, card, seed, qcfg, 2, 1024, ("exact",))
    rng = np.random.RandomState(seed + 20)
    gpt2 = dict(arch="gpt2_medium", shape=(2, 2), B=8, modes=("exact", "lut"), full=True,
                want_launches={m: refs[m]["launches"] for m in ("exact", "lut")},
                ref_mu={m: r["mu"] for m, r in refs.items() if "mu" in r})
    qwen2 = dict(arch="qwen2_1_5b", shape=(1, 2), B=2, modes=("exact",), full=False,
                 want_launches={m: r["launches"] for m, r in qrefs.items()}, ref_mu=None)
    job = dict(card=card, seed=seed, S=1024, ckpt=str(root / "ckpt"), cases=[gpt2, qwen2],
               grads=[rng.randn(4, 64).astype(np.float32) for _ in range(2)],
               softmax=((rng.randn(64) * 3).astype(np.float32),
                        rng.randn(64, 8).astype(np.float32)),
               stage_params=(rng.randn(4, 16, 16) * 0.3).astype(np.float32),
               x=rng.randn(8, 16).astype(np.float32))
    log(f"  this process holds {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB of the card")
    t0 = time.perf_counter()
    world = World(mesh_train_rank, 4, (job,), workdir=root, backend="gloo",
                  timeout_s=900).join()
    ranks = [r["gpt2_medium"] for r in world]
    qranks = [r["qwen2_1_5b"] for r in world[:2]]
    log(f"  4 ranks (gloo, on {[r['device'] for r in ranks]}, mesh coordinates "
        f"{[r['coords'] for r in ranks]}; qwen2 on the first 2) ran GPT-2 in "
        f"{[round(r['sec'], 1) for r in ranks]} s, qwen2 in "
        f"{[round(r['sec'], 1) for r in qranks]} s ({time.perf_counter() - t0:.1f} s with the "
        f"spawn)")
    if any(r["qwen2_1_5b"] is not None for r in world[2:]):
        raise AssertionError("mesh train: a rank outside qwen2's (1, 2) mesh ran its step")
    modes = gpt2["modes"]

    def gaps(rank_steps, ref, label):
        worst = 0.0
        for mode, st in rank_steps.items():
            dl = abs(st["loss"] - ref[mode]["loss"]) / abs(ref[mode]["loss"])
            dn = abs(st["norm"] - ref[mode]["norm"]) / ref[mode]["norm"]
            worst = max(worst, dl, dn)
            if not (dl <= MESH_TRAIN_GAP and dn <= MESH_TRAIN_GAP):
                raise AssertionError(f"mesh train [{label} {mode}]: loss gap {dl:.3e}, grad "
                                     f"norm gap {dn:.3e} against one device")
        return worst

    r0 = ranks[0]
    for mode in modes:
        st = [r["steps"][mode] for r in ranks]
        if any((s["loss"], s["norm"]) != (st[0]["loss"], st[0]["norm"]) for s in st):
            raise AssertionError(f"mesh train [{mode}]: the ranks report different metrics")
        ref = refs[mode]
        log(f"  mesh[gpt2 (2, 2) fsdp {mode}]: loss {st[0]['loss']:.6f} against "
            f"{ref['loss']:.6f} on one device (gap "
            f"{abs(st[0]['loss'] - ref['loss']) / abs(ref['loss']):.3e}); global grad norm "
            f"{st[0]['norm']:.6f} against {ref['norm']:.6f} (gap "
            f"{abs(st[0]['norm'] - ref['norm']) / ref['norm']:.3e}); limit {MESH_TRAIN_GAP:.0e} "
            f"each; tensor-parallel parts {[p for p, on in st[0]['plan'].items() if on]}; a "
            f"rank's step {statistics.median(s['sec'] for s in st):.3f} s on the host clock "
            f"(one device's {ref['sec']:.3f} s); peak memory a rank "
            f"{[round(s['peak_gib'], 2) for s in st]} GiB against {ref['peak_gib']:.2f} GiB on "
            f"one device ({card})")
    worst = gaps({m: r0["steps"][m] for m in modes}, refs, "gpt2")
    for mode in modes:
        for label, g0 in r0["steps"][mode]["mu_gaps"].items():
            by_leaf = {p: max(r["steps"][mode]["mu_gaps"][label][p][0] for r in ranks)
                       / max(max(r["steps"][mode]["mu_gaps"][label][p][1] for r in ranks),
                             1e-30)
                       for p in g0 if p != "embed row"}
            row, n, most, d, top = max((r["steps"][mode]["mu_gaps"][label]["embed row"]
                                        for r in ranks), key=lambda t: t[3])
            log(f"  mesh[gpt2 {mode}] largest relative gap by leaf of the first moment after "
                f"the step against the one-device {label} step (the clipped gradient times "
                f"1 - b1; max |mesh - one device| / max |one device| over the ranks' slices, "
                f"both under deterministic algorithms; reported, not gated: LUT gradients are "
                f"piecewise constant): " + ", ".join(
                    f"{k} {v:.3e}" for k, v in sorted(by_leaf.items(), key=lambda kv: -kv[1]))
                + f"; the embedding's largest gap {d:.3e} at token {row} ({n} of the batch's "
                f"tokens; the most frequent {most}), whose row's largest element is {top:.3e}")
    for r in ranks:
        b = r["bytes"]
        if (b["params"], b["moments"]) != (b["spec_params"], b["spec_moments"]):
            raise AssertionError(f"mesh train: a rank holds {b}, not its spec's slices")
    log(f"  a rank's parameters and moments, bytes: "
        + ", ".join(f"rank {i} {r['bytes']['params']} + {r['bytes']['moments']}"
                    for i, r in enumerate(ranks))
        + f", each its spec's slices; the whole model {r0['bytes']['whole_params']} + "
        f"{4 * r0['bytes']['whole_params']} (bf16 parameters, two f32 moments)")
    coll = r0["collectives"]
    log(f"  mesh LUT step on rank 0 with a synchronise around each of its {coll['calls']} "
        f"collectives: {coll['step_sec']:.3f} s, of which collectives {coll['sec']:.3f} s "
        f"({100 * coll['sec'] / coll['step_sec']:.1f}%; gloo through host memory); by kind "
        f"(s, calls, MB out): " + ", ".join(
            f"{k} {v[0]:.3f} / {v[1]} / {v[2] / 1e6:.0f}" for k, v in sorted(
                coll["by_kind"].items())) + f" ({card})")
    loop = r0["loop"]
    if any(r["loop"]["losses"] != loop["losses"] for r in ranks[1:]):
        raise AssertionError("mesh run_training: the ranks' losses differ")
    if not all(all(r["loop"]["same"]) for r in ranks):
        raise AssertionError("mesh run_training: the resumed run is not the straight one's "
                             f"bits: {[sum(r['loop']['same']) for r in ranks]} of "
                             f"{len(loop['same'])} leaves")
    if [s for s, _ in loop["resumed"]] != [2] or not all(np.isfinite(loop["losses"])):
        raise AssertionError(f"mesh run_training: {loop}")
    like = api.init_params(cfg, device="cuda")
    tree, manifest = ckpt_lib.restore(str(root / "ckpt" / "straight"), {"params": like})
    restored = {p: bit_digest(torch, x) for p, x in opt.named_leaves(tree["params"])}
    if restored != loop["digest"] or manifest["step"] != 3:
        bad = [p for p in restored if restored[p] != loop["digest"].get(p)]
        raise AssertionError(f"mesh checkpoint restored on one device: {bad} differ")
    del like, tree
    log(f"  run_training[lut] on (2, 2) fsdp, 3 steps: losses "
        f"{[round(v, 6) for v in loop['losses']]}, {statistics.median(loop['sec']):.3f} "
        f"s/step a rank on the host clock; resumed from step 2: steps {loop['resumed']}, every "
        f"rank's {len(loop['same'])} parameter and moment slices bit for bit the straight "
        f"run's; launches checked at each of {loop['n_steps']} steps; its step-3 checkpoint "
        f"restored here on one device: {len(restored)} leaves bit for bit the gathered "
        f"shards (exact digests) ({card})")
    red = [r["reductions"] for r in ranks]
    g1, g2 = job["grads"]
    mean1, ef1 = emulate_compressed_psum(np, list(g1), [None] * 4)
    mean2, ef2 = emulate_compressed_psum(np, list(g2), ef1)
    e = np.exp(job["softmax"][0].astype(np.float64) - job["softmax"][0].max())
    want_sm = (e / e.sum()) @ job["softmax"][1]
    seq = job["x"]
    for w in job["stage_params"]:
        seq = np.tanh(seq @ w)
    merge_err = max(float(np.abs(r["merged"][0] - want_sm).max()) for r in red)
    pipe_err = max(float(np.abs(r["pipeline"] - seq).max()) for r in red)
    bits = all(np.array_equal(r["ef"][0], mean1) and np.array_equal(r["ef"][2], mean2)
               and np.array_equal(r["ef"][1], ef1[i]) and np.array_equal(r["ef"][3], ef2[i])
               for i, r in enumerate(red))
    log(f"  on CUDA tensors ({red[0]['devices']}): compressed_psum over 2 steps of error "
        f"feedback {'bit for bit' if bits else 'NOT bit for bit'} the reference's algebra in "
        f"numpy; merge_partial_softmax within {merge_err:.3e} of softmax(scores) @ v (limit "
        f"1e-4); pipeline_forward (4 stages, 4 microbatches) within {pipe_err:.3e} of the "
        f"sequential stages (limit 1e-5)")
    if not bits or merge_err > 1e-4 or pipe_err > 1e-5:
        raise AssertionError("mesh train: a reduction of distributed/ is off")
    shutil.rmtree(root / "ckpt", ignore_errors=True)

    qst = [r["steps"]["exact"] for r in qranks]
    log(f"  mesh[qwen2 (1, 2)]: loss {qst[0]['loss']:.6f} against {qrefs['exact']['loss']:.6f} "
        f"on one device; global grad norm {qst[0]['norm']:.6f} against "
        f"{qrefs['exact']['norm']:.6f}; tensor-parallel parts "
        f"{[p for p, on in qst[0]['plan'].items() if on]}; a rank's step "
        f"{statistics.median(s['sec'] for s in qst):.3f} s on the host clock, peak "
        f"{[round(s['peak_gib'], 2) for s in qst]} GiB against {qrefs['exact']['peak_gib']:.2f} "
        f"on one device ({card})")
    worst = max(worst, gaps({"exact": qranks[0]["steps"]["exact"]}, qrefs, "qwen2"))
    if any((s["loss"], s["norm"]) != (qst[0]["loss"], qst[0]["norm"]) for s in qst):
        raise AssertionError("mesh train [qwen2]: the ranks report different metrics")
    shutil.rmtree(root, ignore_errors=True)
    counts = collections.Counter()
    for r in ranks + qranks:
        counts.update(r["launches"])
    counts = {name: counts.get(name, 0) for name in kernels}
    log(f"  launches over the mesh-train steps, summed over the ranks: {counts}")
    missing = [n for n in TRAIN_KERNELS if counts[n] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the mesh-train path: {missing}")
    times = dict(
        step_sec=statistics.median(loop["sec"]), first_step_sec={
            m: statistics.median(r["steps"][m]["sec"] for r in ranks) for m in modes},
        one_device_sec={m: refs[m]["sec"] for m in modes},
        collectives=coll, worst_gap=worst,
        max_memory_gib=[r["max_memory_gib"] for r in ranks],
        one_device_peak_gib=refs["lut"]["peak_gib"], qwen2_sec=qst[0]["sec"])
    return {"mesh train": counts}, times


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
    errs["decode_attention_partials"], times["decode_attention_partials"] = \
        check_partials_kernel(torch, F, tlut, attn, args.seed)
    model_times = time_model_kernels(torch, F, gemv_pim, paged_attention, paged_prefill,
                                     args.seed)
    ssm_errs, ssm_kernel_times = time_ssm_kernels(torch, F, tlut, gemv_pim, layernorm_lut,
                                                  lut_interp, attn, softmax_lut, args.seed)
    for name, e in ssm_errs.items():
        errs[name] = max(errs[name], e)
    encdec_errs, encdec_kernel_times = time_encdec_kernels(torch, F, tlut, gemv_pim,
                                                           layernorm_lut, attn, softmax_lut,
                                                           args.seed)
    for name, e in encdec_errs.items():
        errs[name] = max(errs[name], e)

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
    check_param_count(params, cfg, "gpt2-medium")
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
    n_params = check_param_count(qw, qcfg, "qwen2-1.5b")
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
    qwen_ref = drain_summary(*q_runs["qwen2 exact"][:3])
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
    n_params = check_param_count(nw, ncfg, "nemotron-4-340b, 1 layer")
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

    log("== 12. slo/swap: the SLO scheduler with preempt-and-swap (GPT-2 medium)")
    t12 = time.perf_counter()
    counts_slo, swap_ms, slo_u1 = slo_phase(torch, F, np, mods, plain, counted, quant,
                                            quantize, params, cfg, prompts, card, args.seed)
    log(f"  phase 12 took {time.perf_counter() - t12:.1f} s")
    torch.cuda.empty_cache()

    log("== 13. telemetry: counters, request traces, Chrome traces, profiler scopes and "
        "the roofline (GPT-2 medium)")
    t13 = time.perf_counter()
    counts_tel = telemetry_phase(torch, np, mods, counted, params, cfg, prompts, card,
                                 args.seed, dense_runs["d1 exact"])
    log(f"  phase 13 took {time.perf_counter() - t13:.1f} s")
    torch.cuda.empty_cache()

    log("== 14. moe: olmoe-1B-7B at full width, 8 of 16 layers, phi-3.5-MoE at its published "
        "widths (2 layers)")
    t14 = time.perf_counter()
    counts_moe, moe_times = moe_phase(torch, F, np, mods, counted, quantize,
                                      prompts[:MODEL_PHASE_REQUESTS], new_tokens, card,
                                      args.seed)
    log(f"  phase 14 took {time.perf_counter() - t14:.1f} s")
    torch.cuda.empty_cache()

    log("== 15. ssm/hybrid: mamba2-370m and zamba2-1.2B at full width, 24 and 19 layers, on "
        "the dense cache")
    t15 = time.perf_counter()
    counts_ssm, ssm_times = ssm_phase(torch, np, mods, counted, quantize,
                                      prompts[:MODEL_PHASE_REQUESTS], new_tokens, card,
                                      args.seed)
    log(f"  phase 15 took {time.perf_counter() - t15:.1f} s")
    torch.cuda.empty_cache()

    log("== 16. encdec: whisper-large-v3 at full width and depth through generate()")
    t16 = time.perf_counter()
    counts_encdec, whisper = whisper_phase(torch, np, mods, counted, quantize, card, args.seed,
                                           new_tokens)
    log(f"  phase 16 took {time.perf_counter() - t16:.1f} s")

    log("== 17. vlm: qwen2-vl-2B's text path (M-RoPE) at full width")
    t17 = time.perf_counter()
    counts_vlm, vlm_ms = vlm_phase(torch, F, np, mods, counted, plain, quant, quantize, prompts,
                                   new_tokens, card, args.seed)
    log(f"  phase 17 took {time.perf_counter() - t17:.1f} s")

    log("== 18. train: GPT-2 medium at full width and depth, batch 8 x seq 1024")
    t18 = time.perf_counter()
    bw_errs, bw_times = check_backward_kernels(torch, F, tlut, layernorm_lut, lut_interp,
                                               softmax_lut, card, args.seed)
    errs.update(bw_errs)
    times.update(bw_times)
    counts_train, train = train_phase(torch, np, mods, counted, card, args.seed)
    log(f"  phase 18 took {time.perf_counter() - t18:.1f} s")

    log("== 19. mesh: tensor-parallel paged serving on 2 ranks of the one card (gloo), "
        "GPT-2 medium, qwen2-1.5B, olmoe-1B-7B")
    t19 = time.perf_counter()
    ref_int8 = serve(torch, mods, params, cfg, prompts, new_tokens, card,
                     label="m3 int8/bf16 exact on one device", fmt="int8/bf16")
    refs = {"digest": bit_digest(torch, params),
            "m1 fp exact": drain_summary(*runs["exact"][:3]),
            "m2 fp lut": drain_summary(*runs["lut"][:3]),
            "m3 int8/bf16 exact": drain_summary(*ref_int8[:3]),
            "m4 fp exact K=4 max_len 1024": drain_summary(*long_runs["2 fp exact K=4"][:3]),
            "m5 fp exact slo": drain_summary(*slo_u1[:3]),
            "qwen2 exact": qwen_ref}
    del ref_int8, slo_u1
    job = dict(card=card, seed=args.seed, prompts=prompts, long_prompts=long_prompts,
               urgent=slo_arrivals(np, cfg, args.seed)[1], q_prompts=q_prompts,
               olmoe_experts=get_config("olmoe_1b_7b").n_experts // MESH_RANKS)
    counts_mesh, mesh_times = mesh_phase(torch, np, mods, card, args.seed, job, refs,
                                         model_ms["exact"]["dec"])
    log(f"  phase 19 took {time.perf_counter() - t19:.1f} s")

    log("== 20. mesh train: GPT-2 medium whole on a (2, 2) (data, model) world of 4 ranks of "
        "the one card with fsdp; qwen2-1.5B whole on (1, 2)")
    t20 = time.perf_counter()
    counts_mesh_train, mesh_train = mesh_train_phase(torch, np, mods, card, args.seed)
    log(f"  phase 20 took {time.perf_counter() - t20:.1f} s")

    log("== 21. mesh dense: the dense decode on a mesh (phase 19's ranks): GPT-2 medium "
        "whole, KV heads on (1, 2); h2o-danube3-4B (2 layers) B 1, the sequence on (2, 1)")
    counts_mesh_dense = mesh_dense_report(torch, mesh_times["dense"], card)

    log("== 22. result")
    all_counts = [("max_len 256", counts_256), ("max_len 1024", counts_1024),
                  ("quantized max_len 256", counts_q), ("dense", counts_dense),
                  ("qwen2-1.5b", counts_qwen), ("gemma2-2b / h2o-danube3-4b", counts_gd),
                  ("nemotron-4-340b", counts_nem), ("share/spec", counts_ss),
                  ("slo/swap", counts_slo), ("telemetry", counts_tel),
                  *counts_moe.items(), *counts_ssm.items(), *counts_encdec.items(),
                  *counts_vlm.items(), *counts_train.items(), *counts_mesh.items(),
                  *counts_mesh_train.items(), *counts_mesh_dense.items()]
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
            row["moe_expert_silu"] = moe_times["kernels"]["lut_interp"]
        if name == "gemv_pim_float":
            row["moe_router_f32"] = moe_times["kernels"]["router"]
        if name == "gemv_pim_float":
            row["qwen2_decode_step"] = model_times["gemv_pim_float"]
        if name in ssm_kernel_times:
            row["ssm_shapes"] = ssm_kernel_times[name]
        if name in encdec_kernel_times:
            row["encdec_shapes"] = encdec_kernel_times[name]
        if name in ("paged_attention", "paged_attention_split"):
            row["mesh_rank_shapes"] = {k: v for k, v in mesh_times["plans"].items()
                                       if ("kv_splits" in k) == (name != "paged_attention")}
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
    log(f"  MoE decode step / 64-token chunk, device ms (host clock ms): "
        + ", ".join(f"[{k}] {v['dev_dec']:.2f} ({v['dec']:.2f}) / {v['dev_chunk']:.2f} "
                    f"({v['chunk']:.2f})" for k, v in moe_times.items()
                    if k in ("olmoe exact", "olmoe lut", "phi exact"))
        + f"; olmoe's bound {moe_times['olmoe bound']['bound_ms']:.2f} ms streaming every "
        f"weight ({card})")
    log(f"  SSM/hybrid decode step (4 slots) / 128-token admission, device ms (host clock "
        f"ms), bound ms: "
        + ", ".join(f"[{k}] {v['device']:.3f} ({v['host']:.2f}) / {v['admit_device']:.3f} "
                    f"({v['admit_host']:.2f}), {v['bound_ms']:.3f}" for k, v in ssm_times.items())
        + f" ({card})")
    log(f"  whisper decode step (4 slots) / admission (4 x 1500 frames + 4 x 128 tokens), "
        f"device ms (host clock ms), bounds ms: "
        + ", ".join(f"[{k}] {v['device']:.3f} ({v['host']:.2f}) / {v['admit_device']:.2f} "
                    f"({v['admit_host']:.2f}), {v['bound_ms']:.3f} / {v['admit_bound_ms']:.2f}"
                    for k, v in whisper["times"].items()) + f" ({card})")
    log(f"  qwen2-vl-2B decode step / 64-token chunk, device ms (host clock ms): "
        f"{vlm_ms['dev_dec']:.2f} ({vlm_ms['dec']:.2f}) / {vlm_ms['dev_chunk']:.2f} "
        f"({vlm_ms['chunk']:.2f}) ({card})")
    log(f"  training step (GPT-2 medium, 8 x 1024 tokens, LUT, remat), host clock: "
        f"{train['sec_per_step']:.4f} s/step, {train['tokens_per_s']:.0f} tokens/s, peak "
        f"{train['peak_gib']:.2f} GiB ({card})")
    log(f"  swap of one request's 9 pages, host clock ms (blob bytes): "
        + ", ".join(f"[{k}] out {o:.3f}, in {i:.3f} ({b})" for k, (b, o, i) in swap_ms.items())
        + f" ({card})")
    step = mesh_times["step"]
    log(f"  mesh decode step (GPT-2 medium, 4 slots, {MESH_RANKS} ranks on one card), host "
        f"clock: {step['dec']:.2f} ms a rank, gather_heads {step['gather']:.2f} ms of it, "
        f"against {model_ms['exact']['dec']:.2f} ms on one device ({card})")
    log(f"  mesh training step (GPT-2 medium, 8 x 1024 tokens, (2, 2) fsdp, 4 ranks on one "
        f"card), host clock: run_training[lut] {mesh_train['step_sec']:.3f} s a rank (one "
        f"device's LUT step {mesh_train['one_device_sec']['lut']:.3f} s); "
        f"collectives {mesh_train['collectives']['sec']:.3f} of "
        f"{mesh_train['collectives']['step_sec']:.3f} s synchronised; max memory a rank "
        f"{[round(v, 2) for v in mesh_train['max_memory_gib']]} GiB ({card})")
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
