// KV-split (flash-decode) paged decode attention, and the combine of its
// partials.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// _paged_attention_split (Pallas body _paged_attn_split_kernel) and the
// combine that follows it there, distributed/collectives.py::
// merge_partial_softmax_stacked, which the JAX package runs in XLA.
//
// paged_attention_split: q (B, H, D), the pools and scale rows of
// paged_attention.cu, block_tables (B, n_table), lengths (B,) -> raw f32
// partials m, l (B, Hkv, K, g, 1) and acc (B, Hkv, K, g, D). Split sp
// walks the logical pages [sp * pps, (sp + 1) * pps) with pps =
// ceil(n_table / K), the run the TPU grid's (split, page) axes cover over
// its trash-padded table, with the single walk's page-ordered online
// softmax from m = -1e30, and writes its (m, l, un-normalised acc). A
// split whose run starts at or past the last valid key, or past the table
// (the trash padding), reads no page and writes the empty partial (-1e30,
// 0, 0).
//
// merge_partials (the combine, its own launch): per (b, kv head, row,
// d), m_glob = max_k m_k, set to 0 when m_glob <= -1e30 (all splits
// empty), corr_k = expf(m_k - m_glob) (exact exp, also in LUT mode, as the
// merge is), and out = sum_k acc_k corr_k / max(sum_k l_k corr_k, 1e-9),
// each product and sum rounded on its own and summed in split order from
// 0, cast to q's dtype: bit for bit kernels/paged_attention.py::
// merge_partials_plain. A warp a (b, kv head, row): lane k reads split
// k's m and l once and forms its corr and l corr, which the warp shares
// by shuffles; each lane sums 4 columns of acc read in 16-byte pieces (the
// first splits' pieces loaded before the maximum is known). It is bound
// by latency (0.02 us of bytes at GPT-2's shapes), so it is launched with
// programmatic dependent launch: the split kernel lets it start once
// every split's block 0 has written its partial, and it waits
// (griddepcontrol.wait) only before it reads one, so its launch overlaps
// the split kernel's tail. (Folding the combine into the split kernel,
// the last split of a (b, kv head) to finish merging on an arrival
// counter, measured level at K = 4 and slower at K = 8 on the H100:
// PERF.md §6, row 4b.)
//
// What bounds it on the H100: the same KV bytes as the single walk, plus
// the partials (K * g * (D + 2) floats per (b, kv head), written once and
// read once by the combine). The design is the single walk's
// (decode_walk.cuh, mode kSplit): a cluster of 1..8 blocks a (b, kv head,
// split), each block an equal run of the split's pages staged by a
// cp.async ring on mbarriers in storage type, the runs merged by
// prefix-max and suffix-product scans and Horner's rule in block 0, which
// writes the split's partial. The grid is B * Hkv * K clusters
// (kernels/paged_attention.py::split_plan sizes them), so at long context
// K times as many blocks stream pages at once as in the single walk.
#include "decode_walk.cuh"

namespace {

constexpr int kMergeWarps = 4;   // (b, kv head, row)s a block
constexpr int kMergeCols = 128;  // columns of a pass: 4 a lane
constexpr int kMergePre = 8;     // splits whose partials load before the maximum

// A warp a row w of (B * Hkv * g). Every lane reads the first kMergePre
// splits' m and l (one broadcast load each) and its 4 columns of their acc
// (one 16-byte piece a split with kVec: D % 4 == 0; else columns lane +
// 32 q) at once, then forms the maximum, each split's corr and the sums in
// split order in its own registers: one round trip and no shuffles. Later
// splits and later passes of 128 columns are read as they are summed.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kMergeWarps * 32)
merge_kernel(const float* __restrict__ m, const float* __restrict__ l,
             const float* __restrict__ acc, T* __restrict__ out, int rows, int splits, int g,
             int D) {
  hopper::pdl_wait();                // the split kernel's partials are written
  const int lane = threadIdx.x % 32;
  const int w = blockIdx.x * kMergeWarps + threadIdx.x / 32;
  if (w >= rows) return;
  const int bh = w / g;
  const size_t mr = (size_t)bh * splits * g + (w - bh * g);   // split 0's m and l of row w
  const float* ar = acc + mr * D;                               // split 0's acc row
  const size_t k_acc = (size_t)g * D;                           // floats between splits' rows
  const int d0 = kVec ? 4 * lane : lane;

  // This lane's 4 columns of split k's acc in pass cb.
  auto load4 = [&](int k, int cb, float (&v)[4]) {
    const float* a = ar + k * k_acc + cb + d0;
    if (kVec) {
      if (cb + d0 < D) {
        const float4 f = *reinterpret_cast<const float4*>(a);
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (cb + d0 + 32 * q < D) v[q] = a[32 * q];
    }
  };
  float pm[kMergePre], pl[kMergePre], pa[kMergePre][4];
#pragma unroll
  for (int k = 0; k < kMergePre; ++k) {
    if (k < splits) {
      pm[k] = m[mr + (size_t)k * g];
      pl[k] = l[mr + (size_t)k * g];
      load4(k, 0, pa[k]);
    }
  }
  float mg = paged::kNegInf;
#pragma unroll
  for (int k = 0; k < kMergePre; ++k)
    if (k < splits) mg = fmaxf(mg, pm[k]);
  for (int k = kMergePre; k < splits; ++k) mg = fmaxf(mg, m[mr + (size_t)k * g]);
  if (mg <= paged::kNegInf) mg = 0.0f;
  float pc[kMergePre];
#pragma unroll
  for (int k = 0; k < kMergePre; ++k)
    if (k < splits) pc[k] = expf(__fsub_rn(pm[k], mg));

  float den = 0.0f;
  T* o = out + (size_t)w * D;
  for (int cb = 0; cb < D; cb += kMergeCols) {
    float lg = 0.0f, ag[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kMergePre; ++k) {
      if (k < splits) {
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (cb == 0) {
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] = pa[k][q];
        } else {
          load4(k, cb, v);
        }
        lg = __fadd_rn(lg, __fmul_rn(pl[k], pc[k]));
#pragma unroll
        for (int q = 0; q < 4; ++q) ag[q] = __fadd_rn(ag[q], __fmul_rn(v[q], pc[k]));
      }
    }
    for (int k = kMergePre; k < splits; ++k) {
      const float c = expf(__fsub_rn(m[mr + (size_t)k * g], mg));
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      load4(k, cb, v);
      lg = __fadd_rn(lg, __fmul_rn(l[mr + (size_t)k * g], c));
#pragma unroll
      for (int q = 0; q < 4; ++q) ag[q] = __fadd_rn(ag[q], __fmul_rn(v[q], c));
    }
    if (cb == 0) den = fmaxf(lg, 1e-9f);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = cb + (kVec ? d0 + q : d0 + 32 * q);
      if (d < D) o[d] = paged::from_f<T>(__fdiv_rn(ag[q], den));
    }
  }
}

}  // namespace

extern "C" {

// Conventions of paged_attention() in paged_attention.cu; splits >= 1 is
// the number of page runs (at most n_table), and m_out, l_out, acc_out
// are f32 (B, Hkv, splits, H / Hkv, 1 | 1 | D). cluster: the blocks of a
// split, 1, 2, 4 or 8, at most its pages; win_pages as in
// paged_attention() over a split's run (split_plan).
int paged_attention_split(const void* q, const void* k_pages, const void* v_pages,
                          const void* k_scales, const void* v_scales,
                          const int* block_tables, const int* lengths,
                          const float* exp_wb, float* m_out, float* l_out,
                          float* acc_out, int B, int H, int Hkv,
                          int D, int page, int n_pool, int n_table, int splits, float scale,
                          float softcap, int window, int use_lut, float lo,
                          float inv_step, int sections, int dtype, int pool_fmt,
                          int cluster, int win_pages, void* stream) {
  if (splits < 1 || splits > n_table) return (int)cudaErrorInvalidValue;
  const int pps = (n_table + splits - 1) / splits;
  if (!walk::valid(H, Hkv, pps, cluster, win_pages, use_lut, exp_wb, sections))
    return (int)cudaErrorInvalidValue;
  walk::Args a{q, nullptr, (const uint8_t*)k_pages, (const uint8_t*)v_pages, k_scales,
               v_scales, block_tables, lengths, exp_wb, m_out, l_out, acc_out,
               H, Hkv, H / Hkv, D, page, n_pool, n_table, 0, splits, pps,
               scale, softcap, window, use_lut, lo, inv_step, sections, 0, win_pages, 0};
  cudaStream_t s = (cudaStream_t)stream;
  const int run_pages = (pps + cluster - 1) / cluster;
  const int rc = paged::dispatch(dtype, pool_fmt, [&](auto tq, auto pool) {
    return walk::launch<decltype(tq), decltype(pool), walk::kSplit>(a, B * Hkv * splits,
                                                                     run_pages, cluster, s);
  });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// m, l (B * Hkv, splits, g), acc (B * Hkv, splits, g, D) f32 -> out
// (B, Hkv * g, D) in dtype (0 = float32, 1 = bfloat16). pdl 1 launches it
// with programmatic stream serialization: it may start while the kernel
// before it in the stream (the split kernel) drains, and waits for that
// kernel's writes before it reads a partial; pdl 0 launches it after that
// kernel has finished.
int merge_partials(const float* m, const float* l, const float* acc, void* out,
                   int BHkv, int g, int D, int splits, int dtype, int pdl, void* stream) {
  if (BHkv <= 0 || g <= 0 || D <= 0 || splits < 1 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int rows = BHkv * g;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((rows + kMergeWarps - 1) / kMergeWarps), 1, 1);
  cfg.blockDim = dim3(kMergeWarps * 32, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const bool vec = D % 4 == 0 && common::aligned16(acc);
  cudaError_t e;
  if (dtype == 0) {
    e = vec ? cudaLaunchKernelEx(&cfg, merge_kernel<float, true>, m, l, acc, (float*)out, rows,
                                 splits, g, D)
            : cudaLaunchKernelEx(&cfg, merge_kernel<float, false>, m, l, acc, (float*)out,
                                 rows, splits, g, D);
  } else {
    using B = __nv_bfloat16;
    e = vec ? cudaLaunchKernelEx(&cfg, merge_kernel<B, true>, m, l, acc, (B*)out, rows, splits,
                                 g, D)
            : cudaLaunchKernelEx(&cfg, merge_kernel<B, false>, m, l, acc, (B*)out, rows,
                                 splits, g, D);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* paged_attention_split_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
