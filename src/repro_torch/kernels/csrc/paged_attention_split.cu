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
// summed in split order, cast to q's dtype. (Folding the combine into
// the split kernel, the last split of a (b, kv head) to finish merging on
// an arrival counter, measured level at K = 4 and slower at K = 8 on the
// H100: PERF.md §6, row 4b.)
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

// One block per (b, kv head); thread i owns (row i / D, column i % D).
template <typename T>
__global__ void merge_kernel(const float* __restrict__ m, const float* __restrict__ l,
                             const float* __restrict__ acc, T* __restrict__ out,
                             int splits, int g, int D) {
  const size_t bh = blockIdx.x;
  const float* mb = m + bh * splits * g;
  const float* lb = l + bh * splits * g;
  const float* ab = acc + bh * splits * g * D;
  for (int i = threadIdx.x; i < g * D; i += blockDim.x) {
    const int r = i / D;
    float mg = paged::kNegInf;
    for (int k = 0; k < splits; ++k) mg = fmaxf(mg, mb[k * g + r]);
    if (mg <= paged::kNegInf) mg = 0.0f;
    float lg = 0.0f, ag = 0.0f;
    for (int k = 0; k < splits; ++k) {
      const float c = expf(mb[k * g + r] - mg);
      lg += lb[k * g + r] * c;
      ag += ab[(size_t)k * g * D + i] * c;
    }
    out[bh * g * D + i] = paged::from_f<T>(ag / fmaxf(lg, 1e-9f));
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
// (B, Hkv * g, D) in dtype (0 = float32, 1 = bfloat16).
int merge_partials(const float* m, const float* l, const float* acc, void* out,
                   int BHkv, int g, int D, int splits, int dtype, void* stream) {
  if (BHkv <= 0 || g <= 0 || D <= 0 || splits < 1) return (int)cudaErrorInvalidValue;
  int threads = ((g * D + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    merge_kernel<float><<<BHkv, threads, 0, s>>>(m, l, acc, (float*)out, splits, g, D);
  } else if (dtype == 1) {
    merge_kernel<__nv_bfloat16><<<BHkv, threads, 0, s>>>(m, l, acc, (__nv_bfloat16*)out,
                                                         splits, g, D);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* paged_attention_split_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
