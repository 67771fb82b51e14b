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
// partials m, l (B, Hkv, K, g, 1) and acc (B, Hkv, K, g, D). One block
// per (b, kv head, split sp) walks the logical pages
// [sp * pps, (sp + 1) * pps) with pps = ceil(n_table / K), the run the TPU
// grid's (split, page) axes cover over its trash-padded table, with the
// unsplit kernel's online softmax (paged_walk.cuh), and writes its
// (m, l, un-normalised acc). A split whose run starts at or past the last
// valid key, or past the table (the trash padding), reads no page and
// writes the empty partial (-1e30, 0, 0).
//
// merge_partials: per (b, kv head, row, d), m_glob = max_k m_k, set to 0
// when m_glob <= -1e30 (all splits empty), corr_k = expf(m_k - m_glob)
// (exact exp, also in LUT mode, as the merge is), and out = sum_k acc_k
// corr_k / max(sum_k l_k corr_k, 1e-9), cast to q's dtype.
//
// What bounds it on the H100: the same KV bytes as the unsplit kernel,
// plus the partials (K * g * (D + 2) floats per (b, kv head), written once
// and read once by the combine). The unsplit kernel runs B * Hkv blocks,
// 64 for GPT-2 at 4 slots on a 132-SM card, each walking the whole
// context in sequence; the split gives K times as many blocks, each
// walking 1/K of the pages, so at long context more SMs stream pages at
// once. The combine is one small block per (b, kv head).
#include "paged_walk.cuh"

namespace {

template <typename T, class Pool>
__global__ void __launch_bounds__(paged::kThreads)
paged_split_kernel(const T* __restrict__ q, float* __restrict__ m_out,
                   float* __restrict__ l_out, float* __restrict__ acc_out,
                   paged::Args a, int H, int g, int pps) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int sp = blockIdx.z;
  const int D = a.d;
  paged::Smem s = paged::carve(smem, g, D, a.page, a.chunk_pages);
  const int length = a.lengths[b];
  for (int i = threadIdx.x; i < g * D; i += blockDim.x) {
    const int r = i / D;
    const int dd = i - r * D;
    s.q[i] = paged::to_f(q[((size_t)b * H + h * g + r) * D + dd]);
  }
  for (int r = threadIdx.x; r < g; r += blockDim.x) s.qpos[r] = length - 1;
  if (a.use_lut) {
    for (int i = threadIdx.x; i < 2 * (a.sections + 2); i += blockDim.x) s.wb[i] = a.exp_wb[i];
  }
  __syncthreads();
  paged::walk<Pool>(a, s, b, h, g, sp * pps, (sp + 1) * pps);
  const size_t row0 = (((size_t)b * a.hkv + h) * gridDim.z + sp) * g;
  for (int r = threadIdx.x; r < g; r += blockDim.x) {
    m_out[row0 + r] = s.m[r];
    l_out[row0 + r] = s.l[r];
  }
  for (int i = threadIdx.x; i < g * D; i += blockDim.x) acc_out[row0 * D + i] = s.acc[i];
}

template <typename T, class Pool>
int launch(const void* q, float* m, float* l, float* acc, paged::Args a, int B,
           int H, int splits, cudaStream_t stream) {
  a.vec = paged::use_vec<Pool>(a.k_pages, a.v_pages, a.d);
  const int g = H / a.hkv;
  const int pps = (a.n_table + splits - 1) / splits;
  const int smem = paged::smem_bytes(g, a.d, a.page, a.chunk_pages);
  if (smem > paged::kSmemDefault) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<T, Pool>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, a.hkv, splits);
  paged_split_kernel<T, Pool><<<grid, paged::kThreads, smem, stream>>>(
      (const T*)q, m, l, acc, a, H, g, pps);
  return 0;
}

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
// are f32 (B, Hkv, splits, H / Hkv, 1 | 1 | D).
int paged_attention_split(const void* q, const void* k_pages, const void* v_pages,
                          const void* k_scales, const void* v_scales,
                          const int* block_tables, const int* lengths,
                          const float* exp_wb, float* m_out, float* l_out,
                          float* acc_out, int B, int H, int Hkv, int D, int page,
                          int n_pool, int n_table, int splits, float scale,
                          float softcap, int window, int use_lut, float lo,
                          float inv_step, int sections, int dtype, int pool_fmt,
                          void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || splits < 1 || splits > n_table ||
      (use_lut && (exp_wb == nullptr || sections + 2 > paged::kMaxTableRows)))
    return (int)cudaErrorInvalidValue;
  const int chunk = paged::pick_chunk(H / Hkv, D, page);
  if (chunk == 0) return (int)cudaErrorInvalidValue;
  paged::Args a{k_pages, v_pages, k_scales, v_scales, block_tables, lengths, exp_wb,
                n_pool, n_table, Hkv, page, D, scale, softcap, window, use_lut, lo,
                inv_step, sections, chunk, 0};
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = paged::dispatch(dtype, pool_fmt, [&](auto tq, auto pool) {
    return launch<decltype(tq), decltype(pool)>(q, m_out, l_out, acc_out, a, B, H,
                                                splits, s);
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
