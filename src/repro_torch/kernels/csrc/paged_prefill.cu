// Chunked paged prefill attention: a chunk of Sq query tokens per sequence
// over the shared KV page pool, causal at absolute positions.
//
// Replaces the TPU kernel src/repro/kernels/paged_prefill.py::
// paged_prefill_attention (Pallas body _paged_prefill_kernel), for pools
// of q's dtype and for int8 / packed int4 pools with scale rows.
//
// q (B, Sq, H, D) at positions start[b] .. start[b] + Sq - 1, pools
// (P, Hkv, page, D) (packed int4: D/2) holding every key in
// [0, length[b]) (the chunk's own K/V already written), block_tables
// (B, n_pages), lengths and starts (B,) int32 -> out (B, Sq, H, D) in q's
// dtype. Per (b, kv head h) there are Sq * g rows; row r is query r / g,
// head h * g + r % g, at position start + r / g, and attends to keys
// k < length with k <= start + r / g. Each row runs the TPU kernel's
// page-ordered online softmax (paged_walk.cuh gives the algebra), so LUT
// mode computes the same function as the Pallas kernel.
//
// The rows are split over blocks of kRows (grid (B, Hkv, ceil(Sq * g /
// kRows))), each block walking the pages up to its own last query
// position through paged_walk.cuh, which dequantizes them in fp32 and keeps
// every sum in fp64: the output is the plain version's, bit for bit in
// practice, so that the first logits of a quantized datapath (int8
// activations over a deep model) stay those of the plain path.
//
// What bounds it on the H100: a 64-token chunk does 64 rows of work per
// key vector read, below the card's fp64 ridge, so at the engine's chunk
// sizes KV bytes bound it (0.23 us at start 64 for GPT-2 medium); at so
// few bytes latency and parallelism decide the time.
#include "paged_walk.cuh"

namespace {

// Rows a block. The walk is latency-bound, so more, smaller blocks pay
// more than the K and V that each of them stages again: on the H100, 8
// rows (a 64-token chunk of GPT-2 medium in 128 blocks) took 20.6 us at
// start 64 where 16 took 32.2, and 4 rows with room for two blocks an SM
// 23.1 (chip_smoke.py's prefill timing).
constexpr int kRows = 8;

template <typename T, class Pool>
__global__ void __launch_bounds__(paged::kThreads)
paged_prefill_kernel(const T* __restrict__ q, T* __restrict__ out,
                     const int* __restrict__ starts, paged::Args a, int Sq,
                     int H, int g) {
  extern __shared__ double smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int r0 = blockIdx.z * kRows;
  const int rows = min(kRows, Sq * g - r0);
  const int D = a.d;
  paged::Smem s = paged::carve(smem, kRows, D, a.page, a.chunk_pages);
  const int start = starts[b];
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int rr = r0 + i / D;
    const int dd = i % D;
    s.q[i] = paged::to_f(q[(((size_t)b * Sq + rr / g) * H + h * g + rr % g) * D + dd]);
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) s.qpos[r] = start + (r0 + r) / g;
  if (a.use_lut) {
    for (int i = threadIdx.x; i < 2 * (a.sections + 2); i += blockDim.x) s.wb[i] = a.exp_wb[i];
  }
  __syncthreads();
  paged::walk<Pool>(a, s, b, h, rows, 0, a.n_table);
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D;
    const int rr = r0 + r;
    const int dd = i % D;
    const double l = fmax(s.l[r], 1e-9);
    out[(((size_t)b * Sq + rr / g) * H + h * g + rr % g) * D + dd] =
        paged::from_f<T>((float)(s.acc[i] / l));
  }
}

template <typename T, class Pool>
int launch(const void* q, void* out, const int* starts, paged::Args a,
           int B, int Sq, int H, cudaStream_t stream) {
  a.vec = paged::use_vec<Pool>(a.k_pages, a.v_pages, a.d);
  const int g = H / a.hkv;
  const int smem = paged::smem_bytes(kRows, a.d, a.page, a.chunk_pages);
  static int sized = paged::kSmemDefault;   // the largest size allowed so far
  if (smem > sized) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<T, Pool>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = smem;
  }
  dim3 grid(B, a.hkv, (Sq * g + kRows - 1) / kRows);
  paged_prefill_kernel<T, Pool><<<grid, paged::kThreads, smem, stream>>>(
      (const T*)q, (T*)out, starts, a, Sq, H, g);
  return 0;
}

}  // namespace

extern "C" {

// Same conventions as paged_attention() in paged_attention.cu; starts (B,)
// int32 is the absolute position of each chunk's first query.
int paged_prefill_attention(const void* q, const void* k_pages,
                            const void* v_pages, const void* k_scales,
                            const void* v_scales, const int* block_tables,
                            const int* lengths, const int* starts,
                            const float* exp_wb, void* out, int B, int Sq,
                            int H, int Hkv, int D, int page, int n_pool,
                            int n_table, float scale, float softcap, int window,
                            int use_lut, float lo, float inv_step, int sections,
                            int dtype, int pool_fmt, void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || (use_lut && (exp_wb == nullptr ||
      sections + 2 > paged::kMaxTableRows)))
    return (int)cudaErrorInvalidValue;
  const int chunk = paged::pick_chunk(kRows, D, page);
  if (chunk == 0) return (int)cudaErrorInvalidValue;
  paged::Args a{k_pages, v_pages, k_scales, v_scales, block_tables, lengths, exp_wb,
                n_pool, n_table, Hkv, page, D, scale, softcap, window, use_lut, lo,
                inv_step, sections, chunk, 0};
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = paged::dispatch(dtype, pool_fmt, [&](auto tq, auto pool) {
    return launch<decltype(tq), decltype(pool)>(q, out, starts, a, B, Sq, H, s);
  });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

const char* paged_prefill_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
