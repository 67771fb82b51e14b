// Paged decode attention: one query token per sequence over a shared KV
// page pool read through a block table.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::
// paged_attention (Pallas body _paged_attn_kernel, dequant _dequant_page)
// on its single-walk path; kv_splits > 1 at long context goes to
// paged_attention_split.cu instead.
//
// q (B, H, D), pools (P, Hkv, page, D) of q's dtype, or int8 (P, Hkv,
// page, D) / packed int4 (P, Hkv, page, D/2) payload with (P, Hkv, page)
// f32 or bf16 scale rows; block_tables (B, n_pages) int32, lengths (B,)
// int32 -> out (B, H, D) in q's dtype. GQA: the g = H / Hkv query heads of
// kv head h are rows h*g .. h*g + g - 1.
//
// What bounds it on the H100: each step reads every valid K and V vector
// (and its scale, when quantized) once for 4 FLOPs per element, so the
// kernel is bound by the KV bytes over HBM; a quantized pool moves
// (D + scale) or (D/2 + scale) bytes a vector instead of 2D or 4D, and is
// dequantized while it is staged in shared memory. The design gives one
// block to each (b, kv head), as the TPU grid's first two axes; the block
// loads its own block-table entries and walks the pages in order
// (paged_walk.cuh), staging several pages at a time in shared memory, and
// stops at the last page that holds a valid key. GPT-2 has g = 1 row per
// block, so a block's time is latency, not bandwidth:
// the walk keeps several 16-byte loads in flight per thread and splits
// each key's dot product over 16 threads. Each page's three passes still
// run one after another, and the rows are not padded to a tensor-core
// tile.
#include "paged_walk.cuh"

namespace {

template <typename T, class Pool>
__global__ void __launch_bounds__(paged::kThreads)
paged_decode_kernel(const T* __restrict__ q, T* __restrict__ out, paged::Args a,
                    int H, int g) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int D = a.d;
  paged::Smem s = paged::carve(smem, g, D, a.page, a.chunk_pages);
  const int length = a.lengths[b];
  for (int i = threadIdx.x; i < g * D; i += blockDim.x) {
    const int r = i / D;
    const int dd = i - r * D;
    s.q[i] = paged::to_f(q[((size_t)b * H + h * g + r) * D + dd]);
  }
  // A decode row is the prefill row at position length - 1: the causal
  // bound then coincides with the length mask.
  for (int r = threadIdx.x; r < g; r += blockDim.x) s.qpos[r] = length - 1;
  if (a.use_lut) {
    for (int i = threadIdx.x; i < 2 * (a.sections + 2); i += blockDim.x) s.wb[i] = a.exp_wb[i];
  }
  __syncthreads();
  paged::walk<Pool>(a, s, b, h, g, 0, a.n_table);
  for (int i = threadIdx.x; i < g * D; i += blockDim.x) {
    const int r = i / D;
    const int dd = i - r * D;
    const float l = fmaxf(s.l[r], 1e-9f);
    out[((size_t)b * H + h * g + r) * D + dd] = paged::from_f<T>(s.acc[i] / l);
  }
}

template <typename T, class Pool>
int launch(const void* q, void* out, paged::Args a, int B, int H,
           cudaStream_t stream) {
  a.vec = paged::use_vec<Pool>(a.k_pages, a.v_pages, a.d);
  const int g = H / a.hkv;
  const int smem = paged::smem_bytes(g, a.d, a.page, a.chunk_pages);
  if (smem > paged::kSmemDefault) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T, Pool>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, a.hkv);
  paged_decode_kernel<T, Pool><<<grid, paged::kThreads, smem, stream>>>(
      (const T*)q, (T*)out, a, H, g);
  return 0;
}

}  // namespace

extern "C" {

// dtype (q's): 0 = float32, 1 = bfloat16; pool_fmt as paged::with_pool
// (scale pointers null for fp pools). softcap <= 0 and window <= 0 turn
// those masks off; exp_wb may be null when use_lut is 0. Returns a CUDA
// error code (0 on success).
int paged_attention(const void* q, const void* k_pages, const void* v_pages,
                    const void* k_scales, const void* v_scales,
                    const int* block_tables, const int* lengths,
                    const float* exp_wb, void* out, int B, int H, int Hkv,
                    int D, int page, int n_pool, int n_table, float scale,
                    float softcap, int window, int use_lut, float lo,
                    float inv_step, int sections, int dtype, int pool_fmt,
                    void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || (use_lut && (exp_wb == nullptr ||
      sections + 2 > paged::kMaxTableRows)))
    return (int)cudaErrorInvalidValue;
  const int chunk = paged::pick_chunk(H / Hkv, D, page);
  if (chunk == 0) return (int)cudaErrorInvalidValue;
  paged::Args a{k_pages, v_pages, k_scales, v_scales, block_tables, lengths, exp_wb,
                n_pool, n_table, Hkv, page, D, scale, softcap, window, use_lut, lo,
                inv_step, sections, chunk, 0};
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = paged::dispatch(dtype, pool_fmt, [&](auto tq, auto pool) {
    return launch<decltype(tq), decltype(pool)>(q, out, a, B, H, s);
  });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
