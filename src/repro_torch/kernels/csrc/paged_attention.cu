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
// The function is the TPU kernel's page-ordered online softmax. With m_j
// the running max through page j (m_-1 = -1e30) and, for page j,
//   corr_j = exp(m_{j-1} - m_j)   or LUT(max(m_{j-1} - m_j, lo)),
//   p_k    = exp(s_k - m_j)       or LUT(s_k - m_j)  (0 outside the mask),
// the walk leaves l = sum_j (prod_{i>j} corr_i) sum_{k in j} p_k, and acc
// the same with p_k v_k; out = acc / max(l, 1e-9). LUT(a) LUT(b) is not
// LUT(a + b), so the kernel evaluates the LUT on exactly these arguments
// and changes only the order of the fp32 roundings.
//
// What bounds it on the H100: each step reads every valid K and V vector
// (and its scale) once for 4 FLOPs an element, so the KV bytes over HBM
// bound it: 4.86 us for 4 x 16 heads x 960..1024 bf16 keys. The walk, a
// cluster of blocks a (slot, kv head) over runs of the table with a
// cp.async ring on mbarriers, pages in storage type and the runs merged by
// prefix-max and suffix-product scans, is decode_walk.cuh's (mode kPaged),
// shared with the KV split and the dense arena; its note gives the design.
// What is left (scripts/sweep_clusters.py on the H100 80GB HBM3 at 700 W):
// the copies are not what bounds it, since L2-warm pools run as fast as
// cold ones; the time grows with the stages of a run, so the per-stage
// work (scores, p . V, the hand-off) is the next target, and a cluster of
// 4 (runs of 16 pages at 1024 keys) beats 8.
#include "decode_walk.cuh"

extern "C" {

// dtype (q's): 0 = float32, 1 = bfloat16; pool_fmt as paged::with_pool
// (scale pointers null for fp pools). softcap <= 0 and window <= 0 turn
// those masks off; exp_wb may be null when use_lut is 0. cluster: the
// blocks that share one (slot, kv head), 1, 2, 4 or 8, at most n_table;
// win_pages: the pages of a window, at least a run (ceil(n_table /
// cluster)) when a run fits, else whole ring stages
// (kernels/paged_attention.py::decode_plan). Returns a CUDA error code (0
// on success).
int paged_attention(const void* q, const void* k_pages, const void* v_pages,
                    const void* k_scales, const void* v_scales,
                    const int* block_tables, const int* lengths,
                    const float* exp_wb, void* out, int B, int H, int Hkv,
                    int D, int page, int n_pool, int n_table, float scale,
                    float softcap, int window, int use_lut, float lo,
                    float inv_step, int sections, int dtype, int pool_fmt,
                    int cluster, int win_pages, void* stream) {
  if (!walk::valid(H, Hkv, n_table, cluster, win_pages, use_lut, exp_wb, sections))
    return (int)cudaErrorInvalidValue;
  walk::Args a{q, out, (const uint8_t*)k_pages, (const uint8_t*)v_pages, k_scales, v_scales,
               block_tables, lengths, exp_wb, nullptr, nullptr, nullptr,
               H, Hkv, H / Hkv, D, page, n_pool, n_table, 0, 1, n_table,
               scale, softcap, window, use_lut, lo, inv_step, sections, 0, win_pages, 0};
  cudaStream_t s = (cudaStream_t)stream;
  const int run_pages = (n_table + cluster - 1) / cluster;
  const int rc = paged::dispatch(dtype, pool_fmt, [&](auto tq, auto pool) {
    return walk::launch<decltype(tq), decltype(pool), walk::kPaged>(a, B * Hkv, run_pages,
                                                                     cluster, s);
  });
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
