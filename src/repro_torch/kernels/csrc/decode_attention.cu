// Decode attention over a dense per-slot KV arena: one new query token per
// sequence against its cached keys.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (Pallas body _decode_attn_kernel).
//
// q (B, H, D), k and v (B, Hkv, S, D) of q's dtype (float32 or bf16), or
// the int8 arena: int8 k and v with (B, Hkv, S) bf16 scale rows, read as
// `k.astype(q.dtype) * k_scale[..., None].astype(q.dtype)` (each product
// rounded to q's dtype; decode_walk.cuh's Int8Arena), so that the kernel
// on the int8 arena is bit for bit the kernel on the dequantized one;
// lengths (B,) int32 -> out (B, H, D) in q's dtype. GQA: the g = H / Hkv
// query heads of kv head h are rows h*g .. h*g + g - 1 and share one K/V
// stream. Key position p is valid when p < min(length, S) and, with a
// window, p >= length - window. Optional softcap and LUT exp.
//
// The function is the TPU kernel's online softmax over blocks of 256 keys
// aligned at 0, in its algebra (m_new = max(m_prev, max(scores)), p =
// exp(scores - m_new) or LUT(scores - m_new), corr = exp(m_prev - m_new)
// or LUT(max(m_prev - m_new, lo)), out = acc / max(l, 1e-9)). Unlike the
// TPU kernel, S need not be a multiple of the block: the last block is cut
// at S, and no key at or past min(length, S) is read. Blocks that hold no
// valid key are skipped, as there.
//
// What bounds it on the H100: each step reads every valid K and V vector
// once for 4 flops an element, so the bytes of the valid keys over HBM
// (4.85 us for 4 x 16 heads x 960..1020 bf16 keys). The design is the
// paged single walk's (decode_walk.cuh, mode kArena), with a "page" read
// as a 256-key block: a cluster of blocks a (slot, kv head), each an equal
// run of the blocks (kernels/paged_attention.py::arena_plan), whose
// contiguous keys are staged by a cp.async ring on mbarriers in 2 stages
// of up to 32 KB (a whole 256-key block of bf16 at D = 64), in storage
// type, V arriving
// while the scores are computed; the runs merged by prefix-max and
// suffix-product scans and Horner's rule in block 0.
//
// decode_attention_partials is the same walk (mode kArenaPart) over one
// rank's slice of an arena sharded along the sequence, the distributed
// flash-decode of the mesh decode: local key j is position key_offset + j
// of the whole arena (lengths and the window are the whole arena's), and
// block 0 writes the raw online-softmax partials m (B, H), l (B, H) and
// acc (B, H, D) in f32, m = -inf where the slice holds no valid key. The
// ranks' partials are merged by log-sum-exp algebra across the mesh
// (distributed/collectives.merge_partial_softmax), the analogue of the
// paper's C-ALU merging the banks' partial results. Its bound is the
// slice's valid K and V bytes, as above.
#include "decode_walk.cuh"

namespace {

// The walk over the arena (kArena: out in q's dtype) or over a slice of it
// at key_offset (kArenaPart: m, l, acc partials); the checks of both entries.
int run(bool part, const void* q, const void* k, const void* v, const void* k_scale,
        const void* v_scale, const int* lengths, const float* exp_wb, void* out, float* m,
        float* l, float* acc, int B, int H, int Hkv, int S, int D, int key_offset, float scale,
        float softcap, int window, int use_lut, float lo, float inv_step, int sections,
        int dtype, int fmt, int cluster, int win_pages, void* stream) {
  constexpr int kBlockS = 256;          // keys a softmax block: the TPU kernel's block_s
  if (B <= 0) return 0;
  if (S <= 0 || fmt < 0 || fmt > 1 || key_offset < 0) return (int)cudaErrorInvalidValue;
  const int n_blocks = (S + kBlockS - 1) / kBlockS;
  if (D <= 0 || !walk::valid(H, Hkv, n_blocks, cluster, win_pages, use_lut, exp_wb, sections) ||
      (fmt == 1) != (k_scale != nullptr && v_scale != nullptr) ||
      (part && (m == nullptr || l == nullptr || acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  walk::Args a{q, out, (const uint8_t*)k, (const uint8_t*)v, k_scale, v_scale, nullptr,
               lengths, exp_wb, m, l, acc,
               H, Hkv, H / Hkv, D, kBlockS, 0, n_blocks, S, 1, n_blocks,
               scale, softcap, window, use_lut, lo, inv_step, sections, 0, win_pages, 0,
               key_offset};
  cudaStream_t s = (cudaStream_t)stream;
  const int run_pages = (n_blocks + cluster - 1) / cluster;
  auto go = [&](auto tq, auto pool) {
    using TQ = decltype(tq);
    using Pool = decltype(pool);
    return part ? walk::launch<TQ, Pool, walk::kArenaPart>(a, B * Hkv, run_pages, cluster, s)
                : walk::launch<TQ, Pool, walk::kArena>(a, B * Hkv, run_pages, cluster, s);
  };
  int rc;
  if (dtype == 0) {
    rc = fmt == 0 ? go(float{}, paged::FpPool<float>{}) : go(float{}, paged::Int8Arena<float>{});
  } else if (dtype == 1) {
    rc = fmt == 0 ? go(__nv_bfloat16{}, paged::FpPool<__nv_bfloat16>{})
                  : go(__nv_bfloat16{}, paged::Int8Arena<__nv_bfloat16>{});
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (q's): 0 = float32, 1 = bfloat16; fmt: 0 = k, v of q's dtype
// (scale pointers null), 1 = int8 k, v with bf16 scale rows. softcap <= 0
// and window <= 0 turn those masks off; exp_wb may be null when use_lut
// is 0. cluster: the blocks of a (slot, kv head), 1, 2, 4 or 8, at most
// ceil(S / 256); win_pages: 256-key blocks a window (arena_plan). Returns
// a CUDA error code (0 on success).
int decode_attention(const void* q, const void* k, const void* v, const void* k_scale,
                     const void* v_scale, const int* lengths, const float* exp_wb, void* out,
                     int B, int H, int Hkv, int S, int D, float scale, float softcap,
                     int window, int use_lut, float lo, float inv_step, int sections,
                     int dtype, int fmt, int cluster, int win_pages, void* stream) {
  return run(false, q, k, v, k_scale, v_scale, lengths, exp_wb, out, nullptr, nullptr, nullptr,
             B, H, Hkv, S, D, 0, scale, softcap, window, use_lut, lo, inv_step, sections, dtype,
             fmt, cluster, win_pages, stream);
}

// The slice of S keys at positions key_offset .. key_offset + S - 1 of an
// arena whose lengths (and window) are the whole arena's: m and l (B, H)
// and acc (B, H, D) f32 out; the other arguments as decode_attention's.
int decode_attention_partials(const void* q, const void* k, const void* v, const void* k_scale,
                              const void* v_scale, const int* lengths, const float* exp_wb,
                              float* m, float* l, float* acc, int B, int H, int Hkv, int S,
                              int D, int key_offset, float scale, float softcap, int window,
                              int use_lut, float lo, float inv_step, int sections, int dtype,
                              int fmt, int cluster, int win_pages, void* stream) {
  return run(true, q, k, v, k_scale, v_scale, lengths, exp_wb, nullptr, m, l, acc, B, H, Hkv,
             S, D, key_offset, scale, softcap, window, use_lut, lo, inv_step, sections, dtype,
             fmt, cluster, win_pages, stream);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
