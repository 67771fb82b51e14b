// The decode walk: one query token a sequence against its cached keys, a
// cluster of blocks a (sequence, kv head), in one of three modes:
//
//   kPaged  the single walk over a paged pool read through a block table
//           (paged_attention.cu), out = acc / max(l, 1e-9);
//   kSplit  the KV split over the same pools (paged_attention_split.cu):
//           one cluster a (sequence, kv head, split), each split walking
//           its run of the table from m = -1e30 and leaving raw (m, l, acc)
//           partials for merge_partials, which it lets launch early
//           (programmatic dependent launch, triggered as each block starts);
//   kArena  the dense per-slot arena (decode_attention.cu): the (S, D) keys
//           of a (slot, kv head) are one contiguous run, read as "pages" of
//           256 keys, the TPU kernel's online-softmax block, the last one
//           cut at S.
//
// The function is the TPU kernels' page-ordered (block-ordered) online
// softmax. With m_j the running max through page j (m_-1 = -1e30) and,
// for page j,
//   corr_j = exp(m_{j-1} - m_j)   or LUT(max(m_{j-1} - m_j, lo)),
//   p_k    = exp(s_k - m_j)       or LUT(s_k - m_j)  (0 outside the mask),
// the walk leaves l = sum_j (prod_{i>j} corr_i) sum_{k in j} p_k, acc the
// same with p_k v_k, and m the last m_j. LUT(a) LUT(b) is not LUT(a + b),
// so the kernel evaluates the LUT on exactly these arguments and changes
// only the order of the fp32 roundings. Pages that hold no valid key
// before the first valid one (wholly before a window) leave m, l and acc
// as they were and are skipped in arena mode, as the TPU kernel skips
// them; the paged modes walk them.
//
// What bounds it on the H100: each step reads every valid K and V vector
// (and its scale) once for 4 FLOPs an element, so the KV bytes over HBM:
// 4.86 us for 4 x 16 heads x 960..1024 bf16 keys. At GPT-2's 4 slots x 16
// kv heads there are only 64 (slot, kv head) pairs for 132 SMs, so
// latency, not bandwidth, decides the time. The design:
//  * A cluster of up to 8 blocks shares one (sequence, kv head[, split]);
//    each block takes an equal run of its pages. Every block computes all
//    of its scores and pushes its maximum into the shared memory of the
//    later blocks of the cluster (of every block, in split mode, whose
//    block 0 also needs the split's m); after one cluster barrier each
//    knows m_{j-1} at its first page. A warp a row then forms every m_j
//    and corr_j by a prefix-max scan and the weights prod_{i>j} corr_i by
//    a suffix-product scan over the run; the block sums its weighted p and
//    p . V and pushes them, with its run's product of corr, into block 0,
//    which after a second barrier combines the runs in order, Horner style
//    (acc = acc * C_b + acc_b): the walk's recurrence regrouped.
//  * Staging: a ring of 64 KB, fed with 16-byte cp.async copies from
//    every thread that arrive on an mbarrier, so V arrives while the
//    scores are computed. For pools, 4 stages of up to 16 KB of whole
//    pages (contiguous page x D runs); for the arena, 2 stages of up to 32
//    KB: a whole 256-key block of bf16 at D = 64, or a contiguous part of
//    one. Rows stay in storage type in shared memory and are widened or
//    dequantized in registers. Rows that are not whole 16-byte vectors are
//    copied by the block instead.
//  * A block keeps a window of its run in shared memory: every key's
//    scores and K/V scales, each page's m_j and weight, beside the ring.
//    The wrappers' planners (kernels/paged_attention.py: decode_plan,
//    split_plan, arena_plan) grow the cluster with the run until it fits
//    one window. A run wider than that is walked in windows of whole ring
//    stages: a first pass reads the run's K once and keeps only its
//    maximum a row, which the block publishes as above; then each window
//    re-reads its K, recomputes its scores, forms m_j and corr_j by the
//    same prefix-max scan with m_{j-1} carried across windows (so the LUT
//    sees the walk's own arguments), and folds its weighted l and p . V
//    into the run's by Horner's rule, beside the run's product of corr. No
//    shared memory grows with the table's width. g * D past the block's
//    threads is summed pair by pair into shared memory.
//  * Work inside a block: the scores of a stage are one pass of dot
//    products over 16-byte units (a pair of threads a key, shuffle-
//    reduced), then one barrier; p . V is one pass with threads over (row,
//    dim) and key groups, then one barrier. No per-page barriers.
#pragma once

#include <cooperative_groups.h>

#include "hopper.cuh"
#include "paged_walk.cuh"

namespace paged {

// The int8 arena of the dense cache: int8 payload, D bytes a row, with a
// bf16 scale a row, dequantized as the JAX package's eager expression
// `cache.astype(q.dtype) * scale[..., None].astype(q.dtype)` does: the
// product in fp32 (exact: 8 by 8 significant bits) rounded to T. Rows are
// read in units of 16 / sizeof(T) elements, the 16-byte vectors of the
// dequantized T arena, and summed in the same order, so that the kernel
// on the int8 arena is bit for bit the kernel on the dequantized one.
template <typename T>
struct Int8Arena {
  using P = int8_t;
  static constexpr bool kScaled = true;
  __host__ __device__ static int row_payload(int d) { return d; }
  __device__ __forceinline__ static float scale(const void* sc, size_t i) {
    return to_f(reinterpret_cast<const __nv_bfloat16*>(sc)[i]);
  }
};

template <typename T>
struct Row<Int8Arena<T>> {
  static constexpr int kUnit = 16 / (int)sizeof(T);   // int8 bytes a unit
  static constexpr bool kInline = true;               // dotu and acc1 take the scale
  __host__ __device__ static int bytes(int d) { return d; }
  __device__ static int elems(int d) { return d; }
  // Units as the T arena's 16-byte vectors, whatever the int8 copy's path.
  __device__ static bool vec_units(int d, int) { return (d * (int)sizeof(T)) % 16 == 0; }
  __device__ __forceinline__ static float deq(int x, float sc) {
    return to_f(from_f<T>((float)x * sc));
  }
  __device__ __forceinline__ static float dotu(const uint8_t* p, const float* q, int u, int,
                                               float sc) {
    int8_t b[kUnit];
    if constexpr (kUnit == 8) {
      *reinterpret_cast<uint2*>(b) = *reinterpret_cast<const uint2*>(p);
    } else {
      *reinterpret_cast<uint32_t*>(b) = *reinterpret_cast<const uint32_t*>(p);
    }
    const float* qq = q + u * kUnit;
    float s = 0.0f;
#pragma unroll
    for (int n = 0; n < kUnit; ++n) s = fmaf(qq[n], deq(b[n], sc), s);
    return s;
  }
  __device__ __forceinline__ static float acc1(const uint8_t* row, const float* q, int e, int,
                                               float acc, float sc) {
    return fmaf(q[e], deq(reinterpret_cast<const int8_t*>(row)[e], sc), acc);
  }
  __device__ __forceinline__ static float at(const uint8_t* row, int dd, int) {
    return (float)reinterpret_cast<const int8_t*>(row)[dd];
  }
  __device__ __forceinline__ static float val(const uint8_t* row, int dd, int, float sc) {
    return deq(reinterpret_cast<const int8_t*>(row)[dd], sc);
  }
};

// The row bytes a ring stage is sized by: the T arena's for the int8
// arena, so that both arenas walk the same stages and sum in one order.
template <class Pool>
struct StageRow {
  __host__ __device__ static int bytes(int d) { return Row<Pool>::bytes(d); }
};
template <typename T>
struct StageRow<Int8Arena<T>> {
  __host__ __device__ static int bytes(int d) { return d * (int)sizeof(T); }
};

}  // namespace paged

// Internal linkage: every source that includes this header keeps its own
// instantiations (and launch()'s record of the shared memory it allowed).
namespace walk {
namespace {

namespace cg = cooperative_groups;
using common::to_f;
using paged::Row;
using paged::kNegInf;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;

enum Mode { kPaged = 0, kSplit = 1, kArena = 2 };

// The ring: pools stage whole pages in 4 stages of up to 16 KB; the
// arena's contiguous runs stage up to a 256-key block (32 KB of bf16 at
// D = 64) in 2, the same 64 KB, so that a block's K and V each arrive in
// one piece.
template <int kMode> __host__ __device__ constexpr int stages() { return kMode == kArena ? 2 : 4; }
template <int kMode> __host__ __device__ constexpr int stage_target() {
  return kMode == kArena ? 32768 : 16384;
}

struct Args {
  const void* q;
  void* out;                // (B, H, D) in q's dtype; null for the split
  const uint8_t* k_pages;   // pools (P, Hkv, page, ·), or the arena (B, Hkv, S, ·)
  const uint8_t* v_pages;
  const void* k_scales;     // (P, Hkv, page) or (B, Hkv, S), or null for fp pools
  const void* v_scales;
  const int* block_tables;  // (B, n_table); null for the arena
  const int* lengths;       // (B,)
  const float* exp_wb;      // (sections + 2, 2) or null
  float* m_part;            // split: (B, Hkv, splits, g) f32
  float* l_part;
  float* acc_part;          // split: (B, Hkv, splits, g, D) f32
  int H, hkv, g, d, page, n_pool, n_table;
  int S;                    // arena: positions a (slot, kv head)
  int splits, pps;          // split: runs, pages a run (1 and n_table otherwise)
  float scale;
  float softcap;            // <= 0: off
  int window;               // <= 0: off
  int use_lut;
  float lo, inv_step;
  int sections;
  int chunk_keys;           // keys a ring stage: whole pages, or a divisor of a page
  int win_pages;            // pages a window: a whole run, or whole ring stages
  int vec;                  // 1: rows are whole 16-byte vectors of aligned pools
};

// Shared-memory carve-up, in bytes, 16-byte aligned pieces.
struct Layout {
  int ring, bars, q, sc, ksc, vsc, m, w, tbl, red, bm_in, recv, wb, st, racc, wacc, total;
};

__host__ __device__ inline int take(int& o, int bytes) {
  const int at = o;
  o += (bytes + 15) & ~15;
  return at;
}

// A run's results as block 0 receives them: its product of corr (g), its
// weighted sum of p (g) and of p . V (g * D).
__host__ __device__ inline int slot_floats(int g, int d) { return 2 * g + g * d; }

// Per-row run state (floats of g each): the run's maximum from the first
// pass, the carried m_j, a window's product of corr, the run's l and its
// product of corr.
constexpr int kRowState = 5;

__host__ __device__ inline Layout layout(int g, int d, int page, int win_pages,
                                         int stages, int stage_bytes, int cluster) {
  Layout L;
  int o = 0;
  const int keys = win_pages * page;
  L.ring = take(o, stages * stage_bytes);
  L.bars = take(o, 8 * stages);
  L.q = take(o, 4 * g * d);
  L.sc = take(o, 4 * g * keys);         // scores, then weighted p
  L.ksc = take(o, 4 * keys);
  L.vsc = take(o, 4 * keys);
  L.m = take(o, 4 * g * win_pages);     // page maxima, then m_j
  L.w = take(o, 4 * g * win_pages);     // corr_j, then prod_{i>j} corr_i in the window
  L.tbl = take(o, 4 * win_pages);
  L.red = take(o, 4 * kThreads);
  L.bm_in = take(o, 4 * cluster * g);                  // the runs' maxima
  L.recv = take(o, 4 * cluster * slot_floats(g, d));   // block 0: every run's results
  L.wb = take(o, 4 * 2 * paged::kMaxTableRows);
  L.st = take(o, 4 * kRowState * g);
  L.racc = take(o, 4 * g * d);          // the run's p . V
  L.wacc = take(o, 4 * g * d);          // a window's p . V when g * D > kThreads
  L.total = o;
  return L;
}

// Keys a ring stage holds: as many whole pages as fit `target` bytes (at
// least one, at most a window), or, for pages larger than that, the
// largest divisor of the page that fits.
__host__ __device__ inline int chunk_keys(int page, int row_bytes, int win_pages, int target) {
  const int page_bytes = page * row_bytes;
  if (page_bytes <= target) {
    const int n = target / page_bytes;
    return (n < win_pages ? n : win_pages) * page;
  }
  int ck = 1;
  for (int c = 1; c <= page; ++c)
    if (page % c == 0 && c * row_bytes <= target) ck = c;
  return ck;
}

__device__ __forceinline__ float warp_max(float x) { return paged::warp_max(x); }
__device__ __forceinline__ float warp_sum(float x) { return paged::warp_sum(x); }

__device__ __forceinline__ float softmax_exp(const Args& a, const float* wb, float x) {
  return a.use_lut ? lut::eval(x, wb, a.lo, a.inv_step, a.sections) : expf(x);
}

__device__ __forceinline__ int clamp_page(const Args& a, int phys) {
  return (phys >= 0 && phys < a.n_pool) ? phys : 0;
}

// The ring's items, in run-relative keys. With one window (the run fits):
// the K chunks of the run, then its V chunks. With several: the first
// pass's K chunks of the whole run (p1 = nkc items), then per window its K
// chunks and its V chunks. cw: chunks a window.
struct Item {
  int first, nk;
  bool is_v;
};

struct Sched {
  int np, run_keys, nkc, cw, nw, p1, n_items;
};

__device__ __forceinline__ Item item(const Args& a, const Sched& S, int i) {
  Item it;
  int chunk;
  if (i < S.p1) {
    it.is_v = false;
    chunk = i;
  } else {
    const int j = i - S.p1;
    const int w = j / (2 * S.cw);
    const int r = j - w * 2 * S.cw;
    const int n = min(S.cw, S.nkc - w * S.cw);
    it.is_v = r >= n;
    chunk = w * S.cw + (it.is_v ? r - n : r);
  }
  it.first = chunk * a.chunk_keys;
  it.nk = min(a.chunk_keys, S.run_keys - it.first);
  return it;
}

// Where the run's rows live: the arena's run starts at row `row0` of the
// K/V tensors; a pool's key k sits in page tbl[k / page] of kv head h.
struct Src {
  const int* tbl;
  size_t row0;
  int h;
};

// Byte offset, in the K or V tensor, of run-relative key k.
template <int kMode>
__device__ __forceinline__ size_t row_offset(const Args& a, const Src& src, int k,
                                             int row_bytes) {
  if constexpr (kMode == kArena) {
    return (src.row0 + k) * (size_t)row_bytes;
  } else {
    const int j = k / a.page;
    const size_t pg = (size_t)clamp_page(a, src.tbl[j]) * a.hkv + src.h;
    return (pg * a.page + (k - j * a.page)) * (size_t)row_bytes;
  }
}

// Index of run-relative key k's scale row entry.
template <int kMode>
__device__ __forceinline__ size_t scale_index(const Args& a, const Src& src, int k) {
  return row_offset<kMode>(a, src, k, 1);
}

// Every thread: start its 16-byte cp.async copies of item i into the
// item's stage, and arrive on the stage's barrier when they land. An item
// is a whole number of pages, or a part of one page: pages are contiguous.
template <class Pool, int kMode>
__device__ void issue(const Args& a, const Layout& L, const Sched& S, uint32_t base,
                      const Src& src, int i) {
  const Item it = item(a, S, i);
  const int row_bytes = Row<Pool>::bytes(a.d);
  const int s = i % stages<kMode>();
  const uint32_t dst = base + L.ring + s * a.chunk_keys * row_bytes;
  const uint8_t* pool = it.is_v ? a.v_pages : a.k_pages;
  const int n16 = it.nk * row_bytes / 16;
  if (kMode == kArena || a.chunk_keys <= a.page) {
    const uint8_t* from = pool + row_offset<kMode>(a, src, it.first, row_bytes);
    for (int v = threadIdx.x; v < n16; v += kThreads) hopper::cp_async16(dst + 16 * v, from + 16 * v);
  } else {
    const int page_vecs = a.page * row_bytes / 16;
    const int p0 = it.first / a.page;
    for (int v = threadIdx.x; v < n16; v += kThreads) {
      const int j = v / page_vecs;
      const size_t pg = (size_t)clamp_page(a, src.tbl[p0 + j]) * a.hkv + src.h;
      hopper::cp_async16(dst + 16 * v,
                         pool + pg * a.page * row_bytes + 16 * (v - j * page_vecs));
    }
  }
  hopper::cp_async_arrive(base + L.bars + 8 * s);
}

// The whole block: copy item i into its stage (rows that are not whole
// 16-byte vectors); the caller synchronises.
template <class Pool, int kMode>
__device__ void copy_item(const Args& a, const Layout& L, const Sched& S, uint8_t* smem,
                          const Src& src, int i) {
  const Item it = item(a, S, i);
  const int row_bytes = Row<Pool>::bytes(a.d);
  uint8_t* dst = smem + L.ring + (i % stages<kMode>()) * a.chunk_keys * row_bytes;
  const uint8_t* pool = it.is_v ? a.v_pages : a.k_pages;
  for (int e = threadIdx.x; e < it.nk * row_bytes; e += blockDim.x) {
    const int k = e / row_bytes;
    dst[e] = pool[row_offset<kMode>(a, src, it.first + k, row_bytes) + (e - k * row_bytes)];
  }
}

// Item i's stage, once its copies have landed (or after the block has
// copied it).
template <class Pool, int kMode>
__device__ __forceinline__ const uint8_t* acquire(const Args& a, const Layout& L,
                                                  const Sched& S, uint8_t* smem, uint32_t base,
                                                  const Src& src, int i) {
  const int s = i % stages<kMode>();
  if (a.vec) {
    hopper::mbar_wait(base + L.bars + 8 * s, (i / stages<kMode>()) & 1);
  } else {
    copy_item<Pool, kMode>(a, L, S, smem, src, i);
    __syncthreads();
  }
  return smem + L.ring + s * a.chunk_keys * Row<Pool>::bytes(a.d);
}

// Every thread is done with item i: refill its stage with the item a ring
// later.
template <class Pool, int kMode>
__device__ __forceinline__ void release(const Args& a, const Layout& L, const Sched& S,
                                        uint32_t base, const Src& src, int i) {
  __syncthreads();
  constexpr int n = stages<kMode>();
  if (a.vec && i + n < S.n_items) issue<Pool, kMode>(a, L, S, base, src, i + n);
}

// At most 64 registers a thread, so that four blocks share an SM and a
// grid of 8-block clusters fits the card in one wave.
// kWin: runs may be wider than a window (the instantiation without it
// holds none of the windowed walk's code).
template <typename T, class Pool, bool kWin, int kMode>
__global__ void __launch_bounds__(kThreads, 4)
decode_walk_kernel(const Args a) {
  using R = Row<Pool>;
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // The combine, launched with programmatic stream serialization, may
  // start as soon as every block of this grid has started: its blocks wait
  // (griddepcontrol.wait) for this grid to finish before they read a
  // partial, so it only takes its launch off the critical path.
  if constexpr (kMode == kSplit) hopper::pdl_launch_dependents();
  const int ci = blockIdx.x / cs;              // this cluster's (b, kv head[, split])
  const int sp = kMode == kSplit ? ci % a.splits : 0;
  const int bh = kMode == kSplit ? ci / a.splits : ci;
  const int b = bh / a.hkv;
  const int h = bh - b * a.hkv;
  const int g = a.g, D = a.d, page = a.page;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row_bytes = R::bytes(D);
  const int W = a.win_pages;
  const Layout L = layout(g, D, page, W, stages<kMode>(), a.chunk_keys * row_bytes, cs);
  const uint32_t base = hopper::smem_u32(smem);
  float* s_q = reinterpret_cast<float*>(smem + L.q);
  float* s_sc = reinterpret_cast<float*>(smem + L.sc);
  float* s_ksc = reinterpret_cast<float*>(smem + L.ksc);
  float* s_vsc = reinterpret_cast<float*>(smem + L.vsc);
  float* s_m = reinterpret_cast<float*>(smem + L.m);
  float* s_w = reinterpret_cast<float*>(smem + L.w);
  int* s_tbl = reinterpret_cast<int*>(smem + L.tbl);
  float* s_red = reinterpret_cast<float*>(smem + L.red);
  float* s_bm_in = reinterpret_cast<float*>(smem + L.bm_in);
  float* s_wb = reinterpret_cast<float*>(smem + L.wb);
  float* s_rmax = reinterpret_cast<float*>(smem + L.st);
  float* s_carry = s_rmax + g;
  float* s_cw = s_carry + g;
  float* s_rl = s_cw + g;
  float* s_rprod = s_rl + g;
  float* s_racc = reinterpret_cast<float*>(smem + L.racc);
  float* s_wacc = reinterpret_cast<float*>(smem + L.wacc);
  // This run's slot in block 0's shared memory: C, l, then acc.
  float* slot = cluster.map_shared_rank(reinterpret_cast<float*>(smem + L.recv), 0) +
                rank * slot_floats(g, D);
  const int keys_max = W * page;               // a window's keys: the score rows' stride

  // The logical pages [r_lo, r_hi) this cluster walks, those that hold a
  // valid key; keys at or past key_end are never read.
  const int length = a.lengths[b];
  int r_lo = 0, r_hi, key_end;
  if constexpr (kMode == kArena) {
    key_end = max(0, min(length, a.S));
    r_hi = (key_end + page - 1) / page;
    if (a.window > 0) r_lo = min(r_hi, max(0, length - a.window) / page);
  } else {
    const int n_pages = length > 0 ? min((length + page - 1) / page, a.n_table) : 0;
    r_hi = n_pages;
    if constexpr (kMode == kSplit) {
      r_lo = min(n_pages, sp * a.pps);
      r_hi = min(n_pages, (sp + 1) * a.pps);
    }
    key_end = r_hi * page;
  }
  // This block's run of them, in windows of W pages (one window when the
  // run fits).
  const int p_lo = r_lo + rank * (r_hi - r_lo) / cs;
  Sched S;
  S.np = r_lo + (rank + 1) * (r_hi - r_lo) / cs - p_lo;
  S.run_keys = max(0, min(S.np * page, key_end - p_lo * page));
  S.nkc = (S.run_keys + a.chunk_keys - 1) / a.chunk_keys;
  S.cw = (W * page + a.chunk_keys - 1) / a.chunk_keys;
  S.nw = (S.nkc + S.cw - 1) / S.cw;
  S.p1 = S.nw > 1 ? S.nkc : 0;
  S.n_items = S.p1 + 2 * S.nkc;
  const bool one = !kWin || S.nw <= 1;
  Src src;
  src.h = h;
  src.row0 = ((size_t)bh * a.S + (size_t)p_lo * page);
  src.tbl = kMode == kArena ? nullptr
            : one           ? s_tbl
                            : a.block_tables + (size_t)b * a.n_table + p_lo;

  // Arrive now and wait before the first store to another block's shared
  // memory: every block of the cluster has started by then.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (kMode != kArena && one) {
    for (int i = tid; i < S.np; i += kThreads)
      s_tbl[i] = clamp_page(a, a.block_tables[(size_t)b * a.n_table + p_lo + i]);
  }
  if (tid == 0) {
    for (int s = 0; s < stages<kMode>(); ++s) hopper::mbar_init(base + L.bars + 8 * s, kThreads);
    hopper::mbar_init_fence();
  }
  for (int r = tid; r < g; r += kThreads) {
    s_rmax[r] = kNegInf;
    s_rl[r] = 0.0f;
    s_rprod[r] = 1.0f;
  }
  for (int i = tid; i < g * D; i += kThreads) {
    s_racc[i] = 0.0f;
    s_wacc[i] = 0.0f;
  }
  __syncthreads();
  if (a.vec) {
    for (int i = 0; i < min(stages<kMode>(), S.n_items); ++i)
      issue<Pool, kMode>(a, L, S, base, src, i);
  }
  const T* q = reinterpret_cast<const T*>(a.q);
  for (int i = tid; i < g * D; i += kThreads)
    s_q[i] = to_f(q[((size_t)b * a.H + h * g) * D + i]);
  if (a.use_lut) lut::stage(s_wb, a.exp_wb, a.sections);

  // Keys in the window whose pages start at run page wp0.
  auto window_keys = [&](int wp0, int wnp) { return min(wnp * page, S.run_keys - wp0 * page); };
  // K (and V) scales of the window's wkeys keys (fp pools have none: their
  // scores and values skip the factor 1).
  auto load_scales = [&](int wp0, int wkeys, bool with_v) {
    if (!Pool::kScaled) return;
    for (int k = tid; k < wkeys; k += kThreads) {
      const size_t at = scale_index<kMode>(a, src, wp0 * page + k);
      s_ksc[k] = Pool::scale(a.k_scales, at);
      if (with_v) s_vsc[k] = Pool::scale(a.v_scales, at);
    }
  };

  // Scores: a pair of threads a key (one when a row is one unit), summed
  // by one shuffle. The walk is bound by the instructions it issues a key
  // on few SMs; a pair keeps the shuffles few and a pass wide (128 keys),
  // and measured faster than 4, 8 or a warp a key.
  const bool uv = R::vec_units(D, a.vec);
  const int units = uv ? row_bytes / R::kUnit : R::elems(D);
  const int tpk = units >= 2 ? 2 : 1;
  const int sub = tid % tpk;
  const int qpos = length - 1;
  int it = 0;                                   // the next ring item
  // Window w's scores (its K items), at window-local key positions.
  auto score = [&](int w) {
    const int c_end = min(S.nkc, (w + 1) * S.cw);
    for (int c = w * S.cw; c < c_end; ++c, ++it) {
      const uint8_t* stage = acquire<Pool, kMode>(a, L, S, smem, base, src, it);
      const int first_key = c * a.chunk_keys - w * W * page;
      const int nk = min(a.chunk_keys, S.run_keys - c * a.chunk_keys);
      for (int k0 = 0; k0 < nk; k0 += kThreads / tpk) {
        const int kl = k0 + tid / tpk;
        const uint8_t* row = stage + (size_t)min(kl, nk - 1) * row_bytes;
        const float ksc = Pool::kScaled ? s_ksc[first_key + min(kl, nk - 1)] : 1.0f;
        for (int r = 0; r < g; ++r) {
          const float* qr = s_q + r * D;
          float dot = 0.0f;
          if (kl < nk) {
            if (uv) {
              for (int v = sub; v < units; v += tpk)
                dot += R::dotu(row + R::kUnit * v, qr, v, D, ksc);
            } else {
              for (int e = sub; e < units; e += tpk) dot = R::acc1(row, qr, e, D, dot, ksc);
            }
          }
          for (int off = tpk / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          if (kl < nk && sub == 0) {
            float s = (R::kInline || !Pool::kScaled ? dot : dot * ksc) * a.scale;
            if (a.softcap > 0.0f) s = a.softcap * tanhf(s / a.softcap);
            const bool ok = paged::key_valid(p_lo * page + c * a.chunk_keys + kl, qpos,
                                             length, a.window);
            s_sc[r * keys_max + first_key + kl] = ok ? s : kNegInf;
          }
        }
      }
      release<Pool, kMode>(a, L, S, base, src, it);
    }
  };
  // Page maxima of a window's wnp pages (wkeys keys) into s_m, and the
  // row's maximum (warp r of every g-th row): a lane a page, or for pages
  // of a warp's width or more (the arena's 256 keys) the warp a page.
  auto page_maxima = [&](int r, int wnp, int wkeys) {
    const float* sr = s_sc + r * keys_max;
    float bm = kNegInf;
    if (page >= 32) {
      for (int j = 0; j < wnp; ++j) {
        float pm = kNegInf;
        for (int t = j * page + lane; t < min((j + 1) * page, wkeys); t += 32)
          pm = fmaxf(pm, sr[t]);
        pm = warp_max(pm);
        if (lane == 0) s_m[r * W + j] = pm;
        bm = fmaxf(bm, pm);
      }
      return bm;
    }
    for (int j = lane; j < wnp; j += 32) {
      float pm = kNegInf;
      const int t_end = min(page, wkeys - j * page);
      for (int t = 0; t < t_end; ++t) pm = fmaxf(pm, sr[j * page + t]);
      s_m[r * W + j] = pm;
      bm = fmaxf(bm, pm);
    }
    return warp_max(bm);
  };

  if (one) {
    load_scales(0, S.run_keys, true);
    __syncthreads();
    score(0);
  } else {
    // First pass: the run's maximum, one window of scores at a time.
    for (int w = 0; w < S.nw; ++w) {
      const int wp0 = w * W;
      const int wkeys = window_keys(wp0, min(W, S.np - wp0));
      load_scales(wp0, wkeys, false);
      __syncthreads();
      score(w);
      for (int r = warp; r < g; r += kWarps) {
        float bm = kNegInf;
        for (int k = lane; k < wkeys; k += 32) bm = fmaxf(bm, s_sc[r * keys_max + k]);
        bm = warp_max(bm);
        if (lane == 0) s_rmax[r] = fmaxf(s_rmax[r], bm);
      }
      __syncthreads();
    }
  }

  // The run's maximum, pushed to the later runs (in split mode to every
  // run, this one included: block 0 writes the split's m).
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int r = warp; r < g; r += kWarps) {
    const float bm = one ? page_maxima(r, S.np, S.run_keys) : s_rmax[r];
    for (int rk = (kMode == kSplit ? 0 : rank + 1) + lane; rk < cs; rk += 32)
      cluster.map_shared_rank(s_bm_in, rk)[rank * g + r] = bm;
  }
  cluster.sync();

  const int pairs = g * D;
  const int KG = pairs <= kThreads ? kThreads / pairs : 1;
  const int kg = pairs <= kThreads ? tid / pairs : 0;
  for (int w = 0; w < S.nw; ++w) {
    const int wp0 = w * W;
    const int wnp = min(W, S.np - wp0);
    const int wkeys = window_keys(wp0, wnp);
    if (!one) {
      load_scales(wp0, wkeys, true);
      __syncthreads();
      score(w);
      for (int r = warp; r < g; r += kWarps) page_maxima(r, wnp, wkeys);
      __syncthreads();
    }

    // m_j by a prefix-max scan from the carry (the earlier runs' maximum,
    // or the last m_j of the previous window), corr_j, then the window's
    // w_j = prod_{i>j} corr_i by a suffix-product scan; one warp a row.
    for (int r = warp; r < g; r += kWarps) {
      float carry = kNegInf;
      if (w == 0) {
        for (int rk = 0; rk < rank; ++rk) carry = fmaxf(carry, s_bm_in[rk * g + r]);
      } else {
        carry = s_carry[r];
      }
      float* mr = s_m + r * W;
      float* wr = s_w + r * W;
      for (int j0 = 0; j0 < wnp; j0 += 32) {
        const int j = j0 + lane;
        float x = j < wnp ? mr[j] : kNegInf;
        for (int off = 1; off < 32; off <<= 1) {
          const float y = __shfl_up_sync(0xffffffffu, x, off);
          if (lane >= off) x = fmaxf(x, y);
        }
        const float m = fmaxf(carry, x);
        float m_prev = __shfl_up_sync(0xffffffffu, m, 1);
        if (lane == 0) m_prev = carry;
        if (j < wnp) {
          const float diff = m_prev - m;
          mr[j] = m;
          wr[j] = a.use_lut ? lut::eval(fmaxf(diff, a.lo), s_wb, a.lo, a.inv_step, a.sections)
                            : expf(diff);
        }
        carry = __shfl_sync(0xffffffffu, m, 31);
      }
      __syncwarp();
      float prod = 1.0f;
      for (int j0 = (wnp - 1) / 32 * 32; wnp > 0 && j0 >= 0; j0 -= 32) {
        const int j = j0 + lane;
        const float corr = j < wnp ? wr[j] : 1.0f;
        float x = corr;                                   // prod_{i>=j} in this group
        for (int off = 1; off < 32; off <<= 1) {
          const float y = __shfl_down_sync(0xffffffffu, x, off);
          if (lane + off < 32) x *= y;
        }
        float after = __shfl_down_sync(0xffffffffu, x, 1);
        if (lane == 31) after = 1.0f;
        if (j < wnp) wr[j] = after * prod;
        prod *= __shfl_sync(0xffffffffu, x, 0);
      }
      if (lane == 0) {
        s_cw[r] = prod;
        s_carry[r] = carry;
      }
    }
    __syncthreads();

    // p_k = exp or LUT of s_k - m_j, weighted by w_j, in place of the scores.
    for (int t = tid; t < g * wkeys; t += kThreads) {
      const int r = t / wkeys;
      const int k = t - r * wkeys;
      const int j = k / page;
      float* sp_ = s_sc + r * keys_max + k;
      float p = 0.0f;
      if (paged::key_valid((p_lo + wp0) * page + k, qpos, length, a.window))
        p = softmax_exp(a, s_wb, *sp_ - s_m[r * W + j]);
      *sp_ = p * s_w[r * W + j];
    }
    __syncthreads();
    // The run's l and product of corr take the window by Horner's rule.
    for (int r = warp; r < g; r += kWarps) {
      float l = 0.0f;
      for (int k = lane; k < wkeys; k += 32) l += s_sc[r * keys_max + k];
      l = warp_sum(l);
      if (lane == 0 && one) {           // the run is this window: straight to block 0
        slot[r] = s_cw[r];
        slot[g + r] = l;
      } else if (lane == 0) {
        s_rl[r] = s_rl[r] * s_cw[r] + l;
        s_rprod[r] *= s_cw[r];
      }
    }

    // p . V: threads over (row, dim) pairs and kg key groups; past
    // kThreads pairs, each thread owns pairs tid, tid + kThreads, ... and
    // sums each V chunk into the window's s_wacc.
    // acc += sum over the stage's keys of p * V[key][dd] for pair pr.
    auto pv = [&](const uint8_t* stage, int pr, int first_key, int nk, float& acc) {
      const int r = pr / D;
      const int dd = pr - r * D;
      const float* pw = s_sc + r * keys_max + first_key;
      const float* vs = s_vsc + first_key;
      auto value = [&](const uint8_t* row, int kl) {
        return Pool::kScaled ? R::val(row, dd, D, vs[kl]) : R::at(row, dd, D);
      };
      const uint8_t* col = stage + (size_t)kg * row_bytes;
      // Four keys at a time, their loads issued before the sums.
      int kl = kg;
      for (; kl + 3 * KG < nk; kl += 4 * KG, col += 4 * (size_t)KG * row_bytes) {
        float v[4], p[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          v[t] = value(col + (size_t)t * KG * row_bytes, kl + t * KG);
          p[t] = pw[kl + t * KG];
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) acc = fmaf(p[t], v[t], acc);
      }
      for (; kl < nk; kl += KG, col += (size_t)KG * row_bytes)
        acc = fmaf(pw[kl], value(col, kl), acc);
    };
    float acc = 0.0f;
    const int c_end = min(S.nkc, (w + 1) * S.cw);
    for (int c = w * S.cw; c < c_end; ++c, ++it) {
      const uint8_t* stage = acquire<Pool, kMode>(a, L, S, smem, base, src, it);
      const int first_key = c * a.chunk_keys - wp0 * page;
      const int nk = min(a.chunk_keys, S.run_keys - c * a.chunk_keys);
      if (pairs <= kThreads) {
        if (kg < KG) pv(stage, tid % pairs, first_key, nk, acc);
      } else {
        for (int pr = tid; pr < pairs; pr += kThreads) {
          float part = 0.0f;
          pv(stage, pr, first_key, nk, part);
          s_wacc[pr] += part;
        }
      }
      release<Pool, kMode>(a, L, S, base, src, it);
    }
    if (pairs <= kThreads) {
      if (kg < KG) s_red[kg * pairs + tid % pairs] = acc;
      __syncthreads();
      for (int pr = tid; pr < pairs; pr += kThreads) {
        float v = s_red[pr];
        for (int j = 1; j < KG; ++j) v += s_red[j * pairs + pr];
        if (one) {
          slot[2 * g + pr] = v;
        } else {
          s_racc[pr] = s_racc[pr] * s_cw[pr / D] + v;
        }
      }
    } else {
      for (int pr = tid; pr < pairs; pr += kThreads) {
        if (one) {
          slot[2 * g + pr] = s_wacc[pr];
        } else {
          s_racc[pr] = s_racc[pr] * s_cw[pr / D] + s_wacc[pr];
          s_wacc[pr] = 0.0f;
        }
      }
    }
    if (!one) __syncthreads();
  }

  // The run's results into block 0 (done above for a run of one window).
  if (!one || S.nw == 0) {
    for (int r = tid; r < g; r += kThreads) {
      slot[r] = s_rprod[r];
      slot[g + r] = s_rl[r];
    }
    for (int pr = tid; pr < pairs; pr += kThreads) slot[2 * g + pr] = s_racc[pr];
  }
  // Every run's results are in block 0, which no other block reads: the
  // others may leave after this barrier.
  cluster.sync();
  if (rank != 0) return;

  // Block 0 merges the runs in order: X = X * C_b + X_b.
  const float* recv = reinterpret_cast<const float*>(smem + L.recv);
  const int sf = slot_floats(g, D);
  T* out = reinterpret_cast<T*>(a.out);
  const size_t row0 = ((size_t)bh * a.splits + sp) * g;   // split: this split's partial rows
  for (int pr = tid; pr < pairs; pr += kThreads) {
    const int r = pr / D;
    float l = recv[g + r], x = recv[2 * g + pr];
    for (int rk = 1; rk < cs; ++rk) {
      const float* sl = recv + rk * sf;
      l = l * sl[r] + sl[g + r];
      x = x * sl[r] + sl[2 * g + pr];
    }
    if constexpr (kMode == kSplit) {
      if (pr - r * D == 0) {
        float m = kNegInf;
        for (int rk = 0; rk < cs; ++rk) m = fmaxf(m, s_bm_in[rk * g + r]);
        a.m_part[row0 + r] = m;
        a.l_part[row0 + r] = l;
      }
      a.acc_part[row0 * D + pr] = x;
    } else {
      out[((size_t)b * a.H + h * g) * D + pr] = common::from_f<T>(x / fmaxf(l, 1e-9f));
    }
  }
}

// Launch n_clusters clusters of `cluster` blocks; a.win_pages and
// a.chunk_keys are set here from the run's pages.
template <typename T, class Pool, int kMode>
int launch(Args a, int n_clusters, int run_pages, int cluster, cudaStream_t stream) {
  const int row_bytes = Row<Pool>::bytes(a.d);
  a.vec = row_bytes % 16 == 0 && common::aligned16(a.k_pages) && common::aligned16(a.v_pages);
  a.win_pages = min(a.win_pages, run_pages);
  a.chunk_keys = chunk_keys(a.page, paged::StageRow<Pool>::bytes(a.d), a.win_pages,
                            stage_target<kMode>());
  // A window shorter than the run holds whole ring stages.
  if (a.win_pages < run_pages && (a.win_pages * a.page) % a.chunk_keys != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = layout(a.g, a.d, a.page, a.win_pages, stages<kMode>(),
                          a.chunk_keys * row_bytes, cluster).total;
  if (smem > paged::kSmemMax) return (int)cudaErrorInvalidValue;
  const bool win = a.win_pages < run_pages;
  auto kernel = win ? decode_walk_kernel<T, Pool, true, kMode>
                    : decode_walk_kernel<T, Pool, false, kMode>;
  static int sized[2] = {paged::kSmemDefault, paged::kSmemDefault};   // largest allowed so far
  if (smem > sized[win]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized[win] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_clusters * cluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, a);
}

// The checks every C entry makes: heads that group, a cluster of 1, 2, 4
// or 8 blocks no larger than a run's pages, a window, and a LUT table that
// fits shared memory.
inline bool valid(int H, int Hkv, int run_pages, int cluster, int win_pages, int use_lut,
                  const float* exp_wb, int sections) {
  return Hkv > 0 && H % Hkv == 0 && run_pages >= 1 && win_pages >= 1 && cluster >= 1 &&
         cluster <= kMaxCluster && (cluster & (cluster - 1)) == 0 && cluster <= run_pages &&
         !(use_lut && (exp_wb == nullptr || sections + 2 > paged::kMaxTableRows));
}

}  // namespace
}  // namespace walk
